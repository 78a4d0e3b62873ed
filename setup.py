"""Packaging (reference: setup.py — pip metadata for distkeras).

The native transport library is built on demand at import time (see
distkeras_tpu/networking.py); ``build_native`` below lets packagers do it
eagerly.
"""

from setuptools import find_packages, setup

setup(
    name="distkeras-tpu",
    version="0.5.0",
    description=(
        "TPU-native distributed deep learning: data-parallel trainers "
        "(DOWNPOUR, ADAG, EASGD/AEASGD/EAMSGD, DynSGD), partitioned-dataset "
        "pipelines, and batch inference on JAX/XLA"
    ),
    packages=find_packages(include=["distkeras_tpu", "distkeras_tpu.*",
                                    "distkeras_torch", "distkeras_torch.*"]),
    # the PyTorch/CUDA port builds its kernels from these at first use
    package_data={"distkeras_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        # floors match the APIs the code depends on: top-level
        # jax.shard_map, lax.pcast, and the vma-aware shard_map transpose
        # semantics the DP gradient math relies on (validated on 0.9.x)
        "jax>=0.7",
        "flax>=0.10",
        "optax>=0.2",
        "orbax-checkpoint>=0.5",
        "numpy>=1.26",
    ],
    extras_require={"test": ["pytest"]},
)
