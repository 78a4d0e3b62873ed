"""distkeras_torch — the PyTorch/CUDA port of :mod:`distkeras_tpu`.

The JAX package stays the reference; this package mirrors its module
paths and class names so each counterpart is easy to find
(``distkeras_torch.serving.engine.ServingEngine`` ports
``distkeras_tpu.serving.engine.ServingEngine``, and so on). It imports
``torch`` and numpy only — never jax, flax, or anything under
``distkeras_tpu``.

Entry points (model builders, the weight bridge, the serving engine,
the trainers, the predictor) run on the CUDA card unless the caller
passes ``device="cpu"``; with no card and no explicit CPU request they
raise instead of drifting onto the host. Every TPU kernel on the serving path is a hand-written
Hopper kernel (``csrc/*.cu``, built at first use by
:mod:`distkeras_torch.kernels.build`) with a plain PyTorch version
beside it that CPU tensors take.

This module imports nothing heavy: submodules load torch on demand, and
the names below (the dist-keras trainers, the parameter servers, the
checkpointer) load their module when first read.
"""

import importlib

__version__ = "0.1.0"

_LAZY = {
    **{name: "distkeras_torch.trainers" for name in (
        "SingleTrainer", "EnsembleTrainer", "AveragingTrainer",
        "DataParallelTrainer", "LMTrainer", "DistributedTrainer",
        "AsynchronousDistributedTrainer", "SynchronousDistributedTrainer",
        "DOWNPOUR", "ADAG", "DynSGD", "AEASGD", "EAMSGD", "EASGD")},
    **{name: "distkeras_torch.parameter_servers" for name in (
        "ParameterServer", "DeltaParameterServer", "ADAGParameterServer",
        "DynSGDParameterServer", "EASGDParameterServer")},
    "Checkpointer": "distkeras_torch.checkpoint",
    "PartitionedDataset": "distkeras_torch.data.dataset",
    "Model": "distkeras_torch.models.wrapper",
}

__all__ = ["__version__", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'distkeras_torch' has no attribute {name!r}")
