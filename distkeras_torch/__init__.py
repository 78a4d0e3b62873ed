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

This module imports nothing heavy: submodules load torch on demand.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
