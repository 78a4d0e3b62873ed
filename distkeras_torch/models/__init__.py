"""Models of the port: the flagship :class:`TransformerLM`, the
dist-keras :class:`MLP`, :class:`MNISTCNN` and :class:`CIFARCNN`, and the
name registry (``get_model("cifar_cnn", ...)``)."""

from distkeras_torch.models.cnn import CIFARCNN, MNISTCNN  # noqa: F401
from distkeras_torch.models.mlp import MLP  # noqa: F401
from distkeras_torch.models.registry import (  # noqa: F401
    get_model,
    model_spec,
    register_model,
)
from distkeras_torch.models.transformer import TransformerLM  # noqa: F401

__all__ = ["get_model", "model_spec", "register_model", "TransformerLM",
           "MLP", "MNISTCNN", "CIFARCNN"]
