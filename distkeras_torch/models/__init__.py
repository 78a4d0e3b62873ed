"""Models of the port: the flagship :class:`TransformerLM` and the
name registry (``get_model("transformer_lm", ...)``)."""

from distkeras_torch.models.registry import get_model, register_model  # noqa: F401
from distkeras_torch.models.transformer import TransformerLM  # noqa: F401

__all__ = ["get_model", "register_model", "TransformerLM"]
