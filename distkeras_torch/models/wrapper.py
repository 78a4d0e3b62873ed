"""Model — the trained model trainers return — the port of
:mod:`distkeras_tpu.models.wrapper`.

The reference pairs an immutable flax module with a params pytree. A
PyTorch module holds its own parameters, so here the pair is the module
itself: :attr:`Model.params` reads them (by name), :meth:`predict` and
:meth:`generate` run it, and :meth:`replace_params` builds a twin module
of the same configuration loaded with other weights.
"""

from __future__ import annotations

import numpy as np
import torch


class Model:
    """A trained model: a port module (its parameters inside it), with
    batched predict and LM generation."""

    def __init__(self, module):
        self.module = module

    @property
    def params(self) -> dict:
        """The module's parameters by name (live tensors, not copies)."""
        return dict(self.module.named_parameters())

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @torch.no_grad()
    def predict(self, x) -> np.ndarray:
        """Batched forward pass -> host numpy (logits for an LM)."""
        x = torch.as_tensor(np.asarray(x), device=self.device)
        return self.module(x).float().cpu().numpy()

    def serialize(self) -> dict:
        raise NotImplementedError(
            "Model.serialize (the msgpack model blob) is not ported yet "
            "(ROADMAP A1)")

    @classmethod
    def deserialize(cls, blob: dict) -> "Model":
        raise NotImplementedError(
            "Model.deserialize (the msgpack model blob) is not ported yet "
            "(ROADMAP A1)")

    def replace_params(self, params) -> "Model":
        """A new Model over a fresh module of the same configuration on
        the same device, loaded with ``params``: a flax-layout tree of
        numpy arrays (:func:`distkeras_torch.bridge.params_from_jax`) or
        a ``state_dict``-style mapping of tensors."""
        from distkeras_torch import bridge

        twin = type(self.module)(device=self.device,
                                 **self.module.config())
        if any(isinstance(v, dict) for v in params.values()):
            bridge.params_from_jax(params, twin)
        else:
            twin.load_state_dict(params)
        return Model(twin)

    def generate(self, prompt, max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id=None, top_k=None, top_p=None) -> np.ndarray:
        """Autoregressive sampling (language models only) through
        :func:`distkeras_torch.models.transformer.generate`."""
        from distkeras_torch.models import transformer

        if not hasattr(self.module, "max_len"):
            raise TypeError(
                f"{type(self.module).__name__} is not a language model; "
                "generate() needs a TransformerLM-family module")
        return transformer.generate(
            self.module, prompt, max_new_tokens, temperature=temperature,
            seed=seed, eos_id=eos_id, top_k=top_k, top_p=top_p,
        ).cpu().numpy()
