"""Model — the trained model trainers return — the port of
:mod:`distkeras_tpu.models.wrapper`.

The reference pairs an immutable flax module with a params pytree. A
PyTorch module holds its own parameters, so here the pair is the module
itself: :attr:`Model.params` reads them (by name), :meth:`predict`,
:meth:`generate` and :meth:`beam_search` run it, and
:meth:`replace_params` builds a twin module of the same configuration
loaded with other weights. :meth:`serialize` / :meth:`deserialize`
write and read the reference's msgpack blob.
"""

from __future__ import annotations

import numpy as np
import torch


class Model:
    """A trained model: a port module (its parameters inside it), with
    batched predict, LM generation and beam search."""

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
        """The reference's model blob, ``{'model': {name, kwargs},
        'weights': msgpack}`` (:func:`distkeras_torch.utils.serde.
        serialize_model`), which the JAX package loads too."""
        from distkeras_torch import bridge
        from distkeras_torch.models.registry import model_spec
        from distkeras_torch.utils.serde import serialize_model

        return serialize_model(model_spec(self.module),
                               bridge.params_to_jax(self.module))

    @classmethod
    def deserialize(cls, blob: dict, device=None) -> "Model":
        """A Model from a blob of either package, built on ``device``
        (default: the card)."""
        from distkeras_torch.utils.serde import deserialize_model

        module, _ = deserialize_model(blob, device=device)
        return cls(module)

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

    def beam_search(self, prompt, max_new_tokens: int, beam_size: int = 4,
                    length_penalty: float = 0.0, eos_id=None) -> np.ndarray:
        """Beam-search decoding (language models only) through
        :func:`distkeras_torch.models.transformer.beam_search`."""
        from distkeras_torch.models import transformer

        if not hasattr(self.module, "max_len"):
            raise TypeError(
                f"{type(self.module).__name__} is not a language model; "
                "beam_search() needs a TransformerLM-family module")
        return transformer.beam_search(
            self.module, prompt, max_new_tokens, beam_size=beam_size,
            length_penalty=length_penalty, eos_id=eos_id,
        ).cpu().numpy()
