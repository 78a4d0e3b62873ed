"""MLP — the port of :mod:`distkeras_tpu.models.mlp`, the reference's
MNIST multilayer perceptron: flatten, ``Dense(f)`` + ReLU for each entry
of ``features``, then a float32 head. Logits come back un-softmaxed.

flax infers a ``Dense``'s input width from the first batch; a PyTorch
module holds its weights from construction, so the input width is a
constructor argument (``in_features``, 784 for flattened MNIST).

The layers are named as flax names them (``Dense_0``, ``Dense_1``, ...,
the head last), each with a ``kernel`` of the flax shape ``[in, out]``
and a ``bias``, so :mod:`distkeras_torch.bridge` maps the weights by
name. Every parameter is an f32 master cast to ``dtype`` at use, as flax
keeps ``param_dtype`` f32 and computes in ``dtype``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from distkeras_torch.models.registry import register_model
from distkeras_torch.models.transformer import _trunc_normal
from distkeras_torch.utils.device import resolve_device


class Dense(nn.Module):
    """flax ``nn.Dense(features, dtype=dtype)``: ``x @ kernel + bias`` with
    the input, kernel and bias cast to ``dtype``. The kernel is
    lecun-normal (flax's default), the bias zeros."""

    def __init__(self, in_features: int, features: int, dtype, device, gen):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(_trunc_normal(
            (in_features, features), in_features, device, gen))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.kernel.to(self.dtype).t(),
                        self.bias.to(self.dtype))


def _as_dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


@register_model("mlp")
class MLP(nn.Module):
    """``[B, ...]`` features -> ``[B, num_classes]`` f32 logits. Keywords
    mirror the reference module's attributes, plus ``in_features`` (the
    flattened input width), ``device`` (default: the CUDA card, raising
    without one) and ``seed`` (the init's ``torch.Generator`` seed)."""

    def __init__(self, features: Sequence[int] = (500, 250),
                 num_classes: int = 10, dtype=torch.float32,
                 in_features: int = 784, device=None, seed: int = 0):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        self.num_classes = num_classes
        self.dtype = _as_dtype(dtype)
        self.in_features = in_features
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        widths = (in_features,) + self.features
        for i, f in enumerate(self.features):
            setattr(self, f"Dense_{i}",
                    Dense(widths[i], f, self.dtype, dev, gen))
        self.head_name = f"Dense_{len(self.features)}"
        setattr(self, self.head_name,
                Dense(widths[-1], num_classes, torch.float32, dev, gen))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def config(self) -> dict:
        return dict(features=self.features, num_classes=self.num_classes,
                    dtype=self.dtype, in_features=self.in_features)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(len(self.features)):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, self.head_name)(x)
