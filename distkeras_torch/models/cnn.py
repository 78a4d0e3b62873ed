"""Convolutional models for the MNIST and CIFAR-10 workloads — the port
of :mod:`distkeras_tpu.models.cnn`.

The reference's modules take NHWC input and compute in ``dtype`` (bf16
by default) with f32 parameters and f32 logits. The port keeps every
flax convention that decides the function they compute:

- **Layout.** Each ``Conv_i/kernel`` keeps flax's ``[kh, kw, Cin, Cout]``
  shape (so weights bridge by name) and is used as
  ``kernel.to(dtype).permute(3, 2, 0, 1)``: the cast copies the weight
  anyway. The NHWC input's ``permute(0, 3, 1, 2)`` is already a
  ``channels_last`` tensor, the layout cuDNN prefers, and every
  convolution and pooling keeps it.
- **Padding.** flax's ``nn.Conv`` pads ``'SAME'`` (``padding=1`` for a
  3x3 kernel at stride 1); ``nn.max_pool((2, 2), strides=(2, 2))`` pads
  ``'VALID'`` (``F.max_pool2d(2)``).
- **Flatten order.** flax flattens ``(h, w, c)``; so does
  ``permute(0, 2, 3, 1).reshape(B, -1)``, free on a channels-last
  tensor. A ``(c, h, w)`` flatten would scramble ``Dense_0``'s rows.
- **Dtypes.** f32 masters cast to ``dtype`` at use; the head is
  ``Dense(num_classes, dtype=float32)``, which promotes the activations
  and returns f32 logits.
- **Init.** lecun-normal kernels (``fan_in = kh * kw * Cin`` for a
  convolution), zero biases.

flax infers shapes from the first batch; here the input's ``input_shape``
``(H, W, C)`` is a constructor argument (``Dense_0``'s width depends on
it), defaulting to the workload's: MNIST ``(28, 28, 1)``, CIFAR
``(32, 32, 3)``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from distkeras_torch.models.mlp import Dense, _as_dtype
from distkeras_torch.models.registry import register_model
from distkeras_torch.models.transformer import _trunc_normal
from distkeras_torch.utils.device import resolve_device


class Conv(nn.Module):
    """flax ``nn.Conv(features, (3, 3), dtype=dtype)`` on channels-first
    views of NHWC tensors: 'SAME' padding, the kernel kept ``[3, 3, Cin,
    Cout]`` in f32, input, kernel and bias cast to ``dtype``."""

    def __init__(self, cin: int, cout: int, dtype, device, gen):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(_trunc_normal((3, 3, cin, cout), 9 * cin,
                                                 device, gen))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x):
        return F.conv2d(x.to(self.dtype),
                        self.kernel.to(self.dtype).permute(3, 2, 0, 1),
                        self.bias.to(self.dtype), padding=1)


class _ConvNet(nn.Module):
    """Blocks of 3x3 convolutions (ReLU after each) and 2x2 max-pools,
    then ``Dense(dense)`` + ReLU and an f32 ``Dense(num_classes)`` head,
    named ``Conv_0, ...`` and ``Dense_0, Dense_1`` as flax names them.
    ``blocks`` lists each block's convolution widths."""

    def _build(self, blocks: Sequence[Sequence[int]], dense: int,
               input_shape: Tuple[int, int, int], device, seed: int):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        H, W, cin = input_shape
        self._blocks = [len(b) for b in blocks]
        i = 0
        for block in blocks:
            for cout in block:
                setattr(self, f"Conv_{i}",
                        Conv(cin, cout, self.dtype, dev, gen))
                cin, i = cout, i + 1
            H, W = H // 2, W // 2
        self.Dense_0 = Dense(H * W * cin, dense, self.dtype, dev, gen)
        self.Dense_1 = Dense(dense, self.num_classes, torch.float32, dev,
                             gen)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, x):
        # NHWC in; the NCHW view of a contiguous NHWC tensor is
        # channels_last in memory
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        i = 0
        for n in self._blocks:
            for _ in range(n):
                x = F.relu(getattr(self, f"Conv_{i}")(x))
                i += 1
            x = F.max_pool2d(x, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's (h, w, c)
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x)


@register_model("mnist_cnn")
class MNISTCNN(_ConvNet):
    """Conv(32)-Conv(64)-pool-Dense(128)-Dense(10), MNIST-shaped
    ``[B, 28, 28, 1]``. Keywords mirror the reference module's, plus
    ``input_shape``, ``device`` (default: the CUDA card, raising without
    one) and ``seed``."""

    def __init__(self, num_classes: int = 10, dtype=torch.bfloat16,
                 input_shape: Tuple[int, int, int] = (28, 28, 1),
                 device=None, seed: int = 0):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = _as_dtype(dtype)
        self.input_shape = tuple(input_shape)
        self._build([(32, 64)], 128, self.input_shape, device, seed)

    def config(self) -> dict:
        return dict(num_classes=self.num_classes, dtype=self.dtype,
                    input_shape=self.input_shape)


@register_model("cifar_cnn")
class CIFARCNN(_ConvNet):
    """VGG-style CNN, CIFAR-shaped ``[B, 32, 32, 3]``: for each width two
    convolutions and a pool, then Dense(256) and the head. Keywords
    mirror the reference module's, plus ``input_shape``, ``device`` and
    ``seed``."""

    def __init__(self, num_classes: int = 10,
                 widths: Sequence[int] = (64, 128, 256),
                 dtype=torch.bfloat16,
                 input_shape: Tuple[int, int, int] = (32, 32, 3),
                 device=None, seed: int = 0):
        super().__init__()
        self.num_classes = num_classes
        self.widths = tuple(int(w) for w in widths)
        self.dtype = _as_dtype(dtype)
        self.input_shape = tuple(input_shape)
        self._build([(w, w) for w in self.widths], 256, self.input_shape,
                    device, seed)

    def config(self) -> dict:
        return dict(num_classes=self.num_classes, widths=self.widths,
                    dtype=self.dtype, input_shape=self.input_shape)
