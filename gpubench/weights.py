"""Seeded weights and inputs, made by the benchmark and handed alike to
the program and to the plain reference.

Weights are one flat f32 buffer drawn on the device by one
``torch.randn`` call of a ``torch.Generator`` seeded from ``--seed``,
then scaled leaf by leaf in place: a kernel by ``1/sqrt(fan_in)``, a
bias by 0.02, a LayerNorm scale around 1. The layout is the port's parameter names and shapes (the flax tree of
the reference package, which the port mirrors); the values are the
benchmark's own. Drawing again from the same seed gives the same bytes,
so the reference regenerates them instead of keeping a copy.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (name, shape, std, mean) of every leaf, in one fixed order
Spec = List[Tuple[str, tuple, float, float]]

# distinct streams of one seed: weights, data
_DATA_STREAM = 0x5DEECE66D


def lm_specs(cfg: dict) -> Spec:
    """The leaves of a TransformerLM (rope, GQA, LayerNorm, 4x GELU MLP,
    untied head), named as ``named_parameters()`` names them."""
    D, H, L, V = (cfg[k] for k in ("d_model", "num_heads", "num_layers",
                                   "vocab_size"))
    Hk = cfg.get("num_kv_heads") or H
    hd = D // H
    F = cfg.get("mlp_ratio", 4) * D
    out: Spec = [("embed.embedding", (V, D), 1.0, 0.0)]
    for i in range(L):
        p = f"blocks.{i}."
        a = p + "CausalSelfAttention_0."
        out += [
            (p + "LayerNorm_0.scale", (D,), 0.1, 1.0),
            (p + "LayerNorm_0.bias", (D,), 0.02, 0.0),
            (a + "q_proj.kernel", (D, H, hd), 1 / math.sqrt(D), 0.0),
            (a + "q_proj.bias", (H, hd), 0.02, 0.0),
            (a + "kv_proj.kernel", (D, 2, Hk, hd), 1 / math.sqrt(D), 0.0),
            (a + "kv_proj.bias", (2, Hk, hd), 0.02, 0.0),
            (a + "out.kernel", (H, hd, D), 1 / math.sqrt(D), 0.0),
            (a + "out.bias", (D,), 0.02, 0.0),
            (p + "LayerNorm_1.scale", (D,), 0.1, 1.0),
            (p + "LayerNorm_1.bias", (D,), 0.02, 0.0),
            (p + "mlp_up.kernel", (D, F), 1 / math.sqrt(D), 0.0),
            (p + "mlp_up.bias", (F,), 0.02, 0.0),
            (p + "mlp_down.kernel", (F, D), 1 / math.sqrt(F), 0.0),
            (p + "mlp_down.bias", (D,), 0.02, 0.0),
        ]
    out += [("ln_f.scale", (D,), 0.1, 1.0), ("ln_f.bias", (D,), 0.02, 0.0),
            ("head.kernel", (D, V), 1 / math.sqrt(D), 0.0),
            ("head.bias", (V,), 0.02, 0.0)]
    return out


def cnn_specs(cfg: dict) -> Spec:
    """The leaves of the CIFAR CNN: two 3x3 convolutions a width
    (``[3, 3, Cin, Cout]`` kernels), Dense(dense) and the head."""
    H, W, cin = cfg["input_shape"]
    out: Spec = []
    i = 0
    for w in cfg["widths"]:
        for _ in range(2):
            out += [(f"Conv_{i}.kernel", (3, 3, cin, w),
                     1 / math.sqrt(9 * cin), 0.0),
                    (f"Conv_{i}.bias", (w,), 0.02, 0.0)]
            cin, i = w, i + 1
        H, W = H // 2, W // 2
    flat = H * W * cin
    out += [("Dense_0.kernel", (flat, cfg["dense"]), 1 / math.sqrt(flat),
             0.0),
            ("Dense_0.bias", (cfg["dense"],), 0.02, 0.0),
            ("Dense_1.kernel", (cfg["dense"], cfg["num_classes"]),
             1 / math.sqrt(cfg["dense"]), 0.0),
            ("Dense_1.bias", (cfg["num_classes"],), 0.02, 0.0)]
    return out


def make_flat(specs: Spec, seed: int, device) -> torch.Tensor:
    """The flat f32 buffer of every leaf, drawn in one call and scaled."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(math.prod(s) for _, s, _, _ in specs)
    flat = torch.randn(total, generator=gen, device=device)
    off = 0
    with torch.no_grad():
        for _, shape, std, mean in specs:
            n = math.prod(shape)
            view = flat[off:off + n]
            view.mul_(std)
            if mean:
                view.add_(mean)
            off += n
    return flat


def views(flat: torch.Tensor, specs: Spec) -> Dict[str, torch.Tensor]:
    """``{name: view of flat}`` in the leaves' shapes."""
    out, off = {}, 0
    for name, shape, _, _ in specs:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


def data_generator(seed: int, device) -> torch.Generator:
    """The generator of a run's inputs: the seed's data stream."""
    return torch.Generator(device=device).manual_seed(
        int(seed) ^ _DATA_STREAM)


def lm_tokens(seed: int, steps: int, batch: int, seq: int, vocab: int,
              device) -> torch.Tensor:
    """``[steps, batch, seq]`` uniform token ids (int64)."""
    return torch.randint(0, vocab, (steps, batch, seq),
                         generator=data_generator(seed, device),
                         device=device)


def cnn_batches(seed: int, steps: int, batch: int, input_shape,
                num_classes: int, device):
    """``[steps, batch, H, W, C]`` bf16 normal images and
    ``[steps, batch, num_classes]`` f32 one-hot labels."""
    gen = data_generator(seed, device)
    xs = torch.randn((steps, batch) + tuple(input_shape), generator=gen,
                     device=device).to(torch.bfloat16)
    labels = torch.randint(0, num_classes, (steps, batch), generator=gen,
                           device=device)
    return xs, torch.nn.functional.one_hot(labels, num_classes).float()
