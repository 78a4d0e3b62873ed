"""Weight-initialization helpers — the port of
:mod:`distkeras_tpu.utils.initializers`.

Reference: distkeras/utils.py · uniform_weights — reinitializes a
model's weights from a uniform distribution, giving ensemble members
distinct starting points. Pure here as in the JAX package: the input is
left as it was.
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch


def uniform_weights(params, bounds: Tuple[float, float] = (-0.5, 0.5),
                    seed: int = 0):
    """Fresh weights with every parameter ~ U[low, high), same shapes,
    dtypes and devices, drawn in order from one ``torch.Generator``
    seeded by ``seed``.

    ``params`` is an ``nn.Module`` (a new module of the same structure is
    returned) or a mapping of name -> tensor such as a ``state_dict`` (a
    new dict is returned)."""
    lo, hi = bounds
    if not hi > lo:
        raise ValueError(f"bounds must satisfy low < high, got {bounds}")
    if isinstance(params, torch.nn.Module):
        module = copy.deepcopy(params)
        fresh = uniform_weights(dict(module.named_parameters()), bounds, seed)
        with torch.no_grad():
            for name, p in module.named_parameters():
                p.copy_(fresh[name])
        return module
    gens = {}
    out = {}
    for name, t in params.items():
        dev = t.device
        if dev not in gens:
            gens[dev] = torch.Generator(device=dev).manual_seed(seed)
        w = torch.empty(t.shape, dtype=torch.float32, device=dev)
        w.uniform_(lo, hi, generator=gens[dev])
        out[name] = w.to(t.dtype)
    return out
