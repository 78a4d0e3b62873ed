"""Weight bridge between the reference's flax parameter trees and the
port's models (:class:`~distkeras_torch.models.transformer.TransformerLM`,
the MLP and the CNNs).

The port names its modules and parameters after the flax tree, so the
map is by name: the flax path ``Block_i/<module>/.../<leaf>`` is the
port's ``blocks.i.<module>. ... .<leaf>``; every other path keeps its
names (``embed/embedding``, ``ln_f/scale``, ``head/kernel``,
``Conv_0/kernel``, ``Dense_1/bias``, ...). Kernels keep the flax shapes
(``[D, H, hd]``, ``[D, 2, Hk, hd]``, a convolution's ``[kh, kw, Cin,
Cout]``, a Dense's ``[in, out]``, ...), so a leaf copies as it is, cast
to the dtype the port stores it in.

The JAX side is plain numpy: :func:`params_from_jax` takes what
``jax.tree.map(np.asarray, variables)`` gives, and :func:`params_to_jax`
returns nested dicts of numpy arrays (f32) that ``jnp.asarray`` loads.
Neither imports jax.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def _port_name(path: Tuple[str, ...]) -> str:
    head = path[0]
    if head.startswith("Block_"):
        return ".".join(("blocks", head[len("Block_"):]) + path[1:])
    return ".".join(path)


def _jax_path(name: str) -> Tuple[str, ...]:
    parts = tuple(name.split("."))
    if parts[0] == "blocks":
        return (f"Block_{parts[1]}",) + parts[2:]
    return parts


def flax_key(name: str) -> str:
    """A port parameter's flax path as one '/'-joined key, under
    ``params`` (``Dense_0.kernel`` -> ``params/Dense_0/kernel``): the key
    of the flat trees the parameter servers hold."""
    return "/".join(("params",) + _jax_path(name))


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


@torch.no_grad()
def params_from_jax(tree: dict, model) -> None:
    """Load a flax ``{"params": ...}`` tree of numpy arrays into ``model``
    in place. Every leaf must match a port parameter by name and shape,
    and every port parameter must be covered — a partial load raises."""
    params = tree["params"] if "params" in tree else tree
    own = dict(model.named_parameters())
    seen = set()
    for path, leaf in _flatten(params):
        name = _port_name(path)
        if name not in own:
            raise KeyError(f"flax leaf {'/'.join(path)} has no port "
                           f"parameter '{name}'")
        arr = np.asarray(leaf)
        dst = own[name]
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{'/'.join(path)}: flax shape "
                             f"{tuple(arr.shape)} != port shape "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.tensor(arr).to(device=dst.device, dtype=dst.dtype))
        seen.add(name)
    missing = sorted(set(own) - seen)
    if missing:
        raise KeyError(f"flax tree does not cover port parameters {missing}")


@torch.no_grad()
def params_to_jax(model) -> Dict[str, dict]:
    """The inverse of :func:`params_from_jax`: ``{"params": nested dict
    of float32 numpy arrays}`` in the flax tree layout."""
    out: Dict[str, dict] = {}
    for name, p in model.named_parameters():
        path = _jax_path(name)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.detach().to("cpu", torch.float32).numpy().copy()
    return {"params": out}
