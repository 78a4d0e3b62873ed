"""Live weight updates: the admission gate for a pushed weight tree — the
port of the validation half of :mod:`distkeras_tpu.serving.weights`.

:func:`validate_like` compares a pushed tree against the serving
engine's current weights: structure, shape and dtype must match exactly;
the first mismatched leaf (in the current tree's flatten order) is named
in a typed :class:`WeightPushError`, so a bad checkpoint is refused at
the boundary instead of surfacing as a shape error inside a tick.

Trees are the reference's layout: nested dicts keyed by the flax path
(``{"params": {"Block_0": {...}}}``), leaves anything with ``shape`` and
``dtype`` (numpy arrays, torch tensors). The payload codec and the
checkpoint / parameter-server feeders that push through the wire are not
ported yet (ROADMAP A11).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple


class WeightPushError(RuntimeError):
    """A pushed weight tree was refused before any swap happened: its
    structure, a leaf's shape, or a leaf's dtype does not match the
    serving engine's current weights. Always names the first offending
    leaf (in the current tree's flatten order); ``leaf`` carries its key
    path."""

    def __init__(self, msg: str, leaf: Optional[str] = None):
        super().__init__(msg)
        self.leaf = leaf


def _leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key-path string, leaf) pairs in flatten order (sorted keys, as
    jax flattens a dict), the path spelled as jax's ``keystr``."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key in sorted(tree):
        out += _leaf_paths(tree[key], f"{prefix}[{key!r}]")
    return out


def _shape(leaf) -> tuple:
    return tuple(int(n) for n in leaf.shape)


def _dtype(leaf) -> str:
    """A leaf's dtype by name (``float32``), numpy or torch alike."""
    return str(leaf.dtype).replace("torch.", "")


def validate_like(current: Any, new: Any):
    """Raise :class:`WeightPushError` naming the first leaf (in the
    current tree's flatten order) whose presence, shape, or dtype
    differs between ``current`` (the engine's live weights) and ``new``
    (the pushed tree); return silently when the trees match. Values are
    never compared — a weight update is *supposed* to change them."""
    cur = _leaf_paths(current)
    new_map = dict(_leaf_paths(new))
    cur_keys = {p for p, _ in cur}
    for path, leaf in cur:
        got = new_map.get(path)
        if got is None:
            raise WeightPushError(
                f"pushed weights are missing leaf {path}: expected "
                f"shape {_shape(leaf)} dtype {_dtype(leaf)}",
                leaf=path,
            )
        if _shape(got) != _shape(leaf):
            raise WeightPushError(
                f"pushed weights mismatch at leaf {path}: shape "
                f"{_shape(got)} != expected {_shape(leaf)}",
                leaf=path,
            )
        if _dtype(got) != _dtype(leaf):
            raise WeightPushError(
                f"pushed weights mismatch at leaf {path}: dtype "
                f"{_dtype(got)} != expected {_dtype(leaf)}",
                leaf=path,
            )
    for path in sorted(new_map):
        if path not in cur_keys:
            raise WeightPushError(
                f"pushed weights carry unknown leaf {path} (not in "
                f"the serving model's tree)",
                leaf=path,
            )
