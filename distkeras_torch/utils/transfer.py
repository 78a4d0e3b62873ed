"""Host-to-device transfer helpers — the port of
:mod:`distkeras_tpu.utils.transfer`.

The feeding paths (worker staging, predictor chunks) are transfer-bound
before they are compute-bound; when the model's first op casts to a
narrower compute dtype anyway, doing that cast on the host gives the same
values and halves the bytes over PCIe.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_transfer_dtype(module, transfer_dtype):
    """The host-side cast dtype of a feeding path. ``"auto"`` (the
    default everywhere) is the module's own compute dtype (it would cast
    on the device anyway); ``None`` is no host-side cast; anything else
    is used as given."""
    if transfer_dtype == "auto":
        return getattr(module, "dtype", None)
    return transfer_dtype


def pad_to_rows(x: np.ndarray, rows: int) -> np.ndarray:
    """Pad the leading axis up to ``rows`` by repeating the first row, so
    every model call sees one shape; callers slice the pad off after."""
    if len(x) >= rows:
        return x
    pad = np.repeat(x[:1], rows - len(x), axis=0)
    return np.concatenate([x, pad], axis=0)


def narrow_cast(x: np.ndarray, target_dtype):
    """Cast ``x`` to ``target_dtype`` only when that narrows a floating
    array: never widen, never touch ints or bools (labels and token ids
    pass through).

    A torch dtype target (or its name, such as ``"bfloat16"``, which numpy
    has no dtype for) casts with torch on the host and returns a CPU
    ``torch.Tensor``: round-to-nearest-even, the values the device's own
    cast would give; float32 -> bfloat16 goes through the native kernel
    of :func:`distkeras_torch.data.shard_io.cast_f32_bf16`, the bits the
    disk-streaming loader gives. A numpy dtype target returns a numpy
    array."""
    if target_dtype is None or not np.issubdtype(x.dtype, np.floating):
        return x
    if isinstance(target_dtype, str) and isinstance(
            getattr(torch, target_dtype, None), torch.dtype):
        target_dtype = getattr(torch, target_dtype)
    if isinstance(target_dtype, torch.dtype):
        if (target_dtype.is_floating_point
                and target_dtype.itemsize < x.dtype.itemsize):
            if x.dtype == np.float32 and target_dtype == torch.bfloat16:
                from distkeras_torch.data.shard_io import cast_f32_bf16

                return cast_f32_bf16(x)
            return torch.from_numpy(np.ascontiguousarray(x)).to(target_dtype)
        return x
    td = np.dtype(target_dtype)
    if td.itemsize < x.dtype.itemsize:
        return x.astype(td)
    return x
