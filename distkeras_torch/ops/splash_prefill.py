"""Splash-style chunked-prefill attention for the serving engine's mixed
tick — the port of :mod:`distkeras_tpu.ops.splash_prefill`.

The chunked mixed tick attends each row's prompt chunk over the whole
cache; the dense masked reference computes a ``[B, T, L]`` score tensor
whose beyond-diagonal half is thrown away. :func:`splash_prefill_attention`
on a CUDA tensor runs the hand-written Hopper kernel of
``csrc/splash_prefill.cu``: one block per (row ``b``, KV head ``h``,
tile of 16 query rows), a loop inside the block over 16-key tiles of the
contiguous ``[B, L, Hk, hd]`` view, tiles wholly past the tile's last
query position skipped outright, GQA grouped natively and an f32 online
softmax.

It consumes the contiguous K/V view both serving cache layouts produce
(the slot path's cache, or the paged path's gathered view), in the model
dtype. CPU tensors run :func:`splash_prefill_reference`, the dense
grouped masked attend of ``_cached_attend``; a CUDA call the kernel
cannot take raises.
"""

from __future__ import annotations

import ctypes

import torch

_NEG_INF = -1e30

# the TPU kernel's KV-axis tiles (choose_kv_block mirrors its pick); the
# Hopper kernel walks 16-key tiles whatever L is (KV_TILE)
_KV_BLOCKS = (512, 256, 128, 64, 32, 16, 8, 4, 2, 1)
KV_TILE = 16
KERNEL_HEAD_DIMS = (64, 128, 256)


def choose_kv_block(L: int) -> int:
    """KV tile the TPU kernel would run at for a cache of length ``L``
    (kept for parity with the reference package; the Hopper kernel's
    tile is :data:`KV_TILE`)."""
    for b in _KV_BLOCKS:
        if L % b == 0:
            return b
    return L


def supports(T: int, hd: int, L: int) -> bool:
    """Shapes the Hopper kernel serves: a true chunk (T > 1 — one decode
    token stays on the dense attend), a head dim it is compiled for, and
    a cache length that is a whole number of 16-key tiles. Any GQA group
    tiles."""
    return T > 1 and hd in KERNEL_HEAD_DIMS and L % KV_TILE == 0


def preferred(T: int, hd: int, L: int, device=None) -> bool:
    """THE auto-select predicate (``prefill_kernel='auto'``): the call's
    tensors are on a CUDA device and the shape is supported."""
    if device is None or torch.device(device).type != "cuda":
        return False
    return supports(T, hd, L)


def splash_prefill_reference(q, keys, vals, starts):
    """The plain version: the dense grouped masked attend of
    ``_cached_attend`` (distkeras_tpu transformer.py:525-540) at per-row
    absolute positions ``starts[b] + t`` — f32 scores, ``-1e30`` mask,
    probabilities cast to ``q.dtype`` before the PV product. The model's
    dense decode attend on both cache layouts is this function."""
    B, T, H, hd = q.shape
    L, Hk = keys.shape[1], keys.shape[2]
    G = H // Hk
    qg = q.reshape(B, T, Hk, G, hd)
    s = torch.einsum("bqkgd,blkd->bkgql", qg, keys).float() * (hd ** -0.5)
    qpos = starts.long()[:, None] + torch.arange(T, device=q.device)[None]
    mask = torch.arange(L, device=q.device)[None, None, :] <= qpos[..., None]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgql,blkd->bqkgd", p.to(q.dtype), vals)
    return out.reshape(B, T, H, hd)


def _check(q, keys, vals, starts):
    B, T, H, hd = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16; got {q.dtype}")
    if keys.dim() != 4 or keys.shape != vals.shape or keys.shape[0] != B \
            or keys.shape[3] != hd:
        raise ValueError(f"keys/vals must be [B, L, Hk, hd] matching q "
                         f"{tuple(q.shape)}; got {tuple(keys.shape)}")
    L, Hk = keys.shape[1], keys.shape[2]
    if H % Hk:
        raise ValueError(f"H={H} not divisible by Hk={Hk}")
    if keys.dtype != q.dtype or vals.dtype != q.dtype:
        raise TypeError("keys/vals must be in q's dtype (dequantize first)")
    if not supports(T, hd, L):
        raise ValueError(
            f"the splash-prefill kernel takes T > 1, hd in "
            f"{KERNEL_HEAD_DIMS} and L % {KV_TILE} == 0; got T={T}, "
            f"hd={hd}, L={L} (use prefill_kernel='gather')")
    if starts.dtype != torch.int32 or tuple(starts.shape) != (B,):
        raise ValueError("starts must be int32 [B]")
    for t in (q, keys, vals, starts):
        if t.device != q.device:
            raise ValueError("all splash-prefill inputs must share a device")
        if not t.is_contiguous():
            raise ValueError("splash-prefill inputs must be contiguous")
    if keys.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError("keys/vals must be 16-byte aligned (16-byte loads)")


def splash_prefill_attention(q, keys, vals, starts):
    """Chunked-prefill causal attention over a contiguous per-row KV
    view.

    Args:
      q: ``[B, T, H, hd]`` chunk queries (rope already applied,
        unscaled) — T is the prefill chunk width.
      keys / vals: ``[B, L, Hk, hd]`` per-row K/V in ``q.dtype`` (the
        slot cache, or the paged path's gathered — and, under int8,
        already dequantized — view; this call's chunk already written).
      starts: ``[B]`` int32 — row ``b``'s query ``t`` sits at absolute
        position ``starts[b] + t`` and attends key positions ``<= that``.

    Returns ``[B, T, H, hd]`` in ``q.dtype``. CPU tensors run the plain
    version; CUDA tensors launch the Hopper kernel or raise.
    """
    if q.device.type == "cpu":
        return splash_prefill_reference(q, keys, vals, starts)
    if q.device.type != "cuda":
        raise RuntimeError(f"splash_prefill_attention runs on cuda or cpu, "
                           f"not {q.device}")
    starts = starts.to(torch.int32)
    _check(q, keys, vals, starts)
    from distkeras_torch.kernels import build

    lib = build.load()
    B, T, H, hd = q.shape
    L, Hk = keys.shape[1], keys.shape[2]
    out = torch.empty_like(q)
    vp = ctypes.c_void_p
    rc = lib.dk_splash_prefill(
        vp(q.data_ptr()), vp(keys.data_ptr()), vp(vals.data_ptr()),
        vp(starts.data_ptr()), vp(out.data_ptr()),
        B, T, H, Hk, hd, L, int(q.dtype == torch.bfloat16),
        ctypes.c_float(hd ** -0.5),
        vp(torch.cuda.current_stream(q.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"splash_prefill kernel launch failed: "
                           f"{build.error_string(rc)} (cuda error {rc})")
    splash_prefill_attention.launches += 1
    return out


# kernel launches made through the wrapper (chip_smoke.py zeroes it
# before the serving phase and reads it after)
splash_prefill_attention.launches = 0
