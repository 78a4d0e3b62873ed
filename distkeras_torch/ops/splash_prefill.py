"""Splash-style chunked-prefill attention for the serving engine's mixed
tick — the port of :mod:`distkeras_tpu.ops.splash_prefill`.

The chunked mixed tick attends each row's prompt chunk over the whole
cache; the dense masked reference computes a ``[B, T, L]`` score tensor
whose beyond-diagonal half is thrown away. :func:`splash_prefill_attention`
on a CUDA tensor runs the hand-written Hopper kernel of
``csrc/splash_prefill.cu``, which dispatches on the query dtype:

- bf16 queries run the tensor-core split-K core of ``csrc/serve_mma.cuh``:
  ``mma.sync`` for both products with the f32 online softmax in
  registers; GQA on the M axis (a block takes 64 query rows
  ``r = t * G + g`` of one (row, KV head), or 16 when ``T * G <= 16``);
  the key axis cut into splits of 64-key stages chosen by
  :func:`split_plan` from shapes alone, each split writing an f32
  partial that a second kernel merges in split order; stages copied with
  ``cp.async`` into a two-deep ring, stages past a block's last query
  position never loaded (the splash skip).
- f32 queries run the scalar kernel of ``csrc/attn_common.cuh`` (one
  block per 16 query rows, f32 FMAs), which meets f32's 1e-5.

It consumes the contiguous K/V view both serving cache layouts produce
(the slot path's cache, or the paged path's gathered view), in the model
dtype. CPU tensors run :func:`splash_prefill_reference`, the dense
grouped masked attend of ``_cached_attend``; a CUDA call the kernel
cannot take raises. :func:`splash_prefill_split_reference` computes the
kernel's split partials and merge in plain PyTorch (the CPU tests hold
it against the TPU kernel; nothing on the main path calls it).
"""

from __future__ import annotations

import ctypes
import functools

import torch

_NEG_INF = -1e30

# the TPU kernel's KV-axis tiles (choose_kv_block mirrors its pick); the
# Hopper kernels take the cache in 16-key tiles (KV_TILE: L % 16 == 0)
# and walk it in stages of four (STAGE_KEYS)
_KV_BLOCKS = (512, 256, 128, 64, 32, 16, 8, 4, 2, 1)
KV_TILE = 16
STAGE_KEYS = 64
KERNEL_HEAD_DIMS = (64, 128, 256)
# blocks the split plan aims for per streaming multiprocessor
BLOCKS_PER_SM = 2


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


def split_plan(B: int, Hk: int, TG: int, nkeys: int, sms: int):
    """How the tensor-core kernels cut one launch, from shapes alone
    (never from the device-resident ``starts`` / ``seq_lens``, which
    would cost a host sync per layer per tick): ``(bm, splits, per)`` —
    query rows per block (16 when the ``T * G`` rows of a KV head fit
    one m16 tile, else 64), the number of splits of the key axis and the
    64-key stages each split walks. The splits are as many as bring the
    grid to about :data:`BLOCKS_PER_SM` blocks per SM, at most one per
    stage, and none is empty by construction."""
    bm = 16 if TG <= 16 else 64
    base = B * Hk * -(-TG // bm)
    stages = -(-nkeys // STAGE_KEYS)
    want = max(1, min(stages, -(-BLOCKS_PER_SM * sms // base)))
    per = -(-stages // want)
    return bm, -(-stages // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device)."""
    index = device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def partial_scratch(B, Hk, TG, hd, splits, device):
    """The f32 scratch of a launch with more than one split: for each
    split's query row an acc of ``hd`` values, then every row's ``m``,
    then every row's ``l``; ``None`` with one split."""
    if splits == 1:
        return None
    rows = splits * B * Hk * TG
    return torch.empty(rows * (hd + 2), dtype=torch.float32, device=device)


def launch_route(kernel: str, bf16: bool, bm: int, splits: int) -> str:
    """What one launch of ``kernel`` (``"paged"`` or ``"splash"``) runs,
    named as the profile names its kernels: bf16 queries the tensor-core
    split kernel at ``bm`` rows a block, followed by the merge when there
    is more than one split; f32 queries the scalar ``attn_kernel``."""
    if not bf16:
        return "attn_kernel f32"
    route = f"{kernel}_split_kernel bm={bm} splits={splits}"
    return route + f" + {kernel}_merge_kernel" if splits > 1 else route


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


def splash_prefill_split_reference(q, keys, vals, starts, keys_per_split):
    """The bf16 kernel's split-K math in plain PyTorch, in f32: the key
    axis cut into splits of ``keys_per_split`` keys, each split's
    partial ``(m, l, acc)`` from the masked scores (``-1e30`` mask, P
    cast to ``q.dtype`` before P V), a split wholly past a row's last
    query position left neutral (``m = -inf``, ``l = 0``), then the
    merge in split order: ``w_s = exp(m_s - max m)`` (0 for a neutral
    split), ``out = sum w_s acc_s / max(sum w_s l_s, 1e-30)``."""
    B, T, H, hd = q.shape
    L, Hk = keys.shape[1], keys.shape[2]
    G = H // Hk
    qg = q.reshape(B, T, Hk, G, hd)
    s = torch.einsum("bqkgd,blkd->bkgql", qg, keys).float() * (hd ** -0.5)
    qpos = starts.long()[:, None] + torch.arange(T, device=q.device)[None]
    kpos = torch.arange(L, device=q.device)
    mask = kpos[None, None, :] <= qpos[..., None]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, _NEG_INF))
    last = qpos[:, -1]  # each row's last query position
    parts = []
    for k0 in range(0, L, keys_per_split):
        sl = s[..., k0:k0 + keys_per_split]
        m = sl.amax(-1)  # [B, Hk, G, T]
        p = torch.exp(sl - m[..., None])
        acc = torch.einsum("bkgql,blkd->bkgqd", p.to(q.dtype).float(),
                           vals[:, k0:k0 + keys_per_split].float())
        neutral = (k0 > last)[:, None, None, None]
        m = torch.where(neutral, torch.full_like(m, -float("inf")), m)
        parts.append((m, p.sum(-1), acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    l_tot = torch.zeros_like(M)
    a_tot = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(m == -float("inf"), torch.zeros_like(m),
                        torch.exp(m - M))
        l_tot = l_tot + w * l
        a_tot = a_tot + w[..., None] * acc
    out = a_tot / torch.clamp(l_tot, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd).to(q.dtype)


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
    if q.data_ptr() % 16 or keys.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError("q/keys/vals must be 16-byte aligned (16-byte "
                         "loads)")


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
    version; CUDA tensors launch the Hopper kernel (bf16: the split-K
    tensor-core kernel and its merge; f32: the scalar kernel) or raise.
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
    bf16 = q.dtype == torch.bfloat16
    bm, splits, per = split_plan(B, Hk, T * (H // Hk), L,
                                 sm_count(q.device))
    part = (partial_scratch(B, Hk, T * (H // Hk), hd, splits, q.device)
            if bf16 else None)
    vp = ctypes.c_void_p
    rc = lib.dk_splash_prefill(
        vp(q.data_ptr()), vp(keys.data_ptr()), vp(vals.data_ptr()),
        vp(starts.data_ptr()), vp(out.data_ptr()),
        B, T, H, Hk, hd, L, int(bf16), ctypes.c_float(hd ** -0.5),
        vp(torch.cuda.current_stream(q.device).cuda_stream),
        vp(part.data_ptr() if part is not None else 0), bm, splits, per,
    )
    if rc != 0:
        raise RuntimeError(f"splash_prefill kernel launch failed: "
                           f"{build.error_string(rc)} (cuda error {rc})")
    splash_prefill_attention.launches += 1
    route = launch_route("splash", bf16, bm, splits)
    routes = splash_prefill_attention.routes
    routes[route] = routes.get(route, 0) + 1
    return out


# wrapper calls that launched the kernel (the merge included: one per
# call), and the same calls by :func:`launch_route`; chip_smoke.py
# zeroes both before the serving phase and reads them after
splash_prefill_attention.launches = 0
splash_prefill_attention.routes = {}
