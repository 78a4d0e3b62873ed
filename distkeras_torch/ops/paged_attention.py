"""Paged attention for the serving engine's block-pooled KV cache — the
port of :mod:`distkeras_tpu.ops.paged_attention`.

The gathered attend (``CausalSelfAttention._paged_attend``'s reference
path) materializes each row's cache view with ``pages[block_tables]``
before a dense masked attend: one full ``[B, L, Hk, hd]`` round trip per
tick per layer, and under int8 KV the whole view is dequantized into the
model dtype first. :func:`paged_attention` on a CUDA tensor runs the
hand-written Hopper kernel of ``csrc/paged_attention.cu`` instead, which
reads the pool straight off the block table. Both dtypes share one plan:
GQA on the row axis (query row ``r = t * G + g`` of KV head ``h`` is
query head ``h * G + g`` at position ``seq_lens[b] + t``; a block takes
64 such rows, or 16 when ``T * G <= 16``); the row's pages cut into
splits of four-page stages chosen by
:func:`~distkeras_torch.ops.splash_prefill.split_plan` from shapes alone
(never from ``seq_lens``), each split writing an f32 partial that a
second kernel merges in split order (flash-decoding). A block stages its
own block-table entries and copies its pages with ``cp.async`` into a
two-deep ring. The kernel dispatches on the query dtype:

- bf16 queries run the tensor-core core of ``csrc/serve_mma.cuh``:
  ``mma.sync`` for ``q kᵀ`` and ``p v`` with the f32 online softmax in
  registers; int8 pages travel as int8 and are converted to bf16 on chip
  (once per stage in shared memory for 64-row blocks, in the fragment
  loads at decode), each key's scale applied to its f32 score column and
  each value's to P's (bf16-rounded) column, carried as a bf16 hi + lo
  pair so the scale keeps f32 precision.
- f32 queries run the FFMA core of ``csrc/serve_f32.cuh``: register-tiled
  f32 FMAs on the CUDA cores (a thread computes a tile of rows x keys of
  ``q kᵀ`` and of rows x channels of ``p v`` from shared memory), int8
  pages dequantized to f32 in shared memory as
  :func:`dequantize_int8` does it; it meets f32's 1e-5, which the tensor
  cores (bf16 or TF32 operands) cannot. A row's summation order depends
  only on the plan, so decode and a verify window (any ``T * G <= 16``)
  give a row the same bits.

Pages wholly past a block's last query position are never loaded. On a
CPU tensor the same function runs :func:`paged_attention_reference`, the
gather + dequant + masked softmax math of ``_paged_attend``;
:func:`paged_attention_split_reference` is both routes' split-K math in
plain PyTorch (the CPU tests hold it against the TPU kernel; nothing on
the main path calls it). There is no other fallback: a CUDA call that
the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes

import torch

from distkeras_torch.ops.splash_prefill import (
    launch_route, partial_scratch, sm_count, splash_prefill_reference,
    splash_prefill_split_reference, split_plan)

# shapes the Hopper kernel is compiled for (csrc/paged_attention.cu)
KERNEL_HEAD_DIMS = (64, 128, 256)
KERNEL_BLOCK_SIZES = (16,)


def supports(hd: int, block_size: int) -> bool:
    """Shapes the Hopper kernel serves: head dims it is compiled for and
    16-token pages (four pages make one 64-key stage of the split plan).
    Any query count ``T``, GQA group and page dtype tile — unlike the
    TPU's sublane rules."""
    return hd in KERNEL_HEAD_DIMS and block_size in KERNEL_BLOCK_SIZES


def preferred(hd: int, block_size: int, device=None) -> bool:
    """THE auto-select predicate (``paged_kernel='auto'``): the call's
    tensors are on a CUDA device and the shape is supported."""
    if device is None or torch.device(device).type != "cuda":
        return False
    return supports(hd, block_size)


def gather_pages(pages, block_tables):
    """``[P, bs, ...]`` pool + ``[B, MB]`` tables -> the row-major
    ``[B, MB * bs, ...]`` view the slot path attends over."""
    B, MB = block_tables.shape
    g = pages[block_tables.long()]
    return g.reshape((B, MB * pages.shape[1]) + tuple(pages.shape[2:]))


def dequantize_int8(values, scales, dtype):
    """int8 values times their per-token f32 scales, cast to ``dtype``
    (the reference's dequantize: f32 multiply, then the cast)."""
    return (values.to(torch.float32) * scales[..., None]).to(dtype)


def gathered_view(k_pages, v_pages, block_tables, key_scales, value_scales,
                  dtype):
    """Each row's pages gathered into contiguous ``[B, L, Hk, hd]`` K/V
    in ``dtype`` (dequantized when the pool is int8) — the view the
    reference's gathered attend and the splash kernel read."""
    if key_scales is None:
        return (gather_pages(k_pages, block_tables),
                gather_pages(v_pages, block_tables))
    return (dequantize_int8(gather_pages(k_pages, block_tables),
                            gather_pages(key_scales, block_tables), dtype),
            dequantize_int8(gather_pages(v_pages, block_tables),
                            gather_pages(value_scales, block_tables), dtype))


def paged_attention_reference(q, k_pages, v_pages, block_tables, seq_lens,
                              key_scales=None, value_scales=None):
    """The plain version: the gathered view (int8 dequantized to
    ``q.dtype``), then the dense grouped masked attend at positions
    ``seq_lens[b] + t`` — the math of ``_paged_attend`` (distkeras_tpu
    transformer.py:381-407)."""
    keys, vals = gathered_view(k_pages, v_pages, block_tables, key_scales,
                               value_scales, q.dtype)
    return splash_prefill_reference(q, keys, vals, seq_lens)


def paged_attention_split_reference(q, k_pages, v_pages, block_tables,
                                    seq_lens, key_scales=None,
                                    value_scales=None, *, pages_per_split):
    """The kernel's split-K math in plain PyTorch, for both routes (the
    bf16 tensor-core kernel and the f32 FFMA kernel): the gathered view,
    cut into splits of ``pages_per_split`` pages, each split's f32
    partial and the merge in split order
    (:func:`~distkeras_torch.ops.splash_prefill.splash_prefill_split_reference`
    on the gathered view)."""
    keys, vals = gathered_view(k_pages, v_pages, block_tables, key_scales,
                               value_scales, q.dtype)
    return splash_prefill_split_reference(
        q, keys, vals, seq_lens, pages_per_split * k_pages.shape[1])


def _check(q, k_pages, v_pages, block_tables, seq_lens, key_scales,
           value_scales):
    """Device, dtype, shape and contiguity checks for the CUDA kernel —
    it takes nothing it was not compiled for."""
    B, T, H, hd = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16; got {q.dtype}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"k_pages/v_pages must be equal [P, bs, Hk, hd]; got "
            f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    P, bs, Hk, hdk = k_pages.shape
    if hdk != hd or H % Hk:
        raise ValueError(f"q {tuple(q.shape)} does not group over pages "
                         f"{tuple(k_pages.shape)}")
    quant = key_scales is not None
    want = torch.int8 if quant else q.dtype
    if k_pages.dtype != want or v_pages.dtype != want:
        raise TypeError(f"pages must be {want}; got {k_pages.dtype}")
    if not supports(hd, bs):
        raise ValueError(
            f"the paged-attention kernel takes hd in {KERNEL_HEAD_DIMS} "
            f"and block_size in {KERNEL_BLOCK_SIZES}; got hd={hd}, "
            f"block_size={bs} (use paged_kernel='gather' for other shapes)")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_tables and seq_lens must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError("block_tables must be [B, MB] and seq_lens [B]")
    tensors = [q, k_pages, v_pages, block_tables, seq_lens]
    if quant:
        for s in (key_scales, value_scales):
            if s.dtype != torch.float32 or tuple(s.shape) != (P, bs, Hk):
                raise ValueError("int8 scales must be float32 [P, bs, Hk]")
        tensors += [key_scales, value_scales]
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all paged-attention inputs must share a device")
        if not t.is_contiguous():
            raise ValueError("paged-attention inputs must be contiguous")
    if q.data_ptr() % 16 or k_pages.data_ptr() % 16 \
            or v_pages.data_ptr() % 16:
        raise ValueError("q and pages must be 16-byte aligned (16-byte "
                         "loads)")


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                    key_scales=None, value_scales=None):
    """Paged causal attention over a block-pooled KV cache.

    Args:
      q: ``[B, T, H, hd]`` queries (rope already applied, unscaled).
      k_pages / v_pages: ``[num_pages, block_size, Hk, hd]`` pool, model
        dtype or int8 (then pass the scales).
      block_tables: ``[B, max_blocks]`` int32 physical page ids per row
        (entries past a row's chain point at the reserved trash page 0).
      seq_lens: ``[B]`` int32 — row ``b``'s query ``t`` sits at absolute
        position ``seq_lens[b] + t`` and attends positions ``<= that``.
      key_scales / value_scales: ``[num_pages, block_size, Hk]`` f32
        dequant scales for int8 pools (both or neither).

    Returns ``[B, T, H, hd]`` in ``q.dtype``. CPU tensors run the plain
    version; CUDA tensors launch the Hopper kernel (the split kernel and,
    with more than one split, its merge: bf16 on the tensor cores, f32
    on FFMA) or raise.
    """
    if (key_scales is None) != (value_scales is None):
        raise ValueError("pass both key_scales and value_scales or neither")
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         seq_lens, key_scales, value_scales)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_attention runs on cuda or cpu, not "
                           f"{q.device}")
    _check(q, k_pages, v_pages, block_tables, seq_lens, key_scales,
           value_scales)
    from distkeras_torch.kernels import build

    lib = build.load()
    B, T, H, hd = q.shape
    _, bs, Hk, _ = k_pages.shape
    quant = key_scales is not None
    MB = block_tables.shape[1]
    out = torch.empty_like(q)
    bf16 = q.dtype == torch.bfloat16
    TG = T * (H // Hk)
    bm, splits, per = split_plan(B, Hk, TG, MB * bs, sm_count(q.device))
    part = partial_scratch(B, Hk, TG, hd, splits, q.device)
    vp = ctypes.c_void_p
    rc = lib.dk_paged_attention(
        vp(q.data_ptr()), vp(k_pages.data_ptr()), vp(v_pages.data_ptr()),
        vp(key_scales.data_ptr() if quant else 0),
        vp(value_scales.data_ptr() if quant else 0),
        vp(block_tables.data_ptr()), vp(seq_lens.data_ptr()),
        vp(out.data_ptr()),
        B, T, H, Hk, hd, bs, MB, int(bf16), int(quant),
        ctypes.c_float(hd ** -0.5),
        vp(torch.cuda.current_stream(q.device).cuda_stream),
        vp(part.data_ptr() if part is not None else 0), bm, splits, per,
    )
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"{build.error_string(rc)} (cuda error {rc})")
    paged_attention.launches += 1
    route = launch_route("paged", bf16, bm, splits)
    # the template instance (KV type, head dim, row tile) and the merge
    build.note_launch("paged_attention", (bf16, quant, hd, bm, splits > 1))
    paged_attention.routes[route] = paged_attention.routes.get(route, 0) + 1
    return out


# wrapper calls that launched the kernel (the merge included: one per
# call), and the same calls by route (``launch_route``); chip_smoke.py
# zeroes both before the serving phase and reads them after
paged_attention.launches = 0
paged_attention.routes = {}
