"""Causal flash attention with causal tile skipping for training — the
port of :mod:`distkeras_tpu.ops.pallas_attention`.

:func:`pallas_causal_attention` is a ``torch.autograd.Function`` over
``[B, T, H, hd]`` tensors. On CUDA tensors its forward launches the
hand-written Hopper forward kernel of ``csrc/causal_attention.cu`` and
saves ``(q, k, v, out, lse)``; its backward launches the dq kernel, then
the dk/dv kernel (the Dao recompute, split as the TPU kernels split it).
Each kernel walks only its causal wedge on the tensor cores, bf16 in,
f32 accumulate, on ``wgmma`` with TMA loads and warp-specialized blocks:
the forward (``csrc/flash_fwd_sm90.cuh``) and dq
(``csrc/flash_bwd_sm90.cuh``) take 128 query rows a work item, dk/dv
(the same header) 64 keys. A prep pass writes ``q * scale`` and
``delta = rowsum(dO * O)`` once per row into :func:`bwd_scratch`: the dq
launch runs it and the backward's dk/dv launch reads it (a dk/dv call on
its own runs it itself).

CPU tensors take the plain versions beside it,
:func:`causal_attention_reference` and
:func:`causal_attention_bwd_reference`: the same math computed densely
in f32 from the same inputs. A CUDA call the kernels cannot take raises.

The gates are written for Hopper tiles, not for the TPU's ``(8, 128)``
tiling: the kernels take bf16 operands, head dims 64/128/256 and any T
(ragged last tiles are masked in-kernel). :func:`preferred` — the
auto-select predicate the model and the bench share — is true only for
CUDA tensors the kernels take.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

_NEG_INF = -1e30
# the kernels' tile (dq's 64-row consumer halves and key tiles, dk/dv's
# key items and query steps) and the head dims they are compiled for
BLOCK = 64
KERNEL_HEAD_DIMS = (64, 128, 256)


def supports(T: int, hd: int, dtype=torch.bfloat16,
             block: Optional[int] = None) -> bool:
    """Shapes the Hopper kernels serve: bf16 operands, a compiled head
    dim, T >= 1 (any T: the last tile is masked), and the kernels' own
    tile when one is pinned."""
    if block is not None and block != BLOCK:
        return False
    return dtype == torch.bfloat16 and hd in KERNEL_HEAD_DIMS and T >= 1


def choose_block(T: int, hd: int, dtype=torch.bfloat16) -> Optional[int]:
    """The tile the kernels run at for this shape, or ``None`` when they
    do not take it."""
    return BLOCK if supports(T, hd, dtype) else None


def preferred(T: int, hd: int, dtype=torch.bfloat16, device=None,
              block: Optional[int] = None) -> bool:
    """THE auto-select predicate, shared by the model and the bench so
    the recorded kernel label cannot drift from what ran: the tensors
    are on a CUDA device and :func:`supports` passes."""
    if device is None or torch.device(device).type != "cuda":
        return False
    return supports(T, hd, dtype, block)


# -- plain versions ---------------------------------------------------------


def _scaled_q(q):
    """q scaled in f32 and rounded back to its dtype, as the kernels
    scale it before ``q k^T``; returned in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return (q.float() * scale).to(q.dtype).float()


def _masked_logits(qs, k):
    """Scaled, causally masked logits ``[B, H, T, T]`` f32."""
    T = qs.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=qs.device))
    return torch.where(mask, s, torch.full_like(s, _NEG_INF))


def causal_attention_reference(q, k, v):
    """The forward's plain version: ``(out, lse)`` computed densely in
    f32 — ``out`` ``[B, T, H, hd]`` and the per-row logsumexp of the
    scaled, masked logits ``lse`` ``[B, H, T]``."""
    s = _masked_logits(_scaled_q(q), k)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out, lse


def _bwd_common(q, k, v, out, lse, do):
    """The Dao recompute shared by both backward plain versions:
    ``P = exp(s - lse)``, ``delta = rowsum(dO * O)``,
    ``dS = P * (dO V^T - delta)``; returns ``(P, dS, q_scaled, dO)`` in
    f32."""
    qs = _scaled_q(q)
    p = torch.exp(_masked_logits(qs, k) - lse.float()[..., None])
    dof = do.float()
    delta = torch.einsum("bqhd,bqhd->bhq", dof, out.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    return p, p * (dp - delta[..., None]), qs, dof


def causal_attention_dq_reference(q, k, v, out, lse, do):
    """The dq kernel's plain version: ``dS K * scale`` in f32."""
    _, ds, _, _ = _bwd_common(q, k, v, out, lse, do)
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale


def causal_attention_dkv_reference(q, k, v, out, lse, do):
    """The dk/dv kernel's plain version: ``(dS^T q_scaled, P^T dO)`` in
    f32."""
    p, ds, qs, dof = _bwd_common(q, k, v, out, lse, do)
    return (torch.einsum("bhqk,bqhd->bkhd", ds, qs),
            torch.einsum("bhqk,bqhd->bkhd", p, dof))


def causal_attention_bwd_reference(q, k, v, out, lse, do):
    """The backward's plain version: ``(dq, dk, dv)`` in f32 from one
    dense recompute (:func:`causal_attention_dq_reference` and
    :func:`causal_attention_dkv_reference` together)."""
    p, ds, qs, dof = _bwd_common(q, k, v, out, lse, do)
    scale = 1.0 / math.sqrt(q.shape[-1])
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, qs),
            torch.einsum("bhqk,bqhd->bkhd", p, dof))


# -- the kernels ------------------------------------------------------------


def _aligned(t):
    """``t`` contiguous and starting on a 16-byte boundary (the kernels
    move rows as 16-byte vectors); a copy only where needed."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _qkv_strides(q, k, v):
    """(batch, token) strides shared by q, k and v in elements: the
    kernels read ``[B, T, H, hd]`` with head stride ``hd`` and a
    contiguous last axis, so views of a fused qkv projection pass as
    they are; anything else is made contiguous first."""
    hd = q.shape[-1]

    def ok(t):
        return t.stride(3) == 1 and t.stride(2) == hd and (
            t.data_ptr() % 16 == 0)

    if not (ok(q) and ok(k) and ok(v)
            and q.stride()[:2] == k.stride()[:2] == v.stride()[:2]
            and q.stride(1) % 8 == 0 and q.stride(0) % 8 == 0):
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    return q, k, v, q.stride(0), q.stride(1)


def _check(q, k, v, block):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, T, H, hd] of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for t in (q, k, v):
        if t.dtype != q.dtype:
            raise TypeError("q, k and v must share a dtype")
        if t.device != q.device:
            raise ValueError("q, k and v must share a device")
    T, hd = q.shape[1], q.shape[3]
    if not supports(T, hd, q.dtype, block):
        raise ValueError(
            f"the causal attention kernels take bf16, hd in "
            f"{KERNEL_HEAD_DIMS} and their own {BLOCK}-row tile; got "
            f"dtype={q.dtype}, hd={hd}, block={block} — use "
            f"attention='blocked'")


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(rc, what):
    if rc != 0:
        from distkeras_torch.kernels import build

        raise RuntimeError(f"causal attention {what} kernel launch failed: "
                           f"{build.error_string(rc)} (cuda error {rc})")


def _fwd_kernel(q, k, v):
    from distkeras_torch.kernels import build

    lib = build.load()
    q, k, v, sb, st = _qkv_strides(q, k, v)
    B, T, H, hd = q.shape
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    vp = ctypes.c_void_p
    rc = lib.dk_causal_attention_fwd(
        vp(q.data_ptr()), vp(k.data_ptr()), vp(v.data_ptr()),
        vp(out.data_ptr()), vp(lse.data_ptr()), B, T, H, hd, sb, st,
        ctypes.c_float(1.0 / math.sqrt(hd)), _stream(q))
    _raise_on(rc, "forward")
    causal_attention_fwd.launches += 1
    return out, lse


def _bwd_args(q, k, v, out, lse, do):
    q, k, v, sb, st = _qkv_strides(q, k, v)
    out, lse, do = _aligned(out), lse.contiguous(), _aligned(do.to(q.dtype))
    vp = ctypes.c_void_p
    ptrs = [vp(t.data_ptr()) for t in (q, k, v, out, do, lse)]
    # keep the tensors alive while their pointers are in use
    return (q, k, v, out, lse, do), ptrs, sb, st


def bwd_scratch(q):
    """Scratch of the backward's prep pass for inputs shaped like ``q``:
    ``(qs, delta)`` — ``q * scale`` rounded to bf16, ``[B, T, H, hd]``, and
    ``delta = rowsum(dO * O)``, ``[B, H, T]`` f32. The dq kernel's launch
    fills it; the same backward's dk/dv launch reads it."""
    B, T, H, hd = q.shape
    return (torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device),
            torch.empty((B, H, T), dtype=torch.float32, device=q.device))


def _dq_kernel(q, k, v, out, lse, do, scratch):
    from distkeras_torch.kernels import build

    lib = build.load()
    held, ptrs, sb, st = _bwd_args(q, k, v, out, lse, do)
    B, T, H, hd = held[0].shape
    dq = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    qs, delta = scratch if scratch is not None else bwd_scratch(held[0])
    vp = ctypes.c_void_p
    rc = lib.dk_causal_attention_dq(
        *ptrs, vp(dq.data_ptr()), vp(qs.data_ptr()), vp(delta.data_ptr()),
        B, T, H, hd, sb, st, ctypes.c_float(1.0 / math.sqrt(hd)), _stream(q))
    _raise_on(rc, "dq")
    causal_attention_dq.launches += 1
    return dq


def _dkv_kernel(q, k, v, out, lse, do, scratch):
    from distkeras_torch.kernels import build

    lib = build.load()
    held, ptrs, sb, st = _bwd_args(q, k, v, out, lse, do)
    B, T, H, hd = held[0].shape
    dk = torch.empty((B, T, H, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    # without the dq launch's scratch, the prep pass runs here first
    prep = scratch is None
    qs, delta = bwd_scratch(held[0]) if prep else scratch
    vp = ctypes.c_void_p
    rc = lib.dk_causal_attention_dkv(
        *ptrs, vp(dk.data_ptr()), vp(dv.data_ptr()), vp(qs.data_ptr()),
        vp(delta.data_ptr()), int(prep), B, T, H, hd, sb, st,
        ctypes.c_float(1.0 / math.sqrt(hd)), _stream(q))
    _raise_on(rc, "dk/dv")
    causal_attention_dkv.launches += 1
    return dk, dv


def _on_card(q, k, v, block) -> bool:
    """True for CUDA tensors the kernels take (checked: raises
    otherwise); False for CPU tensors, which take the plain versions."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise RuntimeError(f"causal attention runs on cuda or cpu, not "
                           f"{q.device}")
    _check(q, k, v, block)
    return True


def causal_attention_fwd(q, k, v, block: Optional[int] = None):
    """The forward: ``(out, lse)`` — ``out`` in ``q.dtype``, ``lse``
    ``[B, H, T]`` f32. CUDA tensors launch the forward kernel or raise;
    CPU tensors run :func:`causal_attention_reference`."""
    if _on_card(q, k, v, block):
        return _fwd_kernel(q, k, v)
    out, lse = causal_attention_reference(q, k, v)
    return out.to(q.dtype), lse


def causal_attention_dq(q, k, v, out, lse, do, block: Optional[int] = None,
                        scratch=None):
    """dq of the backward, in ``q.dtype``: the dq kernel (after its prep
    pass) on CUDA tensors, the plain version on CPU tensors. ``scratch``
    (:func:`bwd_scratch`), when given, keeps what the prep pass wrote for
    the same backward's :func:`causal_attention_dkv` call."""
    if _on_card(q, k, v, block):
        return _dq_kernel(q, k, v, out, lse, do, scratch)
    return causal_attention_dq_reference(q, k, v, out, lse, do).to(q.dtype)


def causal_attention_dkv(q, k, v, out, lse, do, block: Optional[int] = None,
                         scratch=None):
    """(dk, dv) of the backward, in their primals' dtypes: the dk/dv
    kernel on CUDA tensors, the plain version on CPU tensors. ``scratch``
    filled by :func:`causal_attention_dq` on the same inputs skips the
    kernel's own prep pass; without it the prep pass runs first."""
    if _on_card(q, k, v, block):
        return _dkv_kernel(q, k, v, out, lse, do, scratch)
    dk, dv = causal_attention_dkv_reference(q, k, v, out, lse, do)
    return dk.to(k.dtype), dv.to(v.dtype)


# kernel launches made through the wrappers (chip_smoke.py zeroes them
# before the training phase and reads them after)
causal_attention_fwd.launches = 0
causal_attention_dq.launches = 0
causal_attention_dkv.launches = 0


class _PallasCausalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block):
        out, lse = causal_attention_fwd(q, k, v, block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.block = block
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":  # one dense recompute serves all three
            dq, dk, dv = causal_attention_bwd_reference(q, k, v, out, lse,
                                                        do)
            return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None
        # one prep pass (scaled q, delta) serves both kernels
        scratch = bwd_scratch(q)
        dq = causal_attention_dq(q, k, v, out, lse, do, ctx.block, scratch)
        dk, dv = causal_attention_dkv(q, k, v, out, lse, do, ctx.block,
                                      scratch)
        return dq, dk, dv, None


def pallas_causal_attention(q, k, v, block: Optional[int] = None):
    """Causal flash attention, ``[B, T, H, hd] -> [B, T, H, hd]``:
    ``softmax(q k^T / sqrt(hd) + causal mask) v`` with causal tile
    skipping, differentiable (the backward is the Dao recompute from the
    saved ``out`` and ``lse``). Each gradient comes back in its primal's
    dtype. See :func:`supports` for what the kernels take."""
    return _PallasCausalAttention.apply(q, k, v, block)
