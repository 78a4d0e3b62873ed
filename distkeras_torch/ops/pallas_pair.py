"""Pair attention — the zigzag ring's inner op, the port of
:mod:`distkeras_tpu.ops.pallas_pair`.

:func:`pallas_pair_attention` attends one chunk pair,
``q [B, Tq, H, hd] x k, v [B, Tk, H, hd] -> (o [B, Tq, H, hd], lse
[B, Tq, H] f32)``. Unlike :mod:`.pallas_attention` (self-attention), it

- takes PRE-SCALED q (the ring scales once on entry) and never scales it;
- returns ``o`` normalized within the pair AND its per-row logsumexp,
  because the ring folds pairs into running online-softmax stats
  (``ring_attention._merge_pair``);
- is differentiable in both outputs: its backward takes ``(do, dlse)``
  (either may be ``None``: zeros) and folds the lse cotangent into the
  Dao recompute as ``dS = P * (dP - delta + dlse)``, since
  ``d lse_i / d s_ij = p_ij``;
- has two variants: ``causal=True`` masks LOCAL positions
  ``q_pos >= k_pos`` (a diagonal chunk against itself, ``Tq == Tk``), and
  ``causal=False`` is the full rectangle, where ``Tq`` may differ from
  ``Tk``.

On CUDA tensors each entry point launches its hand-written Hopper kernel
(``csrc/pair_attention.cu``: the PAIR instantiations of the forward of
``csrc/flash_fwd_sm90.cuh`` and of the dq and dk/dv kernels of
``csrc/flash_bwd_sm90.cuh``, all on ``wgmma`` with TMA loads, bf16 in,
f32 accumulate). The backward's prep pass writes
``delta' = rowsum(dO * O) - dlse`` once per row into
:func:`bwd_scratch` (the lse cotangent folded into delta, so the kernels
compute ``dS = P * (dP - delta')``): the dq launch runs it and the
backward's dk/dv launch reads it (a dk/dv call on its own runs it
itself). CPU tensors take the plain versions beside them,
:func:`pair_attention_reference`, :func:`pair_attention_dq_reference`
and :func:`pair_attention_dkv_reference` — dense in f32 from the same
inputs, with the reference's roundings (probabilities cast to v's dtype
before ``P V`` and to dO's before ``dV``; ``dS`` cast to q's dtype
before ``dQ`` and ``dK``) — and :func:`pair_attention_prep_reference`,
the prep pass's. A CUDA call the kernels cannot take raises, and so
does a launch that fails: there is no fallback.

The gate, :func:`pair_supports`, is written for Hopper tiles, not for
the TPU's ``hd % 128`` rule: bf16 operands, head dims 64/128/256, any
chunk lengths (ragged tiles are masked in-kernel).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from distkeras_torch.ops.pallas_attention import (
    BLOCK,
    KERNEL_HEAD_DIMS,
    _aligned,
    _stream,
)

_NEG_INF = -1e30


def pair_supports(Tq: int, Tk: int, hd: int,
                  dtype=torch.bfloat16) -> Optional[int]:
    """The tile both sides of the pair run at, or ``None`` when the
    kernels do not take the shape: bf16, a compiled head dim, and chunks
    of at least one token (any length: ragged tiles are masked)."""
    if dtype != torch.bfloat16 or hd not in KERNEL_HEAD_DIMS:
        return None
    if Tq < 1 or Tk < 1:
        return None
    return BLOCK


# -- plain versions ---------------------------------------------------------


def _logits(q, k, causal):
    """``q k^T`` in f32 ``[B, H, Tq, Tk]``, local-causally masked."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if causal:
        Tq, Tk = s.shape[-2:]
        mask = torch.ones((Tq, Tk), dtype=torch.bool,
                          device=s.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return s


def pair_attention_reference(q, k, v, causal: bool = False):
    """The forward's plain version: ``(o, lse)`` in f32 — ``o``
    ``[B, Tq, H, hd]`` (probabilities rounded to v's dtype before
    ``P V``) and ``lse`` ``[B, Tq, H]``."""
    s = _logits(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return o, lse.transpose(1, 2)


def pair_attention_prep_reference(o, do, dlse):
    """The backward prep pass's plain version: ``delta' = rowsum(dO * O)
    - dlse``, ``[B, Tq, H]`` f32 — the lse cotangent folded into delta,
    as the dq and dk/dv kernels read it."""
    return (torch.einsum("bqhd,bqhd->bqh", do.float(), o.float())
            - dlse.float())


def _bwd_common(q, k, v, o, lse, do, dlse, causal, delta=None):
    """The Dao recompute the backward plain versions share, with the lse
    cotangent folded in: ``P = exp(s - lse)``, ``delta = rowsum(dO * O)``,
    ``dS = P * (dO V^T - delta + dlse)`` rounded to q's dtype — or, given
    the prep pass's ``delta'``, ``dS = P * (dO V^T - delta')``; returns
    ``(P, dS, dO)`` in f32."""
    do = do.to(q.dtype)
    p = torch.exp(_logits(q, k, causal)
                  - lse.float().transpose(1, 2)[..., None])
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    if delta is None:
        delta = torch.einsum("bqhd,bqhd->bhq", dof, o.float())
        ds = p * (dp - delta[..., None]
                  + dlse.float().transpose(1, 2)[..., None])
    else:
        ds = p * (dp - delta.float().transpose(1, 2)[..., None])
    return p, ds.to(q.dtype).float(), dof


def pair_attention_dq_reference(q, k, v, o, lse, do, dlse,
                                causal: bool = False):
    """The dq kernel's plain version: ``dS K`` in f32 — the gradient of
    the pre-scaled q, not rescaled."""
    _, ds, _ = _bwd_common(q, k, v, o, lse, do, dlse, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float())


def pair_attention_dkv_reference(q, k, v, o, lse, do, dlse,
                                 causal: bool = False):
    """The dk/dv kernel's plain version: ``(dS^T q, P^T dO)`` in f32, P
    rounded to dO's dtype."""
    p, ds, dof = _bwd_common(q, k, v, o, lse, do, dlse, causal)
    return (torch.einsum("bhqk,bqhd->bkhd", ds, q.float()),
            torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof))


def pair_attention_bwd_reference(q, k, v, o, lse, do, dlse,
                                 causal: bool = False, delta=None):
    """The backward's plain version: ``(dq, dk, dv)`` in f32 from one
    dense recompute (:func:`pair_attention_dq_reference` and
    :func:`pair_attention_dkv_reference` together). Given ``delta`` (the
    prep pass's ``delta'``, :func:`pair_attention_prep_reference`), ``dS``
    takes the folded form the kernels compute, ``P * (dP - delta')``,
    and ``o`` and ``dlse`` are not read."""
    p, ds, dof = _bwd_common(q, k, v, o, lse, do, dlse, causal, delta)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()),
            torch.einsum("bhqk,bqhd->bkhd", ds, q.float()),
            torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof))


# -- the kernels ------------------------------------------------------------


def _strided(t):
    """``t`` as the kernels read it — head stride ``hd``, a contiguous
    last axis, 16-byte aligned rows — with its (batch, token) strides;
    a copy only where needed."""
    hd = t.shape[-1]
    if not (t.stride(3) == 1 and t.stride(2) == hd
            and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0
            and t.data_ptr() % 16 == 0):
        t = _aligned(t)
    return t, t.stride(0), t.stride(1)


def _kv(k, v):
    """k and v read through one pair of strides."""
    k, ksb, kst = _strided(k)
    v, vsb, vst = _strided(v)
    if (vsb, vst) != (ksb, kst):
        k, v = _aligned(k), _aligned(v)
        ksb, kst = k.stride(0), k.stride(1)
    return k, v, ksb, kst


def _raise_on(rc, what):
    if rc != 0:
        from distkeras_torch.kernels import build

        raise RuntimeError(f"pair attention {what} kernel launch failed: "
                           f"{build.error_string(rc)} (cuda error {rc})")


def _variant(causal):
    return "wedge" if causal else "rect"


def _fwd_kernel(q, k, v, causal):
    from distkeras_torch.kernels import build

    lib = build.load()
    q, qsb, qst = _strided(q)
    k, v, ksb, kst = _kv(k, v)
    B, Tq, H, hd = q.shape
    out = torch.empty((B, Tq, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Tq, H), dtype=torch.float32, device=q.device)
    vp = ctypes.c_void_p
    rc = lib.dk_pair_attention_fwd(
        vp(q.data_ptr()), vp(k.data_ptr()), vp(v.data_ptr()),
        vp(out.data_ptr()), vp(lse.data_ptr()), B, Tq, k.shape[1], H, hd,
        int(causal), qsb, qst, ksb, kst, _stream(q))
    _raise_on(rc, "forward")
    pair_attention_fwd.launches[_variant(causal)] += 1
    build.note_launch("pair_attention_fwd", (q.shape[-1], causal))
    return out, lse


def _bwd_args(q, k, v, o, lse, do, dlse):
    q, qsb, qst = _strided(q)
    k, v, ksb, kst = _kv(k, v)
    o, do = _aligned(o), _aligned(do.to(q.dtype))
    lse, dlse = lse.contiguous(), dlse.float().contiguous()
    vp = ctypes.c_void_p
    held = (q, k, v, o, do, lse, dlse)
    # the tensors are returned with their pointers to keep them alive
    return held, [vp(t.data_ptr()) for t in held], (qsb, qst, ksb, kst)


def bwd_scratch(q):
    """Scratch of the backward's prep pass for a pair whose q is shaped
    like ``q``: ``delta' = rowsum(dO * O) - dlse``, ``[B, Tq, H]`` f32
    (lse's layout). The dq kernel's launch fills it; the same backward's
    dk/dv launch reads it."""
    B, Tq, H, _ = q.shape
    return torch.empty((B, Tq, H), dtype=torch.float32, device=q.device)


def _dq_kernel(q, k, v, o, lse, do, dlse, causal, scratch):
    from distkeras_torch.kernels import build

    lib = build.load()
    held, ptrs, strides = _bwd_args(q, k, v, o, lse, do, dlse)
    B, Tq, H, hd = held[0].shape
    dq = torch.empty((B, Tq, H, hd), dtype=q.dtype, device=q.device)
    delta = bwd_scratch(q) if scratch is None else scratch
    vp = ctypes.c_void_p
    rc = lib.dk_pair_attention_dq(
        *ptrs, vp(dq.data_ptr()), vp(delta.data_ptr()), B, Tq, k.shape[1],
        H, hd, int(causal), *strides, _stream(q))
    _raise_on(rc, "dq")
    pair_attention_dq.launches[_variant(causal)] += 1
    build.note_launch("pair_attention_dq", (q.shape[-1], causal))
    return dq


def _dkv_kernel(q, k, v, o, lse, do, dlse, causal, scratch):
    from distkeras_torch.kernels import build

    lib = build.load()
    held, ptrs, strides = _bwd_args(q, k, v, o, lse, do, dlse)
    B, Tq, H, hd = held[0].shape
    Tk = k.shape[1]
    dk = torch.empty((B, Tk, H, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    # without the dq launch's scratch, the prep pass runs here first
    prep = scratch is None
    delta = bwd_scratch(q) if prep else scratch
    vp = ctypes.c_void_p
    rc = lib.dk_pair_attention_dkv(
        *ptrs, vp(dk.data_ptr()), vp(dv.data_ptr()), vp(delta.data_ptr()),
        int(prep), B, Tq, Tk, H, hd, int(causal), *strides, _stream(q))
    _raise_on(rc, "dk/dv")
    pair_attention_dkv.launches[_variant(causal)] += 1
    build.note_launch("pair_attention_dkv", (q.shape[-1], causal))
    return dk, dv


def _check(q, k, v, causal, block):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or (
            k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]):
        raise ValueError(f"pair attention takes q [B, Tq, H, hd] and k, v "
                         f"[B, Tk, H, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"a causal pair is a chunk against itself: Tq == "
                         f"Tk; got {q.shape[1]} and {k.shape[1]}")
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share a dtype and a device")
    if block is not None and block != BLOCK:
        raise ValueError(f"the pair kernels run {BLOCK}-row tiles; got "
                         f"block={block}")


def _on_card(q, k, v, causal, block) -> bool:
    """True for CUDA tensors the kernels take (raises for those they do
    not); False for CPU tensors, which take the plain versions."""
    _check(q, k, v, causal, block)
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise RuntimeError(f"pair attention runs on cuda or cpu, not "
                           f"{q.device}")
    if pair_supports(q.shape[1], k.shape[1], q.shape[3], q.dtype) is None:
        raise ValueError(
            f"the pair attention kernels take bf16 and hd in "
            f"{KERNEL_HEAD_DIMS}; got dtype={q.dtype}, hd={q.shape[3]} — "
            f"gate with pair_supports()")
    return True


def pair_attention_fwd(q, k, v, causal: bool = False,
                       block: Optional[int] = None):
    """The forward: ``(o, lse)`` — ``o`` in ``q.dtype``, ``lse``
    ``[B, Tq, H]`` f32. CUDA tensors launch the forward kernel or raise;
    CPU tensors run :func:`pair_attention_reference`."""
    if _on_card(q, k, v, causal, block):
        return _fwd_kernel(q, k, v, causal)
    o, lse = pair_attention_reference(q, k, v, causal)
    return o.to(q.dtype), lse


def pair_attention_dq(q, k, v, o, lse, do, dlse, causal: bool = False,
                      block: Optional[int] = None, scratch=None):
    """dq (of the pre-scaled q) in ``q.dtype``: the dq kernel (after its
    prep pass) on CUDA tensors, the plain version on CPU tensors.
    ``scratch`` (:func:`bwd_scratch`), when given, keeps what the prep
    pass wrote for the same backward's :func:`pair_attention_dkv` call."""
    if _on_card(q, k, v, causal, block):
        return _dq_kernel(q, k, v, o, lse, do, dlse, causal, scratch)
    return pair_attention_dq_reference(q, k, v, o, lse, do, dlse,
                                       causal).to(q.dtype)


def pair_attention_dkv(q, k, v, o, lse, do, dlse, causal: bool = False,
                       block: Optional[int] = None, scratch=None):
    """(dk, dv) in their primals' dtypes: the dk/dv kernel on CUDA
    tensors, the plain version on CPU tensors. ``scratch`` filled by
    :func:`pair_attention_dq` on the same inputs (``dlse`` included)
    skips the kernel's own prep pass; without it the prep pass runs
    first."""
    if _on_card(q, k, v, causal, block):
        return _dkv_kernel(q, k, v, o, lse, do, dlse, causal, scratch)
    dk, dv = pair_attention_dkv_reference(q, k, v, o, lse, do, dlse,
                                          causal)
    return dk.to(k.dtype), dv.to(v.dtype)


# kernel launches made through the wrappers, by variant: "wedge" (causal)
# and "rect" (chip_smoke.py zeroes them before the ring training phase and
# reads them after)
pair_attention_fwd.launches = {"wedge": 0, "rect": 0}
pair_attention_dq.launches = {"wedge": 0, "rect": 0}
pair_attention_dkv.launches = {"wedge": 0, "rect": 0}


class _PairAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block):
        ctx.set_materialize_grads(False)
        o, lse = pair_attention_fwd(q, k, v, causal, block)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.block = causal, block
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        if dlse is None:
            dlse = torch.zeros_like(lse)
        if q.device.type == "cpu":  # one dense recompute serves all three
            dq, dk, dv = pair_attention_bwd_reference(q, k, v, o, lse, do,
                                                      dlse, ctx.causal)
            return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None,
                    None)
        # one prep pass (delta') serves both kernels
        scratch = bwd_scratch(q)
        dq = pair_attention_dq(q, k, v, o, lse, do, dlse, ctx.causal,
                               ctx.block, scratch)
        dk, dv = pair_attention_dkv(q, k, v, o, lse, do, dlse, ctx.causal,
                                    ctx.block, scratch)
        return dq, dk, dv, None, None


def pallas_pair_attention(q, k, v, causal: bool = False,
                          block: Optional[int] = None):
    """Attention of one chunk pair, ``[B, Tq, H, hd] x [B, Tk, H, hd]`` ->
    ``(o [B, Tq, H, hd] in q.dtype, lse [B, Tq, H] f32)``.

    ``q`` must arrive PRE-SCALED (the ring scales once on entry). ``o``
    is softmax-normalized within the pair; ``lse`` is the per-row
    log-sum-exp, so pairs merge exactly into running online-softmax
    stats. ``causal`` masks LOCAL positions (diagonal chunks, Tq == Tk).
    Differentiable in both outputs."""
    return _PairAttention.apply(q, k, v, causal, block)
