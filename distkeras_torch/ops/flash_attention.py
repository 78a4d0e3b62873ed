"""Blocked (flash-style) causal attention with the Dao recompute
backward — the port of :mod:`distkeras_tpu.ops.flash_attention`.

Plain PyTorch: the forward streams over key/value blocks with an f32
online softmax and saves only ``out`` and the per-query logsumexp; the
backward re-derives each block's probabilities from ``(q, k, lse)`` and
accumulates dq/dk/dv blockwise. Peak intermediate memory is
``[B, H, T, block_k]`` rather than ``[B, H, T, T]``.

It is the model's ``attention='blocked'`` mode, the CPU path of
``'standard'`` above the dense limit, and the card-side twin the
training phase of ``chip_smoke.py`` compares the hand-written kernels'
losses with. Numerics follow the reference: q scaled in its own dtype,
matrix products with model-dtype operands and f32 accumulation (the
operands are upcast to f32, which is exact), probabilities and the
softmax cotangent cast to the model dtype before their products, and
masked logits filled with ``-1e30``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_NEG_INF = -1e30


def _scale_q(q):
    scale = 1.0 / math.sqrt(q.shape[-1])
    if q.dtype == torch.float32:
        return q * scale
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def _block_kv(x, bk):
    """``[B, T, H, hd]`` -> ``[nk, B, bk, H, hd]`` (zero-padded to a
    ``bk`` multiple)."""
    B, T, H, hd = x.shape
    nk = -(-T // bk)
    pad = nk * bk - T
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
    return x.reshape(B, nk, bk, H, hd).permute(1, 0, 2, 3, 4)


def _mask(i, bk, T, q_pos, causal):
    k_pos = i * bk + torch.arange(bk, device=q_pos.device)
    valid = k_pos[None, :] < T
    if causal:
        valid = valid & (q_pos[:, None] >= k_pos[None, :])
    return valid  # [T, bk]


def _mm(spec, a, b):
    """einsum with f32 accumulation and an f32 result (the reference's
    ``preferred_element_type=float32``): operands upcast exactly."""
    return torch.einsum(spec, a.float(), b.float())


def _flash_fwd(q, k, v, block_k, causal):
    B, T, H, hd = q.shape
    bk = min(block_k, T)
    qf = _scale_q(q)
    kb, vb = _block_kv(k, bk), _block_kv(v, bk)
    q_pos = torch.arange(T, device=q.device)
    o = torch.zeros((B, T, H, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    for i in range(kb.shape[0]):
        s = _mm("bqhd,bkhd->bhqk", qf, kb[i])
        s = torch.where(_mask(i, bk, T, q_pos, causal)[None, None], s,
                        torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)  # [B, H, T]
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr.permute(0, 2, 1)[..., None] + _mm(
            "bhqk,bkhd->bqhd", p.to(q.dtype), vb[i])
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    o = o / l_safe.permute(0, 2, 1)[..., None]
    lse = m + torch.log(l_safe)  # per-query logsumexp [B, H, T]
    return o.to(q.dtype), lse


def _flash_bwd(q, k, v, out, lse, do, block_k, causal):
    B, T, H, hd = q.shape
    bk = min(block_k, T)
    scale = 1.0 / math.sqrt(hd)
    qf = _scale_q(q)
    kb, vb = _block_kv(k, bk), _block_kv(v, bk)
    q_pos = torch.arange(T, device=q.device)
    do_f = do.to(q.dtype)
    delta = _mm("bqhd,bqhd->bhq", do_f, out)  # rowsum(dO * O), [B, H, T]
    nk = kb.shape[0]
    dqf = torch.zeros((B, T, H, hd), dtype=torch.float32, device=q.device)
    dk_b, dv_b = [], []
    for i in range(nk):
        s = _mm("bqhd,bkhd->bhqk", qf, kb[i])
        s = torch.where(_mask(i, bk, T, q_pos, causal)[None, None], s,
                        torch.full_like(s, _NEG_INF))
        p = torch.exp(s - lse[..., None])  # zero where masked
        dv_b.append(_mm("bhqk,bqhd->bkhd", p.to(q.dtype), do_f))
        dp = _mm("bqhd,bkhd->bhqk", do_f, vb[i])
        dsc = (p * (dp - delta[..., None])).to(q.dtype)
        dqf = dqf + _mm("bhqk,bkhd->bqhd", dsc, kb[i])
        dk_b.append(_mm("bhqk,bqhd->bkhd", dsc, qf))
    dk = torch.cat(dk_b, dim=1)[:, :T]
    dv = torch.cat(dv_b, dim=1)[:, :T]
    dq = dqf * scale  # qf = q * scale, so d/dq = scale * d/dqf
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _BlockedCausalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block_k, causal):
        out, lse = _flash_fwd(q, k, v, block_k, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.block_k, ctx.causal = block_k, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, do, ctx.block_k,
                                ctx.causal)
        return dq, dk, dv, None, None


def blocked_causal_attention(q, k, v, block_k: int = 512,
                             causal: bool = True):
    """Exact attention with blockwise streaming softmax.

    Args:
      q, k, v: ``[B, T, H, head_dim]``.
      block_k: key/value block length (clamped to T; T is padded up to a
        multiple of it, pads masked out).
      causal: apply the standard causal mask.

    Returns ``[B, T, H, head_dim]`` in ``q.dtype``; differentiable with
    the Dao recompute backward.
    """
    return _BlockedCausalAttention.apply(q, k, v, block_k, causal)
