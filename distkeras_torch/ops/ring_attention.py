"""Ring attention — sequence-parallel exact attention over a process
group, the port of :mod:`distkeras_tpu.ops.ring_attention`.

The sequence is sharded over the ranks of ``group``; each rank holds a
contiguous ``[B, T_local, H, hd]`` shard of q, k and v, K/V rotate around
the ring (:func:`~distkeras_torch.parallel.collectives.ppermute`, over
NCCL between cards or gloo between CPU processes) while each rank folds
its queries' output into streaming log-sum-exp softmax stats. A group of
one (``None``) is the ring of one shard: no communication at all.

Two implementations, as in the reference:

- **zigzag** (causal default): the global sequence is split into 2N
  chunks of ``C = T_local / 2``; rank d holds chunk d (early) and chunk
  2N-1-d (late), so every ring step gives every rank exactly two
  unmasked chunk pairs and the causal skip turns into balanced wall
  clock. Step 0 (``local_step``) attends the two diagonal chunks
  (causal) and the (late q, early kv) rectangle. The entry and exit
  shuffles are one collective each (q, k and v ride it stacked, the two
  half-shards as two streams), a ring step is one collective (K and V
  stacked); each step's attention runs under ``torch.utils.checkpoint``
  with the collectives outside it, as the reference runs its steps under
  ``jax.checkpoint``. The chunk pairs go through the hand-written Hopper
  pair kernels (:func:`~distkeras_torch.ops.pallas_pair.pallas_pair_attention`)
  where :func:`_pair_kernel_block` passes, else through the blocked
  online-softmax loop :func:`_attend`.
- **naive** (non-causal, and shapes the zigzag gate rejects): rotate the
  whole K/V shard N times and mask by global position.

The rank is known on the host, so where the reference selects with
``jnp.where`` on ``axis_index`` this port branches in Python on the same
condition and computes the same result.
"""

from __future__ import annotations

import functools
import math
import os

import torch
from torch.utils.checkpoint import checkpoint

from distkeras_torch.ops.flash_attention import _mm
from distkeras_torch.parallel.collectives import (
    group_rank,
    group_size,
    ppermute,
    ppermute_many,
)

_NEG_INF = -1e30
DEFAULT_KV_BLOCK = 512


def ring_attention(q, k, v, group=None, causal: bool = True,
                   impl: str = "auto"):
    """Exact attention over a sequence sharded across ``group``.

    Args:
      q, k, v: ``[B, T_local, H, head_dim]`` — this rank's CONTIGUOUS
        sequence shard (group rank x T_local + local offset = global
        position). Any zigzag re-layout is internal.
      group: the process group the sequence is sharded over (``None``: a
        group of one).
      causal: causal mask by global position, so the result equals
        unsharded causal attention.
      impl: ``'auto'`` (zigzag when causal and the shapes allow, else
        naive), ``'zigzag'`` (raises where its gate fails) or
        ``'naive'``.

    Returns ``[B, T_local, H, head_dim]`` in ``q.dtype``; differentiable.
    """
    if impl not in ("auto", "zigzag", "naive"):
        raise ValueError(
            f"Unknown ring impl '{impl}'. Known: auto, zigzag, naive")
    N, my = group_size(group), group_rank(group)
    zig_ok = causal and _zigzag_supports(q.shape[1])
    if impl == "zigzag" and not zig_ok:
        raise ValueError(
            "zigzag ring attention needs causal=True and an even T_local "
            "whose half is block-divisible; use impl='auto' to fall back")
    if impl in ("auto", "zigzag") and zig_ok:
        return _ring_zigzag(q, k, v, group, N, my)
    return _ring_naive(q, k, v, group, N, my, causal)


# ---------------------------------------------------------------------------
# zigzag implementation
# ---------------------------------------------------------------------------


def _zigzag_supports(T_local: int) -> bool:
    C = T_local // 2
    if T_local % 2 or C == 0:
        return False
    return C <= DEFAULT_KV_BLOCK or C % DEFAULT_KV_BLOCK == 0


def _zero_stats(B, C, H, hd, device):
    """Empty online-softmax stats ``(o [B,C,H,hd], m [B,H,C], l [B,H,C])``
    in f32."""
    return (torch.zeros((B, C, H, hd), dtype=torch.float32, device=device),
            torch.full((B, H, C), _NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((B, H, C), dtype=torch.float32, device=device))


def _merge_pair(stats, o_pair, lse_pair):
    """Fold one pair's normalized output + log-sum-exp into running
    online-softmax stats — the exact flash merge: the pair contributes
    total softmax mass ``exp(lse - m_new)`` and its normalized rows enter
    at that weight."""
    o, m, l = stats
    lse_t = lse_pair.transpose(1, 2)  # [B, C, H] -> [B, H, C]
    m_new = torch.maximum(m, lse_t)
    corr = torch.exp(m - m_new)
    w = torch.exp(lse_t - m_new)
    l_new = l * corr + w
    o_new = (o * corr.transpose(1, 2)[..., None]
             + o_pair.float() * w.transpose(1, 2)[..., None])
    return o_new, m_new, l_new


def _pair_kernel_block(C: int, hd: int, dtype, device):
    """Tile of the pair op, or ``None`` to use the blocked :func:`_attend`.
    Auto: CUDA tensors the hand-written kernels take
    (:func:`~distkeras_torch.ops.pallas_pair.pair_supports`). The
    environment variable ``DK_RING_PALLAS`` overrides: ``'1'`` forces the
    pair op anywhere — CPU tensors run its plain version, which takes any
    shape, and CUDA tensors of a shape the kernels cannot take raise —
    and ``'0'`` disables it."""
    from distkeras_torch.ops.pallas_pair import BLOCK, pair_supports

    flag = os.environ.get("DK_RING_PALLAS", "auto")
    if flag == "0":
        return None
    if torch.device(device).type != "cuda":
        return BLOCK if flag == "1" else None
    b = pair_supports(C, C, hd, dtype)
    if b is None and flag == "1":
        raise ValueError(
            f"DK_RING_PALLAS=1 but the pair kernels do not take C={C}, "
            f"hd={hd}, dtype={dtype} (they need bf16 and hd in "
            f"(64, 128, 256))")
    return b


def _attend(stats, qf, kc, vc, causal: bool, bk: int):
    """Streamed attention of one chunk pair, folded into running
    online-softmax stats ``(o [B,C,H,hd] f32, m [B,H,C] f32, l [B,H,C]
    f32)``.

    ``qf`` is pre-scaled, model dtype; products take model-dtype operands
    with f32 accumulation. ``causal`` masks LOCAL positions (the only
    masked pairs are a chunk against itself on the diagonal)."""
    o, m, l = stats
    C = qf.shape[1]
    q_pos = torch.arange(C, device=qf.device)
    for i in range(C // bk):
        kcb, vcb = kc[:, i * bk:(i + 1) * bk], vc[:, i * bk:(i + 1) * bk]
        s = _mm("bqhd,bkhd->bhqk", qf, kcb)
        if causal:
            k_pos = i * bk + torch.arange(bk, device=qf.device)
            s = torch.where((q_pos[:, None] >= k_pos[None, :])[None, None],
                            s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr.transpose(1, 2)[..., None] + _mm(
            "bhqk,bkhd->bqhd", p.to(qf.dtype), vcb)
        m = m_new
    return o, m, l


def _zig_perms(N: int):
    """Static ppermute pairs for contiguous -> zigzag: contiguous rank d
    holds chunks (2d, 2d+1) in units of C = T_local/2; zigzag rank r
    wants (r, 2N-1-r). Chunk c lives on zigzag rank min(c, 2N-1-c), and
    the two send streams (first/second local half) are each a bijection
    over ranks."""
    dst0 = [2 * d if 2 * d < N else 2 * N - 1 - 2 * d for d in range(N)]
    dst1 = [2 * d + 1 if 2 * d + 1 < N else 2 * N - 2 - 2 * d
            for d in range(N)]
    perm0 = [(d, dst0[d]) for d in range(N)]
    perm1 = [(d, dst1[d]) for d in range(N)]
    inv0 = [(dst0[d], d) for d in range(N)]
    inv1 = [(dst1[d], d) for d in range(N)]
    return perm0, perm1, inv0, inv1


def _maybe_checkpoint(fn, *args):
    """``jax.checkpoint``: keep only the inputs, recompute in the
    backward (a plain call when no gradient is being recorded)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _ring_zigzag(q, k, v, group, N, my):
    B, T_local, H, hd = q.shape
    C = T_local // 2
    bk = min(DEFAULT_KV_BLOCK, C)
    scale = 1.0 / math.sqrt(hd)
    perm0, perm1, inv0, inv1 = _zig_perms(N)
    even = my % 2 == 0

    # entry: q, k and v ride one collective, stacked; the two half-shards
    # are its two streams. Stream 0 carries an even chunk (2s), stream 1
    # an odd one; the early chunk id equals the rank, so it arrived on
    # stream 0 iff the rank is even.
    first = [x[:, :C] for x in (q, k, v)]
    second = [x[:, C:] for x in (q, k, v)]
    if N > 1:
        r0, r1 = ppermute_many((torch.stack(first), torch.stack(second)),
                               (perm0, perm1), group)
        first, second = r0.unbind(0), r1.unbind(0)
    (qe, ke, ve), (ql, kl, vl) = ((first, second) if even
                                  else (second, first))
    qe = (qe.float() * scale).to(q.dtype)
    ql = (ql.float() * scale).to(q.dtype)

    pb = _pair_kernel_block(C, hd, q.dtype, q.device)
    if pb is not None:
        from distkeras_torch.ops.pallas_pair import pallas_pair_attention

        def attend(stats, qf, kc, vc, causal):
            o_pair, lse = pallas_pair_attention(qf, kc, vc, causal, pb)
            return _merge_pair(stats, o_pair, lse)
    else:
        attend = functools.partial(_attend, bk=bk)

    def zeros():
        return _zero_stats(B, C, H, hd, q.device)

    # step 0 — the only masked work: both local diagonal chunks, plus the
    # always-full (late q, early kv) pair
    def local_step(qe, ql, ke, kl, ve, vl):
        es = attend(zeros(), qe, ke, ve, causal=True)
        ls = attend(zeros(), ql, ke, ve, causal=False)
        ls = attend(ls, ql, kl, vl, causal=True)
        return es + ls

    st = _maybe_checkpoint(local_step, qe, ql, ke, kl, ve, vl)

    if N > 1:
        rot = [(j, (j + 1) % N) for j in range(N)]

        def pair_step(use_early, qe, ql, kv, *st):
            # Exactly two UNMASKED chunk pairs per step (the zigzag
            # balance): (late q, early kv) always; plus early q against
            # early kv when this rank is past the source shard, else late
            # q against late kv.
            es, ls = st[:3], st[3:]
            ls = attend(ls, ql, kv[0, 0], kv[1, 0], causal=False)
            if use_early:
                es = attend(es, qe, kv[0, 0], kv[1, 0], causal=False)
            else:
                ls = attend(ls, ql, kv[0, 1], kv[1, 1], causal=False)
            return es + ls

        # early/late halves of K and V ride one stacked buffer, so a
        # rotation is one collective
        kv = torch.stack([torch.stack([ke, kl]), torch.stack([ve, vl])])
        for i in range(1, N):
            kv = ppermute(kv, rot, group)
            src = (my - i) % N  # the shard this K/V came from, never my
            st = _maybe_checkpoint(
                functools.partial(pair_step, my > src), qe, ql, kv, *st)

    def finalize(o, m, l):
        denom = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
        return (o / denom).to(q.dtype)

    oe, ol = finalize(*st[:3]), finalize(*st[3:])
    # exit: invert the entry shuffle (each chunk goes back on the stream
    # it arrived on, through the inverted perms)
    s0, s1 = (oe, ol) if even else (ol, oe)
    if N > 1:
        s0, s1 = ppermute_many((s0, s1), (inv0, inv1), group)
    return torch.cat([s0, s1], dim=1)


# ---------------------------------------------------------------------------
# naive implementation: rotate and mask
# ---------------------------------------------------------------------------


def _ring_naive(q, k, v, group, N, my, causal):
    B, T_local, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qf = q.float() * scale
    dev = q.device
    q_pos = my * T_local + torch.arange(T_local, device=dev)
    rot = [(j, (j + 1) % N) for j in range(N)]
    o = torch.zeros((B, T_local, H, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, H, T_local), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, H, T_local), dtype=torch.float32, device=dev)
    kc, vc = k, v
    for i in range(N):
        src = (my - i) % N  # kc originated on shard src
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc.float())
        if causal:
            k_pos = src * T_local + torch.arange(T_local, device=dev)
            s = torch.where((q_pos[:, None] >= k_pos[None, :])[None, None],
                            s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)  # [B, H, Tq]
        p = torch.exp(s - m_new[..., None])  # [B, H, Tq, Tk]
        l = l * corr + p.sum(dim=-1)
        o = o * corr.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, vc.float())
        m = m_new
        if i + 1 < N:  # the reference's last rotation is never read
            kc, vc = ppermute(torch.stack([kc, vc]), rot, group).unbind(0)
    denom = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return (o / denom).to(q.dtype)
