"""Collectives over process groups — the port's counterparts of
``lax.ppermute`` and ``lax.psum`` inside ``shard_map``.

A group is a ``torch.distributed`` process group, or ``None`` for a
group of one (this process alone): then every collective is the
identity and no process group needs to exist.

:func:`ppermute_many` is differentiable: its backward sends each
cotangent back along the INVERSE permutation, which is JAX's transpose
of ``ppermute``. All sends and receives of one call go out in one
``batch_isend_irecv`` (each stream under its own tag), so no rank waits
on a receive that its peer posts later. Collectives that autograd runs
must be issued in the same order on every rank; callers keep that order
by giving each communication step ONE call (several tensors ride it as
streams or stacked), so that the backward's calls form a chain of data
dependencies.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

Perm = Sequence[Tuple[int, int]]


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank within ``group`` (0 in a group of one)."""
    return 0 if group is None else dist.get_rank(group)


def _permute(xs, perms, group):
    me = group_rank(group)
    ops, outs = [], []
    for tag, (x, perm) in enumerate(zip(xs, perms)):
        x = x.contiguous()
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        # a rank no pair sends to receives zeros, as in lax.ppermute
        out = torch.empty_like(x) if src else torch.zeros_like(x)
        if dst == [me]:
            out.copy_(x)
        else:
            if dst:
                ops.append(dist.P2POp(dist.isend, x,
                                      dist.get_global_rank(group, dst[0]),
                                      group, tag))
            if src:
                ops.append(dist.P2POp(dist.irecv, out,
                                      dist.get_global_rank(group, src[0]),
                                      group, tag))
        outs.append(out)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return tuple(outs)


def _inverse(perm: Perm):
    return tuple((d, s) for s, d in perm)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, perms, *xs):
        ctx.group, ctx.perms = group, perms
        return _permute(xs, perms, group)

    @staticmethod
    def backward(ctx, *gs):
        inv = tuple(_inverse(p) for p in ctx.perms)
        return (None, None) + _permute(gs, inv, ctx.group)


def ppermute_many(xs: Sequence[torch.Tensor], perms: Sequence[Perm],
                  group=None) -> Tuple[torch.Tensor, ...]:
    """``lax.ppermute`` of several tensors in one collective: tensor ``i``
    goes from group rank ``s`` to ``d`` for each ``(s, d)`` in
    ``perms[i]``. Differentiable (the backward permutes the cotangents
    back). A group of one returns the inputs as they are."""
    if len(xs) != len(perms):
        raise ValueError(f"{len(xs)} tensors but {len(perms)} permutations")
    n = group_size(group)
    perms = tuple(tuple((int(s), int(d)) for s, d in p) for p in perms)
    for p in perms:
        srcs, dsts = [s for s, _ in p], [d for _, d in p]
        if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
                or not all(0 <= r < n for r in srcs + dsts)):
            raise ValueError(f"ppermute pairs {p} are not a partial "
                             f"permutation of a group of {n}")
    if n == 1:
        return tuple(xs)
    return _PPermute.apply(group, perms, *xs)


def ppermute(x: torch.Tensor, perm: Perm, group=None) -> torch.Tensor:
    """``lax.ppermute`` of one tensor (see :func:`ppermute_many`)."""
    return ppermute_many((x,), (perm,), group)[0]


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum``: the sum of ``x`` over the group (``x`` itself in a
    group of one). It carries no gradient: the LM step sums only its token
    count and the loss it reports."""
    if group_size(group) == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y
