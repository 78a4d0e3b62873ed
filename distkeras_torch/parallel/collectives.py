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

Routes. NCCL moves CUDA tensors and gloo CPU tensors directly; gloo
cannot send CUDA tensors point to point nor exchange them all to all,
so on a gloo group (two ranks sharing one card) :func:`ppermute_many`
and :func:`all_to_all` stage them through host memory: one copy to the
host, gloo's CPU collective, one copy back. The route is chosen from the
group's backend and the tensor's device (:func:`staged`), never by
catching an error.

:func:`all_to_all` is ``lax.all_to_all(split_axis=0, concat_axis=0)``
over the leading axis, differentiable (its backward is the same
exchange). :func:`reduce_grads` sums the gradients of a parameter list
over a group in flat per-dtype buckets (one ``all_reduce`` a bucket),
the port's form of the reference's one ``psum`` over the gradient tree.

Tensor parallelism (Megatron's conjugate pair, the port's form of the
transposes ``shard_map``'s autodiff inserts for the reference):
:func:`copy_to_tp` goes before a column-parallel layer (identity forward,
``all_reduce`` of the input's gradient backward: each head shard's
gradient of a replicated input is partial), :func:`reduce_from_tp` after
a row-parallel one (``all_reduce`` forward, identity backward).
:func:`all_gather_tp` assembles a tensor sharded along one dimension
(the engine's host-side paths and the plain-layout checkpoints). Every
tp collective is an ``all_reduce``: gloo on CUDA tensors serves only
``all_reduce`` and ``broadcast``, and two ranks sharing one card cannot
run NCCL.

Lock-step control (the tensor-parallel serving loop, over a mesh's
:meth:`~distkeras_torch.parallel.mesh.Mesh.control_group`: gloo, CPU
tensors): :func:`broadcast_object` sends one small picklable record from
a source rank to the group, :func:`broadcast_tensors` a list of tensors
whose shapes and dtypes every rank already knows (pushed weights,
migrated KV blocks), packed into flat byte buckets. A rank that never
joins makes the others' call raise after the group's timeout; a rank
that died makes it raise at once.
"""

from __future__ import annotations

import pickle
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Perm = Sequence[Tuple[int, int]]


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank within ``group`` (0 in a group of one)."""
    return 0 if group is None else dist.get_rank(group)


def staged(group, x: torch.Tensor) -> bool:
    """Whether a point-to-point or all-to-all exchange of ``x`` over
    ``group`` goes through host memory: a CUDA tensor on a gloo group."""
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _permute(xs, perms, group):
    if xs and staged(group, xs[0]):
        dev = xs[0].device
        outs = _permute(tuple(x.cpu() for x in xs), perms, group)
        return tuple(o.to(dev) for o in outs)
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


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    if staged(group, x):
        return _exchange(x.cpu(), group).to(x.device)
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=0, concat_axis=0)``: ``x``'s leading
    axis (the group's size) indexes destination ranks; the result's
    indexes source ranks — block ``j`` of rank ``i``'s input becomes
    block ``i`` of rank ``j``'s output. Differentiable: the backward is
    the same exchange of the cotangents. ``x`` itself in a group of
    one."""
    n = group_size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all splits a leading axis of the group's "
                         f"size {n}; got shape {tuple(x.shape)}")
    if n == 1:
        return x
    return _AllToAll.apply(x, group)


# the most bytes one all_reduce of reduce_grads carries
GRAD_BUCKET_BYTES = 256 << 20


@torch.no_grad()
def reduce_grads(params, group=None) -> int:
    """Sum the gradients of ``params`` over ``group`` in place: flat
    buckets of one dtype, each at most :data:`GRAD_BUCKET_BYTES` (a
    gradient larger than that rides alone), one ``all_reduce`` a bucket, the sums copied back into
    each ``.grad``. A parameter without a gradient gets zeros first, so
    every rank reduces the same buckets. Returns the number of
    all-reduces (also added to ``reduce_grads.calls``); nothing happens
    in a group of one."""
    if group_size(group) == 1:
        return 0
    buckets, open_ = [], {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        g = p.grad
        nbytes = g.numel() * g.element_size()
        cur = open_.get(g.dtype)
        if cur is None or cur[1] + nbytes > GRAD_BUCKET_BYTES:
            cur = open_[g.dtype] = [[], 0]
            buckets.append(cur)
        cur[0].append(g)
        cur[1] += nbytes
    for grads, _ in buckets:
        if len(grads) == 1:
            dist.all_reduce(grads[0], group=group)
            continue
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in grads]), grads)])
    reduce_grads.calls += len(buckets)
    return len(buckets)


reduce_grads.calls = 0


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum``: the sum of ``x`` over the group (``x`` itself in a
    group of one). It carries no gradient: the LM step sums only its token
    count and the loss it reports."""
    if group_size(group) == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's f: the identity forward; backward, the input gradient
    summed over the tp ``group`` (a replicated input feeding
    column-parallel layers gets one partial gradient per head shard).
    The identity itself in a group of one."""
    if group_size(group) == 1:
        return x
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's g: forward, the partial products of a row-parallel
    layer summed over the tp ``group``; backward, the identity (the
    replicated output's gradient is every shard's). The identity itself
    in a group of one."""
    if group_size(group) == 1:
        return x
    return _ReduceFromTP.apply(x, group)


@torch.no_grad()
def all_gather_tp(x: torch.Tensor, group=None, dim: int = 0
                  ) -> torch.Tensor:
    """The shards of ``x`` along ``dim`` over ``group``, concatenated in
    group-rank order (a new contiguous tensor; ``x`` itself in a group of
    one). One ``all_reduce`` of a zero-padded slab, summed as bytes so
    every value (signed zeros and NaN payloads included) arrives bit for
    bit. Not differentiable."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    slab = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    slab[group_rank(group)] = x
    dist.all_reduce(slab.view(-1).view(torch.uint8), op=dist.ReduceOp.SUM,
                    group=group)
    return torch.cat(tuple(slab.unbind(0)), dim=dim)


# the step record's first broadcast: an 8-byte length, then up to this
# many bytes of the pickled record (a longer one sends the rest after)
RECORD_HEAD_BYTES = 4096
# the most bytes one broadcast of broadcast_tensors carries
BCAST_BUCKET_BYTES = 64 << 20


def broadcast_object(obj, group, src: int = 0):
    """``obj`` (picklable) from group rank ``src`` to every rank of
    ``group``; returns it on every rank (``obj`` is ignored elsewhere).
    One broadcast of a fixed-size head carries a record of up to
    :data:`RECORD_HEAD_BYTES`, a second one the rest of a longer one."""
    me = group_rank(group)
    head = torch.zeros(8 + RECORD_HEAD_BYTES, dtype=torch.uint8)
    if me == src:
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        head[:8] = torch.tensor([len(data)], dtype=torch.int64).view(
            torch.uint8)
        first = data[:RECORD_HEAD_BYTES]
        head[8:8 + len(first)] = torch.frombuffer(bytearray(first),
                                                  dtype=torch.uint8)
    src_g = dist.get_global_rank(group, src)
    dist.broadcast(head, src_g, group=group)
    n = int(head[:8].view(torch.int64)[0])
    if n <= RECORD_HEAD_BYTES:
        return obj if me == src else pickle.loads(head[8:8 + n].numpy()
                                                  .tobytes())
    rest = torch.empty(n - RECORD_HEAD_BYTES, dtype=torch.uint8)
    if me == src:
        rest.copy_(torch.frombuffer(bytearray(data[RECORD_HEAD_BYTES:]),
                                    dtype=torch.uint8))
    dist.broadcast(rest, src_g, group=group)
    if me == src:
        return obj
    return pickle.loads(head[8:].numpy().tobytes() + rest.numpy().tobytes())


def tensor_specs(tensors: Sequence[torch.Tensor]) -> List[tuple]:
    """``(shape, dtype)`` of each tensor: what :func:`broadcast_tensors`
    needs on the ranks that receive."""
    return [(tuple(t.shape), t.dtype) for t in tensors]


def _buckets(specs, cap):
    """Indexes of ``specs`` grouped into runs of at most ``cap`` bytes
    (a larger tensor rides alone), identically on every rank."""
    out, cur, size = [], [], 0
    for i, (shape, dtype) in enumerate(specs):
        n = _nbytes(shape, dtype)
        if cur and size + n > cap:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
    if cur:
        out.append(cur)
    return out


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


@torch.no_grad()
def broadcast_tensors(tensors: Optional[Sequence[torch.Tensor]], specs,
                      group, src: int = 0) -> List[torch.Tensor]:
    """CPU tensors from group rank ``src`` (``tensors``; ``None``
    elsewhere) to every rank of ``group``, whose ``specs`` (``[(shape,
    dtype)]``, :func:`tensor_specs` of the source's list) every rank
    already holds. The tensors travel as raw bytes (every dtype, bit for
    bit) packed into buckets of at most :data:`BCAST_BUCKET_BYTES`, one
    broadcast each. Returns the tensors on every rank (the source's own,
    contiguous)."""
    me = group_rank(group)
    src_g = dist.get_global_rank(group, src)
    if me == src:
        out = [t.detach().cpu().contiguous() for t in tensors]
        if [(tuple(t.shape), t.dtype) for t in out] != [
                (tuple(s), d) for s, d in specs]:
            raise ValueError("broadcast_tensors: the tensors do not match "
                             "their specs")
    else:
        out = [torch.empty(s, dtype=d) for s, d in specs]
    for idx in _buckets(specs, BCAST_BUCKET_BYTES):
        views = [out[i].view(-1).view(torch.uint8) for i in idx]
        if len(views) == 1:
            dist.broadcast(views[0], src_g, group=group)
            continue
        flat = (torch.cat(views) if me == src else
                torch.empty(sum(v.numel() for v in views),
                            dtype=torch.uint8))
        dist.broadcast(flat, src_g, group=group)
        if me != src:
            torch._foreach_copy_(views, list(flat.split(
                [v.numel() for v in views])))
    return out
