"""The language-model training step — the port of
:func:`distkeras_tpu.parallel.spmd.make_lm_train_step`.

The reference jits one program over a dp x sp (x tp) mesh and threads
params and optimizer state through it (donated). Here each mesh position
is one process (:mod:`distkeras_torch.parallel.mesh`) holding a full
replica of the parameters, which the optimizer updates in place, so the
step is ``step(tokens) -> loss``. Every rank is handed the same global
batch and takes its own ``[B/dp, T/sp]`` shard of it; after the backward
each gradient is summed over the dp x sp group (the port's form of
``shard_map``'s transpose for replicated parameters), so every replica
takes the same update.

Tensor parallelism (``tp_axis``): the model is a ``tp_size`` model whose
ranks each hold their slice of the heads and the MLP hidden dimension
(:func:`lm_param_specs`); activations stay replicated over tp, and the
model's own conjugate collectives make every gradient whole on every tp
rank — the sharded ones for the slice the rank holds, the replicated
ones identical across tp ranks — so no reduction, broadcast or loss sum
ever spans tp. :func:`shard_state` and :func:`gather_state` move a
state between the plain (``tp_size=1``) layout and a rank's shard, as
checkpoints and the weight bridge need.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from distkeras_torch.ops.fused_ce import lm_head_loss
from distkeras_torch.parallel.collectives import (all_gather_tp, ppermute,
                                                  psum)
from distkeras_torch.parallel.mesh import current_mesh, local_mesh

# the sharded dimension of each tensor-parallel parameter, by the names
# of its module and leaf (reference: parallel/spmd.py · lm_param_specs);
# every other parameter is replicated
_TP_DIMS = {
    ("qkv", "kernel"): 2, ("qkv", "bias"): 1,            # [D,3,H,hd], [3,H,hd]
    ("q_proj", "kernel"): 1, ("q_proj", "bias"): 0,      # [D,H,hd], [H,hd]
    ("kv_proj", "kernel"): 2, ("kv_proj", "bias"): 1,    # [D,2,Hk,hd]
    ("out", "kernel"): 0,                                # [H,hd,D]
    ("mlp_up", "kernel"): 1, ("mlp_up", "bias"): 0,      # [D,F], [F]
    ("mlp_down", "kernel"): 0,                           # [F,D]
}


def tp_dim(name: str) -> Optional[int]:
    """The dimension of port parameter ``name`` (``blocks.0.mlp_up.kernel``
    or its flax path ``Block_0/mlp_up/kernel``) sharded over tp, or None
    when it is replicated (the row layers' biases are added after the
    all-reduce, so they are replicated too)."""
    parts = name.replace("/", ".").split(".")
    return _TP_DIMS.get(tuple(parts[-2:])) if len(parts) >= 2 else None


def _names(params):
    if isinstance(params, torch.nn.Module):
        return [(n, p) for n, p in params.named_parameters()]
    return list(params.items())


def lm_param_specs(params, tp_axis: Optional[str] = None) -> Dict[str, tuple]:
    """Partition specs of a :class:`TransformerLM`'s parameters (a module,
    or a mapping of port names to tensors) under tensor parallelism:
    ``{name: spec}`` where a spec names, per dimension, the mesh axis it
    is sharded over or None — ``qkv`` / ``q_proj`` / ``kv_proj`` /
    ``mlp_up`` column-sharded, ``out`` / ``mlp_down`` row-sharded over
    ``tp_axis``, everything else replicated (``()``, the reference's
    ``P()``). Built by parameter name, so it holds for the full-size
    (``tp_size=1``) parameters."""
    out = {}
    for name, leaf in _names(params):
        dim = tp_dim(name) if tp_axis is not None else None
        out[name] = (() if dim is None else tuple(
            tp_axis if i == dim else None for i in range(leaf.dim())))
    return out


def draft_param_specs(draft, tp_size: int, tp_axis: str = "model"):
    """``(specs, draft_tp)`` of a speculative-decoding draft model under
    the serving mesh (reference: parallel/spmd.py · draft_param_specs):
    sharded like the flagship (:func:`lm_param_specs`, ``draft_tp =
    tp_size``) when both its head counts divide ``tp_size``, else
    replicated (``draft_tp = 1``: every rank runs the whole draft and
    proposes the same tokens)."""
    hk = draft.num_kv_heads or draft.num_heads
    if tp_size > 1 and draft.num_heads % tp_size == 0 and hk % tp_size == 0:
        return lm_param_specs(draft, tp_axis=tp_axis), tp_size
    return lm_param_specs(draft), 1


def shard_tensor(x: torch.Tensor, dim: Optional[int], tp_rank: int,
                 tp_size: int) -> torch.Tensor:
    """Rank ``tp_rank``'s contiguous ``1/tp_size`` slice of ``x`` along
    ``dim`` (``x`` itself when ``dim`` is None or ``tp_size`` is 1)."""
    if dim is None or tp_size == 1:
        return x
    n = x.shape[dim]
    if n % tp_size:
        raise ValueError(f"dim {dim} of size {n} does not split over "
                         f"tp_size={tp_size}")
    return x.narrow(dim, tp_rank * (n // tp_size), n // tp_size).contiguous()


def shard_state(full: dict, tp_rank: int, tp_size: int) -> dict:
    """A plain (``tp_size=1``) state dict -> rank ``tp_rank``'s shard of
    it: each tensor-parallel parameter's contiguous slice, the others as
    they are."""
    return {name: shard_tensor(t, tp_dim(name), tp_rank, tp_size)
            for name, t in full.items()}


def _tp_group_of(model, mesh):
    mesh = mesh if mesh is not None else current_mesh()
    if model.tp_size == 1:
        return None
    if (mesh is None or model.tp_axis not in mesh.axis_names
            or mesh.axis_size(model.tp_axis) != model.tp_size):
        raise ValueError(
            f"gathering a tp_size={model.tp_size} model needs its mesh (one "
            f"with a '{model.tp_axis}' axis of that size): pass mesh= or "
            f"bind it with `with mesh:`")
    return mesh.group(model.tp_axis)


@torch.no_grad()
def gather_state(model, mesh=None) -> dict:
    """The plain (``tp_size=1``) state dict of a tensor-parallel model:
    every sharded parameter gathered over ``mesh``'s tp group (the bound
    mesh by default), the replicated ones as they are. Collective: every
    tp rank calls it."""
    group = _tp_group_of(model, mesh)
    return {name: (all_gather_tp(p.detach(), group, tp_dim(name))
                   if tp_dim(name) is not None else p.detach())
            for name, p in model.named_parameters()}


def _opt_param_dims(optimizer, model):
    """Per optimizer-state index, the tp dimension of its parameter."""
    dims = {id(p): tp_dim(n) for n, p in model.named_parameters()}
    flat = [p for g in optimizer.param_groups for p in g["params"]]
    return [dims.get(id(p)) for p in flat], flat


@torch.no_grad()
def gather_opt_state(optimizer, model, mesh=None) -> dict:
    """The optimizer's ``state_dict`` in the plain layout, copied to the
    host: each per-parameter state tensor of a sharded parameter (AdamW's
    moments, a momentum trace; shaped like the parameter) gathered over
    tp, in its stored dtype. Collective: every tp rank calls it."""
    group = _tp_group_of(model, mesh)
    sd = optimizer.state_dict()
    dims, flat = _opt_param_dims(optimizer, model)
    state = {}
    for i, st in sd["state"].items():
        dim, p = dims[i], flat[i]
        state[i] = {k: ((all_gather_tp(v, group, dim) if dim is not None
                         and group is not None and v.shape == p.shape
                         else v).detach().to("cpu", copy=True)
                        if isinstance(v, torch.Tensor) else v)
                    for k, v in st.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def shard_opt_state(state_dict: dict, optimizer, model) -> dict:
    """A plain-layout optimizer ``state_dict`` -> this rank's shard of it
    for ``optimizer`` over the tp ``model``'s parameters (the inverse of
    :func:`gather_opt_state`)."""
    dims, flat = _opt_param_dims(optimizer, model)
    state = {}
    for i, st in state_dict["state"].items():
        i = int(i)
        dim, p = dims[i], flat[i]
        state[i] = {k: (shard_tensor(v, dim, model.tp_rank, model.tp_size)
                        if isinstance(v, torch.Tensor) and v.dim()
                        and v.dim() == p.dim() else v)
                    for k, v in st.items()}
    return {"state": state, "param_groups": state_dict["param_groups"]}


def _next_token_targets(tokens, sp_group, sp: int, my_sp: int):
    """Targets and row weights of a ``[B_l, T_l]`` sequence shard: each
    shard's last position is supervised by the NEXT shard's first token
    (one ``ppermute`` over the sequence group; at sp=1 the shard's own
    first column), and the last global position is masked out."""
    B_l, T_l = tokens.shape
    perm = [(j, (j - 1) % sp) for j in range(sp)]
    next_first = ppermute(tokens[:, :1].contiguous(), perm, sp_group)
    targets = torch.cat([tokens[:, 1:], next_first], dim=1)
    local_pos = my_sp * T_l + torch.arange(T_l, device=tokens.device)
    mask = (local_pos < T_l * sp - 1).to(torch.float32)
    return targets, mask[None, :].expand(B_l, T_l).contiguous()


def make_lm_train_step(model, optimizer, mesh=None, window: bool = False,
                       fused_ce: bool = True, dp_axis: str = "dp",
                       sp_axis: str = "sp", tp_axis=None,
                       local_batch: bool = False):
    """The LM training step of a :class:`TransformerLM`, sharded over the
    data (``dp_axis``) and sequence (``sp_axis``) axes of ``mesh``.

    ``optimizer`` is a ``torch.optim.Optimizer`` over ``model``'s
    parameters, or a factory from
    :func:`distkeras_torch.utils.losses.get_optimizer` (bound here to
    ``model.parameters()``).

    ``mesh`` is a :func:`~distkeras_torch.parallel.mesh.make_mesh` mesh
    with an ``sp_axis`` (and optionally a ``dp_axis``); this process runs
    its position. ``None`` is the mesh of one position, which needs no
    ``torch.distributed`` world. With ``sp > 1`` the model must be built
    with ``attention='ring'`` (``seq_axis=sp_axis``), so attention is
    exact over the whole sequence while each rank holds ``T/sp`` of it.
    At the start every rank takes rank 0's parameters, so the replicas
    begin equal.

    Returns ``step(tokens) -> loss``: ``tokens`` ``[B, T]`` int ids (tensor
    or numpy), the GLOBAL batch, the same on every rank (B divisible by
    dp, T by sp); one forward/backward/optimizer step. The loss is the
    global mean next-token cross-entropy (``local_sum / psum(count)``,
    summed over the mesh), a 0-dim device tensor. With ``window=True``
    the step takes ``[W, B, T]`` and runs W optimizer steps, returning
    the ``[W]`` losses on the device — no host sync inside the window.

    ``fused_ce`` (default on) computes the loss with
    :func:`distkeras_torch.ops.fused_ce.lm_head_loss` on the
    ``features_only`` twin's output: the head product and softmax-CE run
    chunk by chunk and ``[B, T, V]`` logits never exist. Set False for
    the full-logits path.

    ``local_batch=True`` changes the feed: each rank is handed only its
    dp coordinate's ``[B/dp, T]`` rows (the disk-streaming feed, where
    each replica group reads its own stride of shards) and takes just its
    ``T/sp`` slice of them.

    ``tp_axis`` names the mesh's tensor-parallel axis: the model must be
    built with ``tp_size`` equal to its size (and this rank's coordinate
    on it, ``with mesh:``). The ranks of one dp x sp coordinate get the
    same rows; every collective of the step spans dp x sp, the model's
    own span tp.
    """
    if mesh is None:
        if getattr(model, "attention", None) == "ring":
            raise ValueError(
                "attention='ring' shards the sequence over a mesh: pass "
                f"mesh=make_mesh({{'{dp_axis}': 1, '{sp_axis}': 1}}) (or "
                f"larger)")
        mesh = local_mesh({dp_axis: 1, sp_axis: 1})
    if sp_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh {mesh.axis_names} has no '{sp_axis}' axis — the LM step "
            f"always shards the sequence over sp_axis; use a size-1 axis "
            f"for the unsharded-sequence case")
    tp = 1
    if tp_axis is not None:
        if tp_axis not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.axis_names} has no '{tp_axis}' "
                             f"axis (tp_axis)")
        tp = mesh.axis_size(tp_axis)
    if getattr(model, "tp_size", 1) != tp:
        raise ValueError(
            f"model.tp_size={getattr(model, 'tp_size', 1)} != mesh "
            f"{tp_axis} size {tp}" + ("" if tp_axis else
                                      " (pass tp_axis= for a tp model)"))
    if tp > 1 and (model.tp_axis != tp_axis
                   or model.tp_rank != mesh.index(tp_axis)):
        raise ValueError(
            f"the model holds rank {model.tp_rank}'s slices over "
            f"'{model.tp_axis}'; this process is at coordinate "
            f"{mesh.index(tp_axis)} of the mesh's '{tp_axis}' axis")
    spare = {a: n for a, n in mesh.shape.items()
             if a not in (dp_axis, sp_axis, tp_axis) and n > 1}
    if spare:
        raise ValueError(f"the LM step shards over {dp_axis}, {sp_axis} "
                         f"and tp_axis; mesh axes {spare} are not used")
    sp, my_sp = mesh.axis_size(sp_axis), mesh.index(sp_axis)
    has_dp = dp_axis in mesh.axis_names
    dp = mesh.axis_size(dp_axis) if has_dp else 1
    my_dp = mesh.index(dp_axis) if has_dp else 0
    if sp > 1 and getattr(model, "attention", None) != "ring":
        raise ValueError(
            f"sp={sp} needs the model built with attention='ring' "
            f"(seq_axis='{sp_axis}')")
    sp_group = mesh.group(sp_axis)
    # the dp x sp group through this rank: its tp coordinate fixed
    all_group = mesh.group(*((dp_axis, sp_axis) if has_dp else (sp_axis,)))
    if not isinstance(optimizer, torch.optim.Optimizer):
        optimizer = optimizer(model.parameters())
    params = list(model.parameters())
    if all_group is not None:
        with torch.no_grad():
            for p in params:
                dist.broadcast(p, dist.get_global_rank(all_group, 0),
                               group=all_group)
    feat_model = model.clone(features_only=True) if fused_ce else None
    head = {"kernel": model.head.kernel, "bias": model.head.bias}
    dev = model.device

    def shard(tokens):
        B, T = tokens.shape
        rows = 1 if local_batch else dp
        if B % rows or T % sp:
            raise ValueError(f"batch [{B}, {T}] does not split over "
                             f"dp={rows} x sp={sp}")
        b, t = B // rows, T // sp
        r0 = 0 if local_batch else my_dp * b
        return tokens[r0:r0 + b, my_sp * t:(my_sp + 1) * t]

    def batch_update(tokens):
        tokens = shard(tokens)
        targets, mask = _next_token_targets(tokens, sp_group, sp, my_sp)
        optimizer.zero_grad(set_to_none=True)
        with mesh:
            if fused_ce:
                feats = feat_model(tokens)
                local_sum, count = lm_head_loss(feats, head, targets, mask)
            else:
                logits = model(tokens)
                token_loss = F.cross_entropy(
                    logits.reshape(-1, logits.shape[-1]),
                    targets.reshape(-1), reduction="none")
                local_sum = (token_loss * mask.reshape(-1)).sum()
                count = mask.sum()
        # the local objective sums to the global mean over dp x sp, so
        # the gradients summed over dp x sp are the global gradient (every
        # tp rank's is already whole: summing it over tp would scale it)
        local_obj = local_sum / psum(count.detach(), all_group)
        local_obj.backward()
        if all_group is not None:
            for p in params:
                if p.grad is not None:
                    dist.all_reduce(p.grad, group=all_group)
        optimizer.step()
        return psum(local_obj.detach(), all_group)

    def as_tokens(tokens):
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=dev, dtype=torch.long)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=dev)

    if window:
        def step(tokens):
            tokens = as_tokens(tokens)
            if tokens.dim() != 3:
                raise ValueError(f"window step takes [W, B, T] tokens; got "
                                 f"{tuple(tokens.shape)}")
            return torch.stack([batch_update(t) for t in tokens])
    else:
        def step(tokens):
            tokens = as_tokens(tokens)
            if tokens.dim() != 2:
                raise ValueError(f"step takes [B, T] tokens; got "
                                 f"{tuple(tokens.shape)}")
            return batch_update(tokens)

    return step
