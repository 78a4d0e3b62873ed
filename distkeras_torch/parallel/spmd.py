"""The SPMD training steps — the port of
:mod:`distkeras_tpu.parallel.spmd`: the data-parallel step of any model
(:func:`make_dp_train_step`), the language-model step
(:func:`make_lm_train_step`) and the MoE step.

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

Expert parallelism (:func:`make_moe_lm_train_step`): a :class:`MoeLM`
whose expert banks are sharded over ``ep`` (each rank holds ``E/ep``
experts, leading axis) trains on a (dp, ep) mesh, the batch sharded over
dp x ep jointly; the replicated parameters' gradients are summed over
dp x ep and the experts' over dp only.

Every step sums its gradients with
:func:`~distkeras_torch.parallel.collectives.reduce_grads`: one
``all_reduce`` a flat per-dtype bucket of at most
``GRAD_BUCKET_BYTES``, the port's form of the reference's one ``psum``
over the gradient tree.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from distkeras_torch.ops.fused_ce import lm_head_loss
from distkeras_torch.parallel.collectives import (all_gather_tp, ppermute,
                                                  psum, reduce_grads)
from distkeras_torch.parallel.mesh import current_mesh, local_mesh
from distkeras_torch.workers import _bind, _step_fn

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


# the expert banks of a SwitchMoE, sharded over ep along their leading
# (expert) axis; its router is replicated
_EP_LEAVES = ("w1", "b1", "w2", "b2")


def tp_dim(name: str) -> Optional[int]:
    """The dimension of port parameter ``name`` (``blocks.0.mlp_up.kernel``
    or its flax path ``Block_0/mlp_up/kernel``) sharded over tp, or None
    when it is replicated (the row layers' biases are added after the
    all-reduce, so they are replicated too)."""
    parts = name.replace("/", ".").split(".")
    return _TP_DIMS.get(tuple(parts[-2:])) if len(parts) >= 2 else None


def ep_dim(name: str) -> Optional[int]:
    """0 for an expert bank (``blocks.0.moe.w1`` or ``Block_0/moe/w1``:
    sharded over ep along its leading expert axis), else None."""
    parts = name.replace("/", ".").split(".")
    return (0 if len(parts) >= 2 and parts[-2] == "moe"
            and parts[-1] in _EP_LEAVES else None)


def _sharded(model):
    """``[(dim_fn, size, rank, axis)]``: the axes ``model``'s parameters
    are sharded over (tp, ep), those of size > 1."""
    out = []
    if getattr(model, "tp_size", 1) > 1:
        out.append((tp_dim, model.tp_size, model.tp_rank, model.tp_axis))
    if getattr(model, "ep_size", 1) > 1:
        out.append((ep_dim, model.ep_size, model.ep_rank, model.ep_axis))
    return out


def _names(params):
    if isinstance(params, torch.nn.Module):
        return [(n, p) for n, p in params.named_parameters()]
    return list(params.items())


def lm_param_specs(params, tp_axis: Optional[str] = None,
                   ep_axis: Optional[str] = None) -> Dict[str, tuple]:
    """Partition specs of a :class:`TransformerLM`'s parameters (a module,
    or a mapping of port names to tensors) under tensor and expert
    parallelism: ``{name: spec}`` where a spec names, per dimension, the
    mesh axis it is sharded over or None — ``qkv`` / ``q_proj`` /
    ``kv_proj`` / ``mlp_up`` column-sharded, ``out`` / ``mlp_down``
    row-sharded over ``tp_axis``, the SwitchMoE expert banks (``w1``,
    ``b1``, ``w2``, ``b2``) leading-axis-sharded over ``ep_axis`` (the
    router replicated), everything else replicated (``()``, the
    reference's ``P()``). Built by parameter name, so it holds for the
    full-size (``tp_size=1``, ``ep_size=1``) parameters."""
    out = {}
    for name, leaf in _names(params):
        dim = tp_dim(name) if tp_axis is not None else None
        axis = tp_axis
        if dim is None and ep_axis is not None:
            dim, axis = ep_dim(name), ep_axis
        out[name] = (() if dim is None else tuple(
            axis if i == dim else None for i in range(leaf.dim())))
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


def shard_state(full: dict, tp_rank: int, tp_size: int, ep_rank: int = 0,
                ep_size: int = 1) -> dict:
    """A plain (``tp_size=1``, ``ep_size=1``) state dict -> the shard of
    rank ``tp_rank`` of tp and ``ep_rank`` of ep: each tensor-parallel
    parameter's contiguous slice, each expert bank's slice of experts,
    the others as they are."""
    return {name: shard_tensor(shard_tensor(t, tp_dim(name), tp_rank,
                                            tp_size),
                               ep_dim(name), ep_rank, ep_size)
            for name, t in full.items()}


def _groups_of(model, mesh):
    """``[(dim_fn, group)]`` of the axes a sharded model's parameters are
    split over, from ``mesh`` (the bound mesh by default)."""
    mesh = mesh if mesh is not None else current_mesh()
    out = []
    for dim_fn, size, _, axis in _sharded(model):
        if (mesh is None or axis not in mesh.axis_names
                or mesh.axis_size(axis) != size):
            raise ValueError(
                f"gathering a model sharded {size} ways over '{axis}' needs "
                f"its mesh (one with a '{axis}' axis of that size): pass "
                f"mesh= or bind it with `with mesh:`")
        out.append((dim_fn, mesh.group(axis)))
    return out


def _gather_dim(name, groups):
    """``(dim, group)`` a parameter named ``name`` is gathered along, or
    None when it is whole on every rank."""
    for dim_fn, group in groups:
        if dim_fn(name) is not None:
            return dim_fn(name), group
    return None


@torch.no_grad()
def gather_state(model, mesh=None) -> dict:
    """The plain (``tp_size=1``, ``ep_size=1``) state dict of a sharded
    model: every tp-sharded parameter gathered over ``mesh``'s tp group
    and every expert bank over its ep group (the bound mesh by default),
    the replicated ones as they are. Collective: every rank of those
    groups calls it."""
    groups = _groups_of(model, mesh)
    out = {}
    for name, p in model.named_parameters():
        at = _gather_dim(name, groups)
        out[name] = (all_gather_tp(p.detach(), at[1], at[0]) if at
                     else p.detach())
    return out


def _opt_params(optimizer, model):
    """Per optimizer-state index: its parameter and that parameter's
    name in ``model``."""
    names = {id(p): n for n, p in model.named_parameters()}
    flat = [p for g in optimizer.param_groups for p in g["params"]]
    return [(p, names.get(id(p), "")) for p in flat]


@torch.no_grad()
def gather_opt_state(optimizer, model, mesh=None) -> dict:
    """The optimizer's ``state_dict`` in the plain layout, copied to the
    host: each per-parameter state tensor of a sharded parameter (AdamW's
    moments, a momentum trace; shaped like the parameter) gathered over
    tp or ep, in its stored dtype. Collective: every rank of those groups
    calls it."""
    groups = _groups_of(model, mesh)
    sd = optimizer.state_dict()
    params = _opt_params(optimizer, model)
    state = {}
    for i, st in sd["state"].items():
        p, name = params[i]
        at = _gather_dim(name, groups)
        state[i] = {k: ((all_gather_tp(v, at[1], at[0]) if at
                         and v.shape == p.shape else v
                         ).detach().to("cpu", copy=True)
                        if isinstance(v, torch.Tensor) else v)
                    for k, v in st.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def shard_opt_state(state_dict: dict, optimizer, model) -> dict:
    """A plain-layout optimizer ``state_dict`` -> this rank's shard of it
    for ``optimizer`` over the sharded ``model``'s parameters (the
    inverse of :func:`gather_opt_state`)."""
    params = _opt_params(optimizer, model)
    shardings = _sharded(model)
    state = {}
    for i, st in state_dict["state"].items():
        i = int(i)
        p, name = params[i]

        def cut(v):
            for dim_fn, size, rank, _ in shardings:
                v = shard_tensor(v, dim_fn(name), rank, size)
            return v

        state[i] = {k: (cut(v) if isinstance(v, torch.Tensor) and v.dim()
                        and v.dim() == p.dim() else v)
                    for k, v in st.items()}
    return {"state": state, "param_groups": state_dict["param_groups"]}


def make_dp_train_step(module, loss_fn, optimizer, mesh=None,
                       dp_axis: str = "dp"):
    """The synchronous data-parallel step of any model (reference:
    parallel/spmd.py · make_dp_train_step): the batch split over
    ``dp_axis``, the parameters replicated, the gradients' global mean,
    one optimizer update.

    ``optimizer`` is a ``torch.optim.Optimizer`` over ``module``'s
    parameters or a :func:`~distkeras_torch.utils.losses.get_optimizer`
    factory; ``loss_fn(logits, y)`` a scalar (:func:`get_loss`).
    ``mesh`` is a :func:`~distkeras_torch.parallel.mesh.make_mesh` mesh
    with a ``dp_axis`` (:func:`~distkeras_torch.parallel.mesh.
    default_mesh`); this process runs its position. ``None`` is the mesh
    of one position. Every replica starts from the mesh's first rank's
    parameters; the mesh's other axes get the same rows (the reference's
    batch is replicated over them).

    Returns ``step(x, y) -> loss``: ``x`` and ``y`` (tensors or numpy)
    the GLOBAL batch, the same on every rank, its rows divisible by dp;
    rank ``i`` of dp trains on rows ``[i B/dp, (i+1) B/dp)``. One forward
    and backward, the gradients averaged over dp (one all-reduce of
    them flattened, :func:`distkeras_torch.workers.make_window_step`'s),
    one ``optimizer.step()``: ``module`` is updated in place. The loss
    is the mean of the ranks' local losses (``pmean``), a 0-dim device
    tensor."""
    if mesh is None:
        mesh = local_mesh({dp_axis: 1})
    if dp_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no '{dp_axis}' axis "
                         f"(dp_axis)")
    dp, my_dp = mesh.axis_size(dp_axis), mesh.index(dp_axis)
    group = mesh.group(dp_axis)
    optimizer = _bind(module, optimizer, mesh.group())
    core = _step_fn(module, loss_fn, optimizer, (), group)
    dev = next(module.parameters()).device

    def step(x, y):
        x, y = (torch.as_tensor(a if isinstance(a, torch.Tensor)
                                else np.asarray(a), device=dev)
                for a in (x, y))
        B = x.shape[0]
        if B % dp or y.shape[0] != B:
            raise ValueError(f"batch of {B} rows (labels {y.shape[0]}) "
                             f"does not split over {dp_axis}={dp}")
        b = B // dp
        rows = slice(my_dp * b, (my_dp + 1) * b)
        loss = core(x[rows], y[rows])[0]
        return psum(loss, group) / dp if dp > 1 else loss

    return step


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

    The gradients are summed over dp x sp in flat buckets
    (:func:`~distkeras_torch.parallel.collectives.reduce_grads`).
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
    broadcast_params(params, all_group)
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
        reduce_grads(params, all_group)
        optimizer.step()
        return psum(local_obj.detach(), all_group)

    return stepper(batch_update, dev, "B, T", window)


def stepper(batch_update, dev, dims: str, window: bool):
    """``step(tokens)`` of a training step: ``batch_update`` on one batch
    of token ids (tensor or numpy) shaped ``[<dims>]``, or with
    ``window`` on each of ``[W, <dims>]``, its losses stacked on the
    device (no host sync inside the window)."""
    shape = f"[W, {dims}]" if window else f"[{dims}]"
    rank = dims.count(",") + 1 + int(window)

    def step(tokens):
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.to(device=dev, dtype=torch.long)
        else:
            tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                     device=dev)
        if tokens.dim() != rank:
            raise ValueError(f"the step takes {shape} tokens; got "
                             f"{tuple(tokens.shape)}")
        if window:
            return torch.stack([batch_update(t) for t in tokens])
        return batch_update(tokens)

    return step


@torch.no_grad()
def broadcast_params(params, group) -> None:
    """Every rank of ``group`` takes the group's first rank's values of
    ``params`` (nothing in a group of one)."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    for p in params:
        dist.broadcast(p, src, group=group)


def make_moe_lm_train_step(model, optimizer, mesh=None, dp_axis: str = "dp",
                           ep_axis: str = "ep", aux_weight: float = 0.01,
                           window: bool = False, local_batch: bool = False):
    """The MoE language-model step over a (dp, ep) mesh — the port of
    the reference's ``make_moe_lm_train_step``.

    ``model`` is a :class:`~distkeras_torch.models.transformer.MoeLM` (or
    a ``TransformerLM`` with ``moe_experts``) whose ``ep_size`` equals the
    mesh's ``ep_axis`` size, built inside ``with mesh:`` when it is > 1
    (each rank holds its ``E/ep`` experts); ``tp_size`` must be 1. The
    batch is sharded over dp and ep jointly (row block ``dp_index * ep +
    ep_index`` of the global batch each rank is handed, the reference's
    ``P((dp, ep))``), so every rank carries its own tokens and its slice
    of the expert banks; tokens cross ranks inside the model through the
    two all-to-all exchanges of each MoE layer.

    The objective of each rank is its local mean next-token
    cross-entropy (full logits ``[:, :-1]`` against ``[:, 1:]``) plus
    ``aux_weight`` x the mean Switch aux over its layers. Gradient
    reductions: the replicated parameters summed over dp x ep, the
    expert banks over dp only (this rank's ep coordinate: summing them
    over ep would add different experts together), then every gradient
    scaled by ``1 / (dp * ep)`` — the gradient of the mean objective.
    The loss returned is the mean of the local cross-entropies.

    ``optimizer`` is a factory from
    :func:`distkeras_torch.utils.losses.get_optimizer` or an optimizer
    over ``model.parameters()``. ``mesh=None`` is the mesh of one
    position. Returns ``step(tokens) -> loss`` (``[B, T]``, the global
    batch, the same on every rank; ``local_batch=True``: this rank's dp
    coordinate's ``[B/dp, T]`` rows); ``window=True`` takes ``[W, B, T]``
    and returns the ``[W]`` losses on the device.
    """
    if mesh is None:
        mesh = local_mesh({dp_axis: 1, ep_axis: 1})
    if not getattr(model, "moe_experts", 0):
        raise ValueError("the MoE step takes a model with moe_experts > 0 "
                         "(get_model('moe_lm', ...))")
    if ep_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no '{ep_axis}' axis")
    ep = mesh.axis_size(ep_axis)
    if model.ep_size != ep:
        raise ValueError(f"model.ep_size={model.ep_size} != mesh {ep_axis} "
                         f"size {ep}")
    if getattr(model, "tp_size", 1) != 1:
        raise ValueError("the MoE step shards ep only; build the model "
                         "with tp_size=1 (tp x ep composition is not "
                         "supported here)")
    spare = {a: n for a, n in mesh.shape.items()
             if a not in (dp_axis, ep_axis) and n > 1}
    if spare:
        raise ValueError(f"the MoE step shards over {dp_axis} and "
                         f"{ep_axis}; mesh axes {spare} are not used")
    if ep > 1 and model.ep_rank != mesh.index(ep_axis):
        raise ValueError(
            f"the model holds rank {model.ep_rank}'s experts; this process "
            f"is at coordinate {mesh.index(ep_axis)} of '{ep_axis}'")
    has_dp = dp_axis in mesh.axis_names
    dp = mesh.axis_size(dp_axis) if has_dp else 1
    my_dp = mesh.index(dp_axis) if has_dp else 0
    my_ep = mesh.index(ep_axis)
    n_shards = dp * ep
    all_group = mesh.group(*((dp_axis, ep_axis) if has_dp else (ep_axis,)))
    dp_group = mesh.group(dp_axis) if has_dp else None
    if not isinstance(optimizer, torch.optim.Optimizer):
        optimizer = optimizer(model.parameters())
    named = list(model.named_parameters())
    experts = [p for n, p in named if ep_dim(n) is not None]
    replicated = [p for n, p in named if ep_dim(n) is None]
    broadcast_params(replicated, all_group)
    broadcast_params(experts, dp_group)
    dev = model.device

    def shard(tokens):
        B = tokens.shape[0]
        rows = ep if local_batch else n_shards
        if B % rows:
            raise ValueError(f"batch of {B} rows does not split over "
                             f"{'ep' if local_batch else 'dp x ep'}={rows}")
        b = B // rows
        j = my_ep if local_batch else my_dp * ep + my_ep
        return tokens[j * b:(j + 1) * b]

    def batch_update(tokens):
        tokens = shard(tokens)
        optimizer.zero_grad(set_to_none=True)
        with mesh:
            logits, auxes = model(tokens, return_aux=True)
        V = logits.shape[-1]
        ce = F.cross_entropy(logits[:, :-1].reshape(-1, V),
                             tokens[:, 1:].reshape(-1))
        aux = sum(auxes) / max(len(auxes), 1)
        (ce + aux_weight * aux).backward()
        reduce_grads(replicated, all_group)
        reduce_grads(experts, dp_group)
        if n_shards > 1:
            with torch.no_grad():
                torch._foreach_mul_([p.grad for _, p in named
                                     if p.grad is not None], 1.0 / n_shards)
        optimizer.step()
        return psum(ce.detach(), all_group) / n_shards

    return stepper(batch_update, dev, "B, T", window)
