"""Pipeline parallelism (pp), GPipe microbatches — the port of
:mod:`distkeras_tpu.parallel.pipeline`.

The layer stack of a :class:`~distkeras_torch.models.transformer.
TransformerLM` is split into ``pp`` contiguous stages, one a process
along the mesh's ``pp`` axis: stage ``s`` holds blocks ``[s L/pp, (s+1)
L/pp)`` (:class:`PipelineStage`, its blocks named by their global index,
so the plain layout maps back by name) and the replicated embedding,
final norm and head. Microbatches flow stage to stage with one
``ppermute`` of the carry a tick: ``M`` microbatches run ``M + pp - 1``
ticks (the GPipe bubble ``(pp - 1) / (M + pp - 1)``), and the backward
falls out of autograd, whose transpose of the ``ppermute`` is the
reverse rotation.

The reference's data chain is kept: every rank's carry requires grad
from tick 0 on, and stage ``s``'s input is ``where(s == 0, feed,
prev)``, so every tick's permute output feeds the next tick on every
rank and every rank's backward issues the same permutes in the same
order. Where the reference computes every tick on every stage and masks
what the bubble produces (one SPMD program), here a stage runs its
blocks only at the ticks that hold one of its microbatches and passes
its input on unchanged in the bubble, the first stage alone embeds, and
the last alone runs the head and the loss: the same values at every
tick that reaches the loss, which stays ``psum_pp(ce_sum) / (M * B_l *
(T - 1))``.

Composes with dp (each microbatch's rows sharded over dp) and tp (each
stage's blocks the model's tensor-parallel blocks).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from distkeras_torch.models.transformer import remat_block
from distkeras_torch.parallel.collectives import (all_gather_tp, ppermute,
                                                  psum, reduce_grads)
from distkeras_torch.parallel.spmd import (broadcast_params, lm_param_specs,
                                           shard_tensor, stepper, tp_dim)


def _block_index(name: str) -> Optional[int]:
    parts = name.split(".")
    return int(parts[1]) if parts[0] == "blocks" else None


def to_pipeline_params(state: Dict[str, torch.Tensor], num_layers: int):
    """A plain state dict (port names) -> ``{'blocks': {leaf: stacked
    [L, ...]}, 'rest': {name: tensor}}``: each block leaf stacked over the
    layers (the layout that shards over ``pp`` along its leading axis),
    the embedding, final norm and head under ``rest``."""
    blocks: Dict[str, list] = {}
    rest = {}
    for name, t in state.items():
        i = _block_index(name)
        if i is None:
            rest[name] = t
        else:
            leaf = name.split(".", 2)[2]
            blocks.setdefault(leaf, [None] * num_layers)[i] = t
    return {"blocks": {k: torch.stack(v) for k, v in blocks.items()},
            "rest": rest}


def from_pipeline_params(pp_state, num_layers: int) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`to_pipeline_params`: the plain state dict."""
    out = dict(pp_state["rest"])
    for leaf, stacked in pp_state["blocks"].items():
        for i in range(num_layers):
            out[f"blocks.{i}.{leaf}"] = stacked[i]
    return out


def pipeline_param_specs(template, pp_axis: str = "pp",
                         tp_axis: Optional[str] = None):
    """Specs of the pipeline layout: stacked blocks lead with ``pp_axis``
    (with ``tp_axis``, the per-layer feature dims shard Megatron-style
    as :func:`~distkeras_torch.parallel.spmd.lm_param_specs` says, one
    axis right of the stack); ``rest`` replicated."""
    blocks = {}
    for leaf, stacked in template["blocks"].items():
        inner = ()
        if tp_axis is not None:
            inner = lm_param_specs({leaf: stacked[0]}, tp_axis)[leaf]
        if not inner:
            inner = (None,) * (stacked.dim() - 1)
        blocks[leaf] = (pp_axis,) + tuple(inner)
    return {"blocks": blocks, "rest": {k: () for k in template["rest"]}}


def stage_layers(num_layers: int, pp: int, stage: int) -> range:
    """The global indices of stage ``stage``'s blocks."""
    if num_layers % pp:
        raise ValueError(f"num_layers={num_layers} not divisible by pp={pp}")
    n = num_layers // pp
    return range(stage * n, (stage + 1) * n)


class PipelineStage(nn.Module):
    """One pipeline stage of a :class:`TransformerLM`: its blocks
    ``blocks[str(i)]`` for the stage's global indices ``i`` and the
    replicated ``embed``, ``ln_f`` and ``head`` — the model's own
    modules, shared (parameter names equal the model's)."""

    def __init__(self, model, stage: int, pp: int):
        super().__init__()
        self.stage, self.pp = stage, pp
        self.layers = stage_layers(model.num_layers, pp, stage)
        self.embed, self.ln_f, self.head = model.embed, model.ln_f, model.head
        self.blocks = nn.ModuleDict({str(i): model.blocks[i]
                                     for i in self.layers})
        self._cfg = (model,)  # read by the blocks; not a submodule

    def embed_tokens(self, tokens):
        """The first stage's input: embeddings plus sinusoidal positions
        (rope positions live inside attention)."""
        m = self._cfg[0]
        x = self.embed(tokens)
        if m.pos_emb != "rope":
            x = x + m.pos_table[:tokens.shape[1]].to(m.dtype)
        return x

    def forward(self, x):
        """The stage's blocks (each recomputed in the backward under
        ``remat='block'``)."""
        m = self._cfg[0]
        for block in self.blocks.values():
            if m.remat == "block" and torch.is_grad_enabled():
                x, _ = remat_block(block, x, m)
            else:
                x, _ = block(x, m)
        return x

    def ce_sum(self, x, tokens):
        """The last stage's summed next-token cross-entropy of one
        microbatch (full logits ``[:, :-1]`` against ``[:, 1:]``)."""
        logits = self.head(self.ln_f(x))
        V = logits.shape[-1]
        return F.cross_entropy(logits[:, :-1].reshape(-1, V),
                               tokens[:, 1:].reshape(-1), reduction="sum")

    def rest_parameters(self):
        return [p for n, p in self.named_parameters()
                if _block_index(n) is None]

    def block_parameters(self):
        return [p for n, p in self.named_parameters()
                if _block_index(n) is not None]


def check_pp_model(model, pp: int, tp: int = 1) -> None:
    """The reference's refusals of a pipeline run at ``pp`` stages and tp
    size ``tp``: a ring or MoE model, ``num_layers % pp``, a model whose
    ``tp_size`` is not ``tp``. Needs no mesh (the trainer refuses before
    it builds one)."""
    if model.num_layers % pp:
        raise ValueError(f"num_layers={model.num_layers} not divisible by "
                         f"pp={pp}")
    if model.attention == "ring" or getattr(model, "moe_experts", 0) > 0:
        raise ValueError(
            "pipeline step takes a plain TransformerLM (non-ring attention, "
            "no MoE); it composes with dp and tp only")
    if getattr(model, "tp_size", 1) != tp:
        raise ValueError(
            f"model.tp_size={getattr(model, 'tp_size', 1)} != mesh tp size "
            f"{tp} — build the model with tp_size={tp}")


def make_pp_lm_train_step(model, optimizer, mesh, pp_axis: str = "pp",
                          dp_axis: str = "dp", tp_axis: Optional[str] = None,
                          window: bool = False, local_batch: bool = False):
    """The pipeline-parallel LM step over a (dp, pp[, tp]) mesh — the port
    of the reference's ``make_pp_lm_train_step``.

    ``model`` is a :class:`TransformerLM` (non-ring attention, no MoE)
    whose ``num_layers`` divides the mesh's pp size; with ``tp_axis`` its
    ``tp_size`` equals that axis's size (built inside ``with mesh:``),
    and each stage's blocks run Megatron tensor-parallel. This process
    trains its stage (a :class:`PipelineStage`, ``step.stage``):
    ``optimizer`` is a factory from
    :func:`distkeras_torch.utils.losses.get_optimizer` (bound here to the
    stage's parameters) or an optimizer over them (``step.optimizer``).
    The storage of the other stages' blocks in ``model`` is freed
    (:func:`release_blocks`), so each rank holds ``L/pp`` blocks;
    :func:`sync_blocks` makes the model whole again.

    Returns ``step(tokens) -> loss``: ``tokens`` ``[M, B, T]``, M
    microbatches of the global batch (the same on every rank; dp shards
    the B rows; ``local_batch=True``: this dp coordinate's ``[M, B/dp,
    T]``). The loss is the global mean next-token cross-entropy, a 0-dim
    device tensor; ``window=True`` takes ``[W, M, B, T]`` and returns the
    ``[W]`` losses. Gradients: the blocks' summed over dp, the replicated
    embedding, final norm and head over pp x dp (each stage's replica
    then takes the same update), then all scaled by ``1/dp``.
    """
    if pp_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no '{pp_axis}' axis")
    pp = mesh.axis_size(pp_axis)
    check_pp_model(model, pp,
                   mesh.axis_size(tp_axis) if tp_axis is not None else 1)
    if tp_axis is not None and (model.tp_axis != tp_axis or
                                model.tp_rank != mesh.index(tp_axis)):
        raise ValueError(
            f"the model holds rank {model.tp_rank}'s slices over "
            f"'{model.tp_axis}'; this process is at coordinate "
            f"{mesh.index(tp_axis)} of the mesh's '{tp_axis}' axis")
    spare = {a: n for a, n in mesh.shape.items()
             if a not in (dp_axis, pp_axis, tp_axis) and n > 1}
    if spare:
        raise ValueError(f"the pipeline step shards over {dp_axis}, "
                         f"{pp_axis} and tp_axis; mesh axes {spare} are "
                         f"not used")
    stage = PipelineStage(model, mesh.index(pp_axis), pp)
    my = stage.stage
    has_dp = dp_axis in mesh.axis_names
    dp = mesh.axis_size(dp_axis) if has_dp else 1
    my_dp = mesh.index(dp_axis) if has_dp else 0
    pp_group = mesh.group(pp_axis)
    dp_group = mesh.group(dp_axis) if has_dp else None
    rest_group = mesh.group(*((dp_axis, pp_axis) if has_dp else (pp_axis,)))
    if not isinstance(optimizer, torch.optim.Optimizer):
        optimizer = optimizer(stage.parameters())
    blocks, rest = stage.block_parameters(), stage.rest_parameters()
    broadcast_params(blocks, dp_group)
    broadcast_params(rest, rest_group)
    release_blocks(model, stage.layers)
    dev, D = model.device, model.d_model
    perm = [(d, (d + 1) % pp) for d in range(pp)]
    first = torch.ones((), dtype=torch.bool, device=dev)

    def shard(tokens):
        M, B, T = tokens.shape
        if local_batch:
            return tokens
        if B % dp:
            raise ValueError(f"microbatch of {B} rows does not split over "
                             f"dp={dp}")
        b = B // dp
        return tokens[:, my_dp * b:(my_dp + 1) * b]

    def batch_update(tokens):
        toks = shard(tokens)
        M, b, T = toks.shape
        optimizer.zero_grad(set_to_none=True)
        # every rank's carry requires grad from tick 0 on, so every
        # tick's permute has a backward on every rank
        x = torch.zeros((b, T, D), dtype=model.dtype, device=dev,
                        requires_grad=True)
        ce_sum = torch.zeros((), dtype=torch.float32, device=dev)
        with mesh:
            for t in range(M + pp - 1):
                prev = ppermute(x, perm, pp_group)
                # this stage holds microbatch t - my at tick t, if any
                if not 0 <= t - my < M:
                    x = prev  # the bubble: nothing to compute
                    continue
                x_in = prev
                if my == 0:
                    x_in = torch.where(first, stage.embed_tokens(toks[t]),
                                       prev)
                x = stage(x_in)
                if my == pp - 1:
                    ce_sum = ce_sum + stage.ce_sum(x, toks[t - (pp - 1)])
            local = ce_sum / (M * b * (T - 1))
            # the last carry's cotangent is zero; it reaches every
            # permute of the chain
            outs, grads = [x], [torch.zeros_like(x)]
            if my == pp - 1:
                outs.append(local)
                grads.append(torch.ones_like(local))
            torch.autograd.backward(outs, grads)
        reduce_grads(blocks, dp_group)
        reduce_grads(rest, rest_group)
        if dp > 1:
            with torch.no_grad():
                torch._foreach_mul_([p.grad for p in stage.parameters()
                                     if p.grad is not None], 1.0 / dp)
        optimizer.step()
        return psum(local.detach(), rest_group) / dp

    step = stepper(batch_update, dev, "M, B, T", window)
    step.stage, step.optimizer = stage, optimizer
    return step


def _pp_owner(model, mesh, pp_axis):
    pp_group = mesh.group(pp_axis)
    n = model.num_layers // mesh.axis_size(pp_axis)

    def src(i):
        return dist.get_global_rank(pp_group, i // n)

    return pp_group, n, src


@torch.no_grad()
def release_blocks(model, layers) -> None:
    """Free the storage of every block of ``model`` outside ``layers``
    (the global indices of this rank's stage): their parameters become
    empty tensors, so a rank holds ``L/pp`` blocks, until
    :func:`sync_blocks` makes the model whole again."""
    for i, block in enumerate(model.blocks):
        if i not in layers:
            for p in block.parameters():
                p.data = p.data.new_empty(0)


@torch.no_grad()
def sync_blocks(model, mesh, pp_axis: str = "pp") -> None:
    """Every rank's ``model`` takes each block from the stage that trains
    it (one broadcast a block parameter over the pp group; a block that
    :func:`release_blocks` freed is allocated again, shaped after this
    rank's own block at the same depth in its stage): afterwards the
    model is whole on every rank. Collective over pp."""
    pp_group, n, src = _pp_owner(model, mesh, pp_axis)
    if pp_group is None:
        return
    lo = mesh.index(pp_axis) * n
    for i, block in enumerate(model.blocks):
        mine = model.blocks[lo + i % n].parameters()
        for p, like in zip(block.parameters(), mine):
            if p.shape != like.shape:
                p.data = torch.empty_like(like)
            dist.broadcast(p, src(i), group=pp_group)


def _by_name(optimizer, stage):
    names = {id(p): n for n, p in stage.named_parameters()}
    flat = [p for g in optimizer.param_groups for p in g["params"]]
    sd = optimizer.state_dict()
    return {names[id(flat[i])]: st for i, st in sd["state"].items()}, sd


@torch.no_grad()
def gather_pp_opt_state(optimizer, stage: PipelineStage, model, mesh,
                        pp_axis: str = "pp") -> dict:
    """The stage optimizer's state in the plain layout of ``model`` (the
    indices of ``model.parameters()``, on the host): each block's state
    broadcast from the stage that trains it (shaped after this rank's
    own block at the same depth in its stage), the replicated leaves'
    from this rank, and with tp the sharded state gathered. Collective
    over pp (and tp)."""
    local, sd = _by_name(optimizer, stage)
    pp_group, n, src = _pp_owner(model, mesh, pp_axis)
    tp_group = (mesh.group(model.tp_axis) if model.tp_size > 1 else None)
    lo = stage.layers.start
    names = [nm for nm, _ in model.named_parameters()]
    own = dict(stage.named_parameters())
    state = {}
    for idx, name in enumerate(names):
        i = _block_index(name)
        mine = (name if i is None
                else f"blocks.{lo + i % n}.{name.split('.', 2)[2]}")
        st = local.get(mine)
        if st is not None and i is not None:
            st = dict(st)
            for k, v in st.items():
                if isinstance(v, torch.Tensor):
                    v = v.clone()
                    if pp_group is not None:
                        dist.broadcast(v, src(i), group=pp_group)
                    st[k] = v
        if st is None:
            continue
        dim = tp_dim(name)
        state[idx] = {k: ((all_gather_tp(v, tp_group, dim)
                           if dim is not None and tp_group is not None
                           and v.shape == own[mine].shape else v)
                          .detach().to("cpu", copy=True)
                          if isinstance(v, torch.Tensor) else v)
                      for k, v in st.items()}
    group = dict(sd["param_groups"][0], params=list(range(len(names))))
    return {"state": state, "param_groups": [group]}


def shard_pp_opt_state(state_dict: dict, optimizer, stage: PipelineStage,
                       model) -> dict:
    """A plain-layout optimizer ``state_dict`` (indices of
    ``model.parameters()``, tensors of the unsharded shapes) -> the state
    of ``optimizer`` over this rank's stage (the inverse of
    :func:`gather_pp_opt_state`)."""
    full = {nm: i for i, (nm, _) in enumerate(model.named_parameters())}
    names = {id(p): nm for nm, p in stage.named_parameters()}
    flat = [p for g in optimizer.param_groups for p in g["params"]]
    saved = {int(k): v for k, v in state_dict["state"].items()}
    state = {}
    for j, p in enumerate(flat):
        name = names[id(p)]
        st = saved.get(full[name])
        if st is None:
            continue
        dim = tp_dim(name) if model.tp_size > 1 else None
        state[j] = {k: (shard_tensor(v, dim, model.tp_rank, model.tp_size)
                        if isinstance(v, torch.Tensor) and v.dim()
                        and v.dim() == p.dim() else v)
                    for k, v in st.items()}
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}
