"""The language-model training step — the port of
:func:`distkeras_tpu.parallel.spmd.make_lm_train_step`.

The reference jits one program over a dp x sp (x tp) mesh and threads
params and optimizer state through it (donated). Here each mesh position
is one process (:mod:`distkeras_torch.parallel.mesh`) holding a full
replica of the parameters, which the optimizer updates in place, so the
step is ``step(tokens) -> loss``. Every rank is handed the same global
batch and takes its own ``[B/dp, T/sp]`` shard of it; after the backward
each gradient is summed over the whole mesh (the port's form of
``shard_map``'s transpose for replicated parameters), so every replica
takes the same update. Tensor parallelism (``tp_axis``) raises
(ROADMAP A10).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from distkeras_torch.ops.fused_ce import lm_head_loss
from distkeras_torch.parallel.collectives import ppermute, psum
from distkeras_torch.parallel.mesh import local_mesh


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
                       sp_axis: str = "sp", tp_axis=None):
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
    """
    if tp_axis is not None:
        raise NotImplementedError(
            "tensor parallelism in the LM step (tp_axis) is not ported yet "
            "(ROADMAP A10)")
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
    sp, my_sp = mesh.axis_size(sp_axis), mesh.index(sp_axis)
    has_dp = dp_axis in mesh.axis_names
    dp = mesh.axis_size(dp_axis) if has_dp else 1
    my_dp = mesh.index(dp_axis) if has_dp else 0
    if sp > 1 and getattr(model, "attention", None) != "ring":
        raise ValueError(
            f"sp={sp} needs the model built with attention='ring' "
            f"(seq_axis='{sp_axis}')")
    sp_group = mesh.group(sp_axis)
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
        if B % dp or T % sp:
            raise ValueError(f"batch [{B}, {T}] does not split over "
                             f"dp={dp} x sp={sp}")
        b, t = B // dp, T // sp
        return tokens[my_dp * b:(my_dp + 1) * b, my_sp * t:(my_sp + 1) * t]

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
        # the local objective sums to the global mean over the mesh, so
        # the gradients summed over the mesh are the global gradient
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
