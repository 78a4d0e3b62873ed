"""The language-model training step — the single-device part of
:func:`distkeras_tpu.parallel.spmd.make_lm_train_step`.

The reference jits one program over a dp x sp (x tp) mesh and threads
params and optimizer state through it (donated). Here the parameters
live in the module and the optimizer updates them in place, so the step
is ``step(tokens) -> loss``; a mesh, sequence or tensor parallelism
raise (ROADMAP A10).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from distkeras_torch.ops.fused_ce import lm_head_loss


def _next_token_targets(tokens):
    """Targets and row weights at sp=1: ``tokens[:, 1:]`` followed by the
    first column (the reference's ring neighbour is the shard itself),
    with the last position masked."""
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    return targets, mask


def make_lm_train_step(model, optimizer, mesh=None, window: bool = False,
                       fused_ce: bool = True):
    """The LM training step of a :class:`TransformerLM` on its device.

    ``optimizer`` is a ``torch.optim.Optimizer`` over ``model``'s
    parameters, or a factory from
    :func:`distkeras_torch.utils.losses.get_optimizer` (bound here to
    ``model.parameters()``).

    Returns ``step(tokens) -> loss``: ``tokens`` ``[B, T]`` int ids
    (tensor or numpy), one forward/backward/optimizer step, the mean
    next-token cross-entropy as a 0-dim device tensor. With
    ``window=True`` the step takes ``[W, B, T]`` and runs W optimizer
    steps, returning the ``[W]`` losses on the device — no host sync
    inside the window.

    ``fused_ce`` (default on) computes the loss with
    :func:`distkeras_torch.ops.fused_ce.lm_head_loss` on the
    ``features_only`` twin's output: the head product and softmax-CE run
    chunk by chunk and ``[B, T, V]`` logits never exist. Set False for
    the full-logits path.
    """
    if mesh is not None:
        raise NotImplementedError(
            "make_lm_train_step over a mesh (dp/sp/tp sharding) is not "
            "ported yet (ROADMAP A10); pass mesh=None for one device")
    if getattr(model, "attention", None) == "ring":
        raise NotImplementedError(
            "attention='ring' (sequence parallelism) is not ported yet "
            "(ROADMAP A10)")
    if not isinstance(optimizer, torch.optim.Optimizer):
        optimizer = optimizer(model.parameters())
    feat_model = model.clone(features_only=True) if fused_ce else None
    head = {"kernel": model.head.kernel, "bias": model.head.bias}
    dev = model.device

    def batch_update(tokens):
        targets, mask = _next_token_targets(tokens)
        optimizer.zero_grad(set_to_none=True)
        if fused_ce:
            feats = feat_model(tokens)
            local_sum, count = lm_head_loss(feats, head, targets, mask)
            loss = local_sum / count
        else:
            logits = model(tokens)
            token_loss = F.cross_entropy(
                logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                reduction="none")
            loss = (token_loss * mask.reshape(-1)).sum() / mask.sum()
        loss.backward()
        optimizer.step()
        return loss.detach()

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
