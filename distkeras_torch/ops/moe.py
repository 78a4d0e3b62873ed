"""Switch-style mixture of experts with expert parallelism — the port of
:mod:`distkeras_tpu.ops.moe`.

Top-k routing (k=1: the Switch Transformer; k=2: GShard-style) with a
per-source capacity, the experts sharded over a process group, and the
two ``all_to_all`` exchanges of the reference: tokens travel to their
expert's rank and back. Dropped tokens (capacity overflow) give zero and
ride the block's residual, as in Switch.

The routing is the reference's exactly: f32 logits and softmax, top-k
with ties to the lower expert index (``argmax`` for k=1, a stable
descending sort for k=2), gates renormalized when k > 1, choice-major
ranking (every first choice claims capacity before any second choice),
``C = max(1, int(capacity_factor * k * S / E))`` slots per expert per
source rank, and the Switch aux loss over first choices.

The reference dispatches with one-hot ``[S, E, C]`` tensors contracted
against ``x`` (static shapes, MXU-friendly). Here each kept ``(token,
choice)`` is routed by index instead: its row of ``x`` is gathered into
its ``(expert, slot)`` of an ``[E, C, D]`` buffer and the expert outputs
come back by a gather and a gate-weighted sum — the same function (the
dispatch copies ``x`` exactly, as the one-hot sum does), without the
``S * E * C * D`` products. The expert products are batched matmuls in
the model's dtype (``torch.bmm``: the reference computes them as plain
einsums, outside any Pallas kernel).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from distkeras_torch.parallel.collectives import all_to_all, group_size

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at +-2


def route(x32: torch.Tensor, router: torch.Tensor, E: int, k: int,
          C: int):
    """The routing of ``S`` tokens over ``E`` experts with ``C`` slots
    each: ``(probs [S, E] f32, gate [S, k] f32, expert [S, k] int64,
    slot [S, k] int64, keep [S, k] bool)`` — choice ``j`` of token ``s``
    goes to slot ``slot[s, j]`` of expert ``expert[s, j]`` when
    ``keep[s, j]``."""
    probs = torch.softmax(x32 @ router.float(), dim=-1)
    if k == 1:
        # argmax takes the first maximum: lax.top_k's tie to the lower
        # index
        expert = torch.argmax(probs, dim=-1, keepdim=True)
    else:
        expert = torch.sort(probs, dim=-1, descending=True,
                            stable=True).indices[:, :k]
    gate = torch.gather(probs, 1, expert)
    if k > 1:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    # choice-major: all first choices rank before any second choice
    flat = expert.t().reshape(-1)  # [k*S]
    onehot = F.one_hot(flat, E).to(torch.int32)
    rank = torch.gather(torch.cumsum(onehot, dim=0), 1, flat[:, None])[:, 0]
    S = x32.shape[0]
    slot = (rank - 1).reshape(k, S).t().long()
    keep = slot < C
    return probs, gate, expert, slot, keep


def switch_moe(x: torch.Tensor, router: torch.Tensor, w1: torch.Tensor,
               b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
               ep_size: int = 1, group=None, capacity_factor: float = 1.25,
               dtype=torch.float32, top_k: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed MoE layer: ``x [S, D]`` (this rank's tokens) ->
    ``(y [S, D] in x's dtype, aux f32 scalar)``.

    ``router [D, E]`` (replicated), ``w1 [E_l, D, F]``, ``b1 [E_l, F]``,
    ``w2 [E_l, F, D]``, ``b2 [E_l, D]``: this rank's ``E_l = E /
    ep_size`` experts (experts ``[r E_l, (r+1) E_l)`` at rank ``r`` of
    ``group``, the ep process group; None with ``ep_size=1``). Capacity
    is per source rank, so the sharded layer equals the unsharded one
    applied to each rank's tokens. ``aux`` is the Switch load-balancing
    loss ``E * sum_e(frac_first_choice_e * mean_prob_e)`` over the LOCAL
    tokens."""
    S, D = x.shape
    E_l = w1.shape[0]
    E = E_l * ep_size
    if group_size(group) != ep_size:
        raise ValueError(f"ep_size={ep_size} but the ep group has "
                         f"{group_size(group)} ranks")
    k = top_k
    C = max(1, int(capacity_factor * k * S / E))
    x32 = x.float()
    probs, gate, expert, slot, keep = route(x32, router, E, k, C)
    # aux (Switch eq. 4) over first choices
    frac = F.one_hot(expert[:, 0], E).sum(dim=0).float() / S
    aux = E * torch.sum(frac * probs.mean(dim=0))

    # dispatch by index: slot (e, c) of the [E*C] buffer takes one token
    # (a dropped choice points at the pad row S, whose row is zero)
    dest = torch.where(keep, expert * C + slot, E * C)  # [S, k]
    src = torch.full((E * C + 1,), S, dtype=torch.long, device=x.device)
    src = src.scatter(0, dest.reshape(-1),
                      torch.arange(S, device=x.device).repeat_interleave(k))
    x_pad = torch.cat([x32, x32.new_zeros(1, D)])
    d = x_pad[src[:E * C]].reshape(E, C, D)
    if ep_size > 1:
        # axis 0 = destination rank; after the exchange, source rank
        d = all_to_all(d.reshape(ep_size, E_l, C, D), group)
        d = d.transpose(0, 1).reshape(E_l, ep_size * C, D)
    h = torch.bmm(d.to(dtype), w1.to(dtype)) + b1[:, None].to(dtype)
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    y = torch.bmm(h, w2.to(dtype)) + b2[:, None].to(dtype)
    y = y.float()
    if ep_size > 1:
        y = y.reshape(E_l, ep_size, C, D).transpose(0, 1)
        y = all_to_all(y.contiguous(), group).reshape(E, C, D)
    # combine: gate * y[expert, slot] per kept choice, summed over k
    y_pad = torch.cat([y.reshape(E * C, D), y.new_zeros(1, D)])
    out = (gate[..., None] * y_pad[dest]).sum(dim=1)
    return out.to(x.dtype), aux


def expert_init(shape, fan_in: int, device, gen) -> torch.Tensor:
    """flax ``variance_scaling(1.0, 'fan_in', 'truncated_normal')`` of an
    ``[E, in, out]`` expert bank: flax counts the leading expert axis
    into the fan-in (``fan_in = E * in``)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    return w


class SwitchMoE(nn.Module):
    """The router and the expert bank of one MoE MLP — the reference's
    ``SwitchMoE``, parameters ``router [D, E]``, ``w1 [E_l, D, F]``,
    ``b1 [E_l, F]``, ``w2 [E_l, F, D]``, ``b2 [E_l, D]``, f32 masters.

    ``num_experts`` is global. The full bank is drawn from ``gen`` (the
    ``ep_size=1`` init) and rank ``ep_rank`` keeps its contiguous
    ``E / ep_size`` slice, so an ep model holds exactly the slices of
    the unsharded model drawn from the same seed. ``forward(x [B, T, D],
    group)`` returns ``(y [B, T, D], aux)``; ``group`` is the ep process
    group (None at ``ep_size=1``)."""

    def __init__(self, d_model: int, num_experts: int, hidden: int, dtype,
                 device, gen, ep_size: int = 1, ep_rank: int = 0,
                 capacity_factor: float = 1.25, top_k: int = 1):
        super().__init__()
        E, D, Fh = num_experts, d_model, hidden
        if E % ep_size:
            raise ValueError(f"num_experts={E} not divisible by "
                             f"ep_size={ep_size}")
        El = E // ep_size
        self.dtype, self.ep_size = dtype, ep_size
        self.capacity_factor, self.top_k = capacity_factor, top_k
        lo = ep_rank * El
        self.router = nn.Parameter(expert_init((D, E), D, device, gen))
        w1 = expert_init((E, D, Fh), E * D, device, gen)
        self.w1 = nn.Parameter(w1[lo:lo + El].contiguous())
        self.b1 = nn.Parameter(torch.zeros((El, Fh), device=device))
        w2 = expert_init((E, Fh, D), E * Fh, device, gen)
        self.w2 = nn.Parameter(w2[lo:lo + El].contiguous())
        self.b2 = nn.Parameter(torch.zeros((El, D), device=device))

    def forward(self, x, group: Optional[object] = None):
        B, T, D = x.shape
        y, aux = switch_moe(x.reshape(B * T, D), self.router, self.w1,
                            self.b1, self.w2, self.b2, ep_size=self.ep_size,
                            group=group,
                            capacity_factor=self.capacity_factor,
                            dtype=self.dtype, top_k=self.top_k)
        return y.reshape(B, T, D), aux
