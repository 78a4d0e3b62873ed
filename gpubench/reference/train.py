"""The reference's first training steps, in float32.

:func:`follow` builds the weights from the seed (one flat buffer whose
leaves are views), takes ``steps`` optimizer steps on the batches it is
handed, each gradient summed over blocks of rows so that it fits, and
returns what the comparison reads: each step's loss, the first step's
gradient norm per leaf, and the norm per leaf of the change of the
weights after the last step. Under data parallelism each process
follows its own rows and the gradient sums, the losses and the counts
are summed over ``group`` with ``torch.distributed`` (the reference's
own exchange, not the program's).

The optimizers are optax's, written out: ``adamw`` (bias-corrected
moments, ``u = mu_hat / (sqrt(nu_hat) + eps) + wd * p``, the first
moment stored in ``mu_dtype`` with optax's weak-typed decay product) and
``momentum`` (``t = g + m * t``, ``p -= lr * t``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from gpubench.reference.precision import F32
from gpubench.weights import make_flat, views


def leaf_norms(flat: torch.Tensor, specs) -> Dict[str, float]:
    vs = views(flat, specs)
    norms = torch.stack([v.double().norm() for v in vs.values()]).cpu()
    return {name: float(n) for name, n in zip(vs, norms)}


class AdamW:
    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4,
                 mu_dtype: Optional[str] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd = weight_decay
        self.mu_dtype = getattr(torch, mu_dtype) if mu_dtype else None
        self.count = 0
        self.mu = self.nu = None

    @torch.no_grad()
    def update(self, p: torch.Tensor, g: torch.Tensor):
        if self.mu is None:
            self.mu = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
            self.nu = torch.zeros_like(p)
        self.count += 1
        if self.mu_dtype is None:
            decayed = self.b1 * self.mu
        else:
            # optax multiplies the stored moment by the decay rounded to
            # its dtype, and the product stays in that dtype
            b1 = torch.tensor(self.b1, dtype=self.mu_dtype).item()
            decayed = (self.mu * b1).float()
        mu = (1 - self.b1) * g + decayed
        nu = (1 - self.b2) * g * g + self.b2 * self.nu
        c = torch.tensor(float(self.count))
        bc1 = float(1 - torch.tensor(self.b1) ** c)
        bc2 = float(1 - torch.tensor(self.b2) ** c)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) + self.wd * p
        p.add_(u, alpha=-self.lr)
        self.mu = mu.to(self.mu.dtype)
        self.nu = nu


class Momentum:
    def __init__(self, lr, momentum=0.9):
        self.lr, self.m = lr, momentum
        self.trace = None

    @torch.no_grad()
    def update(self, p: torch.Tensor, g: torch.Tensor):
        self.trace = g.clone() if self.trace is None else g + self.m * self.trace
        p.add_(self.trace, alpha=-self.lr)


def make_optimizer(spec: dict):
    kw = {k: v for k, v in spec.items() if k != "name"}
    if spec["name"] == "adamw":
        return AdamW(**kw)
    if spec["name"] == "momentum":
        return Momentum(**kw)
    raise ValueError(f"unknown optimizer {spec['name']!r}")


def follow(specs, seed: int, device, loss_sum: Callable, batch: Callable,
           steps: int, optimizer: dict, rows_per_block: int, group=None,
           prec=F32) -> dict:
    """``steps`` reference steps. ``batch(s)`` is the tuple of this
    process's input tensors of step ``s`` (rows first);
    ``loss_sum(w, *rows, prec=prec)`` the summed loss of a block of rows
    and the number of terms in it."""
    flat = make_flat(specs, seed, device).requires_grad_()
    start = flat.detach().clone()
    opt = make_optimizer(optimizer)
    losses: List[float] = []
    grads = None
    for s in range(steps):
        rows = batch(s)
        flat.grad = None
        total = torch.zeros((), dtype=torch.float64, device=device)
        count = 0
        n = rows[0].shape[0]
        for r0 in range(0, n, rows_per_block):
            w = views(flat, specs)
            loss, c = loss_sum(w, *(t[r0:r0 + rows_per_block] for t in rows),
                               prec=prec)
            loss.backward()
            total += loss.detach().double()
            count += c
        sums = torch.cat([total.view(1),
                          torch.tensor([float(count)], dtype=torch.float64,
                                       device=device)])
        g = flat.grad
        if group is not None:
            dist.all_reduce(g, group=group)
            dist.all_reduce(sums, group=group)
        g = g / float(sums[1])
        losses.append(float(sums[0] / sums[1]))
        if s == 0:
            grads = leaf_norms(g, specs)
        opt.update(flat.data, g)
    delta = leaf_norms(flat.detach() - start, specs)
    return {"losses": losses, "grad_norms": grads, "delta_norms": delta}
