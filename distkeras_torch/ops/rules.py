"""Distributed-optimization update rules — the port of
:mod:`distkeras_tpu.ops.rules`.

The reference writes every synchronization rule of the parameter-server
family as a pure function over JAX pytrees. Here a tree is a flat
``dict[str, Tensor]`` (keys are the '/'-joined paths of the flax tree,
:func:`flatten`), and a rule that touches every leaf runs as one
``torch._foreach_*`` call over the leaves. The functions are pure: they
return new tensors and never write their inputs (the in-place forms the
parameter servers use are :func:`tree_add_` and :func:`tree_copy_`).

The reference's ``allreduce_*`` rules are ``psum``s over a mesh axis
inside ``shard_map``. The port's lock-step engine runs every worker in
one process (worker ``i`` on ``devices[i % n]``), so they become
reductions over a list of per-worker trees, summed onto the center's
device: :func:`allreduce_sum_delta`, :func:`allreduce_mean_delta`,
:func:`allreduce_dynsgd_round` and :func:`allreduce_easgd_round`.

Papers: DOWNPOUR (Dean et al. 2012); EASGD / AEASGD / EAMSGD (Zhang,
Choromanska, LeCun 2015); DynSGD (Jiang et al. 2017); ADAG (Hermans).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Tree layout: nested flax dicts <-> flat dicts of tensors
# ---------------------------------------------------------------------------


def flatten(tree) -> dict:
    """A nested dict -> a flat dict keyed by the '/'-joined path (a flat
    dict comes back as it is). Leaves are untouched."""
    if not any(isinstance(v, dict) for v in tree.values()):
        return dict(tree)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (str(k),))
            else:
                out["/".join(prefix + (str(k),))] = v

    walk(tree, ())
    return out


def unflatten(flat: dict) -> dict:
    """Inverse of :func:`flatten`: '/'-joined keys -> nested dicts."""
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def to_tensors(tree, device, dtype=None) -> Tree:
    """A tree (nested or flat; numpy, scalars or tensors) -> a flat dict of
    tensors on ``device``, each a fresh copy (numpy never aliased)."""
    out = {}
    for k, v in flatten(tree).items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().to(device=device, dtype=dtype, copy=True)
        else:
            out[k] = torch.tensor(np.array(v), device=device, dtype=dtype)
    return out


def to_numpy(tree: Tree) -> dict:
    """A flat dict of tensors -> the nested flax layout of numpy arrays."""
    return unflatten({k: v.detach().cpu().numpy() for k, v in tree.items()})


def _keys(a: Tree, b: Tree):
    if a.keys() != b.keys():
        raise ValueError(f"trees differ in their leaves: "
                         f"{sorted(set(a) ^ set(b))}")
    return list(a)


# ---------------------------------------------------------------------------
# Generic tree arithmetic
# ---------------------------------------------------------------------------


def tree_sub(a: Tree, b: Tree) -> Tree:
    """``a - b`` leafwise: the worker-side delta of every async rule."""
    keys = _keys(a, b)
    return dict(zip(keys, torch._foreach_sub([a[k] for k in keys],
                                             [b[k] for k in keys])))


def tree_add(a: Tree, b: Tree) -> Tree:
    """``a + b`` leafwise."""
    keys = _keys(a, b)
    return dict(zip(keys, torch._foreach_add([a[k] for k in keys],
                                             [b[k] for k in keys])))


def tree_scale(a: Tree, s) -> Tree:
    """``s * a`` leafwise (``s`` a Python scalar)."""
    keys = list(a)
    return dict(zip(keys, torch._foreach_mul([a[k] for k in keys], s)))


def tree_axpy(alpha, x: Tree, y: Tree) -> Tree:
    """``alpha * x + y`` leafwise."""
    return tree_add(tree_scale(x, alpha), y)


def tree_mean(trees: List[Tree]) -> Tree:
    """Leafwise mean of a list of trees (the one-shot average)."""
    total = trees[0]
    for t in trees[1:]:
        total = tree_add(total, t)
    return tree_scale(total, 1.0 / len(trees))


def tree_zeros_like(a: Tree) -> Tree:
    return {k: torch.zeros_like(v) for k, v in a.items()}


def tree_add_(a: Tree, b: Tree, alpha=None) -> Tree:
    """``a += b`` (or ``a += b * alpha``, the product taken first, as
    the reference's scaled commit) in place, one ``_foreach`` call."""
    keys = _keys(a, b)
    src = [b[k] for k in keys]
    if alpha is not None:
        src = torch._foreach_mul(src, alpha)
    torch._foreach_add_([a[k] for k in keys], src)
    return a


def tree_sub_(a: Tree, b: Tree) -> Tree:
    """``a -= b`` in place, one ``_foreach`` call."""
    keys = _keys(a, b)
    torch._foreach_sub_([a[k] for k in keys], [b[k] for k in keys])
    return a


def tree_copy_(dst: Tree, src: Tree) -> Tree:
    """``dst[k] <- src[k]`` in place for every leaf (across devices too)."""
    keys = _keys(dst, src)
    torch._foreach_copy_([dst[k] for k in keys], [src[k] for k in keys])
    return dst


# ---------------------------------------------------------------------------
# DOWNPOUR (Dean et al. 2012)
# ---------------------------------------------------------------------------


def downpour_delta(local: Tree, last_pulled: Tree) -> Tree:
    """The delta a DOWNPOUR worker pushes after its window: local weights
    minus the last pulled center."""
    return tree_sub(local, last_pulled)


def downpour_commit(center: Tree, delta: Tree) -> Tree:
    """Parameter-server commit: ``center + delta``."""
    return tree_add(center, delta)


# ---------------------------------------------------------------------------
# EASGD family (Zhang et al. 2015)
# ---------------------------------------------------------------------------


def elastic_difference(alpha, worker: Tree, center: Tree) -> Tree:
    """``alpha * (worker - center)``, the elastic force (``alpha =
    learning_rate * rho``)."""
    return tree_scale(tree_sub(worker, center), alpha)


def easgd_worker_update(worker: Tree, center: Tree, alpha) -> Tree:
    """Elastic pull of the worker toward the center: ``w - alpha*(w - c)``."""
    return tree_sub(worker, elastic_difference(alpha, worker, center))


def easgd_center_update(center: Tree, workers: List[Tree], alpha) -> Tree:
    """Synchronous-round center update: ``c + alpha * sum_i (w_i - c)``
    (the force summed first, then scaled, as the reference does)."""
    force = tree_zeros_like(center)
    for w in workers:
        force = tree_add(force, tree_sub(w, center))
    return tree_add(center, tree_scale(force, alpha))


def aeasgd_commit(center: Tree, elastic_diff: Tree) -> Tree:
    """Asynchronous EASGD commit: ``c + alpha*(w - c)`` (the pushed
    elastic difference is the delta)."""
    return tree_add(center, elastic_diff)


def eamsgd_momentum_update(velocity: Tree, grad_step: Tree, momentum) -> Tree:
    """Momentum velocity update on the local worker: ``v = momentum * v +
    step``."""
    return tree_add(tree_scale(velocity, momentum), grad_step)


# ---------------------------------------------------------------------------
# DynSGD (Jiang et al. 2017) and ADAG (Hermans)
# ---------------------------------------------------------------------------


def dynsgd_scale(delta: Tree, staleness) -> Tree:
    """``delta / (staleness + 1)``: commits the center absorbed since the
    worker's pull damp its delta."""
    return tree_scale(delta, 1.0 / (staleness + 1.0))


def dynsgd_commit(center: Tree, delta: Tree, staleness) -> Tree:
    """``center + delta / (staleness + 1)``."""
    return tree_add(center, dynsgd_scale(delta, staleness))


def adag_commit(center: Tree, delta: Tree, num_workers: int) -> Tree:
    """Normalized asynchronous accumulation: ``center + delta /
    num_workers``."""
    return tree_add(center, tree_scale(delta, 1.0 / num_workers))


# ---------------------------------------------------------------------------
# Lock-step forms (the reference's allreduce_* rules): reductions over the
# workers' trees, summed onto the center's device
# ---------------------------------------------------------------------------


def _sum_onto(trees: List[Tree], device) -> Tree:
    total = {k: v.to(device, copy=True) for k, v in trees[0].items()}
    for t in trees[1:]:
        tree_add_(total, {k: v.to(device) for k, v in t.items()})
    return total


def allreduce_sum_delta(deltas: List[Tree], device) -> Tree:
    """Sum of the workers' deltas on ``device``: DOWNPOUR's lock-step
    commit (every delta at full strength)."""
    return _sum_onto(deltas, device)


def allreduce_mean_delta(deltas: List[Tree], device) -> Tree:
    """Mean of the workers' deltas on ``device`` (sum, then ``/ n``):
    ADAG's lock-step commit."""
    total = _sum_onto(deltas, device)
    return dict(zip(total, torch._foreach_div(list(total.values()),
                                              float(len(deltas)))))


def allreduce_dynsgd_round(workers: List[Tree], center: Tree
                           ) -> Tuple[List[Tree], Tree]:
    """One lock-step DynSGD round: ``center += sum_i delta_i / (1 + i)``
    (worker ``i`` sees ``i`` commits land before its own), then every
    worker re-pulls the new center. Returns ``(pulled, new_center)``."""
    dev = next(iter(center.values())).device
    damped = [tree_scale(tree_sub({k: v.to(dev) for k, v in w.items()},
                                  center), 1.0 / (1.0 + i))
              for i, w in enumerate(workers)]
    new_center = tree_add(center, _sum_onto(damped, dev))
    return [new_center] * len(workers), new_center


def allreduce_easgd_round(workers: List[Tree], center: Tree, alpha
                          ) -> Tuple[List[Tree], Tree]:
    """One synchronous EASGD round: each worker moves by ``-alpha * (w_i -
    c)`` and the center by ``alpha * sum_i (w_i - c)``. Returns
    ``(new_workers, new_center)`` (each worker on its own device)."""
    dev = next(iter(center.values())).device
    diffs, new_workers = [], []
    for w in workers:
        wdev = next(iter(w.values())).device
        diff = tree_sub(w, {k: v.to(wdev) for k, v in center.items()})
        new_workers.append(tree_sub(w, tree_scale(diff, alpha)))
        diffs.append(diff)
    new_center = tree_add(center, tree_scale(_sum_onto(diffs, dev), alpha))
    return new_workers, new_center
