"""Loss, metric and optimizer registries — the port of
:mod:`distkeras_tpu.utils.losses`.

Losses and metrics resolve by Keras-style name to PyTorch functions
``f(logits_or_preds, targets) -> scalar`` (means over the batch).

Optimizers follow **optax**, not ``torch.optim``'s defaults, so a port
run and a reference run take the same steps from the same gradients:
``sgd``/``momentum``/``nesterov`` are ``optax.sgd`` (with ``optax.trace``
momentum), ``adam`` is ``optax.adam`` and ``adamw`` is ``optax.adamw``
— weight decay 1e-4 on every leaf by default, the update
``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, and with
``mu_dtype=torch.bfloat16`` the first moment stored in bf16 while this
step's ``m_hat`` uses the unrounded f32 moment (optax's
``scale_by_adam``; ``torch.optim.AdamW`` has neither). Each is a small
``torch.optim.Optimizer`` that updates the parameters in place.

:func:`get_optimizer` returns a factory, the counterpart of an optax
``GradientTransformation``: calling it with parameters builds the
optimizer, as ``optimizer.init(params)`` builds optax's state.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def categorical_crossentropy(logits, labels):
    """Softmax cross-entropy; ``labels`` one-hot ``[B, C]``."""
    return -(labels * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def sparse_categorical_crossentropy(logits, labels):
    """Softmax cross-entropy with integer class labels ``[B]``."""
    return F.cross_entropy(logits, labels.long())


def binary_crossentropy(logits, labels):
    return F.binary_cross_entropy_with_logits(logits, labels.to(logits.dtype))


def mean_squared_error(preds, targets):
    return torch.mean(torch.square(preds - targets))


def mean_absolute_error(preds, targets):
    return torch.mean(torch.abs(preds - targets))


_LOSSES = {
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
}


def accuracy(logits, labels):
    """Classification accuracy; one-hot ``[B, C]`` or integer ``[B]``
    labels."""
    pred = torch.argmax(logits, dim=-1)
    true = (torch.argmax(labels, dim=-1) if labels.dim() == logits.dim()
            else labels)
    return torch.mean((pred == true.to(pred.dtype)).to(torch.float32))


_METRICS = {
    "accuracy": accuracy,
    "mse": mean_squared_error,
    "mae": mean_absolute_error,
}


def get_loss(loss) -> LossFn:
    """Resolve a loss by Keras-style name, or pass a callable through."""
    if callable(loss):
        return loss
    try:
        return _LOSSES[loss]
    except KeyError:
        raise ValueError(
            f"Unknown loss '{loss}'. Known: {sorted(_LOSSES)}") from None


def get_metric(metric) -> LossFn:
    """Resolve a metric by name, or pass a callable through."""
    if callable(metric):
        return metric
    try:
        return _METRICS[metric]
    except KeyError:
        raise ValueError(
            f"Unknown metric '{metric}'. Known: {sorted(_METRICS)}") from None


def resolve_metrics(metrics) -> list:
    """Names/callables -> ``[(name, fn), ...]`` pairs."""
    return [(m if isinstance(m, str) else m.__name__, get_metric(m))
            for m in metrics]


# -- optimizers (optax semantics) -------------------------------------------


class SGD(torch.optim.Optimizer):
    """``optax.sgd(lr, momentum, nesterov)``: without momentum
    ``p -= lr * g``; with it the ``optax.trace`` accumulator
    ``t = g + momentum * t`` and the update ``t`` (or ``g + momentum * t``
    under Nesterov), scaled by ``-lr``."""

    def __init__(self, params, lr: float, momentum: Optional[float] = None,
                 nesterov: bool = False):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for group in self.param_groups:
            mom = group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad
                if mom is not None:
                    st = self.state[p]
                    if "trace" not in st:
                        st["trace"] = torch.zeros_like(p)
                    t = u + mom * st["trace"]
                    st["trace"] = t
                    u = u + mom * t if group["nesterov"] else t
                p.add_(u * -group["lr"])
        return loss


class Adam(torch.optim.Optimizer):
    """``optax.adam`` (``weight_decay=None``) and ``optax.adamw``
    (``weight_decay`` set): optax's ``scale_by_adam`` — moments
    ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, bias
    corrections ``1 - b^count`` in f32, ``u = mu_hat / (sqrt(nu_hat +
    eps_root) + eps)`` — then ``u + wd * p`` and ``p += -lr * u``.
    ``mu_dtype`` stores the first moment in that dtype (rounded after
    this step's ``mu_hat`` is formed from the f32 moment)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0,
                 mu_dtype=None, weight_decay: Optional[float] = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      eps_root=eps_root, mu_dtype=mu_dtype,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(
                        p, dtype=group["mu_dtype"] or p.dtype)
                    st["nu"] = torch.zeros_like(p)
                st["count"] += 1
                # decay * mu is taken in the stored dtype with the decay
                # rounded to it (optax's weak-typed scalar product), then
                # summed in f32; a Python float keeps the card unsynced
                b1_stored = float(torch.tensor(b1, dtype=st["mu"].dtype))
                mu = (1 - b1) * g + (st["mu"] * b1_stored).to(g.dtype)
                nu = (1 - b2) * (g * g) + b2 * st["nu"]
                c = torch.tensor(float(st["count"]), dtype=torch.float32)
                bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** c).item()
                bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** c).item()
                u = (mu / bc1) / (torch.sqrt(nu / bc2 + group["eps_root"])
                                  + group["eps"])
                if wd is not None:
                    u = u + wd * p
                p.add_(u * -group["lr"])
                st["mu"] = mu.to(st["mu"].dtype)
                st["nu"] = nu
        return loss


_DEFERRED = ("adagrad", "rmsprop", "adadelta")


def get_optimizer(name, learning_rate: float = 0.01, **kwargs):
    """Resolve an optimizer by Keras-style name (optax semantics).

    Returns a factory: ``get_optimizer("adamw", 3e-4,
    mu_dtype=torch.bfloat16)(model.parameters())`` builds the optimizer.
    A ``torch.optim.Optimizer`` instance, or any other callable, passes
    through. ``momentum``/``nesterov`` take ``momentum=`` (default 0.9);
    ``adamw`` takes ``weight_decay=`` (default 1e-4, optax's).
    """
    if isinstance(name, torch.optim.Optimizer) or callable(name):
        return name
    ported = ("adam", "adamw", "momentum", "nesterov", "sgd")
    if name in _DEFERRED:
        raise NotImplementedError(
            f"optimizer '{name}' is not ported yet (ROADMAP A7); ported: "
            f"{list(ported)}")
    if name not in ported:
        raise ValueError(f"Unknown optimizer '{name}'. Known: "
                         f"{sorted(ported + _DEFERRED)}")
    if name in ("momentum", "nesterov"):
        kwargs.setdefault("momentum", 0.9)
        kwargs["nesterov"] = name == "nesterov"
    if name == "adamw":
        kwargs.setdefault("weight_decay", 1e-4)
    cls = Adam if name.startswith("adam") else SGD
    return functools.partial(cls, lr=learning_rate, **kwargs)
