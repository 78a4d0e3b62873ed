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
``scale_by_adam``; ``torch.optim.AdamW`` has neither); ``adagrad``,
``rmsprop`` and ``adadelta`` are optax's (accumulator from 0.1; eps
inside the square roots), which ``torch.optim``'s namesakes are not.
Each is a small ``torch.optim.Optimizer`` that updates the parameters in
place.

:func:`get_optimizer` returns a factory, the counterpart of an optax
``GradientTransformation``: calling it with parameters builds the
optimizer, as ``optimizer.init(params)`` builds optax's state. ``adam`` / ``adamw``
also take a schedule for ``learning_rate`` (a callable of the step
count, :func:`warmup_cosine_decay_schedule`), as ``optax.adam`` does.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np

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
    this step's ``mu_hat`` is formed from the f32 moment). ``lr`` may be
    a schedule, a callable of optax's count (0 at the first step)."""

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.999,
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
                lr = group["lr"]
                if callable(lr):
                    # optax's scale_by_schedule: its own count, 0 at the
                    # first step (the moments' count is already 1 there)
                    lr = float(lr(st["count"] - 1))
                p.add_(u * -lr)
                st["mu"] = mu.to(st["mu"].dtype)
                st["nu"] = nu
        return loss

    def load_state_dict(self, state_dict):
        """``torch.optim.Optimizer.load_state_dict`` casts every float
        state tensor to its parameter's dtype; a ``mu_dtype`` first
        moment is cast back (exactly: it was stored in that dtype), so a
        resumed run continues the same trajectory."""
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            if group["mu_dtype"] is None:
                continue
            for p in group["params"]:
                st = self.state.get(p)
                if st and "mu" in st:
                    st["mu"] = st["mu"].to(group["mu_dtype"])


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad``: ``optax.scale_by_rss`` — the accumulator starts at
    ``initial_accumulator_value`` and gains ``g^2`` each step; the update
    ``g * where(acc > 0, rsqrt(acc + eps), 0)`` — scaled by ``-lr``."""

    def __init__(self, params, lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if "sum_of_squares" not in st:
                    st["sum_of_squares"] = torch.full_like(
                        p, group["initial_accumulator_value"])
                acc = g * g + st["sum_of_squares"]
                st["sum_of_squares"] = acc
                inv = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                                  torch.zeros_like(acc))
                p.add_(inv * g * -group["lr"])
        return loss


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop`` (not centered, no momentum): ``optax.scale_by_rms``
    — ``nu = (1 - decay) g^2 + decay nu`` from ``initial_scale``, the
    update ``g * rsqrt(nu + eps)`` (eps INSIDE the root, unlike
    ``torch.optim.RMSprop``) — scaled by ``-lr``."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8, initial_scale: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      initial_scale=initial_scale))

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for group in self.param_groups:
            decay = group["decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if "nu" not in st:
                    st["nu"] = torch.full_like(p, group["initial_scale"])
                nu = (1 - decay) * (g * g) + decay * st["nu"]
                st["nu"] = nu
                p.add_(torch.rsqrt(nu + group["eps"]) * g * -group["lr"])
        return loss


class Adadelta(torch.optim.Optimizer):
    """``optax.adadelta`` (no weight decay): ``optax.scale_by_adadelta`` —
    ``e_g = (1 - rho) g^2 + rho e_g``, the update ``sqrt(e_x + eps) /
    sqrt(e_g + eps) * g`` (with the PREVIOUS ``e_x``), then ``e_x = (1 -
    rho) u^2 + rho e_x`` — scaled by ``-lr``."""

    def __init__(self, params, lr: float, rho: float = 0.9,
                 eps: float = 1e-6):
        super().__init__(params, dict(lr=lr, rho=rho, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for group in self.param_groups:
            rho, eps = group["rho"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["e_g"] = torch.zeros_like(p)
                    st["e_x"] = torch.zeros_like(p)
                e_g = (1 - rho) * (g * g) + rho * st["e_g"]
                u = torch.sqrt(st["e_x"] + eps) / torch.sqrt(e_g + eps) * g
                st["e_x"] = (1 - rho) * (u * u) + rho * st["e_x"]
                st["e_g"] = e_g
                p.add_(u * -group["lr"])
        return loss


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Callable:
    """``optax.warmup_cosine_decay_schedule``: a linear warm-up from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` at ``decay_steps`` (the warm-up included),
    constant after. Returns ``f(count) -> float``: optax's operations, in
    its order, in float32. Its values agree with optax's to a few float32
    units in the last place, not bit for bit: numpy's cosine rounds
    differently from XLA's, and inside a jitted step XLA turns a division
    by a constant into a product with its reciprocal."""
    f32 = np.float32

    if decay_steps - warmup_steps <= 0:
        raise ValueError(
            f"The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={decay_steps - warmup_steps}.")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = f32(decay_steps - warmup_steps)

    def linear(count):
        if warmup_steps <= 0:
            return f32(init_value)
        c = f32(min(max(count, 0), warmup_steps))
        frac = f32(1) - c / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def cosine(count):
        c = np.minimum(f32(count), span)
        decay = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / span))
        if exponent != 1.0:
            decay = decay ** f32(exponent)
        return f32(peak_value) * (f32(1 - alpha) * decay + f32(alpha))

    def schedule(count):
        count = int(count)
        return float(linear(count) if count < warmup_steps
                     else cosine(count - warmup_steps))

    return schedule


_OPTIMIZERS = {"sgd": SGD, "momentum": SGD, "nesterov": SGD, "adam": Adam,
               "adamw": Adam, "adagrad": Adagrad, "rmsprop": RMSprop,
               "adadelta": Adadelta}


def get_optimizer(name, learning_rate: float = 0.01, **kwargs):
    """Resolve an optimizer by Keras-style name (optax semantics).

    Returns a factory: ``get_optimizer("adamw", 3e-4,
    mu_dtype=torch.bfloat16)(model.parameters())`` builds the optimizer.
    A ``torch.optim.Optimizer`` instance, or any other callable, passes
    through. ``momentum``/``nesterov`` take ``momentum=`` (default 0.9);
    ``adamw`` takes ``weight_decay=`` (default 1e-4, optax's); the others
    take optax's keywords (``adagrad``: ``initial_accumulator_value``,
    ``eps``; ``rmsprop``: ``decay``, ``eps``, ``initial_scale``;
    ``adadelta``: ``rho``, ``eps``). ``adam`` and ``adamw`` take a
    schedule as ``learning_rate`` (``optax.adam(schedule)``).
    """
    if isinstance(name, torch.optim.Optimizer) or callable(name):
        return name
    if name not in _OPTIMIZERS:
        raise ValueError(f"Unknown optimizer '{name}'. Known: "
                         f"{sorted(_OPTIMIZERS)}")
    if name in ("momentum", "nesterov"):
        kwargs.setdefault("momentum", 0.9)
        kwargs["nesterov"] = name == "nesterov"
    if name == "adamw":
        kwargs.setdefault("weight_decay", 1e-4)
    return functools.partial(_OPTIMIZERS[name], lr=learning_rate, **kwargs)
