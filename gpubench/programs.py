"""The program under test, built from a cell's configuration and fed the
benchmark's weights: the port's training steps and serving engine.

This is the only module of the harness besides the kind modules that
imports ``distkeras_torch``, and it takes only the system's public
entry points (``get_model``, ``make_lm_train_step``,
``make_window_step``, ``get_optimizer``, ``get_loss``,
``ServingEngine``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def lm_kwargs(cfg: dict) -> dict:
    return dict(vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
                num_heads=cfg["num_heads"], num_layers=cfg["num_layers"],
                max_len=cfg["max_len"], pos_emb=cfg["pos_emb"],
                num_kv_heads=cfg["num_kv_heads"],
                dtype=_DTYPES[cfg["dtype"]])


def build_model(cfg: dict, weights: Dict[str, torch.Tensor], device):
    """The port's model of ``cfg`` holding ``weights`` (copied in)."""
    from distkeras_torch.models import get_model

    if cfg["model"] == "transformer_lm":
        model = get_model("transformer_lm", device=device, seed=0,
                          **lm_kwargs(cfg))
    elif cfg["model"] == "cifar_cnn":
        model = get_model("cifar_cnn", widths=tuple(cfg["widths"]),
                          num_classes=cfg["num_classes"],
                          dtype=_DTYPES[cfg["dtype"]],
                          input_shape=tuple(cfg["input_shape"]),
                          device=device, seed=0)
    else:
        raise ValueError(f"unknown model {cfg['model']!r}")
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            f"the program's parameters differ from the benchmark's layout: "
            f"{sorted(set(params) ^ set(weights))[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
    return model


class TrainProgram:
    """A training step of the port over a model, with its optimizer."""

    def __init__(self, cfg: dict, traffic: dict, weights, device,
                 mesh=None):
        from distkeras_torch.utils.losses import get_loss, get_optimizer

        self.model = build_model(cfg, weights, device)
        spec = dict(traffic["optimizer"])
        name = spec.pop("name")
        lr = spec.pop("lr")
        if "mu_dtype" in spec:
            spec["mu_dtype"] = _DTYPES[spec["mu_dtype"]]
        self.b2 = spec.get("b2")
        self.optimizer = get_optimizer(name, lr, **spec)(
            self.model.parameters())
        if cfg["model"] == "transformer_lm":
            from distkeras_torch.parallel.spmd import make_lm_train_step

            self._step = make_lm_train_step(
                self.model, self.optimizer, mesh=mesh, window=True,
                fused_ce=traffic["fused_ce"])
            self.step = lambda batch: self._step(batch[0])
        else:
            from distkeras_torch.workers import make_window_step

            self._step = make_window_step(
                self.model, get_loss(traffic["loss"]), self.optimizer)
            self.step = lambda batch: self._step(*batch)["loss"]

    def named(self) -> List[tuple]:
        return list(self.model.named_parameters())

    @torch.no_grad()
    def grad_norms(self) -> Dict[str, float]:
        """Each leaf's first gradient, worked out from the optimizer's
        state after one step: AdamW's second moment is ``(1 - b2) g^2``,
        the momentum trace is ``g``. None where a leaf has no state."""
        out = {}
        for name, p in self.named():
            st = self.optimizer.state.get(p) or {}
            if "nu" in st:
                out[name] = math.sqrt(float(st["nu"].double().sum())
                                      / (1 - self.b2))
            elif "trace" in st:
                out[name] = float(st["trace"].double().norm())
            else:
                return None
        return out
