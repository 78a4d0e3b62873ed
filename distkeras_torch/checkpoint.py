"""Step-level checkpoint / resume — the port of
:mod:`distkeras_tpu.checkpoint`, on ``torch.save`` / ``torch.load``
(the reference writes orbax directories; a JAX checkpoint directory does
not load here).

One state ``{"params", "opt_state", "extra"}`` per step, in the file
``step_<step>.pt`` of ``directory``, written to a temporary name and
renamed into place, so a crash mid-save leaves the last whole step.
Array leaves are stored as CPU tensors (``torch.load`` with
``weights_only=True`` reads them back, no pickle of code); ``params``
comes back as the flax-layout tree of numpy arrays the trainers take.

Resume semantics by trainer (the reference's):

- ``SingleTrainer`` / ``DataParallelTrainer``: params + optimizer state +
  epoch counter are saved per epoch; resume replays the exact remaining
  trajectory.
- ``DistributedTrainer`` (the async PS family): snapshots carry the
  center plus every worker's optimizer state (read racily mid-run) and
  ``n_workers``. Resume restores the center and, when the worker count
  matches, the workers' optimizer states; the restarted run trains its
  full ``num_epoch`` from there.
- The lock-step engines (``spmd=True``): center, every worker's
  parameters and optimizer state, the epoch, and an engine stamp
  (``trainers._SPMD_ENGINE_IDS``) with the worker count: a resume under
  another engine or worker count raises.

Usage::

    ckpt = Checkpointer(dir, every_steps=100, max_to_keep=3)
    trainer = SingleTrainer(model, checkpointer=ckpt, ...)
    trainer.train(ds)          # writes checkpoints as it goes
    # after a crash:
    trainer2 = SingleTrainer(model, checkpointer=Checkpointer(dir), ...)
    trainer2.train(ds)         # resumes from the latest step
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointMismatchError(ValueError):
    """A ``restore(like=)`` template does not fit the checkpoint on disk:
    the first offending leaf — wrong shape, wrong dtype, or present on
    only one side — is named with its key path; ``leaf`` carries the
    path."""

    def __init__(self, msg, leaf=None):
        super().__init__(msg)
        self.leaf = leaf


def _to_store(tree):
    """Array leaves -> CPU tensors (copies); containers recurse."""
    if isinstance(tree, dict):
        return {k: _to_store(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_store(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.tensor(np.array(tree))
    return tree


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return tree


def _leaves(tree, prefix=""):
    """``{path: leaf}`` of a nested dict/list tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}" if prefix else str(i)))
    else:
        out[prefix] = tree
    return out


def _spec(leaf):
    """(shape, dtype name) of an array leaf, (None, type name) else."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).split(".")[-1]
    if isinstance(leaf, (np.ndarray, np.generic)):
        return tuple(np.shape(leaf)), np.dtype(leaf.dtype).name
    return None, type(leaf).__name__


class Checkpointer:
    """Save and restore training state by step in ``directory``.

    ``every_steps`` is the cadence :meth:`maybe_save` honors (a forced
    save ignores it); ``max_to_keep`` the newest steps kept on disk.
    Saves are synchronous: :meth:`wait` has nothing to wait for and is
    kept for the reference's call sites."""

    def __init__(self, directory: str, every_steps: int = 100,
                 max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.every_steps = max(1, int(every_steps))
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self):
        steps = []
        for f in os.listdir(self.directory):
            m = _NAME.match(f)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    # -- write --------------------------------------------------------------

    def maybe_save(self, step: int, params: Any, opt_state: Any = None,
                   extra: Optional[dict] = None, force: bool = False):
        """Save if ``step`` hits the cadence (or ``force``); a step already
        on disk is skipped. Returns whether it saved."""
        if not force and step % self.every_steps != 0:
            return False
        if step in self.all_steps():
            return False
        state = {"params": _to_store(params),
                 "opt_state": _to_store(opt_state)
                 if opt_state is not None else {},
                 "extra": dict(extra or {})}
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        return True

    def wait(self):
        """Saves are synchronous: nothing to wait for."""

    # -- read ---------------------------------------------------------------

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Optional[dict] = None):
        """Restore ``(step, state)``, or ``(None, None)`` when there is no
        checkpoint. ``state["params"]`` is numpy (the flax layout); the
        rest keeps its tensors. ``like``, a template of the state, is
        checked leaf by leaf before anything is returned: a leaf whose
        shape or dtype differs, or that exists on one side only, raises
        :class:`CheckpointMismatchError` naming it."""
        step = step if step is not None else self.latest_step
        if step is None:
            return None, None
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        if like is not None:
            template = {"params": like.get("params"),
                        "opt_state": like.get("opt_state")
                        if like.get("opt_state") is not None else {},
                        "extra": dict(like.get("extra") or {})}
            self._validate(step, _to_store(template), state)
        state["params"] = _to_numpy(state["params"])
        return step, state

    @staticmethod
    def _validate(step: int, template: dict, state: dict):
        want, got = _leaves(template), _leaves(state)
        for path, leaf in want.items():
            if path not in got:
                raise CheckpointMismatchError(
                    f"checkpoint step {step} has no leaf {path} (template "
                    f"expects {_spec(leaf)})", leaf=path)
            (ws, wd), (gs, gd) = _spec(leaf), _spec(got[path])
            if ws != gs:
                raise CheckpointMismatchError(
                    f"checkpoint step {step} mismatch at leaf {path}: saved "
                    f"shape {gs} != template shape {ws}", leaf=path)
            if ws is not None and wd != gd:
                raise CheckpointMismatchError(
                    f"checkpoint step {step} mismatch at leaf {path}: saved "
                    f"dtype {gd} != template dtype {wd}", leaf=path)
        for path in got:
            if path not in want:
                raise CheckpointMismatchError(
                    f"checkpoint step {step} carries leaf {path} the "
                    f"template does not have", leaf=path)

    def close(self):
        """Nothing is held open."""
