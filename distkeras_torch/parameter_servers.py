"""Parameter servers — the center-variable owners; the port of
:mod:`distkeras_tpu.parameter_servers`.

The center is a flat ``dict[str, Tensor]`` (:func:`rules.flatten` of the
flax tree) on ``device``. A commit is an in-place ``_foreach_add_`` of
the (scaled) delta under the lock; a pull is a copy of the center onto
the caller's device, taken under the lock, so no later commit can touch
what a worker holds and a worker's in-place optimizer step can never
write the center. The constructor copies the caller's parameters for
the same reason.

Concurrency contract: every worker thread issues its work on its
device's default stream, and every read or write of ``self.center`` is
issued under the lock, so the order of commits and pulls on the card is
their order under the lock. Nothing under the lock waits for the
device (no ``.item()``, ``.cpu()`` or synchronize): the host reads
happen outside it (:meth:`get_model`, :meth:`_save_pending`).

The commit math is :mod:`distkeras_torch.ops.rules`'s; the synchronous
algorithms' lock-step engine (``spmd=True``) uses its ``allreduce_*``
forms instead of these objects.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import torch

from distkeras_torch import telemetry
from distkeras_torch.ops import rules

# registry series shared by every PS in the process: commits by server
# class, and DynSGD's staleness distribution
_PS_COMMITS = telemetry.get_registry().counter(
    "ps_commits_total", "center commits applied", labelnames=("kind",),
)
_PS_STALENESS = telemetry.get_registry().histogram(
    "ps_commit_staleness",
    "commit staleness in server-clock ticks (DynSGD)",
    buckets=telemetry.STALENESS_BUCKETS,
)


def _snapshot(tree: rules.Tree, device=None) -> rules.Tree:
    """A fresh copy of ``tree`` (on ``device`` when given)."""
    return {k: v.to(device=device, copy=True) if device is not None
            else v.clone() for k, v in tree.items()}


class ParameterServer:
    """Base center-variable owner (reference: parameter_servers.py ·
    ParameterServer). Lifecycle: ``start()`` -> workers pull and commit ->
    ``stop()`` -> ``get_model()``.

    ``params``: a tree of numpy arrays or tensors, nested (the flax
    layout) or flat; it is copied onto ``device`` (default: the first
    CUDA card). Deltas may come nested or flat, as tensors on any device
    or as numpy (from the wire)."""

    def __init__(self, params: Any, device=None):
        from distkeras_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.center = rules.to_tensors(params, self.device)
        self.lock = threading.Lock()
        self.num_updates = 0
        self.staleness_log: List[int] = []
        self._running = False
        self.checkpointer = None  # optional; set by DistributedTrainer
        # a resumed run continues its save steps past the restored one's
        self.step_offset = 0
        # optional () -> (opt_state, extra) supplied by the trainer so
        # snapshots carry the workers' optimizer states (read racily)
        self.extra_state_fn = None

    def _committed(self):
        """Post-commit bookkeeping (the caller holds the lock): count the
        update and, on the checkpoint cadence, snapshot the center on the
        device; the caller saves it after releasing the lock."""
        self.num_updates += 1
        _PS_COMMITS.labels(kind=type(self).__name__).inc()
        if (self.checkpointer is not None
                and self.num_updates % self.checkpointer.every_steps == 0):
            return self.step_offset + self.num_updates, _snapshot(self.center)
        return None

    def _save_pending(self, pending):
        """Write a snapshot from :meth:`_committed` (lock released: the
        device-to-host copy happens here, off the commit path)."""
        if pending is not None and self.checkpointer is not None:
            step, snapshot = pending
            opt_state, extra = (self.extra_state_fn()
                                if self.extra_state_fn is not None
                                else (None, None))
            self.checkpointer.maybe_save(step, rules.to_numpy(snapshot),
                                         opt_state=opt_state, extra=extra)

    def _put_delta(self, delta) -> rules.Tree:
        """An incoming tree as a flat dict on the center's device (no copy
        when it already lives there)."""
        flat = rules.flatten(delta)
        return {k: (v.to(self.device) if isinstance(v, torch.Tensor)
                    else torch.tensor(v, device=self.device))
                for k, v in flat.items()}

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        self._running = True

    def stop(self):
        self._running = False

    def get_model(self) -> dict:
        """The center as numpy in the flax layout (end of training,
        serialization)."""
        return rules.to_numpy(self.pull())

    # -- wire ops (reference: 'p' pull / 'c' commit) -------------------------

    def pull(self, device=None) -> rules.Tree:
        """A copy of the center, on ``device`` when given (else on the
        center's own): the caller's to keep and to write."""
        with self.lock:
            return _snapshot(self.center, device)

    def pull_host(self) -> dict:
        """The center as host numpy — the service boundary
        (:mod:`distkeras_torch.networking` serializes it)."""
        return self.get_model()

    def commit(self, delta: Any, worker: int = 0, worker_clock: int = 0):
        raise NotImplementedError

    def leave(self, worker: int):
        """A worker is done (finished or died). No-op for the async
        servers; the synchronous server shrinks its barrier."""


class DeltaParameterServer(ParameterServer):
    """``center += delta`` (reference: DeltaParameterServer — serves
    DOWNPOUR, AEASGD and EAMSGD)."""

    def commit(self, delta, worker: int = 0, worker_clock: int = 0):
        delta = self._put_delta(delta)
        with self.lock:
            rules.tree_add_(self.center, delta)
            pending = self._committed()
        self._save_pending(pending)


class ADAGParameterServer(ParameterServer):
    """``center += delta / num_workers`` (reference: ADAGParameterServer)."""

    def __init__(self, params, num_workers: int, device=None):
        super().__init__(params, device=device)
        self.num_workers = num_workers
        self._scale = 1.0 / num_workers

    def commit(self, delta, worker: int = 0, worker_clock: int = 0):
        delta = self._put_delta(delta)
        with self.lock:
            rules.tree_add_(self.center, delta, self._scale)
            pending = self._committed()
        self._save_pending(pending)


class DynSGDParameterServer(ParameterServer):
    """Staleness-aware commits (reference: DynSGDParameterServer): a
    global clock, pulls return ``(weights, clock)``, and each commit is
    scaled by ``1 / (server_clock - worker_clock + 1)``."""

    def __init__(self, params, device=None):
        super().__init__(params, device=device)
        self.clock = 0

    def pull_with_clock(self, device=None):
        with self.lock:
            return _snapshot(self.center, device), self.clock

    def commit(self, delta, worker: int = 0, worker_clock: int = 0):
        delta = self._put_delta(delta)
        with self.lock:
            staleness = max(0, self.clock - worker_clock)
            self.staleness_log.append(staleness)
            _PS_STALENESS.observe(staleness)
            rules.tree_add_(self.center, delta, 1.0 / (staleness + 1.0))
            self.clock += 1
            pending = self._committed()
        self._save_pending(pending)


class EASGDParameterServer(ParameterServer):
    """Synchronous-round server (reference: EASGDParameterServer): a round
    completes when every active worker has contributed its weights; the
    center then moves by the summed elastic forces and every worker of
    the round receives the pre-round center."""

    def __init__(self, params, num_workers: int, rho: float = 5.0,
                 elastic_lr: float = 0.01, device=None):
        super().__init__(params, device=device)
        self.num_workers = num_workers
        self.rho = rho
        self.alpha = elastic_lr * rho  # paper: alpha = eta * rho
        self._active = set(range(num_workers))
        self._round_inputs: Dict[int, rules.Tree] = {}
        self._round_center: Optional[rules.Tree] = None
        self._cond = threading.Condition(self.lock)
        self._round = 0

    def _round_complete_locked(self):
        """Apply the round and release its waiters (the caller holds the
        lock and every active worker has contributed)."""
        pre_center = _snapshot(self.center)
        new = rules.easgd_center_update(
            self.center, list(self._round_inputs.values()), self.alpha)
        rules.tree_copy_(self.center, new)
        self._pending_ckpt = self._committed()
        self._round_center = pre_center
        self._round_inputs = {}
        self._round += 1
        self._cond.notify_all()

    def commit_and_wait(self, worker_params, worker: int, device=None):
        """Contribute to the current round and block until every active
        worker has; returns the center as of the round's start (on
        ``device`` when given). A finished worker calls :meth:`leave`, so
        the barrier shrinks instead of deadlocking."""
        contributed = self._put_delta(worker_params)
        with self._cond:
            my_round = self._round
            self._round_inputs[worker] = contributed
            if len(self._round_inputs) >= len(self._active):
                self._round_complete_locked()
                pending = self.__dict__.pop("_pending_ckpt", None)
            else:
                self._cond.wait_for(lambda: self._round > my_round)
                pending = None
            center = self._round_center
            if device is not None:
                center = _snapshot(center, device)
        self._save_pending(pending)
        return center

    def leave(self, worker: int):
        with self._cond:
            self._active.discard(worker)
            self._round_inputs.pop(worker, None)
            if self._active and len(self._round_inputs) >= len(self._active):
                self._round_complete_locked()
            elif not self._active:
                self._cond.notify_all()
            pending = self.__dict__.pop("_pending_ckpt", None)
        self._save_pending(pending)

    def commit(self, delta, worker: int = 0, worker_clock: int = 0):
        raise TypeError(
            "EASGDParameterServer is synchronous; workers use commit_and_wait")
