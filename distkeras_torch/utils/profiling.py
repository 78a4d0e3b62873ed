"""Profiling hooks — the port of :mod:`distkeras_tpu.utils.profiling`.

:func:`trace` wraps ``torch.profiler`` (host and, where there is a card,
CUDA activity) and writes a Chrome trace into a directory; the trainers'
``profile_dir=`` runs training inside it. :class:`StepTimer` reads the
clock only after the device has finished, because PyTorch's CUDA calls
return before their kernels do.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('/tmp/profile'):`` -> ``log_dir/trace-<pid>-<ms>.json``,
    a Chrome trace (chrome://tracing, Perfetto) of what ran inside. The
    file is written also when the body raises."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json"))


def _synchronize(sync_on=None):
    """Wait for the CUDA devices of the tensors in ``sync_on`` (a tensor or
    a list/tuple/dict of them), or for the current CUDA device when none
    is given and CUDA is in use."""
    if sync_on is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    if isinstance(sync_on, dict):
        sync_on = list(sync_on.values())
    for t in sync_on if isinstance(sync_on, (list, tuple)) else [sync_on]:
        if isinstance(t, (list, tuple, dict)):
            _synchronize(t)
        elif isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)


class StepTimer:
    """Wall-clock timer that waits for the device before each reading, so
    timings measure compute rather than the enqueue."""

    def __init__(self):
        self.durations: list = []
        self._t: Optional[float] = None

    def start(self):
        _synchronize()
        self._t = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        if self._t is None:
            warnings.warn(
                "StepTimer.stop() called before start(); returning 0.0",
                RuntimeWarning, stacklevel=2,
            )
            return 0.0
        _synchronize(sync_on)
        dt = time.perf_counter() - self._t
        self._t = None  # consumed: a second stop() warns, not double-counts
        self.durations.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.durations)) if self.durations else 0.0
