"""Runtime introspection: recompile counting and memory watermarks.

Two failure modes are invisible to rate metrics until they take the
service down:

- **Silent recompiles.** The serving engine's jitted tick/prefill
  functions are compiled once per configuration; a steady-state retrace
  (a leaked dynamic shape, a config tuple that differs per call) turns
  every N-ms tick into a multi-second compile — and nothing in the
  metrics says why. The fix starts with *seeing* it: the engine calls
  :meth:`RecompileCounter.note` inside each traced function body —
  under ``jax.jit`` the Python body runs only on a trace-cache miss, so
  each call IS one compilation. The process-global :data:`recompiles`
  counter mirrors jit's process-global trace caches;
  ``ServingEngine.stats()`` exposes the per-function counts and
  ``serve_bench --smoke`` asserts zero new traces after warmup.

- **Creeping memory.** Host RSS (:func:`host_rss_bytes`, read from
  ``/proc/self/status``) and device allocator stats
  (``device.memory_stats()``, where the backend supports them — CPU
  returns None) are sampled by the engine into gauges and
  watermark-tracked, so a leaking block pool or fragmenting allocator
  shows a rising floor long before the OOM.

This module is stdlib-only like the rest of the package: jax never
enters here — the *engine* calls ``note()`` from its traced bodies and
feeds ``memory_stats()`` readings in from its side of the fence.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional


class RecompileCounter:
    """Thread-safe per-function trace counts. ``note(fn)`` is called at
    trace time from inside jitted function bodies; ``counts()`` /
    ``total()`` read; ``mark()`` + ``since(mark)`` bracket a steady
    state (warmup ends → mark → any later delta is a bug)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._total = 0

    def note(self, fn: str):
        with self._lock:
            self._counts[fn] = self._counts.get(fn, 0) + 1
            self._total += 1

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def total(self) -> int:
        # read every engine tick: kept incrementally, not summed
        with self._lock:
            return self._total

    def mark(self) -> Dict[str, int]:
        """Snapshot to diff against later with :meth:`since`."""
        return self.counts()

    def since(self, mark: Dict[str, int]) -> Dict[str, int]:
        """Per-function traces since ``mark`` (only nonzero entries —
        empty dict means a clean steady state)."""
        out = {}
        for fn, n in self.counts().items():
            d = n - mark.get(fn, 0)
            if d:
                out[fn] = d
        return out


# Process-global, matching the process-global jit trace caches the
# engine's lru_cached tick/prefill factories share across engines.
recompiles = RecompileCounter()


_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def host_rss_bytes() -> Optional[int]:
    """Current resident set size of this process in bytes, or None when
    the platform offers no cheap reading (no /proc). Reads
    ``/proc/self/statm`` (one short line) rather than scanning
    ``status`` — this is called from the engine's tick path."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        return None


class MemoryWatermarks:
    """Tracks current + peak readings for host RSS and (when the caller
    supplies them) device allocator stats. The engine owns the jax
    side: it passes ``device.memory_stats()`` dicts in; this class just
    keeps the high-water marks and renders a plain-dict summary."""

    def __init__(self):
        self.rss_bytes: Optional[int] = None
        self.rss_peak_bytes: int = 0
        self.device_bytes: Optional[int] = None
        self.device_peak_bytes: int = 0
        self.device_supported: Optional[bool] = None  # None = untested

    def sample_host(self) -> Optional[int]:
        rss = host_rss_bytes()
        if rss is not None:
            self.rss_bytes = rss
            self.rss_peak_bytes = max(self.rss_peak_bytes, rss)
        return rss

    def sample_device(self, stats: Optional[dict]):
        """Feed one ``device.memory_stats()`` result (None on backends
        without allocator stats — recorded so callers can stop asking)."""
        if not stats:
            if self.device_supported is None:
                self.device_supported = False
            return
        self.device_supported = True
        in_use = stats.get("bytes_in_use")
        if in_use is not None:
            self.device_bytes = int(in_use)
            self.device_peak_bytes = max(self.device_peak_bytes,
                                         int(in_use))
        peak = stats.get("peak_bytes_in_use")
        if peak is not None:
            self.device_peak_bytes = max(self.device_peak_bytes,
                                         int(peak))

    def summary(self) -> dict:
        mb = 1024 * 1024
        out = {
            "rss_mb": (round(self.rss_bytes / mb, 1)
                       if self.rss_bytes is not None else None),
            "rss_peak_mb": round(self.rss_peak_bytes / mb, 1),
        }
        if self.device_supported:
            out["device_mb"] = (
                round(self.device_bytes / mb, 1)
                if self.device_bytes is not None else None)
            out["device_peak_mb"] = round(self.device_peak_bytes / mb, 1)
        return out
