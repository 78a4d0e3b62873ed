"""Structured training metrics.

The reference's observability is per-batch loss lists + a PS update counter
(SURVEY.md §5.5). This module upgrades that to structured per-step records
with derived throughput and staleness statistics, written as JSON lines so
any downstream tool can consume them.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, List, Optional


class MetricsWriter:
    """Append-only JSONL metrics sink with wall-clock and throughput
    bookkeeping. Thread-safe: async trainers share one writer across N
    worker threads, and buffered text writes are not atomic, so appends
    take a lock."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._records: List[dict] = []
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()
        self._lock = threading.Lock()

    def log(self, step: int, samples: Optional[int] = None,
            worker: Optional[int] = None, **scalars):
        rec = {"step": int(step), "t": round(time.time() - self._t0, 6)}
        if samples is not None:
            rec["samples"] = int(samples)
        if worker is not None:
            rec["worker"] = int(worker)
        for k, v in scalars.items():
            rec[k] = float(v)
        self._append(rec)

    def summary(self, kind: str, **fields):
        """Write a non-step summary record (e.g. a staleness histogram or
        final throughput) as its own JSON line."""
        self._append({"kind": kind, **fields})

    def _append(self, rec: dict):
        with self._lock:
            self._records.append(rec)
            if self._fh:
                self._fh.write(json.dumps(rec) + "\n")

    @property
    def records(self) -> List[dict]:
        # under the lock like every other _records access: a list copy
        # concurrent with an append must not observe a half-built state
        with self._lock:
            return list(self._records)

    def percentiles(
        self, key: str, ps=(50, 90, 99)
    ) -> Optional[Dict[str, float]]:
        """p50/p90/p99 (linear interpolation, numpy convention) over
        every logged record carrying ``key`` — the serving engine and
        serve_bench both report their TTFT / per-token latency
        distributions through this. None when nothing logged ``key``,
        and None when every logged value is non-finite (NaN/inf would
        otherwise poison the sort and return NaN percentiles — the
        serving ITL report depends on None for scenarios that produced
        no decode ticks)."""
        with self._lock:
            vals = sorted(
                v for r in self._records if key in r
                for v in (float(r[key]),) if math.isfinite(v)
            )
        if not vals:
            return None
        out: Dict[str, float] = {}
        for p in ps:
            rank = (len(vals) - 1) * p / 100.0
            lo = int(rank)
            hi = min(lo + 1, len(vals) - 1)
            out[f"p{p}"] = round(
                vals[lo] + (vals[hi] - vals[lo]) * (rank - lo), 6
            )
        return out

    def throughput(self) -> Optional[float]:
        """Overall samples/sec across logged records (None without samples)."""
        with self._lock:
            with_samples = [r for r in self._records if "samples" in r]
        if len(with_samples) < 2:
            return None
        total = sum(r["samples"] for r in with_samples[1:])
        dt = with_samples[-1]["t"] - with_samples[0]["t"]
        return total / dt if dt > 0 else None

    def close(self):
        """Flush and close the JSONL file (idempotent; records stay
        queryable). Under the lock — async workers may be mid-append."""
        with self._lock:
            if self._fh:
                self._fh.flush()
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def staleness_histogram(staleness_log: List[int]) -> Dict[int, int]:
    """Histogram of commit staleness from a parameter server's log
    (DynSGD records these; see parameter_servers.py)."""
    out: Dict[int, int] = {}
    for s in staleness_log:
        out[s] = out.get(s, 0) + 1
    return dict(sorted(out.items()))
