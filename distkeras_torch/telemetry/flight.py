"""Flight recorder: a bounded ring of per-tick engine snapshots.

Metrics answer "what are the aggregate rates?" and traces answer "what
happened to request N?" — neither answers "why did tick 48211 take
300 ms?". The flight recorder does: the serving engine records one
structured snapshot per tick (slot states, queue depth, token-budget
split, block usage, tick latency decomposed into host-plan / device /
stream phases, recompile count, memory watermarks) into a bounded ring,
so the last few thousand ticks of engine state are always reconstructable
— a black box, in the aviation sense.

The engine's snapshot times its tick by the loop's phase spans
(:class:`~distkeras_torch.telemetry.trace.Tracer`: ``engine.admit``,
``engine.plan``, ``engine.launch``, ``engine.wait``, ``engine.settle``,
``engine.record``, in the tracer's own ring, with running totals the
engine's ``stats()`` exposes): ``plan_ms``, ``dispatch_ms`` (launch),
``device_wait_ms`` and ``stream_ms`` (settle) are those spans of the
tick, ``tick_ms`` sums every phase since the previous snapshot (the
idle phase left out) and ``t0_ns`` is the first one's start on
``time.perf_counter_ns()``. ``device_ms`` is ``dispatch_ms`` plus
``device_wait_ms``: host time, not the device's.

Snapshots are plain dicts (msgpack/json clean) and recording is an
append under a lock — the engine self-measures the overhead and
``serve_bench --smoke`` asserts it stays under 5% of the tick. The ring
is dumped three ways:

- **on demand**: the msgpack ``flight`` op, the HTTP ``/flight``
  endpoint, or :meth:`FlightRecorder.dump` to a JSONL path;
- **on crash**: the engine wraps :meth:`ServingEngine.step` — an
  exception dumps a postmortem JSONL before re-raising;
- **on stall**: the :class:`~distkeras_torch.telemetry.slo.StallWatchdog`
  fires a postmortem when ``step()`` stops making progress while work
  is pending.

Postmortems land in ``postmortem_dir`` (default ``/tmp``) as
``distkeras-postmortem-<pid>-<reason>-<n>.jsonl`` — the CI workflow
uploads anything matching ``/tmp/distkeras-postmortem*`` when tier-1
fails. Render a dump with::

    python -m distkeras_torch.telemetry.report --flight <dump.jsonl>

Like the rest of this package: stdlib-only, no jax import.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

# the filename prefix CI globs for (tier1.yml uploads /tmp/distkeras-
# postmortem* as a workflow artifact on failure)
POSTMORTEM_PREFIX = "distkeras-postmortem"


class FlightRecorder:
    """Thread-safe bounded ring of per-tick snapshot dicts.

    ``capacity`` bounds the ring in ticks (one snapshot each); older
    ticks age out and are counted in ``dropped``. ``postmortem_dir`` is
    where :meth:`dump_postmortem` writes its JSONL files.
    """

    def __init__(self, capacity: int = 512,
                 postmortem_dir: str = "/tmp"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = capacity
        self.postmortem_dir = postmortem_dir
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0  # ticks aged out of the ring
        self._dump_seq = 0

    # -- recording ----------------------------------------------------------

    def record(self, snap: dict):
        """Append one tick snapshot (a plain dict; the caller owns the
        schema). O(1); the engine times this call and reports the
        overhead fraction in its stats."""
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(snap)

    # -- querying -----------------------------------------------------------

    def snapshots(self, last: Optional[int] = None) -> List[dict]:
        """Recorded ticks, oldest first; ``last`` keeps only the most
        recent N."""
        with self._lock:
            snaps = list(self._buf)
        if last is not None and last >= 0:
            snaps = snaps[-last:]
        return snaps

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def percentile(self, key: str, q: float,
                   kind: str = "tick") -> Optional[float]:
        """Exact percentile of a numeric snapshot field across the
        retained ring (``q`` in [0, 100]); None when no retained
        snapshot of ``kind`` carries ``key``. This is how the pipeline
        benches and tests assert overlap claims — e.g. steady-state
        ``device_wait_ms`` p50 must drop under ``pipeline=True`` —
        without exporting the ring through a registry histogram's
        bucket interpolation."""
        vals = sorted(
            float(s[key]) for s in self.snapshots()
            if s.get("kind") == kind and isinstance(s.get(key),
                                                    (int, float))
        )
        if not vals:
            return None
        idx = min(int(q / 100.0 * len(vals)), len(vals) - 1)
        return vals[idx]

    def clear(self):
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    # -- dumping ------------------------------------------------------------

    def meta(self, reason: str = "scrape", **attrs) -> dict:
        """The dump header record: reason, pid, ring occupancy.
        ``recorded`` and ``dropped`` are read under one lock hold so a
        concurrent ``record()`` can't skew them against each other."""
        with self._lock:
            recorded, dropped = len(self._buf), self.dropped
        meta = {
            "kind": "flight_meta", "reason": reason, "pid": os.getpid(),
            "unix_time": round(time.time(), 3),
            "recorded": recorded, "dropped": dropped,
        }
        for k, v in attrs.items():
            if v is not None:
                meta[k] = v
        return meta

    def dump(self, path: str, reason: str = "manual",
             last: Optional[int] = None, **attrs) -> int:
        """Write a meta line plus every retained snapshot as JSONL.
        Returns the number of tick lines written."""
        snaps = self.snapshots(last=last)
        with open(path, "w") as fh:
            fh.write(json.dumps(self.meta(reason, **attrs)) + "\n")
            for s in snaps:
                fh.write(json.dumps(s) + "\n")
        return len(snaps)

    def dump_postmortem(self, reason: str, **attrs) -> str:
        """Dump the ring to a fresh postmortem file and return its path.
        Never raises: a failing postmortem must not mask the crash that
        triggered it (falls back to the system temp dir, then gives
        up and returns "")."""
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
        fname = f"{POSTMORTEM_PREFIX}-{os.getpid()}-{reason}-{seq}.jsonl"
        for d in (self.postmortem_dir, "/tmp"):
            path = os.path.join(d, fname)
            try:
                self.dump(path, reason=reason, **attrs)
                return path
            except OSError:
                continue
        return ""
