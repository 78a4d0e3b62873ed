"""Time-series plane: a bounded ring of periodic metric-registry deltas.

The registry answers "what is the value *now*"; the flight recorder
answers "what were the engine's last N ticks". Neither answers the
forensic question an operator actually asks after an autoscaler action
or a weight push: *what did p99 ITL do in the 30 s around that event?*
This module is the Monarch-style history half of that join — the event
journal (:mod:`~distkeras_torch.telemetry.events`) is the other half.

:class:`TimeSeriesStore` keeps a bounded in-process ring of *points*.
Each point is one pass over a :class:`MetricRegistry` snapshot, reduced
to plain scalars against the previous pass:

- **counters → rates**: ``serving_tokens_total`` becomes
  ``serving_tokens_total:rate`` (delta / dt, per second);
- **gauges → samples**: the current value under the family's own key;
- **histograms → windowed percentiles**: bucket-count deltas since the
  previous point, interpolated to ``:p50`` / ``:p99`` plus an
  observation ``:count`` — the *tail of the last interval*, not the
  process-lifetime tail the registry percentile gives.

Labeled series flatten to ``family{label="value",...}`` keys, so a
point's ``series`` dict is msgpack/JSON-ready as-is (the ``timeseries``
wire op ships it unmodified).

Sampling is driven by :meth:`TimeSeriesStore.start` — a daemon
collector thread on the same cadence pattern as
:class:`~distkeras_torch.telemetry.slo.SloMonitor` — or by calling
:meth:`sample` manually (``now``/``wall`` injection keeps tests
deterministic). Every ``sample()`` is self-timed the same way the
engine times its flight recorder: :meth:`meta` reports
``overhead_frac``, the fraction of wall time since the collector
started that was spent inside ``sample()``; serve_bench's fleet-sim
smoke asserts it stays under 1%.

Fleet merge: :func:`merge_timeseries` aligns per-replica rings on a
shared time bucket and merges with the same MAX-vs-SUM discipline as
``merge_metric_snapshots`` — rates and counts SUM, gauges SUM unless
the family is version/flag-shaped (the caller passes the MAX set),
and windowed percentiles take the MAX (the worst replica's tail;
percentiles of disjoint populations cannot be averaged soundly).

Stdlib-only, like the rest of the package.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from distkeras_torch.telemetry.registry import (
    MetricRegistry,
    get_registry,
)

# the windowed-percentile columns every histogram family contributes
PERCENTILE_POINTS = (50.0, 99.0)


def series_key(family: str, labels: dict) -> str:
    """``family{k="v",...}`` — the flattened series identity. Label
    values are escaped like the Prometheus exposition (backslash,
    quote, newline) so the key round-trips through text renderings."""
    if not labels:
        return family
    inner = ",".join(
        '{}="{}"'.format(
            k,
            str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"),
        )
        for k, v in labels.items()
    )
    return family + "{" + inner + "}"


def base_family(key: str) -> str:
    """The registry family a series key belongs to (labels and the
    ``:rate``/``:p50``-style reduction suffix stripped)."""
    brace = key.find("{")
    if brace >= 0:
        return key[:brace]
    colon = key.rfind(":")
    return key[:colon] if colon >= 0 else key


def _bucket_deltas(prev: Optional[dict], cur: dict,
                   ) -> Tuple[List[float], List[int]]:
    """(finite upper bounds, per-bucket observation deltas incl. +Inf
    last) between two histogram-series snapshots."""
    bounds = sorted(float(k) for k in cur["buckets"] if k != "+Inf")
    deltas = []
    pb = (prev or {}).get("buckets", {})
    for k in [repr(b) for b in bounds] + ["+Inf"]:
        d = int(cur["buckets"].get(k, 0)) - int(pb.get(k, 0))
        deltas.append(max(d, 0))
    return bounds, deltas


def _windowed_percentile(bounds: List[float], deltas: List[int],
                         p: float) -> Optional[float]:
    """Bucket-interpolated percentile of one window's observations —
    the same estimator as ``Histogram.percentile``, over deltas."""
    n = sum(deltas)
    if n == 0 or sum(deltas[:-1]) == 0:
        return None  # empty window, or everything landed in +Inf
    rank = n * p / 100.0
    cum = 0
    lo = 0.0
    for ub, c in zip(bounds, deltas):
        prev = cum
        cum += c
        if cum >= rank:
            frac = (rank - prev) / c if c else 0.0
            return round(lo + (ub - lo) * frac, 6)
        lo = ub
    return bounds[-1] if bounds else None


class TimeSeriesStore:
    """Bounded ring of registry-delta points, with an optional
    self-timed collector thread.

    Mirrors the flight recorder's storage discipline: a deque ring of
    ``capacity`` points, O(1) append under one lock, a ``dropped``
    counter for overwritten history, and a one-lock-hold :meth:`meta`.
    """

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 capacity: int = 720, interval_s: float = 1.0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        if interval_s <= 0:
            raise ValueError(
                f"interval_s must be > 0; got {interval_s}")
        self.registry = registry or get_registry()
        self.capacity = capacity
        self.interval_s = interval_s
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.samples = 0
        # previous registry snapshot keyed by (family, label tuple) so
        # deltas survive label-set growth between points
        self._prev: Optional[Dict] = None
        self._prev_mono: Optional[float] = None
        # self-timing (engine/flight-recorder pattern): ns inside
        # sample() vs wall ns since the clock started
        self._sample_ns = 0
        self._clock0_ns: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- sampling -----------------------------------------------------------

    def sample(self, now: Optional[float] = None,
               wall: Optional[float] = None) -> dict:
        """Take one point: snapshot the registry, reduce against the
        previous snapshot, append to the ring, return the point.
        ``now`` (monotonic) and ``wall`` (epoch) are injectable for
        deterministic tests."""
        t0 = time.perf_counter_ns()
        if self._clock0_ns is None:
            self._clock0_ns = t0
        now = time.monotonic() if now is None else float(now)
        wall = time.time() if wall is None else float(wall)
        snap = self.registry.collect()
        with self._lock:
            # reduce-against-previous and ring append in ONE lock hold:
            # a concurrent sampler must never pair a point with the
            # wrong baseline snapshot (the FlightRecorder.meta
            # torn-read shape)
            point = self._reduce(snap, self._prev, self._prev_mono,
                                 now, wall)
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(point)
            self.samples += 1
            self._prev = snap
            self._prev_mono = now
            self._sample_ns += time.perf_counter_ns() - t0
        return point

    @staticmethod
    def _reduce(snap: dict, prev: Optional[dict],
                prev_mono: Optional[float], now: float,
                wall: float) -> dict:
        dt = (now - prev_mono) if prev_mono is not None else None
        series: Dict[str, float] = {}

        def prev_series(name: str, labels: dict) -> Optional[dict]:
            fam = (prev or {}).get(name)
            if not fam:
                return None
            for s in fam["series"]:
                if s["labels"] == labels:
                    return s
            return None

        for name, fam in snap.items():
            for s in fam["series"]:
                key = series_key(name, s["labels"])
                old = prev_series(name, s["labels"])
                if fam["type"] == "counter":
                    if dt is None or dt <= 0:
                        continue  # rates need two points
                    delta = s["value"] - (old["value"] if old else 0.0)
                    series[key + ":rate"] = round(max(delta, 0.0) / dt,
                                                  6)
                elif fam["type"] == "histogram":
                    bounds, deltas = _bucket_deltas(old, s)
                    n = sum(deltas)
                    series[key + ":count"] = n
                    for p in PERCENTILE_POINTS:
                        v = _windowed_percentile(bounds, deltas, p)
                        if v is not None:
                            series[f"{key}:p{p:g}"] = v
                else:  # gauge / untyped point-in-time value
                    v = s.get("value")
                    if isinstance(v, (int, float)):
                        series[key] = v
        return {"t": round(wall, 6),
                "dt": round(dt, 6) if dt is not None else None,
                "series": series}

    # -- querying -----------------------------------------------------------

    def points(self, last: Optional[int] = None) -> List[dict]:
        """The ring, oldest first; ``last`` keeps the most recent n."""
        with self._lock:
            pts = list(self._ring)
        return pts[-last:] if last else pts

    def series(self, key: str) -> List[Tuple[float, float]]:
        """One series as ``[(t, value), ...]`` (points where the key
        was absent are skipped)."""
        return [(p["t"], p["series"][key]) for p in self.points()
                if key in p["series"]]

    def meta(self) -> dict:
        """Ring/collector state, read in ONE lock hold (the
        FlightRecorder.meta torn-read fix, applied from day one)."""
        t_ns = time.perf_counter_ns()
        with self._lock:
            recorded = len(self._ring)
            dropped = self.dropped
            samples = self.samples
            sample_ns = self._sample_ns
            clock0 = self._clock0_ns
        elapsed = (t_ns - clock0) if clock0 is not None else 0
        return {
            "recorded": recorded,
            "capacity": self.capacity,
            "dropped": dropped,
            "samples": samples,
            "interval_s": self.interval_s,
            # the collector's cost, measured by the collector itself
            "overhead_frac": round(sample_ns / max(elapsed, 1), 6),
        }

    # -- background collection ----------------------------------------------

    def start(self) -> "TimeSeriesStore":
        """Start the daemon collector thread (idempotent)."""
        if self._thread is not None:
            return self
        self._stop.clear()
        if self._clock0_ns is None:
            self._clock0_ns = time.perf_counter_ns()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.sample()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None


def _merge_key(key: str, value: float, acc: Dict[str, float],
               max_families: frozenset):
    """Fold one series sample into a merged bucket under the
    MAX-vs-SUM policy."""
    if key.endswith((":rate", ":count")):
        acc[key] = acc.get(key, 0.0) + value
        return
    colon = key.rfind(":")
    if colon >= 0 and key[colon + 1:].startswith("p"):
        # windowed percentile: worst replica's tail
        acc[key] = max(acc.get(key, value), value)
        return
    if base_family(key) in max_families:
        acc[key] = max(acc.get(key, value), value)
    else:
        acc[key] = acc.get(key, 0.0) + value


def merge_timeseries(points_by_source: Dict[str, List[dict]],
                     bucket_s: float = 1.0,
                     max_families: Iterable[str] = (),
                     ) -> List[dict]:
    """Merge per-replica point rings into one fleet series.

    Points are aligned on ``bucket_s``-wide wall-clock buckets (each
    replica samples on its own clock — exact timestamps never line
    up). Within a bucket, each source contributes its latest point;
    series merge per key: ``:rate``/``:count`` SUM, ``:pNN`` MAX,
    gauges SUM unless their family is in ``max_families`` (the
    caller's version/flag set — ``merge_metric_snapshots`` policy).
    Returns time-ordered points tagged with the contributing
    ``sources``."""
    if bucket_s <= 0:
        raise ValueError(f"bucket_s must be > 0; got {bucket_s}")
    maxf = frozenset(max_families)
    buckets: Dict[int, Dict[str, dict]] = {}
    for source, points in points_by_source.items():
        for p in points:
            b = int(p["t"] // bucket_s)
            # latest point per (bucket, source) wins — one vote each
            slot = buckets.setdefault(b, {})
            cur = slot.get(source)
            if cur is None or p["t"] >= cur["t"]:
                slot[source] = p
    out = []
    for b in sorted(buckets):
        series: Dict[str, float] = {}
        contributors = sorted(buckets[b])
        for source in contributors:
            for key, v in buckets[b][source]["series"].items():
                if isinstance(v, (int, float)):
                    _merge_key(key, v, series, maxf)
        out.append({
            "t": round(b * bucket_s, 6),
            "dt": bucket_s,
            "series": {k: (round(v, 6)
                           if isinstance(v, float) else v)
                       for k, v in series.items()},
            "sources": contributors,
        })
    return out


def write_timeline(path: str, points: List[dict], events: List[dict],
                   meta: Optional[dict] = None) -> str:
    """One offline timeline artifact: a meta line, then one JSONL line
    per point (``{"point": ...}``) and per journal event
    (``{"event": ...}``) — the input format of ``report --timeline``.
    Returns ``path``."""
    import json

    with open(path, "w") as f:
        f.write(json.dumps({"timeline_meta": dict(meta or {})}) + "\n")
        for p in points:
            f.write(json.dumps({"point": p}) + "\n")
        for e in events:
            f.write(json.dumps({"event": e}) + "\n")
    return path
