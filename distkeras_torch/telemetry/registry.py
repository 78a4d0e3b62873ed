"""Process-wide metric registry: counters, gauges, fixed-bucket histograms.

The pre-telemetry observability was three disjoint sinks — the trainers'
:class:`~distkeras_torch.utils.metrics.MetricsWriter` JSONL, the serving
engine's ad-hoc ``stats()`` dict, and the PS ``staleness_log`` list —
none of which a live scraper could read. This module is the one place
every subsystem registers into: Prometheus-style metric objects with
optional labels, safe to update from any thread, snapshot-able at any
moment for the msgpack ``stats`` ops and the HTTP exposition endpoint
(:mod:`distkeras_torch.telemetry.exposition`).

Design constraints, in order:

- **Hot-path cheap.** ``inc``/``set``/``observe`` are a lock plus a few
  float ops; histograms use a precomputed bucket list and a linear scan
  (bucket counts are small and fixed — bisect would not pay for itself at
  the sizes used here). The serving engine calls these once per *tick*
  (not per token per slot), the PS once per op.
- **Get-or-create.** ``registry.counter(name, ...)`` returns the existing
  metric when one is already registered under ``name`` (type and label
  names must match), so modules can declare their metrics at use sites
  without import-order coordination.
- **Plain-data snapshots.** ``collect()`` returns dicts of
  str/int/float only — directly serializable by the framed-msgpack
  transport and by ``json``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

# Default latency buckets (milliseconds): spans four orders of magnitude,
# covering sub-ms CPU ticks through multi-second PS round trips.
LATENCY_MS_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

# Commit staleness is a small non-negative integer (DynSGD scales by
# 1/(staleness+1)); powers of two keep the tail visible.
STALENESS_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)

# Fractions in [0, 1] (e.g. prefill share of a tick's admissions).
FRACTION_BUCKETS = (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


class _Bound:
    """One labelled child of a metric: the object ``labels(...)`` hands
    back, holding the resolved label-value key. Cheap to construct; cache
    it on hot paths."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "_Metric", key: Tuple[str, ...]):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0):
        self._metric._inc(self._key, amount)

    def set(self, value: float):
        self._metric._set(self._key, value)

    def observe(self, value: float, exemplar: Optional[str] = None):
        self._metric._observe(self._key, value, exemplar)

    @property
    def value(self):
        return self._metric._value(self._key)


class _Metric:
    """Base: a named family of (labels → state) series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}

    # -- label plumbing -----------------------------------------------------

    def labels(self, **kv) -> _Bound:
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}"
            )
        key = tuple(str(kv[n]) for n in self.labelnames)
        return _Bound(self, key)

    def _unlabeled(self) -> Tuple[str, ...]:
        if self.labelnames:
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}; "
                f"use .labels(...)"
            )
        return ()

    # -- direct (unlabeled) API ---------------------------------------------

    def inc(self, amount: float = 1.0):
        self._inc(self._unlabeled(), amount)

    def set(self, value: float):
        self._set(self._unlabeled(), value)

    def observe(self, value: float, exemplar: Optional[str] = None):
        self._observe(self._unlabeled(), value, exemplar)

    @property
    def value(self):
        return self._value(self._unlabeled())

    # -- state ops (subclasses) ---------------------------------------------

    def _inc(self, key, amount):
        raise TypeError(f"{self.kind} does not support inc()")

    def _set(self, key, value):
        raise TypeError(f"{self.kind} does not support set()")

    def _observe(self, key, value, exemplar=None):
        raise TypeError(f"{self.kind} does not support observe()")

    def _value(self, key):
        with self._lock:
            return self._series.get(key, 0.0)

    def _copy_state(self, state):
        """A consistent copy of one series' state, taken while the
        metric lock is held. Scalar states (counter/gauge) are already
        immutable; histograms override with a deep copy so rendering
        OUTSIDE the lock can never see a torn write (the same
        torn-read shape ``FlightRecorder.meta()`` fixed: bucket counts
        from one observe, sum/count from the next)."""
        return state

    def snapshot(self) -> dict:
        """Plain-data view: {"type", "help", "labelnames", "series":
        [{"labels": {...}, ...state...}]}. Per-series state is copied
        in the SAME lock hold that reads the series map, so every
        rendered series is internally consistent under concurrent
        writes."""
        with self._lock:
            items = [(key, self._copy_state(state))
                     for key, state in self._series.items()]
        return {
            "type": self.kind,
            "help": self.help,
            "labelnames": list(self.labelnames),
            "series": [
                {"labels": dict(zip(self.labelnames, key)),
                 **self._render_state(state)}
                for key, state in items
            ],
        }

    def _render_state(self, state) -> dict:
        return {"value": state}


class Counter(_Metric):
    """Monotonically increasing float (resets only with the process)."""

    kind = "counter"

    def _inc(self, key, amount):
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount


class Gauge(_Metric):
    """Point-in-time value; settable and incrementable."""

    kind = "gauge"

    def _set(self, key, value):
        with self._lock:
            self._series[key] = float(value)

    def _inc(self, key, amount):
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative ``le`` buckets, Prometheus
    convention, with an implicit +Inf bucket) plus sum and count."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = LATENCY_MS_BUCKETS):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"{self.name}: need at least one bucket")
        self.buckets = b

    def _observe(self, key, value, exemplar=None):
        v = float(value)
        with self._lock:
            state = self._series.get(key)
            if state is None:
                # [per-bucket counts (+Inf last), sum, count,
                #  {bucket index: (value, exemplar)}]
                state = [[0] * (len(self.buckets) + 1), 0.0, 0, {}]
                self._series[key] = state
            counts = state[0]
            idx = len(self.buckets)  # +Inf unless a bound catches it
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    idx = i
                    break
            counts[idx] += 1
            state[1] += v
            state[2] += 1
            if exemplar is not None:
                # most-recent exemplar per bucket: the trace id that
                # LAST landed here, so the tail's exemplar is still
                # resolvable in the bounded trace archives (an all-time
                # max would name a long-evicted chain)
                state[3][idx] = (v, str(exemplar))

    def _value(self, key):
        with self._lock:
            state = self._series.get(key)
            if state is None:
                return None
            state = self._copy_state(state)
        return self._render_state(state)

    def _copy_state(self, state):
        # deep enough that concurrent observes can't tear the render:
        # counts list and exemplar dict are the mutated containers
        return [list(state[0]), state[1], state[2], dict(state[3])]

    def _render_state(self, state) -> dict:
        counts, total, n, exemplars = state
        out = {
            "buckets": {
                **{repr(ub): c for ub, c in zip(self.buckets, counts)},
                "+Inf": counts[-1],
            },
            "sum": round(total, 6),
            "count": n,
        }
        if exemplars:
            le = [repr(ub) for ub in self.buckets] + ["+Inf"]
            out["exemplars"] = {
                le[i]: {"value": v, "trace_id": x}
                for i, (v, x) in sorted(exemplars.items())
            }
        return out

    def tail_exemplar(self, **labels) -> Optional[dict]:
        """The exemplar from the highest populated bucket — the trace
        id that names this series' current tail (``stats()`` surfaces
        it next to p99). None until an exemplar-bearing observation
        landed. One lock hold, like :meth:`percentile`."""
        key = (tuple(str(labels[n]) for n in self.labelnames)
               if labels else self._unlabeled())
        with self._lock:
            state = self._series.get(key)
            if state is None or not state[3]:
                return None
            idx, (v, x) = max(state[3].items())
        le = [repr(ub) for ub in self.buckets] + ["+Inf"]
        return {"value": v, "trace_id": x, "le": le[idx]}

    def percentile(self, p: float, **labels) -> Optional[float]:
        """Bucket-interpolated percentile estimate (the exact-value
        percentiles stay with MetricsWriter; this is the scrape-side
        approximation). None until something was observed, and None
        when every observation fell outside the bucket range (all in
        +Inf — e.g. NaN or beyond the last bound): there is no finite
        bucket to interpolate in, and callers like serve_bench's ITL
        report key on None, not a fabricated bound."""
        key = (tuple(str(labels[n]) for n in self.labelnames)
               if labels else self._unlabeled())
        with self._lock:
            state = self._series.get(key)
            if state is None or state[2] == 0:
                return None
            # bucket counts and total count in ONE lock hold: a copy
            # taken across two acquisitions could see counts from one
            # observe and n from the next (the FlightRecorder.meta
            # torn-read shape), and the interpolation below would
            # then walk past the real distribution
            counts, n = list(state[0]), state[2]
        if sum(counts[:-1]) == 0:  # nothing landed in a finite bucket
            return None
        rank = n * p / 100.0
        cum = 0
        lo = 0.0
        for i, ub in enumerate(self.buckets):
            prev = cum
            cum += counts[i]
            if cum >= rank:
                frac = (rank - prev) / counts[i] if counts[i] else 0.0
                return round(lo + (ub - lo) * frac, 6)
            lo = ub
        return self.buckets[-1]  # landed in +Inf: clamp to the last bound


class MetricRegistry:
    """Thread-safe name → metric map with get-or-create registration.

    One process-global instance (:func:`get_registry`) is the default
    sink for every subsystem; isolated instances (benchmarks, tests)
    just construct their own and pass it down.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.labelnames}"
                    )
                return m
            m = cls(name, help=help, labelnames=labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_MS_BUCKETS) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def get(self, name: str) -> Optional[_Metric]:
        """The registered metric under ``name``, or None — read-side
        lookup for consumers (the SLO monitor) that must not create."""
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> Dict[str, dict]:
        """Plain-data snapshot of every registered metric — the payload
        of the msgpack ``stats`` ops and ``/metrics.json``. The
        name → metric map is captured in one registry-lock hold (a
        concurrent registration lands wholly before or wholly after
        this snapshot, never half-iterated), then each metric renders
        itself under its own lock — no nested lock holds, so a slow
        histogram render never blocks registration."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in items}


_global_registry = MetricRegistry()


def get_registry() -> MetricRegistry:
    """The process-global registry every subsystem defaults to."""
    return _global_registry
