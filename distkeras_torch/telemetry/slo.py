"""SLO monitoring: declarative sliding-window burn-rate alerts + a stall
watchdog, over the existing :class:`MetricRegistry`.

A dashboard full of histograms still needs a human watching it. This
module closes that loop the way production serving systems do
(multi-window burn-rate alerting, Google SRE workbook ch. 5): each
:class:`SloRule` names a registry metric, how to read it (histogram
percentile, gauge value, or counter rate), and a threshold; the
:class:`SloMonitor` samples every rule on a fixed cadence and keeps a
sliding window of breach/ok verdicts per alert window. An alert *fires*
only when the breach fraction exceeds ``burn_threshold`` in **every**
window — the short window makes alerts fast, the long window keeps one
latency spike from paging anyone.

Alert state is surfaced three ways, so whichever pane an operator is
looking at shows it:

- **metrics**: ``slo_alert_active{rule=...}`` gauge (0/1),
  ``slo_alerts_total{rule=...}`` fire counter, and
  ``slo_rule_value{rule=...}`` (the latest sampled value);
- **spans**: ``slo.alert`` / ``slo.resolve`` records in the tracer, so
  alert transitions land in the same timeline as request spans;
- **queries**: :meth:`SloMonitor.alerts` — served by the msgpack
  ``alerts`` op and the HTTP ``/alerts`` endpoint.

The :class:`StallWatchdog` covers the failure mode rules can't: an
engine that stops calling ``step()`` at all (deadlocked loop thread,
wedged device call) updates no metric, so no threshold ever trips. The
watchdog watches a progress counter directly and, when it stops
advancing while work is pending, fires a flight-recorder postmortem
(:meth:`FlightRecorder.dump_postmortem`) — the last N ticks of engine
state, captured at the moment the engine went quiet.

Stdlib-only, like the rest of the package.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from distkeras_torch.telemetry.registry import (
    Histogram,
    MetricRegistry,
    get_registry,
)
from distkeras_torch.telemetry.trace import Tracer, get_tracer


@dataclass(frozen=True)
class SloRule:
    """One declarative objective over a registry metric.

    Args:
      name: rule id (the ``rule`` label on the alert metrics).
      metric: registry metric name to sample.
      kind: how to read one sample — ``"p50"``/``"p90"``/``"p99"``
        (histogram percentile), ``"gauge"`` (current value), or
        ``"rate"`` (counter delta per second between polls).
      threshold: a sample strictly above this breaches the objective.
      labels: label values for labeled metrics (e.g.
        ``{"reason": "expired"}`` on the finish-reason counter).
      windows: alert windows in seconds, shortest first. The alert
        fires only when the breach fraction is >= ``burn_threshold``
        in every window.
      burn_threshold: breach fraction per window that counts as
        burning (0.5 = half the samples in the window are bad).
    """

    name: str
    metric: str
    kind: str = "gauge"
    threshold: float = 0.0
    labels: Optional[Tuple[Tuple[str, str], ...]] = None
    windows: Tuple[float, float] = (30.0, 120.0)
    burn_threshold: float = 0.5

    def __post_init__(self):
        if self.kind not in ("p50", "p90", "p99", "gauge", "rate"):
            raise ValueError(
                f"rule {self.name!r}: kind must be p50/p90/p99/gauge/"
                f"rate; got {self.kind!r}"
            )
        if not self.windows or any(w <= 0 for w in self.windows):
            raise ValueError(
                f"rule {self.name!r}: windows must be positive; "
                f"got {self.windows}"
            )
        if not 0.0 < self.burn_threshold <= 1.0:
            raise ValueError(
                f"rule {self.name!r}: burn_threshold must be in (0, 1]; "
                f"got {self.burn_threshold}"
            )


@dataclass(frozen=True)
class AnomalyRule:
    """A self-calibrating sibling of :class:`SloRule`: instead of a
    fixed threshold, the rule learns its metric's own trailing
    behavior (EWMA mean + EWMA variance) and breaches when a sample
    deviates more than ``z_threshold`` standard deviations from it —
    "p99 ITL deviated 4σ from its own trailing hour" needs no
    per-deployment bound. Samples are read exactly like SloRule
    (histogram percentile / gauge / counter rate), breach verdicts
    feed the same multi-window burn machinery, and firings surface
    through the same ``slo_alert_active`` / ``slo_alerts_total``
    metrics — so the autoscaler's burn inputs pick anomalies up with
    zero new plumbing.

    Args:
      name: rule id (the ``rule`` label on the alert metrics; include
        ``itl``/``ttft`` in the name for the autoscaler's burn-flag
        matching to see it).
      metric/kind/labels/windows/burn_threshold: as on SloRule.
      ewma_alpha: smoothing factor for the trailing mean/variance
        (higher = faster to forget; 0.05 ≈ a trailing window of ~20
        samples dominating the estimate).
      z_threshold: |sample − mean| / std above this is a breach.
      min_samples: calibration warmup — no verdicts (and so no
        firings) until this many samples trained the estimator.
    """

    name: str
    metric: str
    kind: str = "gauge"
    labels: Optional[Tuple[Tuple[str, str], ...]] = None
    ewma_alpha: float = 0.05
    z_threshold: float = 4.0
    min_samples: int = 20
    windows: Tuple[float, float] = (30.0, 120.0)
    burn_threshold: float = 0.5

    def __post_init__(self):
        if self.kind not in ("p50", "p90", "p99", "gauge", "rate"):
            raise ValueError(
                f"rule {self.name!r}: kind must be p50/p90/p99/gauge/"
                f"rate; got {self.kind!r}"
            )
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(
                f"rule {self.name!r}: ewma_alpha must be in (0, 1]; "
                f"got {self.ewma_alpha}"
            )
        if self.z_threshold <= 0:
            raise ValueError(
                f"rule {self.name!r}: z_threshold must be > 0; "
                f"got {self.z_threshold}"
            )
        if self.min_samples < 2:
            raise ValueError(
                f"rule {self.name!r}: min_samples must be >= 2; "
                f"got {self.min_samples}"
            )
        if not self.windows or any(w <= 0 for w in self.windows):
            raise ValueError(
                f"rule {self.name!r}: windows must be positive; "
                f"got {self.windows}"
            )
        if not 0.0 < self.burn_threshold <= 1.0:
            raise ValueError(
                f"rule {self.name!r}: burn_threshold must be in (0, 1]; "
                f"got {self.burn_threshold}"
            )


def default_anomaly_rules(z_threshold: float = 4.0,
                          min_samples: int = 20,
                          windows: Tuple[float, float] = (30.0, 120.0),
                          burn_threshold: float = 0.5,
                          ) -> List["AnomalyRule"]:
    """Deviation twins of the default serving objectives: tail
    latencies (ITL/TTFT p99), queue depth, and block-pool occupancy,
    each judged against its own trailing behavior. Names
    carry the ``_anomaly`` suffix (one alert-label namespace with the
    threshold rules) and keep the ``itl``/``ttft`` substrings the
    autoscaler's burn matching looks for."""
    kw = dict(z_threshold=z_threshold, min_samples=min_samples,
              windows=windows, burn_threshold=burn_threshold)
    return [
        AnomalyRule("itl_p99_anomaly", "serving_itl_ms", "p99", **kw),
        AnomalyRule("ttft_p99_anomaly", "serving_ttft_ms", "p99", **kw),
        AnomalyRule("queue_depth_anomaly", "serving_queue_depth",
                    "gauge", **kw),
        AnomalyRule("blocks_in_use_anomaly", "serving_blocks_in_use",
                    "gauge", **kw),
    ]


def default_serving_rules(itl_p99_ms: float = 200.0,
                          ttft_p99_ms: float = 2000.0,
                          max_queue_depth: float = 64.0,
                          max_expiry_per_s: float = 1.0) -> List[SloRule]:
    """The serving objectives the ISSUE names, with overridable bounds:
    p99 inter-token latency, p99 TTFT, queue depth, and expiry rate."""
    return [
        SloRule("itl_p99_ms", "serving_itl_ms", "p99", itl_p99_ms),
        SloRule("ttft_p99_ms", "serving_ttft_ms", "p99", ttft_p99_ms),
        SloRule("queue_depth", "serving_queue_depth", "gauge",
                max_queue_depth),
        SloRule("expiry_rate", "serving_requests_total", "rate",
                max_expiry_per_s, labels=(("reason", "expired"),)),
    ]


class SloMonitor:
    """Samples a rule set against a registry; call :meth:`poll` on a
    cadence (or :meth:`start` a daemon thread that does). ``now`` and
    ``dt`` injection on ``poll`` exists for deterministic tests.

    Rules may mix :class:`SloRule` (fixed threshold) and
    :class:`AnomalyRule` (self-calibrating EWMA/z-score deviation) —
    both kinds share the sampling kinds, the burn windows, the alert
    metrics, and the :meth:`alerts` surface."""

    def __init__(self, rules: Sequence[SloRule],
                 registry: Optional[MetricRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 interval_s: float = 1.0):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self.rules = list(rules)
        self.registry = registry or get_registry()
        self.tracer = tracer or get_tracer()
        self.interval_s = interval_s
        self._lock = threading.Lock()
        # per rule: [(t, breached bool)], last sampled value, last
        # counter reading (for rate), firing flag + since timestamp
        self._samples: Dict[str, list] = {r.name: [] for r in rules}
        self._value: Dict[str, Optional[float]] = dict.fromkeys(names)
        self._last_counter: Dict[str, Tuple[float, float]] = {}
        self._firing: Dict[str, Optional[float]] = dict.fromkeys(names)
        # anomaly detector state per AnomalyRule:
        # [ewma mean, ewma variance, samples trained, last z]
        self._anomaly: Dict[str, list] = {}
        self._m_active = self.registry.gauge(
            "slo_alert_active", "1 while the rule's alert is firing",
            labelnames=("rule",))
        self._m_fired = self.registry.counter(
            "slo_alerts_total", "alert activations, by rule",
            labelnames=("rule",))
        self._m_value = self.registry.gauge(
            "slo_rule_value", "latest sampled value per rule",
            labelnames=("rule",))
        for r in rules:
            self._m_active.labels(rule=r.name).set(0)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- sampling -----------------------------------------------------------

    def _metric_series(self, rule: SloRule):
        m = self.registry.get(rule.metric)
        if m is None:
            return None, None
        labels = dict(rule.labels) if rule.labels else {}
        return m, labels

    def _sample(self, rule: SloRule, now: float) -> Optional[float]:
        """One reading of the rule's metric; None = nothing to judge yet
        (unregistered metric, empty histogram, first rate sample)."""
        m, labels = self._metric_series(rule)
        if m is None:
            return None
        try:
            if rule.kind in ("p50", "p90", "p99"):
                if not isinstance(m, Histogram):
                    return None
                return m.percentile(float(rule.kind[1:]), **labels)
            bound = m.labels(**labels) if labels else m
            v = bound.value
            if v is None or isinstance(v, dict):
                return None
            if rule.kind == "gauge":
                return float(v)
            # rate: delta per second between this poll and the last
            prev = self._last_counter.get(rule.name)
            self._last_counter[rule.name] = (now, float(v))
            if prev is None or now <= prev[0]:
                return None
            return (float(v) - prev[1]) / (now - prev[0])
        except (ValueError, TypeError):
            return None  # label mismatch etc.: treated as unsampleable

    def poll(self, now: Optional[float] = None) -> List[dict]:
        """Sample every rule once, update windows and alert state, and
        return :meth:`alerts`. ``now`` is monotonic seconds (injectable
        so tests can replay a timeline)."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            for rule in self.rules:
                v = self._sample(rule, now)
                self._value[rule.name] = v
                if v is not None:
                    self._m_value.labels(rule=rule.name).set(v)
                samples = self._samples[rule.name]
                verdict = (self._judge(rule, v)
                           if v is not None else None)
                if verdict is not None:
                    samples.append((now, verdict))
                horizon = now - max(rule.windows)
                while samples and samples[0][0] < horizon:
                    samples.pop(0)
                burn = self._burn(rule, samples, now)
                firing = bool(burn) and all(
                    b is not None and b >= rule.burn_threshold
                    for b in burn.values()
                )
                was = self._firing[rule.name] is not None
                if firing and not was:
                    self._firing[rule.name] = now
                    self._m_fired.labels(rule=rule.name).inc()
                    self._m_active.labels(rule=rule.name).set(1)
                    self.tracer.record(0, "slo.alert", now, 0.0,
                                       rule=rule.name, value=v,
                                       threshold=getattr(
                                           rule, "threshold", None))
                elif not firing and was:
                    self._firing[rule.name] = None
                    self._m_active.labels(rule=rule.name).set(0)
                    self.tracer.record(0, "slo.resolve", now, 0.0,
                                       rule=rule.name, value=v)
            return self._alerts_locked(now)

    def _judge(self, rule, v: float) -> Optional[bool]:
        """One sample's breach verdict. Threshold rules compare
        directly; anomaly rules score the sample against their EWMA
        estimator FIRST, then train it (so the judged deviation is
        relative to history that does not yet include the sample —
        and a sustained shift still becomes the new normal over
        ~1/alpha samples, which is what lets a resolved regression
        stop alerting without a restart). Returns None while an
        anomaly rule is still calibrating: an untrained estimator can
        neither fire nor vouch."""
        if not isinstance(rule, AnomalyRule):
            return v > rule.threshold
        st = self._anomaly.setdefault(rule.name, [None, 0.0, 0, None])
        mean, var, count, _ = st
        verdict: Optional[bool] = None
        if mean is not None and count >= rule.min_samples:
            std = math.sqrt(var) if var > 0 else 0.0
            d = v - mean
            if std > 0:
                z = d / std
                st[3] = round(z, 4)
                verdict = abs(z) > rule.z_threshold
            else:
                # a perfectly constant history: any movement is a
                # deviation, but there is no finite z to report
                st[3] = None
                verdict = d != 0.0
        if mean is None:
            st[0], st[1] = float(v), 0.0
        else:
            a = rule.ewma_alpha
            d = v - mean
            st[0] = mean + a * d
            st[1] = (1.0 - a) * (var + a * d * d)
        st[2] = count + 1
        return verdict

    @staticmethod
    def _burn(rule: SloRule, samples: list, now: float) -> Dict[float, Optional[float]]:
        """Breach fraction per window; None for a window with no
        samples yet (an empty window can neither fire nor resolve)."""
        out: Dict[float, Optional[float]] = {}
        for w in rule.windows:
            inside = [b for t, b in samples if t >= now - w]
            out[w] = (sum(inside) / len(inside)) if inside else None
        return out

    # -- querying -----------------------------------------------------------

    def _alerts_locked(self, now: float) -> List[dict]:
        out = []
        for rule in self.rules:
            since = self._firing[rule.name]
            burn = self._burn(rule, self._samples[rule.name], now)
            entry = {
                "rule": rule.name, "metric": rule.metric,
                "kind": rule.kind,
                "threshold": getattr(rule, "threshold", None),
                "value": self._value[rule.name],
                "firing": since is not None,
                "since_s": (round(now - since, 3)
                            if since is not None else None),
                "burn": {repr(w): (round(b, 4) if b is not None else None)
                         for w, b in burn.items()},
            }
            if isinstance(rule, AnomalyRule):
                st = self._anomaly.get(rule.name)
                entry["anomaly"] = {
                    "z": st[3] if st else None,
                    "z_threshold": rule.z_threshold,
                    "mean": (round(st[0], 6)
                             if st and st[0] is not None else None),
                    "std": (round(math.sqrt(st[1]), 6)
                            if st and st[1] > 0 else 0.0),
                    "samples": st[2] if st else 0,
                    "calibrating": (st is None
                                    or st[2] < rule.min_samples),
                }
            out.append(entry)
        return out

    def alerts(self) -> List[dict]:
        """Current alert state per rule (plain dicts — the payload of
        the ``alerts`` op and ``/alerts``). Firing rules first."""
        with self._lock:
            out = self._alerts_locked(time.monotonic())
        return sorted(out, key=lambda a: not a["firing"])

    # -- background polling -------------------------------------------------

    def start(self) -> "SloMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.poll()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None


class StallWatchdog:
    """Fires a postmortem when a progress counter stops advancing while
    there is work to do.

    Args:
      progress: callable returning a monotonically increasing counter
        (the engine's tick count).
      busy: callable returning True while progress is *expected*
        (occupied slots or queued requests) — an idle engine is not a
        stalled engine.
      timeout_s: how long progress may sit still while busy before the
        watchdog fires.
      on_stall: called once per stall episode with a reason string;
        defaults to ``flight.dump_postmortem`` when a recorder is
        given. A new episode starts only after progress resumes.
      flight: the :class:`FlightRecorder` to dump on stall.
    """

    def __init__(self, progress: Callable[[], int],
                 busy: Callable[[], bool], timeout_s: float = 30.0,
                 interval_s: Optional[float] = None,
                 on_stall: Optional[Callable[[str], object]] = None,
                 flight=None,
                 registry: Optional[MetricRegistry] = None,
                 tracer: Optional[Tracer] = None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0; got {timeout_s}")
        self.progress = progress
        self.busy = busy
        self.timeout_s = timeout_s
        self.interval_s = (interval_s if interval_s is not None
                           else max(timeout_s / 4.0, 0.01))
        self.flight = flight
        self.on_stall = on_stall
        self.registry = registry or get_registry()
        self.tracer = tracer or get_tracer()
        self._m_stalls = self.registry.counter(
            "slo_stalls_total",
            "watchdog firings: step() made no progress while busy")
        self.stalled = False  # current episode state
        self.last_dump: Optional[str] = None
        # (progress, when it last moved); None until the first check so
        # a manual check() without start() can't fire against a stale 0
        self._mark: Optional[Tuple[int, float]] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def check(self, now: Optional[float] = None) -> bool:
        """One watchdog evaluation (the polling thread calls this; tests
        can too). Returns True when this call *fired* the stall."""
        now = time.monotonic() if now is None else float(now)
        p = self.progress()
        if (self._mark is None or p != self._mark[0]
                or not self.busy()):
            if (self.stalled and self._mark is not None
                    and p != self._mark[0]):
                self.tracer.record(0, "slo.stall_recovered", now, 0.0,
                                   progress=p)
            self.stalled = False
            self._mark = (p, now)
            return False
        if self.stalled or now - self._mark[1] < self.timeout_s:
            return False
        # busy, no progress for timeout_s, first detection this episode
        self.stalled = True
        self._m_stalls.inc()
        stuck_s = round(now - self._mark[1], 3)
        self.tracer.record(0, "slo.stall", self._mark[1], stuck_s * 1e3,
                           progress=p, timeout_s=self.timeout_s)
        if self.on_stall is not None:
            self.on_stall("stall")
        elif self.flight is not None:
            self.last_dump = self.flight.dump_postmortem(
                "stall", progress=p, stuck_s=stuck_s,
            )
        return True

    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._mark = (self.progress(), time.monotonic())

        def loop():
            while not self._stop.wait(self.interval_s):
                self.check()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
