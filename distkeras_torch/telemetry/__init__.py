"""Telemetry of the port: the reference's stdlib-only
:mod:`distkeras_tpu.telemetry`, copied with only its import paths
changed — span tracing (``Tracer``), Chrome trace export
(``to_chrome_trace``), the metric registry (``MetricRegistry``), the
per-tick flight recorder (``FlightRecorder``), SLO alerting and the
stall watchdog (``SloMonitor``, ``StallWatchdog``), metric history
(``TimeSeriesStore``), the control-plane journal (``EventJournal``),
Prometheus exposition (``TelemetryServer``) and runtime introspection
(``MemoryWatermarks``, ``RecompileCounter``). Offline analysis:
``python -m distkeras_torch.telemetry.report``. The router
(:mod:`distkeras_torch.serving.router`) merges these across a fleet."""

from distkeras_torch.telemetry.chrome import (  # noqa: F401
    chrome_trace_events,
    to_chrome_trace,
    write_chrome_trace,
)
from distkeras_torch.telemetry.events import (  # noqa: F401
    KNOWN_ACTIONS,
    EventJournal,
    FleetEvent,
    merge_event_journals,
)
from distkeras_torch.telemetry.exposition import (  # noqa: F401
    TelemetryServer,
    render_prometheus,
)
from distkeras_torch.telemetry.flight import (  # noqa: F401
    POSTMORTEM_PREFIX,
    FlightRecorder,
)
from distkeras_torch.telemetry.registry import (  # noqa: F401
    FRACTION_BUCKETS,
    LATENCY_MS_BUCKETS,
    STALENESS_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    get_registry,
)
from distkeras_torch.telemetry.runtime import (  # noqa: F401
    MemoryWatermarks,
    RecompileCounter,
    host_rss_bytes,
    recompiles,
)
from distkeras_torch.telemetry.slo import (  # noqa: F401
    AnomalyRule,
    SloMonitor,
    SloRule,
    StallWatchdog,
    default_anomaly_rules,
    default_serving_rules,
)
from distkeras_torch.telemetry.timeseries import (  # noqa: F401
    TimeSeriesStore,
    merge_timeseries,
    series_key,
    write_timeline,
)
from distkeras_torch.telemetry.trace import (  # noqa: F401
    CRITICAL_PATH_PHASES,
    TraceArchive,
    Tracer,
    critical_path,
    get_tracer,
    merge_span_chains,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "get_registry",
    "Tracer",
    "get_tracer",
    "TraceArchive",
    "merge_span_chains",
    "critical_path",
    "CRITICAL_PATH_PHASES",
    "to_chrome_trace",
    "chrome_trace_events",
    "write_chrome_trace",
    "TelemetryServer",
    "render_prometheus",
    "FlightRecorder",
    "POSTMORTEM_PREFIX",
    "SloMonitor",
    "SloRule",
    "AnomalyRule",
    "StallWatchdog",
    "default_serving_rules",
    "default_anomaly_rules",
    "TimeSeriesStore",
    "merge_timeseries",
    "series_key",
    "write_timeline",
    "EventJournal",
    "FleetEvent",
    "KNOWN_ACTIONS",
    "merge_event_journals",
    "RecompileCounter",
    "MemoryWatermarks",
    "recompiles",
    "host_rss_bytes",
    "LATENCY_MS_BUCKETS",
    "STALENESS_BUCKETS",
    "FRACTION_BUCKETS",
]
