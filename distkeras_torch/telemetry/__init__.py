"""Telemetry of the port: the stdlib-only pieces the serving engine
uses, copied from :mod:`distkeras_tpu.telemetry` with only their import
paths changed — span tracing (``Tracer``), the metric registry
(``MetricRegistry``), the per-tick flight recorder
(``FlightRecorder``), the control-plane journal (``EventJournal``) and
runtime introspection (``MemoryWatermarks``, ``RecompileCounter``).
SLO alerting, metric history, exposition and the report CLI are not
ported yet (ROADMAP A11)."""

from distkeras_torch.telemetry.events import (  # noqa: F401
    KNOWN_ACTIONS,
    EventJournal,
    FleetEvent,
    merge_event_journals,
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
    "FlightRecorder",
    "POSTMORTEM_PREFIX",
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
