"""Exposition: Prometheus text rendering + a stdlib HTTP scrape endpoint.

Two consumers read the registry/tracer: the framed-msgpack ``stats`` /
``trace_dump`` ops on the existing servers (pull model, same transport
the workers already speak), and this module's HTTP endpoint (what an
actual Prometheus/Grafana stack scrapes). The HTTP server is
``http.server`` from the stdlib — no new dependency — threaded so a slow
scraper never blocks another, and bound to loopback unless told
otherwise (same hardening posture as :class:`ParameterServerService`).

Routes:

    /metrics        Prometheus text exposition format (text/plain);
                    ?openmetrics=1 switches to OpenMetrics rendering
                    with ``# {trace_id="..."}`` histogram exemplars
    /metrics.json   the same snapshot as JSON
    /traces         recent spans as JSON; ?trace=<id> filters one
                    request, ?limit=<n> truncates
    /chrome         the same spans as Chrome trace-event JSON
                    (?trace=/?limit= as above) — save and open in
                    ui.perfetto.dev
    /flight         flight-recorder tick snapshots as JSON
                    ({"meta": ..., "ticks": [...]}); ?last=<n> keeps
                    the most recent n; 404 when no recorder is wired
    /alerts         SLO monitor state as JSON (firing rules first);
                    404 when no monitor is wired
    /timeseries     TimeSeriesStore ring as JSON ({"meta": ...,
                    "points": [...]}); ?last=<n> keeps the most recent
                    n; 404 when no store is wired
    /events         control-plane EventJournal as JSON ({"meta": ...,
                    "events": [...]}); ?last=<n> as above; 404 when no
                    journal is wired
    /healthz        200 "ok" (liveness probe)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from distkeras_torch.telemetry.chrome import to_chrome_trace
from distkeras_torch.telemetry.registry import MetricRegistry, get_registry
from distkeras_torch.telemetry.trace import Tracer, get_tracer


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in merged.items()
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def _fmt_exemplar(ex: dict) -> str:
    """One OpenMetrics exemplar suffix: ``# {trace_id="..."} value``.
    Labels escape exactly like series labels (exemplar values are
    user-supplied trace ids — quotes/backslashes must round-trip)."""
    return (f' # {{trace_id="{_escape_label(str(ex["trace_id"]))}"}}'
            f' {_fmt_value(ex["value"])}')


def render_prometheus(registry: Optional[MetricRegistry] = None,
                      openmetrics: bool = False) -> str:
    """The registry as Prometheus text exposition format v0.0.4.

    ``openmetrics=True`` appends histogram-bucket exemplars in
    OpenMetrics syntax (``... # {trace_id="..."} value``). The default
    stays plain v0.0.4 — classic Prometheus text parsers reject the
    ``#`` suffix mid-line, so exemplars are strictly opt-in and the
    default output is byte-identical to the pre-exemplar renderer."""
    registry = registry or get_registry()
    lines = []
    for name, snap in sorted(registry.collect().items()):
        if snap["help"]:
            lines.append(f"# HELP {name} {snap['help']}")
        lines.append(f"# TYPE {name} {snap['type']}")
        for series in snap["series"]:
            labels = series["labels"]
            if snap["type"] == "histogram":
                # buckets are already cumulative-ready counts per bucket;
                # Prometheus wants cumulative le= counts
                exemplars = series.get("exemplars", {}) if openmetrics \
                    else {}
                cum = 0
                for le, c in series["buckets"].items():
                    cum += c
                    ex = exemplars.get(le)
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, {'le': le})} {cum}"
                        + (_fmt_exemplar(ex) if ex else "")
                    )
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)} "
                    f"{_fmt_value(series['sum'])}"
                )
                lines.append(
                    f"{name}_count{_fmt_labels(labels)} {series['count']}"
                )
            else:
                lines.append(
                    f"{name}{_fmt_labels(labels)} "
                    f"{_fmt_value(series['value'])}"
                )
    return "\n".join(lines) + "\n"


class TelemetryServer:
    """Threaded HTTP scrape endpoint over a registry + tracer pair.

    ``port=0`` binds an ephemeral port (read ``.port`` after
    construction). ``start()`` returns self so the one-liner works::

        srv = TelemetryServer(port=9100).start()   # global registry/tracer
        ... curl localhost:9100/metrics ...
        srv.stop()
    """

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 flight=None, slo=None, timeseries=None, events=None):
        self.registry = registry or get_registry()
        self.tracer = tracer or get_tracer()
        # optional panes: a FlightRecorder for /flight, an SloMonitor
        # for /alerts, a TimeSeriesStore for /timeseries, an
        # EventJournal for /events (404 when not wired — scrape
        # configs can probe)
        self.flight = flight
        self.slo = slo
        self.timeseries = timeseries
        self.events = events
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no per-scrape stderr spam
                pass

            def _reply(self, code: int, body: str, ctype: str):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                try:
                    if url.path == "/metrics":
                        om = q.get("openmetrics", ["0"])[0] not in (
                            "0", "", "false")
                        self._reply(
                            200,
                            render_prometheus(outer.registry,
                                              openmetrics=om),
                            ("application/openmetrics-text" if om
                             else "text/plain; version=0.0.4"),
                        )
                    elif url.path == "/metrics.json":
                        self._reply(
                            200, json.dumps(outer.registry.collect()),
                            "application/json",
                        )
                    elif url.path == "/traces":
                        trace = (int(q["trace"][0])
                                 if "trace" in q else None)
                        limit = (int(q["limit"][0])
                                 if "limit" in q else None)
                        self._reply(
                            200,
                            json.dumps(outer.tracer.dump(trace=trace,
                                                         limit=limit)),
                            "application/json",
                        )
                    elif url.path == "/chrome":
                        trace = (int(q["trace"][0])
                                 if "trace" in q else None)
                        limit = (int(q["limit"][0])
                                 if "limit" in q else None)
                        self._reply(
                            200,
                            json.dumps(to_chrome_trace(
                                outer.tracer.dump(trace=trace,
                                                  limit=limit))),
                            "application/json",
                        )
                    elif url.path == "/flight":
                        if outer.flight is None:
                            self._reply(404, "no flight recorder",
                                        "text/plain")
                        else:
                            last = (int(q["last"][0])
                                    if "last" in q else None)
                            self._reply(
                                200,
                                json.dumps({
                                    "meta": outer.flight.meta("scrape"),
                                    "ticks": outer.flight.snapshots(
                                        last=last),
                                }),
                                "application/json",
                            )
                    elif url.path == "/alerts":
                        if outer.slo is None:
                            self._reply(404, "no slo monitor",
                                        "text/plain")
                        else:
                            self._reply(200,
                                        json.dumps(outer.slo.alerts()),
                                        "application/json")
                    elif url.path == "/timeseries":
                        if outer.timeseries is None:
                            self._reply(404, "no time-series store",
                                        "text/plain")
                        else:
                            last = (int(q["last"][0])
                                    if "last" in q else None)
                            self._reply(
                                200,
                                json.dumps({
                                    "meta": outer.timeseries.meta(),
                                    "points": outer.timeseries.points(
                                        last=last),
                                }),
                                "application/json",
                            )
                    elif url.path == "/events":
                        if outer.events is None:
                            self._reply(404, "no event journal",
                                        "text/plain")
                        else:
                            last = (int(q["last"][0])
                                    if "last" in q else None)
                            self._reply(
                                200,
                                json.dumps({
                                    "meta": outer.events.meta(),
                                    "events": outer.events.events(
                                        last=last),
                                }),
                                "application/json",
                            )
                    elif url.path == "/healthz":
                        self._reply(200, "ok", "text/plain")
                    else:
                        self._reply(404, "not found", "text/plain")
                except Exception as e:  # a bad scrape must not kill serving
                    self._reply(500, f"{type(e).__name__}: {e}",
                                "text/plain")

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TelemetryServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
