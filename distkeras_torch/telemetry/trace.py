"""Per-request span tracing (Dapper-style, fleet-aware).

A *trace* is one request's journey; a *span* is one named, timed segment
of it. Trace ids are allocated where a request first enters the system
(the router's front door for fleet requests, :meth:`FIFOScheduler.submit`
for direct serving, the remote-PS proxy for pull/commit ops), carried on
the request/message — including **across the wire**: the framed-msgpack
``generate`` op accepts a ``trace`` (and ``parent_span``) field, so a
request routed client → router → replica keeps ONE id end-to-end — and
every subsystem the request crosses records spans against that id:

    serving   queued → prefill → decode → finish   (engine)
                                  stream           (TCP pump, per client)
    router    router.route · router.failover · router.stream
    PS ops    ps.rpc.<op> (client side) · ps.<op> (service side)

Spans land in a bounded ring buffer (old traces age out; a serving
process never grows without bound) and, when a path is configured, in an
append-only JSONL file that ``python -m distkeras_torch.telemetry.report``
renders into per-request timelines. ``dump()`` is the live query the
msgpack ``trace_dump`` op and the HTTP ``/traces`` endpoint serve.

Span records are plain dicts — msgpack/json serializable as-is:

    {"trace": 8812629903174829301, "span": "decode", "t0": <monotonic s>,
     "w": <wall-clock s>, "pid": 4711, "ms": 41.2, "slot": 3,
     "tokens": 16, ...}

``t0`` is ``time.monotonic()`` so offsets *within* a process are exact.
``w`` is the span's start on the wall clock, derived from a
once-per-tracer ``(monotonic, wall)`` anchor pair captured at
construction — so spans from different processes merge onto one
timeline (:func:`merge_span_chains`) ordered by wall time. Cross-host
alignment is only as good as NTP; renderers treat ``w`` as aligned to
within a few milliseconds, never as exact.

Trace ids are **random 63-bit integers** drawn from a per-process-seeded
generator, not per-process counters: two processes counting 1, 2, 3 …
collide on every id the moment their spans merge into one fleet chain.

Fleet collection: :class:`TraceArchive` keeps the merged chains of
completed requests in a bounded ring (the router snapshots each request's
chain at stream end, so a chain outlives the per-process rings that fed
it), and :func:`critical_path` turns one merged chain into the
per-request time attribution — where a slow p99 actually went.

Phase spans time a loop rather than a request: the serving engine's
tick (``engine.admit``, ``engine.plan``, ``engine.launch``,
``engine.wait``, ``engine.settle``, ``engine.record``, ``engine.idle``)
and a training step (``train.forward``, ``train.backward``). The loop
opens and closes them on one thread (:meth:`Tracer.switch_phase`, or the
:meth:`Tracer.phase` block); each records its name, start and end on
``time.perf_counter_ns()``, the thread's CPU time over it
(``time.thread_time_ns()``) and the thread id, as one tuple in a bounded
ring of its own (``Tracer.PHASE_CAPACITY``; spans aged out are counted), so
request chains do not age out faster. Per name the tracer keeps running
totals of wall ns, CPU ns and spans (:meth:`Tracer.phase_totals`), which
the engine exposes in ``stats()`` and its registry. While a torch
profiler records, each phase span also opens a
``torch.profiler.record_function`` range of its name, so the profiler's
trace shows the loop's phases; otherwise no range is entered (torch is
never imported here). :meth:`Tracer.phase_dump` renders the ring as
span records for the Chrome export, one lane per thread.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import sys
import threading
import time
import warnings
from collections import OrderedDict, deque
from typing import Dict, Iterable, List, Optional


class Tracer:
    """Thread-safe span sink: ring buffer + optional JSONL mirror.

    ``capacity`` bounds the ring in *spans* (a serving request emits
    ~4–5); ``path`` mirrors every span to JSONL for offline analysis.
    ``pid`` is the process identity stamped on every span (defaults to
    ``os.getpid()``; in-process fleets — N replica engines in one test
    or bench process — pass distinct values so each replica gets its
    own lane in merged timelines and Chrome-trace exports, exactly as
    real replica processes would). All methods are safe from any
    thread — the engine loop, TCP handler threads, and PS worker
    threads all write concurrently.
    """

    # the phase ring's length in spans (a ~100 ms serving tick makes ~7)
    PHASE_CAPACITY = 8192

    def __init__(self, capacity: int = 4096, path: Optional[str] = None,
                 pid: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.path = path
        self._buf: deque = deque(maxlen=capacity)
        self._fh = open(path, "a") if path else None
        self._lock = threading.Lock()
        self.pid = int(pid) if pid is not None else os.getpid()
        # wall-clock anchor: ONE (monotonic, wall) pair per tracer so
        # every span gets a derived wall-clock start "w" — chains from
        # different processes merge in the right order even though each
        # process's monotonic clock has an arbitrary epoch
        self._anchor_mono = time.monotonic()
        self._anchor_wall = time.time()
        # the phase spans' clock, anchored with the same pair
        self._anchor_perf_ns = time.perf_counter_ns()
        # phase spans: (name, t0_ns, t1_ns, cpu_ns, thread) tuples, and
        # per name [wall_ns, cpu_ns, spans]
        self._phases: deque = deque(maxlen=self.PHASE_CAPACITY)
        self._phases_dropped = 0
        self._phase_totals: Dict[str, list] = {}
        # per-process-seeded id source: random 63-bit ids are unique
        # within a process AND collision-free across a fleet w.h.p.
        # (sequential per-process ints collide the moment two
        # processes' spans merge into one chain)
        self._rand = random.Random(
            (self.pid << 32) ^ time.time_ns() ^ id(self)
        )

    def new_trace_id(self) -> int:
        """Allocate a fleet-unique trace id: random 63 bits (never 0),
        drawn under the lock — unique within the process by the
        generator's state, unique across processes with probability
        ~1 - n²/2⁶⁴."""
        with self._lock:
            while True:
                tid = self._rand.getrandbits(63)
                if tid:
                    return tid

    def wall_of(self, t0: float) -> float:
        """Project a ``time.monotonic()`` stamp onto the wall clock via
        this tracer's anchor pair."""
        return t0 - self._anchor_mono + self._anchor_wall

    # -- recording ----------------------------------------------------------

    def record(self, trace: Optional[int], span: str, t0: float,
               ms: float, **attrs):
        """Append one finished span. ``t0`` is the span's start on the
        monotonic clock; ``ms`` its duration. The wall-clock start
        (``w``) and process id are stamped automatically. None attrs
        are dropped so records stay msgpack/json-clean."""
        if trace is None:
            return  # untraced caller (e.g. a local PS pull): no-op
        rec = {"trace": int(trace), "span": str(span),
               "t0": round(float(t0), 6), "ms": round(float(ms), 3),
               "w": round(self.wall_of(float(t0)), 6), "pid": self.pid}
        for k, v in attrs.items():
            if v is not None:
                rec[k] = v
        with self._lock:
            self._buf.append(rec)
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(rec) + "\n")
                except (OSError, ValueError) as e:
                    # closed or unwritable mirror (disk full, fd closed
                    # by a crashing test, ...): tracing must never take
                    # a request down — drop the mirror, keep the ring
                    self._fh = None
                    warnings.warn(
                        f"Tracer: JSONL mirror {self.path!r} failed "
                        f"({e}); mirroring disabled, ring buffer "
                        f"unaffected", RuntimeWarning, stacklevel=2,
                    )

    @contextlib.contextmanager
    def span(self, trace: Optional[int], name: str, **attrs):
        """``with tracer.span(tid, "ps.pull"):`` — times the block."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.record(trace, name, t0, (time.monotonic() - t0) * 1e3,
                        **attrs)

    # -- phase spans --------------------------------------------------------

    def switch_phase(self, span: Optional[list], name: Optional[str]
                     ) -> tuple:
        """Close the calling thread's open phase span ``span`` (None:
        none is open) and open phase ``name`` (None: open none) at one
        reading of the thread's clocks. Returns ``(opened, wall_ns,
        cpu_ns)``: the new open span, to pass back here to close it,
        and the closed span's wall and CPU time (0, 0 when none)."""
        now, cpu = time.perf_counter_ns(), time.thread_time_ns()
        wall = used = 0
        if span is not None:
            if span[3] is not None:
                span[3].__exit__(None, None, None)
            wall, used = now - span[1], cpu - span[2]
            with self._lock:
                if len(self._phases) == self._phases.maxlen:
                    self._phases_dropped += 1
                self._phases.append((span[0], span[1], now, used,
                                     threading.get_ident()))
                tot = self._phase_totals.setdefault(span[0], [0, 0, 0])
                tot[0] += wall
                tot[1] += used
                tot[2] += 1
        opened = None
        if name is not None:
            opened = [name, now, cpu, _profiler_range(name)]
        return opened, wall, used

    @contextlib.contextmanager
    def phase(self, name: str):
        """``with tracer.phase("train.forward"):`` — one phase span
        around the block, on the calling thread."""
        span = self.switch_phase(None, name)[0]
        try:
            yield
        finally:
            self.switch_phase(span, None)

    def phase_totals(self) -> Dict[str, dict]:
        """Per phase name since construction: ``{"wall_ns", "cpu_ns",
        "count"}`` summed over every closed span (aged-out ones
        included)."""
        with self._lock:
            return {n: {"wall_ns": w, "cpu_ns": c, "count": k}
                    for n, (w, c, k) in self._phase_totals.items()}

    def phase_spans(self) -> tuple:
        """The phase ring, oldest first, as ``(name, t0_ns, t1_ns,
        cpu_ns, thread)`` tuples on ``time.perf_counter_ns()``, and the
        number of spans aged out of it so far."""
        with self._lock:
            return list(self._phases), self._phases_dropped

    def phase_dump(self, limit: Optional[int] = None) -> List[dict]:
        """The phase ring as span records (the newest ``limit``): its
        name as ``span``, the start ``t0`` (``perf_counter``, s) and on
        the wall clock ``w`` (this tracer's anchor), ``ms``,
        ``cpu_ms``, ``pid``, ``thread`` and ``lane`` (the threads
        numbered in order of appearance): the Chrome export gives each
        lane a track."""
        spans, _ = self.phase_spans()
        if limit is not None and limit >= 0:
            spans = spans[-limit:] if limit else []
        base = self._anchor_wall - self._anchor_perf_ns / 1e9
        lanes: Dict[int, int] = {}
        return [{"span": n, "t0": round(t0 / 1e9, 6),
                 "w": round(base + t0 / 1e9, 6),
                 "ms": round((t1 - t0) / 1e6, 3),
                 "cpu_ms": round(cpu / 1e6, 3), "pid": self.pid,
                 "thread": tid, "lane": lanes.setdefault(tid, len(lanes))}
                for n, t0, t1, cpu, tid in spans]

    # -- querying -----------------------------------------------------------

    def dump(self, trace: Optional[int] = None,
             limit: Optional[int] = None) -> List[dict]:
        """Spans in arrival order, optionally filtered to one trace id
        and/or truncated to the most recent ``limit``. Flushes the
        JSONL mirror first: a dump is a "look at the state now" moment,
        and the on-disk view should match the ring the caller sees."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                except (OSError, ValueError):
                    self._fh = None
            spans = list(self._buf)
        if trace is not None:
            spans = [s for s in spans if s["trace"] == int(trace)]
        if limit is not None and limit >= 0:
            spans = spans[-limit:]
        return spans

    def clear(self):
        with self._lock:
            self._buf.clear()
            self._phases.clear()

    def close(self):
        """Flush and close the JSONL mirror (idempotent); the ring
        buffer stays queryable."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    self._fh.close()
                except (OSError, ValueError):
                    pass
                self._fh = None

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def merge_span_chains(*chains: Iterable[dict]) -> List[dict]:
    """Merge span lists from N processes into ONE chain: exact
    duplicates are dropped (a span can arrive via both a live
    ``trace_dump`` and an archive snapshot), and the result is ordered
    by wall-clock start (``w``), falling back to monotonic ``t0`` for
    pre-anchor records. Within one process the wall order equals the
    monotonic order (one anchor pair); across processes the ordering
    trusts each host's wall clock — NTP skew of a few milliseconds can
    reorder *adjacent* spans from different hosts, which renderers must
    tolerate (and :mod:`~distkeras_torch.telemetry.report` notes)."""
    seen = set()
    merged: List[dict] = []
    for chain in chains:
        for s in chain or ():
            key = (s.get("pid"), s.get("trace"), s.get("span"),
                   s.get("t0"), s.get("ms"), s.get("w"))
            if key in seen:
                continue
            seen.add(key)
            merged.append(s)
    merged.sort(key=lambda s: (s.get("w", s.get("t0", 0.0)),
                               s.get("t0", 0.0)))
    return merged


class TraceArchive:
    """Bounded ring of *completed* request chains, keyed by trace id.

    Per-process span rings age out quickly under load; the archive is
    where a finished request's **merged** chain survives — the router
    snapshots each request's fleet-wide spans at stream end, so
    ``trace_dump``/``chrome_trace`` for a trace id keep answering after
    every contributing ring has moved on. ``capacity`` bounds memory in
    *chains* (LRU by insertion/refresh order). Thread-safe."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._chains: "OrderedDict[int, List[dict]]" = OrderedDict()

    def put(self, trace: int, spans: Iterable[dict]):
        with self._lock:
            self._chains[int(trace)] = list(spans)
            self._chains.move_to_end(int(trace))
            while len(self._chains) > self.capacity:
                self._chains.popitem(last=False)

    def get(self, trace: int) -> Optional[List[dict]]:
        with self._lock:
            spans = self._chains.get(int(trace))
            return list(spans) if spans is not None else None

    def ids(self) -> List[int]:
        """Archived trace ids, oldest first."""
        with self._lock:
            return list(self._chains)

    def __len__(self) -> int:
        with self._lock:
            return len(self._chains)


# phases of the per-request critical path, in pipeline order
CRITICAL_PATH_PHASES = (
    "queue", "prefill", "decode", "device", "stream", "router",
)


def critical_path(spans: Iterable[dict]) -> Optional[dict]:
    """Per-request time attribution from one (merged) span chain.

    Returns ``{"total_ms", "phases": {phase: ms}, "spans"}`` where the
    phases partition the request's end-to-end window:

    - ``queue``   — admission wait (``queued`` spans),
    - ``prefill`` — prompt processing (``prefill`` spans),
    - ``device``  — device compute attributed to this request during
      decode (the ``decode`` span's ``device_ms`` attr, engine-side
      per-tick attribution),
      which the engine measures on the host: each tick's launch time
      plus its wait on the readback, not device time (a pipelined
      tick's device work hides behind the next tick's host work),
    - ``decode``  — the rest of the decode window (host planning,
      scheduling, stream emission overlapped with compute),
    - ``stream``  — delivery tail after decode ended (the non-overlapped
      part of the token pump),
    - ``router``  — everything the serving process cannot see: routing,
      wire hops, proxy forwarding (the residual against the total).

    ``total_ms`` is the ``router.stream`` duration when the chain
    crossed a router (the router's view of the whole request — within
    wire overhead of what the client observed), else the chain's
    wall-clock extent. Failover replays (two ``queued``/``prefill``/
    ``decode`` generations under one id) sum per phase. Returns None
    for an empty chain."""
    spans = [s for s in spans if "ms" in s and ("w" in s or "t0" in s)]
    if not spans:
        return None

    def start(s):
        return float(s.get("w", s["t0"]))

    def end(s):
        return start(s) + float(s["ms"]) / 1e3

    sums: Dict[str, float] = {}
    ends: Dict[str, float] = {}
    device_ms = 0.0
    for s in spans:
        name = s["span"]
        sums[name] = sums.get(name, 0.0) + float(s["ms"])
        ends[name] = max(ends.get(name, float("-inf")), end(s))
        if name == "decode":
            device_ms += float(s.get("device_ms", 0.0))
    rstream = sums.get("router.stream")
    if rstream is not None:
        total = rstream
    else:
        total = (max(end(s) for s in spans)
                 - min(start(s) for s in spans)) * 1e3
    phases = {p: 0.0 for p in CRITICAL_PATH_PHASES}
    phases["queue"] = sums.get("queued", 0.0)
    phases["prefill"] = sums.get("prefill", 0.0)
    dec = sums.get("decode", 0.0)
    phases["device"] = min(device_ms, dec)
    phases["decode"] = dec - phases["device"]
    if "stream" in ends and "decode" in ends:
        phases["stream"] = max(0.0, (ends["stream"] - ends["decode"]) * 1e3)
    else:
        phases["stream"] = sums.get("stream", 0.0)
    accounted = sum(phases.values())
    phases["router"] = max(total - accounted, 0.0)
    return {
        "total_ms": round(total, 3),
        "phases": {k: round(v, 3) for k, v in phases.items()},
        "spans": len(spans),
    }


def _profiler_range(name: str):
    """A ``record_function`` range of ``name``, entered, while a torch
    profiler records; else None. Without torch's profiler module loaded
    no profiler can be recording, so torch is not imported here."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return None
    rng = prof.record_function(name)
    rng.__enter__()
    return rng


_global_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer every subsystem defaults to."""
    return _global_tracer
