"""Chrome trace-event (Perfetto) export for span chains.

Turns the tracer's span records — optionally a fleet-merged chain from
:func:`~distkeras_torch.telemetry.trace.merge_span_chains` — into the
Chrome trace-event JSON format, so any request opens directly in
``ui.perfetto.dev`` or ``chrome://tracing``:

- every span becomes a complete event (``ph="X"``) with microsecond
  ``ts``/``dur`` on a wall-clock timebase (the per-tracer anchor's
  ``w`` stamp, so cross-process spans land on one timeline; the raw
  monotonic ``t0`` is the fallback for pre-anchor records),
- ``pid`` is the span's recording process and ``tid`` its lane within
  it: decode slots get one lane each (the slot id every engine span
  carries), stream pumps and router spans get lanes of their own —
  the Perfetto track layout mirrors the serving architecture,
- each trace id that crossed ≥2 processes emits a **flow** chain
  (``ph`` ``s``/``t``/``f`` with the trace id as flow id) arrowing
  from the first span of each process to the next — the router hop is
  visible as an arrow from the router lane into the replica's slot,
- process/thread metadata events (``ph="M"``) name the tracks.

Everything here is derived data over plain dicts — stdlib-only like the
rest of :mod:`distkeras_torch.telemetry`, and pure (no tracer access), so
it serves equally as the ``chrome_trace`` wire op's payload builder and
as ``report --chrome-trace``'s file writer.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Set

# fixed lanes for spans that carry no slot id (see _tid)
_TID_MISC = 0      # queued/finish and anything slot-less
_TID_ROUTER = 98   # router.* spans
_TID_STREAM = 99   # client-delivery pump spans

_THREAD_NAMES = {_TID_MISC: "requests", _TID_ROUTER: "router",
                 _TID_STREAM: "stream"}


def _tid(span: dict) -> int:
    """Lane for a span within its process: slot-pinned engine spans get
    one lane per decode slot, router and stream-pump spans fixed lanes
    of their own, everything else the shared request lane."""
    slot = span.get("slot")
    if slot is not None:
        return 1 + int(slot)
    name = str(span.get("span", ""))
    if name.startswith("router."):
        return _TID_ROUTER
    if name == "stream":
        return _TID_STREAM
    return _TID_MISC


def _thread_name(tid: int) -> str:
    return _THREAD_NAMES.get(tid, f"slot {tid - 1}")


def chrome_trace_events(spans: Iterable[dict]) -> List[dict]:
    """The ``traceEvents`` list for a span chain (see module doc)."""
    spans = [s for s in spans
             if "ms" in s and ("w" in s or "t0" in s)]
    if not spans:
        return []

    def wall(s):
        return float(s.get("w", s["t0"]))

    base = min(wall(s) for s in spans)
    events: List[dict] = []
    lanes: Dict[int, Set[int]] = {}
    by_trace: Dict[int, List[dict]] = {}
    for s in spans:
        pid = int(s.get("pid", 0))
        tid = _tid(s)
        lanes.setdefault(pid, set()).add(tid)
        args = {k: v for k, v in s.items()
                if k not in ("span", "t0", "ms", "w", "pid")}
        events.append({
            "name": str(s.get("span", "span")), "cat": "serving",
            "ph": "X", "ts": round((wall(s) - base) * 1e6, 3),
            "dur": round(float(s["ms"]) * 1e3, 3),
            "pid": pid, "tid": tid, "args": args,
        })
        if s.get("trace") is not None:
            by_trace.setdefault(int(s["trace"]), []).append(s)
    # flow events: one arrow chain per trace id that crossed processes
    # (client → router → replica); the flow id IS the trace id, so
    # Perfetto groups the arrows with the request
    for trace_id, chain in sorted(by_trace.items()):
        first_in_pid: Dict[int, dict] = {}
        order: List[int] = []
        for s in sorted(chain, key=wall):
            pid = int(s.get("pid", 0))
            if pid not in first_in_pid:
                first_in_pid[pid] = s
                order.append(pid)
        if len(order) < 2:
            continue
        for i, pid in enumerate(order):
            s = first_in_pid[pid]
            ph = "s" if i == 0 else ("f" if i == len(order) - 1 else "t")
            ev = {"name": "request", "cat": "flow", "ph": ph,
                  "id": trace_id,
                  "ts": round((wall(s) - base) * 1e6, 3),
                  "pid": pid, "tid": _tid(s)}
            if ph == "f":
                ev["bp"] = "e"  # bind the arrowhead to the enclosing slice
            events.append(ev)
    # metadata: name every process and lane (ts present so strict
    # validators can treat every event uniformly)
    for pid in sorted(lanes):
        events.append({"name": "process_name", "ph": "M", "ts": 0,
                       "pid": pid, "tid": _TID_MISC,
                       "args": {"name": f"process {pid}"}})
        for tid in sorted(lanes[pid]):
            events.append({"name": "thread_name", "ph": "M", "ts": 0,
                           "pid": pid, "tid": tid,
                           "args": {"name": _thread_name(tid)}})
    return events


def to_chrome_trace(spans: Iterable[dict]) -> dict:
    """The full Chrome trace-event JSON object for a span chain."""
    return {"traceEvents": chrome_trace_events(spans),
            "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Iterable[dict]) -> dict:
    """Serialize :func:`to_chrome_trace` to ``path``; returns the doc."""
    doc = to_chrome_trace(spans)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc
