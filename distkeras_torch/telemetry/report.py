"""Render telemetry JSONL files: span timelines or flight-recorder ticks.

    python -m distkeras_torch.telemetry.report /tmp/trace.jsonl
    python -m distkeras_torch.telemetry.report /tmp/trace.jsonl --trace 17
    python -m distkeras_torch.telemetry.report /tmp/trace.jsonl --top 5
    python -m distkeras_torch.telemetry.report /tmp/trace.jsonl --chrome-trace out.json
    python -m distkeras_torch.telemetry.report --flight /tmp/distkeras-postmortem-*.jsonl
    python -m distkeras_torch.telemetry.report --timeline /tmp/timeline.jsonl
    python -m distkeras_torch.telemetry.report --live http://127.0.0.1:9100 --polls 3

Span mode input is what :class:`~distkeras_torch.telemetry.trace.Tracer`
mirrors to ``path=`` (or a saved ``trace_dump`` / ``/traces`` response,
one span per line — including a fleet-merged chain saved from the
router's ``trace_dump``). Output answers the question the JSONL alone
doesn't: *where did request N spend its time* — an aligned per-span
timeline bar per trace, plus per-span-name duration percentiles across
all traces. ``--trace`` additionally prints the critical-path
breakdown (queue / prefill / decode / device / stream / router).

Chains recorded by more than one process are aligned on each span's
wall-clock stamp (``w``, derived from the per-tracer anchor pair).
**Skew tolerance:** cross-host wall clocks agree only to NTP precision,
so offsets between spans from *different* processes are approximate to
within a few milliseconds — the renderer notes this on multi-process
timelines and never infers ordering bugs from sub-ms inversions.

``--chrome-trace OUT`` exports the spans (optionally one ``--trace``)
as Chrome trace-event JSON — open in ``ui.perfetto.dev``.

``--flight`` mode renders a
:class:`~distkeras_torch.telemetry.flight.FlightRecorder` dump (manual or
postmortem): one row per engine tick — occupancy, queue depth, the
token-budget split, per-phase latency (host-plan / device / stream), and
per-slot state — plus a phase breakdown and the slowest ticks, which is
the "why did tick 48211 take 300 ms?" view.

``--timeline`` mode renders a time-series timeline artifact
(:func:`~distkeras_torch.telemetry.timeseries.write_timeline` output, or
a hand-rolled JSONL of ``{"point": ...}`` / ``{"event": ...}`` lines):
sparklines for the most interesting series over the covered span, an
event ruler marking where control-plane actions landed, and the merged
journal interleaved in timestamp order — each event row annotated with
the headline series values at that moment. That is the forensic join
the flat files cannot give: *the autoscaler scaled up at +3.2 s; what
was p99 ITL doing right then?*

``--live URL`` polls a running
:class:`~distkeras_torch.telemetry.exposition.TelemetryServer` (its
``/timeseries`` and ``/events`` routes — on a router-backed server
those are already fleet-merged) and renders the same view per poll.
``--polls N`` bounds the loop (default: forever, ctrl-C to stop).

A missing, unreadable, or corrupt input file — or an unreachable /
unwired ``--live`` endpoint — exits with status 2 and a one-line
error — no traceback; dumps come from crashing processes, and the
tool reading them must not crash too.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Dict, List, Optional, TextIO

_BAR_WIDTH = 40


class ReportError(Exception):
    """Unusable input file: the CLI prints the message and exits 2."""


def _load_jsonl(path: str) -> List[dict]:
    recs = []
    try:
        with open(path) as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ReportError(
                        f"{path}:{lineno}: not valid JSONL ({e.msg})"
                    ) from None
                if not isinstance(rec, dict):
                    raise ReportError(
                        f"{path}:{lineno}: expected one JSON object per "
                        f"line, got {type(rec).__name__}"
                    )
                recs.append(rec)
    except OSError as e:
        raise ReportError(f"cannot read {path}: {e.strerror or e}") from None
    except UnicodeDecodeError:
        raise ReportError(f"{path}: not a text file") from None
    return recs


def load_spans(path: str) -> List[dict]:
    spans = _load_jsonl(path)
    for i, s in enumerate(spans, 1):
        if not {"trace", "span", "t0", "ms"} <= set(s):
            raise ReportError(
                f"{path}:{i}: not a span record (missing trace/span/ms "
                f"keys) — for flight-recorder dumps use --flight"
            )
    return spans


def _percentile(vals: List[float], p: float) -> float:
    vals = sorted(vals)
    rank = (len(vals) - 1) * p / 100.0
    lo = int(rank)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (rank - lo)


def render_timeline(spans: List[dict], trace: int,
                    out: Optional[TextIO] = None):
    """One request's spans as offset-aligned bars (offsets relative to
    the trace's earliest span start). A chain recorded by more than one
    process is aligned on the wall-clock stamps (``w``) — noted in the
    header, because cross-host wall clocks are only NTP-aligned."""
    out = out or sys.stdout
    mine = [s for s in spans if s["trace"] == trace]
    if not mine:
        out.write(f"trace {trace}: no spans\n")
        return
    # wall-clock alignment only when EVERY span carries the anchor
    # stamp (mixing epoch-seconds `w` with monotonic `t0` would place
    # old-format spans billions of seconds apart)
    use_wall = all("w" in s for s in mine)
    start = (lambda s: s["w"]) if use_wall else (lambda s: s["t0"])
    mine = sorted(mine, key=start)
    pids = {s["pid"] for s in mine if "pid" in s}
    base = start(mine[0])
    end = max(start(s) + s["ms"] / 1e3 for s in mine)
    total_ms = max((end - base) * 1e3, 1e-9)
    multi = len(pids) > 1
    out.write(
        f"trace {trace}  ({total_ms:.1f} ms total)"
        + (f"  [{len(pids)} processes merged on wall clock; "
           f"cross-host offsets are NTP-approximate]" if multi else "")
        + "\n"
    )
    for s in mine:
        off_ms = (start(s) - base) * 1e3
        lo = min(int(off_ms / total_ms * _BAR_WIDTH), _BAR_WIDTH - 1)
        ln = max(1, int(s["ms"] / total_ms * _BAR_WIDTH))
        bar = " " * lo + "#" * min(ln, _BAR_WIDTH - lo)
        attrs = {k: v for k, v in s.items()
                 if k not in ("trace", "span", "t0", "ms", "w", "pid")}
        attr_str = ("  " + " ".join(f"{k}={v}" for k, v in attrs.items())
                    if attrs else "")
        label = (f"[{s['pid']}] " if multi and "pid" in s else "")
        out.write(
            f"  {label}{s['span']:<14} {bar:<{_BAR_WIDTH}} "
            f"+{off_ms:8.1f}ms  {s['ms']:8.1f}ms{attr_str}\n"
        )


def render_critical_path(spans: List[dict], trace: int,
                         out: Optional[TextIO] = None):
    """The per-request phase attribution for one trace (where the time
    actually went): queue / prefill / decode / device / stream /
    router, from :func:`~distkeras_torch.telemetry.trace.critical_path`."""
    from distkeras_torch.telemetry.trace import critical_path

    out = out or sys.stdout
    cp = critical_path([s for s in spans if s["trace"] == trace])
    if cp is None:
        return
    total = max(cp["total_ms"], 1e-9)
    out.write(f"  critical path ({cp['total_ms']:.1f} ms):\n")
    for phase, ms in cp["phases"].items():
        out.write(
            f"    {phase:<8} {ms:>9.1f}ms  {100 * ms / total:5.1f}%\n"
        )


def render_summary(spans: List[dict], out: Optional[TextIO] = None):
    """Per-span-name duration stats across every trace in the file."""
    out = out or sys.stdout
    by_name: Dict[str, List[float]] = defaultdict(list)
    for s in spans:
        by_name[s["span"]].append(float(s["ms"]))
    traces = {s["trace"] for s in spans}
    out.write(
        f"\n{len(spans)} spans across {len(traces)} traces\n"
    )
    out.write(
        f"  {'span':<12} {'count':>6} {'p50 ms':>10} "
        f"{'p90 ms':>10} {'p99 ms':>10} {'max ms':>10}\n"
    )
    for name, vals in sorted(by_name.items()):
        out.write(
            f"  {name:<12} {len(vals):>6} "
            f"{_percentile(vals, 50):>10.2f} "
            f"{_percentile(vals, 90):>10.2f} "
            f"{_percentile(vals, 99):>10.2f} "
            f"{max(vals):>10.2f}\n"
        )


def report(path: str, trace: Optional[int] = None, top: int = 10,
           out: Optional[TextIO] = None):
    out = out or sys.stdout
    spans = load_spans(path)
    if not spans:
        out.write(f"{path}: no spans\n")
        return
    if trace is not None:
        render_timeline(spans, trace, out)
        render_critical_path(spans, trace, out)
        return
    # longest-total traces first: the ones worth looking at
    totals: Dict[int, float] = defaultdict(float)
    for s in spans:
        totals[s["trace"]] += float(s["ms"])
    worst = sorted(totals, key=totals.get, reverse=True)[:top]
    for tid in worst:
        render_timeline(spans, tid, out)
    if len(totals) > len(worst):
        out.write(
            f"  ... {len(totals) - len(worst)} more traces "
            f"(--top to widen, --trace <id> for one)\n"
        )
    render_summary(spans, out)


# -- flight-recorder dumps ---------------------------------------------------


def _slot_cell(s) -> str:
    """One slot's state, compact: 'r17:D-3' = request 17 decoding with 3
    tokens left, 'r18:P+128' = prefilling with 128 prompt tokens
    pending, 'r19:R+2' = RESTORING with 2 host-tier blocks still in
    flight, '-' = idle."""
    if not s:
        return "-"
    state = s.get("state", "?")[:1].upper()
    if state in ("P", "R"):
        return f"r{s.get('rid', '?')}:{state}+{s.get('pending', '?')}"
    return f"r{s.get('rid', '?')}:{state}-{s.get('remaining', '?')}"


def report_flight(path: str, last: Optional[int] = None,
                  slow: int = 5, out: Optional[TextIO] = None):
    """Render a flight dump: the tick timeline, the phase breakdown,
    and the slowest ticks (the postmortem reading order: tail of the
    timeline → which phase ate the time → which tick blew up)."""
    out = out or sys.stdout
    recs = _load_jsonl(path)
    meta = next((r for r in recs if r.get("kind") == "flight_meta"), None)
    ticks = [r for r in recs if r.get("kind") == "tick"]
    if meta is None and not ticks:
        raise ReportError(
            f"{path}: no flight_meta or tick records — is this a trace "
            f"JSONL? (run without --flight)"
        )
    if meta is not None:
        extras = {k: v for k, v in meta.items()
                  if k in ("error", "progress", "stuck_s")}
        out.write(
            f"flight dump: reason={meta.get('reason')} "
            f"pid={meta.get('pid')} — {meta.get('recorded', len(ticks))} "
            f"ticks retained, {meta.get('dropped', 0)} aged out"
            + ("  " + " ".join(f"{k}={v}" for k, v in extras.items())
               if extras else "")
            + "\n"
        )
    if not ticks:
        out.write("(ring was empty — the engine never completed a tick)\n")
        return
    shown = ticks if last is None else ticks[-last:]
    base_t = shown[0].get("t", 0.0)
    # the w=vN column only appears once a live weight update actually
    # happened (every tick at the construction version is just noise)
    show_wv = any(r.get("weight_version") not in (None, 1)
                  for r in ticks)
    out.write(
        f"  {'tick':>7} {'t+s':>8} {'occ':>5} {'q':>3} "
        f"{'dec':>4} {'pre':>4} {'plan':>7} {'device':>8} "
        f"{'stream':>7} {'ms':>8}  slots\n"
    )
    for r in shown:
        slots = r.get("slots")
        cells = (" ".join(_slot_cell(s) for s in slots)
                 if slots is not None else "")
        extra = ""
        if "multi_k" in r:
            # multi-step decode: this one dispatch ran a k-step window
            extra += f"  k={r['multi_k']}"
        if "device_wait_ms" in r:
            # pipelined engines: how long the host actually blocked on
            # readback (device_ms minus what overlap hid)
            extra += f"  wait={float(r['device_wait_ms']):.2f}"
        if r.get("overrun_tokens"):
            extra += f"  overrun={r['overrun_tokens']}"
        if "blocks" in r:
            b = r["blocks"]
            extra += f"  blocks={b.get('in_use')}/{b.get('free')}free"
        if show_wv and "weight_version" in r:
            # live weight updates: which weight set served this tick
            # (a hot swap is the version stepping between rows)
            extra += f"  w=v{r['weight_version']}"
        if "demoted" in r and (r.get("demoted") or r.get("restored")):
            # tiered KV cache: blocks swapped out/in this tick
            extra += f"  tier=-{r['demoted']}/+{r.get('restored', 0)}"
        if r.get("kv_exported") or r.get("kv_imported"):
            # disaggregated serving: KV blocks shipped out / installed
            # by migration control calls since the previous tick
            extra += (f"  kv={r.get('kv_exported', 0)}out"
                      f"/{r.get('kv_imported', 0)}in")
        if "draft_tokens" in r:
            # speculative tick: accepted/proposed draft tokens
            extra += (f"  spec={r.get('accepted_tokens')}"
                      f"/{r.get('draft_tokens')}")
        out.write(
            f"  {r.get('tick', '?'):>7} "
            f"{r.get('t', 0.0) - base_t:>8.3f} "
            f"{r.get('occupancy', '?'):>5} "
            f"{r.get('queue_depth', '?'):>3} "
            f"{r.get('decode_tokens', '?'):>4} "
            f"{r.get('prefill_tokens', '?'):>4} "
            f"{r.get('plan_ms', 0.0):>7.2f} "
            f"{r.get('device_ms', 0.0):>8.2f} "
            f"{r.get('stream_ms', 0.0):>7.2f} "
            f"{r.get('tick_ms', 0.0):>8.2f}  {cells}{extra}\n"
        )
    # phase breakdown + latency percentiles across ALL retained ticks
    sums = {"plan": 0.0, "device": 0.0, "stream": 0.0}
    tick_ms = []
    for r in ticks:
        tick_ms.append(float(r.get("tick_ms", 0.0)))
        for k in sums:
            sums[k] += float(r.get(f"{k}_ms", 0.0))
    total = sum(sums.values()) or 1e-9
    out.write(
        f"\n{len(ticks)} ticks; phase share: "
        + " ".join(f"{k} {100 * v / total:.1f}%"
                   for k, v in sums.items())
        + f"\ntick_ms: p50 {_percentile(tick_ms, 50):.2f}  "
        f"p90 {_percentile(tick_ms, 90):.2f}  "
        f"p99 {_percentile(tick_ms, 99):.2f}  max {max(tick_ms):.2f}\n"
    )
    waits = [float(r["device_wait_ms"]) for r in ticks
             if "device_wait_ms" in r]
    if waits:
        # pipelined engines: the readback block the overlap could not
        # hide, the in-flight depth, and dropped late-finish tokens
        overrun = sum(int(r.get("overrun_tokens", 0)) for r in ticks)
        depth = [r["pipeline_depth"] for r in ticks
                 if "pipeline_depth" in r]
        out.write(
            f"device_wait_ms: p50 {_percentile(waits, 50):.2f}  "
            f"p90 {_percentile(waits, 90):.2f}  max {max(waits):.2f}"
            + (f"  pipeline_depth max {max(depth)}  "
               f"overrun_tokens {overrun}" if depth else "")
            + "\n"
        )
    if any("multi_k" in r for r in ticks):
        # multi-step decode: how much of the retained window actually
        # ran k-step dispatches, and the emitted-tokens amortization
        multi = [r for r in ticks if "multi_k" in r]
        toks = sum(int(r.get("emitted", 0)) for r in multi)
        out.write(
            f"multi-step: {len(multi)}/{len(ticks)} dispatches ran "
            f"k>1 windows (k max {max(int(r['multi_k']) for r in multi)}"
            f", {toks} tokens, "
            f"{toks / max(len(multi), 1):.1f} tokens/dispatch)\n"
        )
    if any("demoted" in r for r in ticks):
        # tiered KV cache: total swap traffic across the retained
        # window and the host pool's final footprint
        demoted = sum(int(r.get("demoted", 0)) for r in ticks)
        restored = sum(int(r.get("restored", 0)) for r in ticks)
        host_now = next((r["host_blocks"] for r in reversed(ticks)
                         if "host_blocks" in r), 0)
        out.write(
            f"host tier: {demoted} blocks demoted, {restored} "
            f"restored, {host_now} resident at last tick\n"
        )
    versions = [r["weight_version"] for r in ticks
                if "weight_version" in r]
    if versions and show_wv:
        swaps = sum(1 for a, b in zip(versions, versions[1:])
                    if b != a)
        out.write(
            f"weights: v{versions[0]} -> v{versions[-1]}, "
            f"{swaps} swap(s) inside the retained window\n"
        )
    if any("kv_exported" in r or "kv_imported" in r for r in ticks):
        # disaggregated serving: migration traffic through this
        # replica across the retained window
        exported = sum(int(r.get("kv_exported", 0)) for r in ticks)
        imported = sum(int(r.get("kv_imported", 0)) for r in ticks)
        out.write(
            f"kv migration: {exported} blocks exported, "
            f"{imported} imported\n"
        )
    worst = sorted(ticks, key=lambda r: float(r.get("tick_ms", 0.0)),
                   reverse=True)[:slow]
    out.write("slowest ticks: " + ", ".join(
        f"{r.get('tick', '?')} ({float(r.get('tick_ms', 0.0)):.1f} ms)"
        for r in worst
    ) + "\n")
    final = ticks[-1]
    mem = next((r["mem"] for r in reversed(ticks) if r.get("mem")), None)
    if mem:
        out.write("memory at last sample: " + " ".join(
            f"{k}={v}" for k, v in mem.items() if v is not None) + "\n")
    if final.get("recompiles") is not None:
        out.write(f"jit traces (process total): "
                  f"{final['recompiles']}\n")


# -- time-series timelines ---------------------------------------------------

_SPARK = "▁▂▃▄▅▆▇█"
_TL_WIDTH = 60
# default series picks, most interesting first: windowed tails, then
# rates, then gauges; :count and :p50 only when explicitly asked for
_SERIES_RANK = ((":p99", 0), (":rate", 1))


def _series_rank(key: str) -> int:
    for suffix, rank in _SERIES_RANK:
        if key.endswith(suffix):
            return rank
    if ":" not in key.rsplit("}", 1)[-1]:
        return 2  # gauge (no reduction suffix after the label block)
    return 3


def _sparkline(samples: List, t0: float, t1: float,
               width: int) -> str:
    """Bucket (t, value) samples onto a fixed-width column axis and
    render one block-character sparkline (empty columns stay blank)."""
    cols: List[List[float]] = [[] for _ in range(width)]
    span = max(t1 - t0, 1e-9)
    for t, v in samples:
        c = min(int((t - t0) / span * width), width - 1)
        cols[c].append(float(v))
    flat = [v for col in cols for v in col]
    lo, hi = min(flat), max(flat)
    rng = hi - lo
    out = []
    for col in cols:
        if not col:
            out.append(" ")
            continue
        v = sum(col) / len(col)
        i = int((v - lo) / rng * (len(_SPARK) - 1)) if rng > 0 else 0
        out.append(_SPARK[i])
    return "".join(out)


def _fmt_val(v: float) -> str:
    if isinstance(v, float) and v != int(v):
        return f"{v:.2f}"
    return str(int(v))


def render_fleet_timeline(points: List[dict], events: List[dict],
                          meta: Optional[dict] = None,
                          series: Optional[List[str]] = None,
                          top: int = 8, width: int = _TL_WIDTH,
                          out: Optional[TextIO] = None):
    """The series-plus-journal join, three stanzas: sparklines over
    the covered span, an event ruler on the same column axis, and the
    journal interleaved in time order with each event row annotated
    with the headline series values at (or just before) its moment."""
    out = out or sys.stdout
    for i, p in enumerate(points, 1):
        if "t" not in p or not isinstance(p.get("series"), dict):
            raise ReportError(
                f"point record {i}: missing t/series keys — is this a "
                f"timeline JSONL? (see timeseries.write_timeline)"
            )
    for i, e in enumerate(events, 1):
        if "t" not in e or "action" not in e:
            raise ReportError(
                f"event record {i}: missing t/action keys — not a "
                f"FleetEvent journal entry"
            )
    points = sorted(points, key=lambda p: p["t"])
    events = sorted(events, key=lambda e: e["t"])
    stamps = ([p["t"] for p in points] + [e["t"] for e in events])
    t0, t1 = min(stamps), max(stamps)
    srcs = sorted({s for p in points for s in p.get("sources", [])})
    head = (f"timeline: {len(points)} points, {len(events)} events "
            f"over {t1 - t0:.1f} s")
    if srcs:
        head += f"  [sources: {','.join(srcs)}]"
    if meta:
        extras = {k: meta[k] for k in ("interval_s", "dropped")
                  if meta.get(k)}
        if extras:
            head += "  " + " ".join(f"{k}={v}"
                                    for k, v in extras.items())
    out.write(head + "\n")

    # pick the series worth sparklining: explicit --series substrings,
    # else the top-N by (tail/rate/gauge rank, coverage)
    coverage: Dict[str, int] = defaultdict(int)
    for p in points:
        for k in p["series"]:
            coverage[k] += 1
    if series:
        chosen = [k for k in sorted(coverage)
                  if any(want in k for want in series)]
        if not chosen:
            raise ReportError(
                "--series matched none of "
                f"{len(coverage)} series in the input"
            )
    else:
        ranked = sorted(coverage,
                        key=lambda k: (_series_rank(k), -coverage[k],
                                       k))
        chosen = sorted(ranked[:top])
    label_w = max((len(k) for k in chosen), default=10)
    for key in chosen:
        samples = [(p["t"], p["series"][key]) for p in points
                   if key in p["series"]]
        if not samples:
            continue
        vals = [v for _, v in samples]
        out.write(
            f"  {key:<{label_w}} "
            f"{_sparkline(samples, t0, t1, width)} "
            f"{_fmt_val(min(vals))}..{_fmt_val(max(vals))}\n"
        )
    hidden = len(coverage) - len(chosen)
    if hidden > 0 and not series:
        out.write(f"  ... {hidden} more series (--series to choose)\n")
    if events:
        # the ruler: where on the sparkline axis each action landed
        ruler = [" "] * width
        span = max(t1 - t0, 1e-9)
        for e in events:
            c = min(int((e["t"] - t0) / span * width), width - 1)
            ruler[c] = "*" if ruler[c] == " " else "+"
        out.write(f"  {'events':<{label_w}} {''.join(ruler)}\n")
    # the interleave: journal rows in time order, each annotated with
    # the chosen series' values at the nearest point at-or-before t
    anno_keys = chosen[:3]
    pi = 0
    for e in events:
        while pi + 1 < len(points) and points[pi + 1]["t"] <= e["t"]:
            pi += 1
        at = (points[pi]["series"]
              if points and points[pi]["t"] <= e["t"] else {})
        detail = {k: v for k, v in e.items()
                  if k not in ("t", "actor", "action", "target")}
        anno = " ".join(f"{k}={_fmt_val(at[k])}" for k in anno_keys
                        if k in at)
        out.write(
            f"  +{e['t'] - t0:7.1f}s [{e.get('actor', '?'):<10}] "
            f"{e['action']:<12} {str(e.get('target') or '-'):<10}"
            + ("  " + " ".join(f"{k}={v}"
                               for k, v in sorted(detail.items()))
               if detail else "")
            + (f"  | {anno}" if anno else "")
            + "\n"
        )


def report_timeline(path: str, series: Optional[List[str]] = None,
                    top: int = 8, out: Optional[TextIO] = None):
    """Render a ``write_timeline`` artifact (meta line plus ``point``
    / ``event`` JSONL records)."""
    recs = _load_jsonl(path)
    meta = next((r["timeline_meta"] for r in recs
                 if "timeline_meta" in r), None)
    points = [r["point"] for r in recs if "point" in r]
    events = [r["event"] for r in recs if "event" in r]
    if not points and not events:
        raise ReportError(
            f"{path}: no point or event records — is this a trace "
            f"JSONL? (run without --timeline)"
        )
    try:
        render_fleet_timeline(points, events, meta=meta,
                              series=series, top=top, out=out)
    except ReportError as e:
        raise ReportError(f"{path}: {e}") from None


def report_live(url: str, polls: Optional[int] = None,
                interval_s: float = 2.0,
                series: Optional[List[str]] = None, top: int = 8,
                out: Optional[TextIO] = None):
    """Poll a running TelemetryServer's ``/timeseries`` + ``/events``
    routes and render the timeline per poll. On a router-backed
    server the routes are already fleet-merged, so this is the live
    whole-fleet view. ``polls=None`` loops until interrupted."""
    import time
    import urllib.error
    import urllib.request

    out = out or sys.stdout
    base = url if "://" in url else "http://" + url
    base = base.rstrip("/")

    def fetch(route: str) -> dict:
        try:
            with urllib.request.urlopen(base + route, timeout=5) as r:
                doc = json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            raise ReportError(
                f"{base}{route}: HTTP {e.code} — is the store wired? "
                f"(TelemetryServer(..., timeseries=, events=))"
            ) from None
        except (OSError, ValueError) as e:
            raise ReportError(
                f"cannot poll {base}{route}: "
                f"{getattr(e, 'reason', None) or e}"
            ) from None
        if not isinstance(doc, dict):
            raise ReportError(f"{base}{route}: not a JSON object")
        return doc

    n = 0
    while polls is None or n < polls:
        if n:
            time.sleep(interval_s)
            out.write("\n")
        n += 1
        ts = fetch("/timeseries")
        ev = fetch("/events")
        points = ts.get("points", [])
        events = ev.get("events", [])
        if not points and not events:
            out.write(f"{base}: no points or events yet "
                      f"(poll {n})\n")
            continue
        render_fleet_timeline(points, events, meta=ts.get("meta"),
                              series=series, top=top, out=out)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Render a telemetry trace JSONL into per-request "
                    "timelines and a span summary table, or a "
                    "flight-recorder dump into a tick timeline."
    )
    ap.add_argument("path", nargs="?", default=None,
                    help="trace JSONL (Tracer path= mirror); with "
                         "--flight a FlightRecorder dump; with "
                         "--timeline a write_timeline artifact "
                         "(omit with --live)")
    ap.add_argument("--trace", type=int, default=None,
                    help="render only this trace id")
    ap.add_argument("--top", type=int, default=10,
                    help="how many longest traces to render (default 10)")
    ap.add_argument("--chrome-trace", metavar="OUT", default=None,
                    help="span mode: export the spans (one trace id "
                         "with --trace, else all) as Chrome "
                         "trace-event JSON to OUT — open in "
                         "ui.perfetto.dev")
    ap.add_argument("--flight", action="store_true",
                    help="input is a flight-recorder dump (postmortem "
                         "or manual): render the tick timeline")
    ap.add_argument("--last", type=int, default=None,
                    help="flight mode: show only the most recent N ticks "
                         "(summary still covers the whole dump)")
    ap.add_argument("--timeline", action="store_true",
                    help="input is a time-series timeline artifact "
                         "(timeseries.write_timeline output): render "
                         "sparklines + the event journal interleaved")
    ap.add_argument("--live", metavar="URL", default=None,
                    help="poll a running TelemetryServer's "
                         "/timeseries and /events routes and render "
                         "the timeline per poll (no path argument)")
    ap.add_argument("--series", action="append", default=None,
                    metavar="SUBSTR",
                    help="timeline/live: sparkline only series whose "
                         "key contains SUBSTR (repeatable)")
    ap.add_argument("--polls", type=int, default=None,
                    help="live mode: stop after N polls "
                         "(default: poll until interrupted)")
    ap.add_argument("--poll-interval", type=float, default=2.0,
                    help="live mode: seconds between polls "
                         "(default 2)")
    args = ap.parse_args(argv)
    if args.live is None and args.path is None:
        ap.error("a JSONL path is required (or use --live URL)")
    try:
        if args.live is not None:
            report_live(args.live, polls=args.polls,
                        interval_s=args.poll_interval,
                        series=args.series)
        elif args.timeline:
            report_timeline(args.path, series=args.series)
        elif args.flight:
            report_flight(args.path, last=args.last)
        elif args.chrome_trace is not None:
            from distkeras_torch.telemetry.chrome import write_chrome_trace

            spans = load_spans(args.path)
            if args.trace is not None:
                spans = [s for s in spans if s["trace"] == args.trace]
            try:
                doc = write_chrome_trace(args.chrome_trace, spans)
            except OSError as e:
                raise ReportError(
                    f"cannot write {args.chrome_trace}: "
                    f"{e.strerror or e}"
                ) from None
            print(f"wrote {len(doc['traceEvents'])} events "
                  f"({len(spans)} spans) to {args.chrome_trace} — "
                  f"open in ui.perfetto.dev")
        else:
            report(args.path, trace=args.trace, top=args.top)
    except ReportError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)
    except KeyboardInterrupt:  # ctrl-C out of --live: clean exit
        pass
    except BrokenPipeError:  # `... | head` closed the pipe: not an error
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())


if __name__ == "__main__":
    main()
