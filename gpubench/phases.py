"""The port's phase spans against a traced window.

The program records phase spans on its tracer
(``distkeras_torch.telemetry.Tracer``): the serving engine's loop
(``engine.admit``, ``engine.plan``, ``engine.launch``, ``engine.wait``,
``engine.settle``, ``engine.record``, ``engine.idle``) and the training
steps' ``train.forward`` and ``train.backward``. While a profiler
records, each span also opens a range of its name, so the full trace
(CPU and CUDA activities) carries them as ``user_annotation`` events.

- The training metrics (``metrics/train_fwd_ms_per_step.py``,
  ``train_bwd_ms_per_step.py``) read the full trace the run wrote
  (:func:`full_trace`) and take the device time of the kernels launched
  inside a range (:func:`range_device_s`).
- The spans' own clock is ``time.perf_counter_ns()``. A pair read
  together at the start of a traced window (:func:`clock_pair`) maps it
  onto the trace's, ``baseTimeNanoseconds + ts * 1000``
  (:func:`trace_us`); ``test_gpubench_clock.py`` holds the mapping to
  a kernel's device interval on the card.
- The serving readings (:func:`serve_readings`, :func:`idle_by_phase`)
  take the engine's ``stats()`` at the timed window's ends and its
  phase ring over the kernel-only window. ``python3 -m gpubench.phases
  --workload <serving cell> --seed <n> --seconds <s>`` runs the cell
  with ``--trace 1`` and prints them after its result line; the kind
  module does not yet put them in the record.
"""

from __future__ import annotations

import argparse
import bisect
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from gpubench import guard

# before torch (gpubench.trace loads it): nothing may bring JAX in
os.environ.update(guard.ENV)

from gpubench.cells import ROOT  # noqa: E402
from gpubench.trace import merged, union_seconds  # noqa: E402

OUT = ROOT / "build" / "gpubench"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the loop's phases that run on its CPU (wait and idle block by design)
HOST_PHASES = ("engine.admit", "engine.plan", "engine.launch",
               "engine.settle", "engine.record")


# -- the clock ---------------------------------------------------------------


def clock_pair() -> Tuple[int, int]:
    """``(time.perf_counter_ns(), time.time_ns())`` read back to back."""
    return time.perf_counter_ns(), time.time_ns()


def trace_us(perf_ns: int, pair: Tuple[int, int], base_ns: int) -> float:
    """A ``perf_counter_ns`` stamp on a Chrome trace's ``ts`` axis (us),
    the trace's ``baseTimeNanoseconds`` being ``base_ns``."""
    return (pair[1] + perf_ns - pair[0] - base_ns) / 1e3


# -- the full trace: device time inside host ranges --------------------------


def device_events(events: Sequence[dict]) -> List[dict]:
    return [e for e in events if e.get("cat") in _DEVICE_CATS
            and e.get("ph") == "X"]


def _interval(e: dict) -> Tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))


def full_trace(record: dict, out_dir: Optional[Path] = None
               ) -> Optional[List[dict]]:
    """The events of the full trace behind ``record``: the newest
    ``trace.*.full.0.json`` under ``out_dir`` (default :data:`OUT`)
    whose device time equals the record summary's ``busy_s`` (a run
    writes it just before its metrics are read). None without device
    time or such a file."""
    busy = (record.get("summary") or {}).get("busy_s")
    if not busy:
        return None
    paths = sorted((out_dir or OUT).glob("trace.*.full.0.json"),
                   key=lambda p: p.stat().st_mtime, reverse=True)
    for path in paths:
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        except (OSError, ValueError, KeyError):
            continue
        spans = [_interval(e) for e in device_events(events)]
        if math.isclose(union_seconds(spans), busy, rel_tol=1e-9):
            return events
    return None


def range_device_s(events: Sequence[dict], name: str) -> float:
    """Union of the device intervals of the kernels, copies and fills
    whose launch (a runtime event, matched by correlation id) lies
    inside a ``name`` range of the trace, on any thread: autograd
    launches a backward's kernels from its own thread, not the one
    holding the range. Seconds."""
    ranges = merged([_interval(e) for e in events
                     if e.get("cat") == "user_annotation"
                     and e.get("ph") == "X" and e.get("name") == name])
    if not ranges:
        return 0.0
    starts = [s for s, _ in ranges]
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in _LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    out = []
    for e in device_events(events):
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            out.append(_interval(e))
    return union_seconds(out)


def range_ms_per_step(record: dict, name: str,
                      out_dir: Optional[Path] = None) -> Optional[float]:
    """:func:`range_device_s` of a training run's full trace a traced
    step, ms; None where the record is not a training run's, the trace
    is not found or no kernel was launched in such a range."""
    if record.get("kind") != "train" or not record.get("steps"):
        return None
    events = full_trace(record, out_dir)
    if events is None:
        return None
    sec = range_device_s(events, name)
    return 1e3 * sec / record["steps"] if sec > 0 else None


# -- serving: the engine's counters over the timed window --------------------


def serve_readings(a: dict, b: dict) -> Optional[dict]:
    """The loop's numbers between two ``ServingEngine.stats()``, taken
    at the timed window's ends: ms a tick of admission and plan, of
    launch, of the wait on the readback, of settle and record; the
    share of the host phases' wall time the loop thread was off its CPU
    (runnable but not running, or blocked); the share of the computed
    positions that were live requests'. None without phases or ticks
    between them."""
    if "phases" not in a or "phases" not in b:
        return None
    ticks = b["ticks"] - a["ticks"]
    if ticks <= 0:
        return None

    def delta(name, key):
        return (b["phases"].get(name, {}).get(key, 0)
                - a["phases"].get(name, {}).get(key, 0))

    def per_tick(*names):
        return sum(delta(n, "wall_ns") for n in names) / 1e6 / ticks

    wall = sum(delta(n, "wall_ns") for n in HOST_PHASES)
    cpu = sum(delta(n, "cpu_ns") for n in HOST_PHASES)
    computed = b["positions_computed"] - a["positions_computed"]
    valid = b["positions_valid"] - a["positions_valid"]
    return {
        "serve_plan_ms": per_tick("engine.admit", "engine.plan"),
        "serve_launch_ms": per_tick("engine.launch"),
        "serve_wait_ms": per_tick("engine.wait"),
        "serve_settle_ms": per_tick("engine.settle", "engine.record"),
        "serve_loop_offcpu_pct": (100.0 * (wall - cpu) / wall if wall > 0
                                  else None),
        "serve_tick_valid_pct": (100.0 * valid / computed if computed > 0
                                 else None),
    }


def window_spans(spans: Sequence[tuple], dropped: int, t0_ns: int,
                 t1_ns: int) -> Optional[List[tuple]]:
    """The phase spans ``(name, t0_ns, t1_ns, cpu_ns, thread)`` that
    overlap ``[t0_ns, t1_ns]``; None when the ring dropped spans there
    (its oldest span starts after ``t0_ns``)."""
    if dropped and (not spans or spans[0][1] > t0_ns):
        return None
    return [s for s in spans if s[2] > t0_ns and s[1] < t1_ns]


def idle_by_phase(events: Sequence[dict], window_us: Tuple[float, float],
                  spans_us: Sequence[Tuple[str, float, float]]
                  ) -> Dict[str, float]:
    """The idle time of a device trace's window (``window_us``, on its
    ``ts`` axis), seconds, split by the phase span open on the loop
    thread during it (``spans_us``: ``(name, start_us, end_us)``, one
    thread, not overlapping); ``""`` is idle time under no span. Idle
    is the window less the union of its kernels, copies and fills, as
    ``device_idle_pct`` counts it."""
    w0, w1 = window_us
    busy = merged([_interval(e) for e in device_events(events)])
    idle, cur = [], w0
    for s, e in busy:
        if s > cur:
            idle.append((cur, min(s, w1)))
        cur = max(cur, e)
        if cur >= w1:
            break
    if cur < w1:
        idle.append((cur, w1))
    idle = [(s, e) for s, e in idle if e > s]
    out: Dict[str, float] = {}
    covered = 0.0
    for name, s, e in spans_us:
        for i0, i1 in idle:
            lap = min(e, i1) - max(s, i0)
            if lap > 0:
                out[name] = out.get(name, 0.0) + lap / 1e6
                covered += lap / 1e6
    out[""] = sum(e - s for s, e in idle) / 1e6 - covered
    return out


def idle_unnamed_pct(by_phase: Dict[str, float]) -> Optional[float]:
    """Share of :func:`idle_by_phase`'s idle time under no span, %."""
    total = sum(by_phase.values())
    return 100.0 * by_phase[""] / total if total > 0 else None


# -- the serving cell with the engine's telemetry read -----------------------


def capture_serving(run) -> Tuple[dict, dict]:
    """Execute the serving ``run`` (``--trace 1``) through its kind
    module, with the engine's ``stats()`` kept at the timed window's
    ends and its phase ring and a :func:`clock_pair` kept around the
    kernel-only window. Returns the result line and the readings."""
    from gpubench.kinds import serve_closed_loop as kind
    from gpubench.run import execute

    got: dict = {"stats": []}
    build, profile = kind.build_engine, kind.profile

    def build_kept(*a, **kw):
        engine = build(*a, **kw)
        got["tracer"] = engine.tracer
        stats = engine.stats

        def kept():
            st = stats()
            got["stats"].append(st)
            return st

        engine.stats = kept
        return engine

    def profile_kept(fn, path, cpu=True):
        pair = clock_pair()
        out = profile(fn, path, cpu)
        if not cpu:
            got["device"] = (path, pair, out["t0"], out["t1"],
                             got["tracer"].phase_spans())
        return out

    kind.build_engine, kind.profile = build_kept, profile_kept
    try:
        line = execute(run)
    finally:
        kind.build_engine, kind.profile = build, profile
    a, b = got["stats"][:2]
    readings = serve_readings(a, b) or {}
    ticks = b["ticks"] - a["ticks"]
    readings["phase_ms_per_tick"] = {
        n: {k[:-3] + "_ms": (b["phases"][n][k]
                            - a["phases"].get(n, {}).get(k, 0)) / 1e6 / ticks
            for k in ("wall_ns", "cpu_ns")}
        for n in b.get("phases", {})} if ticks > 0 else {}
    path, pair, t0, t1, (spans, dropped) = got["device"]
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    # the profiler's window, on the host clock (s), on the trace's axis
    w0 = trace_us(int(t0 * 1e9), pair, base)
    w1 = trace_us(int(t1 * 1e9), pair, base)
    inside = window_spans(spans, dropped, int(t0 * 1e9), int(t1 * 1e9))
    if inside is not None:
        spans_us = [(n, trace_us(s, pair, base), trace_us(e, pair, base))
                    for n, s, e, _, _ in inside]
        by_phase = idle_by_phase(doc["traceEvents"], (w0, w1), spans_us)
        readings["device_idle_unnamed_pct.serve"] = idle_unnamed_pct(
            by_phase)
        readings["idle_s_by_phase"] = by_phase
    return line, readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from gpubench.cells import load_cell
    from gpubench.run import cache_dirs
    from gpubench.runner import Run

    if not torch.cuda.is_available():
        print("gpubench.phases: no CUDA device", file=sys.stderr)
        return 2
    cache_dirs()
    run = Run(load_cell(args.workload), args.seed, args.seconds, True)
    line, readings = capture_serving(run)
    print(json.dumps(line), flush=True)
    print(json.dumps({"phases": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
