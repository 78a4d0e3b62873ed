"""The readers of the program's phase spans (``gpubench/phases.py``) on
synthetic traces and engine statistics, and the spans' ranges in the
full trace of a tiny traced training run on the CPU."""

import json

import pytest

from gpubench import phases
from gpubench.cells import metric_reader
from gpubench.conftest import tiny_cells
from gpubench.run import execute
from gpubench.runner import Run


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _train_trace():
    """Forward [0, 100] and backward [100, 300] on thread 1; a forward
    kernel launched from thread 1, a backward one from autograd's thread
    2, an optimizer one after both ranges."""
    return [
        _x("user_annotation", "train.forward", 0, 100),
        _x("user_annotation", "train.backward", 100, 200),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 2, tid=2,
           correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 350, 2, correlation=3),
        _x("kernel", "fwd", 20, 40, tid=7, correlation=1),
        _x("kernel", "bwd", 160, 100, tid=7, correlation=2),
        _x("kernel", "opt", 360, 40, tid=7, correlation=3),
    ]


def _write(tmp_path, events, name="trace.x.full.0.json"):
    with open(tmp_path / name, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_training_ranges_read_their_kernels(tmp_path, monkeypatch):
    _write(tmp_path, _train_trace())
    record = {"kind": "train", "steps": 2,
              "summary": {"busy_s": 180e-6}}
    assert phases.range_ms_per_step(record, "train.forward",
                                    tmp_path) == pytest.approx(0.02)
    assert phases.range_ms_per_step(record, "train.backward",
                                    tmp_path) == pytest.approx(0.05)
    monkeypatch.setattr(phases, "OUT", tmp_path)
    assert metric_reader("train_fwd_ms_per_step")(record) == (
        pytest.approx(0.02))
    assert metric_reader("train_bwd_ms_per_step")(record) == (
        pytest.approx(0.05))
    # another run's record (its device time differs), another kind, no
    # record, and a trace without the ranges: nothing to read
    other = dict(record, summary={"busy_s": 1.0})
    for r in (other, dict(record, kind="serve"), {}):
        assert metric_reader("train_fwd_ms_per_step")(r) is None
    _write(tmp_path, [e for e in _train_trace()
                      if e["cat"] != "user_annotation"])
    assert metric_reader("train_bwd_ms_per_step")(record) is None


def test_serve_readings_between_two_stats():
    def stats(ticks, pos, valid, **walls):
        return {"ticks": ticks, "positions_computed": pos,
                "positions_valid": valid,
                "phases": {f"engine.{k}": {"wall_ns": w, "cpu_ns": c,
                                           "count": ticks}
                           for k, (w, c) in walls.items()}}

    a = stats(10, 1000, 100, admit=(0, 0), plan=(0, 0), launch=(0, 0),
              wait=(0, 0), settle=(0, 0), record=(0, 0))
    b = stats(14, 1800, 140, admit=(4e6, 4e6), plan=(8e6, 6e6),
              launch=(40e6, 30e6), wait=(80e6, 1e6), settle=(6e6, 6e6),
              record=(2e6, 2e6))
    got = phases.serve_readings(a, b)
    assert got["serve_plan_ms"] == pytest.approx(3.0)
    assert got["serve_launch_ms"] == pytest.approx(10.0)
    assert got["serve_wait_ms"] == pytest.approx(20.0)
    assert got["serve_settle_ms"] == pytest.approx(2.0)
    # host phases: 60 ms of wall, 48 ms on the CPU
    assert got["serve_loop_offcpu_pct"] == pytest.approx(20.0)
    assert got["serve_tick_valid_pct"] == pytest.approx(5.0)
    assert phases.serve_readings({"ticks": 1}, b) is None
    assert phases.serve_readings(b, b) is None


def test_idle_time_by_the_phase_open_during_it():
    events = [_x("kernel", "k", 10, 10), _x("gpu_memcpy", "c", 40, 10)]
    # idle [0, 10], [20, 40], [50, 60]: 40 us
    spans = [("engine.plan", 5, 25), ("engine.wait", 25, 45)]
    by = phases.idle_by_phase(events, (0.0, 60.0), spans)
    assert by["engine.plan"] == pytest.approx(10e-6)
    assert by["engine.wait"] == pytest.approx(15e-6)
    assert by[""] == pytest.approx(15e-6)
    assert phases.idle_unnamed_pct(by) == pytest.approx(37.5)
    assert phases.idle_unnamed_pct({"": 0.0}) is None


def test_window_spans_and_the_clock():
    spans = [("a", 0, 10, 1, 7), ("b", 10, 30, 1, 7), ("a", 30, 40, 1, 7)]
    assert [s[0] for s in phases.window_spans(spans, 0, 12, 35)] == [
        "b", "a"]
    assert phases.window_spans(spans, 5, 12, 35) is not None
    assert phases.window_spans(spans[1:], 5, 5, 35) is None
    # perf 1000 ns is wall 5000 ns; the trace's base is 2000 ns
    assert phases.trace_us(3000, (1000, 5000), 2000) == pytest.approx(5.0)


def test_traced_cpu_run_carries_the_step_ranges():
    """The tiny LM cell traced on the CPU: its full trace holds one
    ``train.forward`` and one ``train.backward`` range a traced step
    (no device time to read there, so the metrics are left out)."""
    cell = tiny_cells()["lm_flagship.train"]
    run = Run(cell, 2**31 + 11, 0.4, True, device_type="cpu")
    line = execute(run)
    assert line["correct"]
    assert "train_fwd_ms_per_step" not in line["metrics"]
    with open(run.trace_path()) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    steps = run.record["steps"]
    assert names.count("train.forward") == steps
    assert names.count("train.backward") == steps
