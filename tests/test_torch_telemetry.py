"""The port's engine and server telemetry on the CPU — the serving cases
of the reference's ``tests/test_telemetry.py`` over the port (the
stdlib telemetry modules themselves are copies, held equal in
``tests/test_torch_imports.py``), run under the lock-order detector:

- a port engine emits the queued / prefill / decode / finish span chain
  and the serving metric families, the recompile gauge among them;
- an expired request is traced and counted;
- one Prometheus endpoint scrapes a live port ``LMServer`` while a
  client streams from it: text, JSON, traces, health and a 404;
- the port's phase spans: the tracer's own ring (bounded, drops
  counted), its totals, a profiler range only while a profiler records,
  and their Chrome lanes; the engine loop's phases cover every step of
  a paged chunked engine (sync, pipelined, speculative) in order and
  without overlap, the flight snapshot reads its intervals from them,
  and a hand-built tick counts its computed and valid positions.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_lockorder_util import lock_order  # noqa: E402,F401

from distkeras_torch import telemetry  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.serving import (  # noqa: E402
    LMServer,
    ServingClient,
    ServingEngine,
)
from torch_spawn_util import one_thread  # noqa: E402,F401

KW = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2, max_len=48)


def _engine(**kw):
    lm = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                   seed=0, **KW)
    reg, tr = telemetry.MetricRegistry(), telemetry.Tracer()
    kw.setdefault("slots", 2)
    return ServingEngine(lm, device="cpu", registry=reg, tracer=tr,
                         **kw), reg, tr


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read().decode()


def test_engine_emits_span_chain_and_metrics():
    eng, reg, tr = _engine()
    reqs = [eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
            for _ in range(3)]
    eng.drain()
    for req in reqs:
        req.stream.tokens(timeout=10)
        chain = {s["span"]: s for s in tr.dump(trace=req.trace_id)}
        assert {"queued", "prefill", "decode", "finish"} <= set(chain)
        assert chain["decode"]["tokens"] == 4
        assert chain["finish"]["reason"] == "length"
        assert chain["finish"]["slot"] in (0, 1)
    assert reg.counter("serving_ticks_total").value == eng.ticks
    assert reg.counter("serving_tokens_total").value == 12
    assert reg.counter("serving_requests_total",
                       labelnames=("reason",)).labels(
                           reason="length").value == 3
    assert reg.histogram("serving_ttft_ms").value["count"] == 3
    assert reg.gauge("serving_slot_occupancy").value == 0  # drained
    # the recompile gauge is refreshed on the memory-sample ticks: on the
    # CPU no kernel is built, loaded or launched by the engine
    assert "jax_recompiles" in reg.collect()
    assert eng.stats()["recompiles_since_mark"] == {}


def test_expired_request_traced():
    eng, reg, tr = _engine(slots=1)
    req = eng.submit(np.zeros(4, np.int32), max_new_tokens=2,
                     deadline_s=0.0)
    time.sleep(0.01)
    eng.drain()
    assert req.stream.tokens(timeout=10) == []
    chain = {s["span"] for s in tr.dump(trace=req.trace_id)}
    assert chain == {"queued", "finish"}
    assert reg.counter("serving_requests_total",
                       labelnames=("reason",)).labels(
                           reason="expired").value == 1


def test_http_endpoint_scrapes_live_server(lock_order):
    """One Prometheus endpoint over a live port LMServer: queue depth,
    slot occupancy, latency histograms and the request's trace. The
    detector saw the port's own locks nest, and no cycle among them."""
    eng, reg, tr = _engine()
    srv = LMServer(eng).start()
    http = telemetry.TelemetryServer(registry=reg, tracer=tr).start()
    client = None
    try:
        client = ServingClient("127.0.0.1", srv.port, timeout=60)
        rid = client.generate(list(range(1, 6)), max_new_tokens=4)
        toks, reason = client.result(rid, timeout=60)
        assert len(toks) == 4 and reason == "length"
        deadline = time.monotonic() + 5.0
        while True:
            code, text = _get(f"http://127.0.0.1:{http.port}/metrics")
            if ("serving_ttft_ms_count 1" in text
                    or time.monotonic() > deadline):
                break
            time.sleep(0.02)
        assert code == 200
        for family in ("serving_queue_depth", "serving_slot_occupancy",
                       "serving_ttft_ms_count 1", "jax_recompiles"):
            assert family in text
        code, text = _get(f"http://127.0.0.1:{http.port}/metrics.json")
        snap = json.loads(text)
        assert snap["serving_tokens_total"]["series"][0]["value"] == 4
        tid = client.trace_of(rid)
        code, text = _get(f"http://127.0.0.1:{http.port}/traces?trace={tid}")
        spans = {s["span"] for s in json.loads(text)}
        assert {"queued", "prefill", "decode", "finish"} <= spans
        assert _get(f"http://127.0.0.1:{http.port}/healthz")[1] == "ok"
        with pytest.raises(urllib.error.HTTPError):
            _get(f"http://127.0.0.1:{http.port}/nope")
    finally:
        if client is not None:
            client.close()
        http.stop()
        srv.stop()
    # ServingClient._call takes its send lock under its call lock: the
    # detector is armed and recorded that ordering
    assert lock_order.edge_count() >= 1


# -- phase spans -------------------------------------------------------------


def test_tracer_phase_ring_totals_and_drops(monkeypatch):
    monkeypatch.setattr(telemetry.Tracer, "PHASE_CAPACITY", 3)
    tr = telemetry.Tracer()
    span = None
    for name in ("a", "b", "a", "b", "a"):
        span, wall, cpu = tr.switch_phase(span, name)
    tr.switch_phase(span, None)
    spans, dropped = tr.phase_spans()
    assert len(spans) == 3 and dropped == 2
    assert [s[0] for s in spans] == ["a", "b", "a"]
    for a, b in zip(spans, spans[1:]):
        assert a[1] <= a[2] == b[1]  # one stamp ends one, starts the next
    tot = tr.phase_totals()
    assert tot["a"]["count"] == 3 and tot["b"]["count"] == 2
    assert tot["a"]["wall_ns"] >= sum(s[2] - s[1] for s in spans
                                      if s[0] == "a")
    with tr.phase("c"):
        pass
    assert tr.phase_totals()["c"]["count"] == 1
    assert tr.phase_spans()[1] == 3
    assert len(tr.dump()) == 0  # request spans keep their own ring


def test_phase_opens_a_profiler_range_only_while_recording(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tr = telemetry.Tracer()
    span = tr.switch_phase(None, "quiet")[0]
    assert span[3] is None
    tr.switch_phase(span, None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.phase("loud"):
            torch.ones(4).sum()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert names.count("loud") == 1 and "quiet" not in names


def test_phase_spans_get_a_chrome_lane_per_thread():
    import threading

    tr = telemetry.Tracer()
    with tr.phase("main.work"):
        pass

    def other():
        with tr.phase("other.work"):
            pass

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    recs = tr.phase_dump()
    assert {r["span"] for r in recs} == {"main.work", "other.work"}
    assert {r["lane"] for r in recs} == {0, 1}
    assert all(r["pid"] == tr.pid and "cpu_ms" in r for r in recs)
    doc = telemetry.to_chrome_trace(recs)
    x = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len({e["tid"] for e in x}) == 2
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["name"] == "thread_name"}
    assert names == {"phases, thread 0", "phases, thread 1"}


# per loop, the phases of one step() call, in order
STEPS = {
    "sync": r"admit( plan launch wait settle record admit)?",
    "pipelined": r"admit( plan launch)?( wait settle record)*",
    "spec": r"admit( wait settle record admit)?( plan launch)? settle",
}


def _burst(mode):
    """A paged chunked engine of ``mode`` driven through 8 requests with
    the collector off; its step() calls' ``(start, end)`` stamps."""
    import gc

    kw = {"sync": {}, "pipelined": {"pipeline": True},
          "spec": {"pipeline": True, "draft": "ngram"}}[mode]
    eng, reg, tr = _engine(paged=True, block_size=8, prefill_chunk=8, **kw)
    rng = np.random.default_rng(0)
    for _ in range(8):
        eng.submit(rng.integers(0, 64, size=13).astype(np.int32), 10)
    steps = []
    gc.collect()
    gc.disable()
    try:
        while True:
            t0 = time.perf_counter_ns()
            more = eng.step()
            steps.append((t0, time.perf_counter_ns()))
            if not more:
                break
    finally:
        gc.enable()
    return eng, reg, tr, steps


@pytest.mark.parametrize("mode", sorted(STEPS))
def test_engine_phases_cover_every_step_in_order(mode):
    """Over a burst the phases' summed wall time is within 2% of the
    step() calls': in one of three bursts, since a timeslice of a loaded
    host can land in the microseconds between a step's last span and
    its return."""
    import re

    for _ in range(3):
        eng, reg, tr, steps = _burst(mode)
        wall = sum(t1 - t0 for t0, t1 in steps)
        total = sum(v["wall_ns"] for v in eng.stats()["phases"].values())
        if total >= 0.98 * wall:
            break
    assert 0.98 * wall <= total <= wall
    assert len(steps) >= 20
    spans, dropped = tr.phase_spans()
    assert dropped == 0
    for a, b in zip(spans, spans[1:]):
        assert a[1] <= a[2] <= b[1]  # in order, no overlap
    seen, ticked = 0, 0
    for t0, t1 in steps:
        names = [s[0] for s in spans if t0 <= s[1] and s[2] <= t1]
        seen += len(names)
        ticked += "engine.plan" in names and "engine.wait" in names
        order = " ".join(n[len("engine."):] for n in names)
        assert re.fullmatch(STEPS[mode], order), order
    assert seen == len(spans)  # every span inside a step() call
    assert ticked >= 3
    phases = eng.stats()["phases"]
    assert total == sum(s[2] - s[1] for s in spans)
    assert phases["engine.wait"]["count"] == eng.ticks
    fam = reg.counter("serving_phase_spans_total", labelnames=("phase",))
    assert fam.labels(phase="engine.plan").value == eng.dispatches
    # the snapshots' tick_ms take the phases in turn, none twice
    snaps = eng.flight.snapshots()
    for a, b in zip(snaps, snaps[1:]):
        assert b["t0_ns"] >= a["t0_ns"] + a["tick_ms"] * 1e6 - 1e3
    assert sum(x["tick_ms"] for x in snaps) <= total / 1e6


def test_flight_snapshot_intervals_are_the_phase_spans():
    eng, _, tr = _engine(paged=True, block_size=8, prefill_chunk=8)
    eng.submit(np.arange(1, 12, dtype=np.int32), 3)
    eng.drain()
    spans, _ = tr.phase_spans()
    for snap in eng.flight.snapshots():
        inside = {s[0]: (s[2] - s[1]) / 1e6 for s in spans
                  if s[1] >= snap["t0_ns"] and s[0] != "engine.record"
                  and s[1] < snap["t0_ns"] + snap["tick_ms"] * 1e6}
        assert snap["plan_ms"] == inside["engine.plan"]
        assert snap["dispatch_ms"] == inside["engine.launch"]
        assert snap["device_wait_ms"] == inside["engine.wait"]
        assert snap["stream_ms"] == inside["engine.settle"]
        assert snap["device_ms"] == snap["dispatch_ms"] + snap[
            "device_wait_ms"]


def test_hand_built_tick_counts_its_positions():
    """Two slots, chunk 8: one decode row and a 5-token prompt chunk in
    one tick compute 2 x 8 positions, 1 + 5 of them live."""
    eng, reg, _ = _engine(paged=True, block_size=8, prefill_chunk=8)
    eng.submit(np.arange(1, 4, dtype=np.int32), 10)
    eng.step()  # the 3-token prompt in one chunk: decoding next
    eng.submit(np.arange(1, 6, dtype=np.int32), 10)
    before = eng.stats()
    eng.step()
    after = eng.stats()
    assert after["positions_computed"] - before["positions_computed"] == 16
    assert after["positions_valid"] - before["positions_valid"] == 6
    assert reg.counter("serving_positions_computed_total").value == (
        after["positions_computed"])
    assert reg.counter("serving_positions_valid_total").value == (
        after["positions_valid"])


def test_serve_forever_records_the_idle_phase():
    import threading

    eng, _, tr = _engine()
    stop = threading.Event()
    loop = threading.Thread(target=eng.serve_forever, args=(stop,),
                            kwargs={"idle_sleep": 0.001})
    loop.start()
    try:
        req = eng.submit(np.arange(1, 6, dtype=np.int32), 3)
        assert len(req.stream.tokens(timeout=30)) == 3
        time.sleep(0.05)
    finally:
        stop.set()
        loop.join(timeout=30)
    assert not loop.is_alive()
    phases = eng.stats()["phases"]
    assert phases["engine.idle"]["count"] >= 1
    assert {s[4] for s in tr.phase_spans()[0]} == {loop.ident}
