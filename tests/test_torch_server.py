"""The port's TCP front end on the CPU: ``LMServer`` / ``ServingClient``
over loopback, the engine's loop thread (``serve_forever``,
``call_in_loop``), the stall watchdog and the telemetry ops the server
serves. Each server is tiny (``torch_engine_util.pair()`` weights) and
is stopped in a fixture finalizer; every client call has a timeout.

Tolerances: token streams are compared exactly (greedy over f32 weights
against the port's ``generate()`` and the JAX engine on the same bridged
weights); telemetry replies by their fields and counts."""

import glob
import io
import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401
from torch_lockorder_util import lock_order  # noqa: E402,F401

from distkeras_torch import telemetry  # noqa: E402
from distkeras_torch.models.transformer import generate  # noqa: E402
from distkeras_torch.serving import (  # noqa: E402
    DrainingError,
    FIFOScheduler,
    LMServer,
    OverloadedError,
    ServingClient,
    ServingConnectionError,
    UnknownOpError,
)
from distkeras_torch.telemetry import report as telemetry_report  # noqa: E402
from distkeras_torch.telemetry.slo import (  # noqa: E402
    SloMonitor,
    default_serving_rules,
)

BS = 8
TIMEOUT = 60.0


@pytest.fixture(scope="module")
def trio():
    return U.pair(seed=0)


@pytest.fixture
def serve(request):
    """``serve(engine, **kw)`` -> a started LMServer, stopped (with every
    client made through ``serve.client``) when the test ends."""
    servers, clients = [], []

    def make(eng, **kw):
        srv = LMServer(eng, **kw).start()
        servers.append(srv)
        return srv

    def client(srv, **kw):
        kw.setdefault("request_timeout", TIMEOUT)
        kw.setdefault("timeout", TIMEOUT)
        c = ServingClient("127.0.0.1", srv.port, **kw)
        clients.append(c)
        return c

    make.client = client

    def fin():
        for c in clients:
            c.close()
        for s in servers:
            s.stop(timeout=10.0)

    request.addfinalizer(fin)
    return make


def _engine(pm, **kw):
    kw.setdefault("paged", True)
    return U.port_engine(pm, **kw)


def _want(pm, prompt, n):
    return generate(pm, torch.as_tensor(prompt)[None], n)[
        0, len(prompt):].tolist()


def _prompts(n, size, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, U.V, size=size).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_server_tcp_smoke(trio, serve, layout):
    """Greedy streams over TCP equal the port's generate() and the JAX
    engine's streams on the same bridged weights; stats count them."""
    jm, params, pm = trio
    prompts = _prompts(3, 6, seed=4)
    srv = serve(_engine(pm, paged=layout == "paged"))
    c = serve.client(srv)
    rids = [c.generate(p, max_new_tokens=5) for p in prompts]
    got = []
    for p, rid in zip(prompts, rids):
        toks, reason = c.result(rid)
        assert reason == "length"
        assert toks == _want(pm, p, 5)
        got.append(toks)
    jeng = U.jax_engine(jm, params, paged=layout == "paged")
    assert got == U.serve(jeng, prompts, U.greedy((5, 5, 5)))
    st = c.stats()
    assert st["requests_completed"] == 3
    assert st["tokens_generated"] == 15


def test_server_stats_under_concurrent_inflight_requests(trio, serve):
    """stats frames interleave with token frames on one connection
    without corrupting either; the final counters and the registry
    snapshot agree with what was streamed."""
    _, _, pm = trio
    srv = serve(_engine(pm))
    c = serve.client(srv)
    prompts = _prompts(4, 5, seed=7)
    rids = [c.generate(p, max_new_tokens=12) for p in prompts]
    polled, errors = [], []

    def poll():
        try:
            for _ in range(20):
                polled.append(c.stats())
        except Exception as e:  # pragma: no cover - failure detail
            errors.append(e)

    t = threading.Thread(target=poll)
    t.start()
    results = {rid: c.result(rid) for rid in rids}
    t.join(timeout=TIMEOUT)
    assert not t.is_alive() and not errors
    assert len(polled) == 20
    done = [s["requests_completed"] for s in polled]
    assert done == sorted(done)
    for p, rid in zip(prompts, rids):
        assert results[rid] == (_want(pm, p, 12), "length")
    final = c.stats()
    assert final["requests_completed"] == 4
    assert final["tokens_generated"] == 48
    series = c.metrics()["serving_tokens_total"]["series"]
    assert series and series[0]["value"] == 48


def test_trace_id_roundtrip_via_client(trio, serve):
    """The generate ack carries the trace id; trace_dump filtered to it
    returns the whole span chain, and chrome_trace the same spans as
    Chrome trace events."""
    _, _, pm = trio
    srv = serve(_engine(pm))
    c = serve.client(srv)
    p = np.arange(1, 7, dtype=np.int32)
    rid = c.generate(p, max_new_tokens=5)
    tid = c.trace_of(rid)
    assert tid is not None
    assert list(c.stream(rid)) == _want(pm, p, 5)
    deadline = time.monotonic() + 5.0
    spans = {}
    while time.monotonic() < deadline:
        spans = {s["span"]: s for s in c.trace_dump(trace=tid)}
        if "stream" in spans:
            break
        time.sleep(0.01)
    assert set(spans) == {"queued", "prefill", "decode", "stream",
                          "finish"}
    assert spans["prefill"]["prompt_tokens"] == 6
    assert spans["decode"]["tokens"] == 5
    assert spans["stream"]["tokens"] == 5
    assert spans["finish"]["reason"] == "length"
    assert spans["finish"]["slot"] == spans["decode"]["slot"]
    assert all(s["trace"] == tid for s in spans.values())
    events = c.chrome_trace(trace=tid)["traceEvents"]
    assert {e["name"] for e in events if e.get("ph") == "X"} >= {
        "queued", "prefill", "decode", "finish"}


def test_server_rejects_bad_requests(trio, serve):
    """Refusals travel as the reference's codes: a hard failure as a
    RuntimeError, backpressure as OverloadedError with the queue depth,
    a closed engine as DrainingError, an unknown op as UnknownOpError —
    and the connection survives each."""
    _, _, pm = trio
    eng = _engine(pm, slots=1,
                  scheduler=FIFOScheduler(max_queue_depth=1))
    srv = serve(eng)
    c = serve.client(srv)
    with pytest.raises(RuntimeError, match="max_len"):
        c.generate(list(range(80)), max_new_tokens=20)
    with pytest.raises(UnknownOpError, match="nope") as ei:
        c._call({"op": "nope"})
    assert ei.value.op == "nope" and isinstance(ei.value, RuntimeError)
    # hold the loop so admissions queue up behind a full queue
    held = threading.Event()
    release = threading.Event()

    def hold():
        held.set()
        release.wait(TIMEOUT)

    t = threading.Thread(target=eng.call_in_loop, args=(hold, TIMEOUT))
    t.start()
    try:
        assert held.wait(TIMEOUT)
        first = c.generate([1, 2, 3], max_new_tokens=2)
        with pytest.raises(OverloadedError) as oe:
            c.generate([1, 2, 3], max_new_tokens=2)
        assert oe.value.queue_depth == 1
    finally:
        release.set()
        t.join(TIMEOUT)
    assert c.result(first) == (_want(pm, [1, 2, 3], 2), "length")
    c.drain()
    with pytest.raises(DrainingError, match="draining"):
        c.generate([1, 2, 3], max_new_tokens=2)
    c.undrain()
    assert "active_slots" in c.stats()


def test_client_close_flips_flags_under_streams_lock(trio, serve):
    """close() marks the connection closed under _streams_lock (the
    reader's shutdown sweep's discipline) and stays idempotent."""
    _, _, pm = trio
    srv = serve(_engine(pm, slots=1))
    c = serve.client(srv)
    real = c._streams_lock
    acquired = []

    class ProbeLock:
        def __enter__(self):
            acquired.append(True)
            return real.__enter__()

        def __exit__(self, *exc):
            return real.__exit__(*exc)

    c._streams_lock = ProbeLock()
    try:
        c.close()
    finally:
        c._streams_lock = real
    assert acquired
    assert c.closed and c.close_reason == "closed by client"
    c.close()
    with pytest.raises(ServingConnectionError, match=str(srv.port)):
        c.stats()


def test_client_request_timeout_names_request(trio, serve):
    _, _, pm = trio
    srv = serve(_engine(pm, slots=1))
    c = serve.client(srv, request_timeout=0.05)
    assert c.request_timeout == 0.05
    with pytest.raises(TimeoutError, match="request 12345"):
        c.result(12345)
    with pytest.raises(TimeoutError, match="request 12345"):
        c.result(12345, timeout=0.01)
    c2 = serve.client(srv)
    p = np.arange(1, 6, dtype=np.int32)
    assert c2.result(c2.generate(p, max_new_tokens=3)) == (
        _want(pm, p, 3), "length")


def test_server_stop_ends_streams_and_joins_threads(trio, serve):
    """stop() unblocks accept and recv and joins every thread within its
    timeout; a client still reading sees the DISCONNECTED sentinel."""
    _, _, pm = trio
    srv = serve(_engine(pm))
    c = serve.client(srv)
    c.generate(np.arange(1, 9, dtype=np.int32), max_new_tokens=60)
    t0 = time.monotonic()
    srv.stop(timeout=10.0)
    assert time.monotonic() - t0 < 10.0
    assert not any(t.is_alive() for t in srv._threads)
    deadline = time.monotonic() + 10.0
    while not c.closed and time.monotonic() < deadline:
        time.sleep(0.01)
    assert c.closed


# -- KV migration over the wire, framing ------------------------------------


def test_export_import_over_the_wire(trio, serve):
    """export_kv against one server, import_kv into another, then a
    prefix-hit generate on the importer equals generate()."""
    _, _, pm = trio
    prompt = _prompts(1, 40, seed=7)[0]
    s1 = serve(_engine(pm, role="prefill", prefill_chunk=16))
    s2 = serve(_engine(pm, role="decode", prefill_chunk=16))
    c1, c2 = serve.client(s1), serve.client(s2)
    c1.result(c1.generate(prompt, max_new_tokens=1))
    exp = c1.export_kv(prompt)
    assert exp["tokens"] == (40 - 1) // BS * BS and exp["blocks"]
    imp = c2.import_kv(prompt, exp["blocks"])
    assert imp == {"imported": len(exp["blocks"]),
                   "tokens": exp["tokens"], "mode": "device"}
    toks, _ = c2.result(c2.generate(prompt, max_new_tokens=6))
    assert toks == _want(pm, prompt, 6)
    assert s2.engine.prefix_hit_tokens == imp["tokens"]
    assert c1.stats()["kv_blocks_exported"] == len(exp["blocks"])


def test_server_survives_malformed_frame_fuzz(trio, serve):
    """Garbage frames drop only their own connection."""
    _, _, pm = trio
    srv = serve(_engine(pm), max_frame_bytes=1 << 20)
    rng = np.random.default_rng(8)
    for p in (b"\x00" * 3, struct.pack(">Q", 1 << 50),
              struct.pack(">Q", 512) + b"j" * 100,
              struct.pack(">Q", 32) + bytes(rng.integers(0, 256, 32))):
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        s.sendall(p)
        s.close()
    c = serve.client(srv)
    assert c.stats()["active_slots"] == 0


def test_client_max_frame_bytes_knob(trio, serve):
    """A reply frame over the client's bound surfaces as a dead
    connection naming host:port, never as a hang."""
    _, _, pm = trio
    srv = serve(_engine(pm, role="prefill"))
    prompt = _prompts(1, 40, seed=9)[0]
    big = serve.client(srv)
    big.result(big.generate(prompt, max_new_tokens=1))
    small = serve.client(srv, request_timeout=30, max_frame_bytes=256)
    with pytest.raises((ServingConnectionError, TimeoutError)):
        small.export_kv(prompt)
    assert small.closed


def test_bf16_blocks_migrate_over_the_wire(serve):
    """A bf16 cache's blocks travel as ml_dtypes bf16 arrays and import
    into the decode server as they would in process: its stream equals
    an engine that imported the exported tensors directly."""
    from distkeras_torch.models import get_model

    pm = get_model("transformer_lm", dtype=torch.bfloat16, device="cpu",
                   seed=2, **U.KW)
    prompt = _prompts(1, 24, seed=3)[0]
    s1 = serve(_engine(pm, role="prefill"))
    s2 = serve(_engine(pm, role="decode"))
    c1, c2 = serve.client(s1), serve.client(s2)
    c1.result(c1.generate(prompt, max_new_tokens=1))
    exp = c1.export_kv(prompt)
    assert exp["blocks"][0][0].dtype.name == "bfloat16"
    assert c2.import_kv(prompt, exp["blocks"])["imported"] == 2
    got, _ = c2.result(c2.generate(prompt, max_new_tokens=5))
    direct = _engine(pm)
    direct.import_blocks(prompt, s1.engine.call_in_loop(
        lambda: s1.engine.export_blocks(prompt))["blocks"])
    assert got == U.serve(direct, [prompt], U.greedy((5,)))[0]
    assert s2.engine.prefix_hit_tokens == direct.prefix_hit_tokens == 16


# -- the loop thread ----------------------------------------------------------


def test_call_in_loop_runs_on_the_loop_thread(trio):
    """serve_forever services control calls between ticks on its own
    thread; exceptions propagate; without a loop a call times out
    naming serve_forever."""
    _, _, pm = trio
    eng = _engine(pm)
    with pytest.raises(TimeoutError, match="serve_forever"):
        eng.call_in_loop(lambda: 1, timeout=0.05)
    eng._ctrl.clear()
    stop = threading.Event()
    loop = threading.Thread(target=eng.serve_forever, args=(stop,))
    loop.start()
    try:
        assert eng.call_in_loop(threading.current_thread) is loop
        with pytest.raises(ValueError, match="unknown role"):
            eng.call_in_loop(lambda: eng.set_role("nope"), timeout=TIMEOUT)
        req = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=6)
        assert req.stream.tokens(timeout=TIMEOUT) == _want(
            pm, np.arange(1, 9), 6)
    finally:
        stop.set()
        loop.join(TIMEOUT)
    assert not loop.is_alive()


def test_multi_step_gate_counts_control_fallbacks(trio):
    """A control call staged while a step plans forces a one-token tick
    (reason "control"); it is serviced at the top of the next step and
    the greedy stream still equals generate()."""
    _, _, pm = trio
    eng = _engine(pm, multi_step_k=4)
    prompt = np.arange(1, 9, dtype=np.int32)
    req = eng.submit(prompt, max_new_tokens=12)
    for _ in range(3):
        eng.step()  # prompt chunk, then decoding
    admit, out = eng._admit, {}

    def admit_then_stage():
        n = admit()
        if not out:
            t = threading.Thread(target=lambda: out.setdefault(
                "v", eng.call_in_loop(lambda: "done", timeout=TIMEOUT)))
            t.start()
            out["t"] = t
            deadline = time.monotonic() + TIMEOUT
            while not eng._ctrl and time.monotonic() < deadline:
                time.sleep(0.001)
        return n

    eng._admit = admit_then_stage
    eng.step()
    assert eng.multi_step_fallbacks.get("control") == 1
    eng.drain()
    out["t"].join(TIMEOUT)
    assert out["v"] == "done"
    assert req.stream.tokens(timeout=10) == _want(pm, prompt, 12)
    assert eng.registry.counter(
        "serving_multi_step_fallbacks_total",
        labelnames=("reason",)).labels(reason="control").value == 1


def test_a_tick_that_raises_kills_the_loop_loudly(trio, serve, tmp_path,
                                                  monkeypatch):
    """A crashing tick writes the flight postmortem and ends the loop
    thread with the error (threading.excepthook sees it)."""
    _, _, pm = trio
    eng = _engine(pm, postmortem_dir=str(tmp_path))
    seen = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda a: seen.append(a.exc_value))

    def boom():
        raise RuntimeError("tick exploded")

    monkeypatch.setattr(eng, "_mixed_tick", boom)
    srv = serve(eng)
    c = serve.client(srv, request_timeout=2.0)
    rid = c.generate([1, 2, 3], max_new_tokens=2)
    deadline = time.monotonic() + TIMEOUT
    while not seen and time.monotonic() < deadline:
        time.sleep(0.01)
    assert [str(e) for e in seen] == ["tick exploded"]
    assert glob.glob(str(tmp_path / "distkeras-postmortem-*-crash-*"))
    with pytest.raises(TimeoutError, match=f"request {rid}"):
        c.result(rid, timeout=0.2)


# -- the stall watchdog -------------------------------------------------------


def test_stall_watchdog_fires_postmortem_and_renders(trio, tmp_path,
                                                     capsys):
    """Work pending and no step: the watchdog fires once per episode,
    the dump renders, and progress resets the episode."""
    _, _, pm = trio
    eng = _engine(pm, slots=1, postmortem_dir=str(tmp_path))
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
    eng.step()
    wd = eng.watchdog(timeout_s=5.0)
    assert not wd.check(now=100.0)
    assert not wd.check(now=104.0)
    assert wd.check(now=106.0)
    assert wd.stalled and not wd.check(now=200.0)
    assert eng.registry.counter("slo_stalls_total").value == 1
    dumps = glob.glob(str(tmp_path / "distkeras-postmortem-*-stall-*"))
    assert len(dumps) == 1 and wd.last_dump == dumps[0]
    telemetry_report.main(["--flight", dumps[0]])
    out = capsys.readouterr().out
    assert "reason=stall" in out and "stuck_s=" in out
    assert "slo.stall" in {s["span"] for s in eng.tracer.dump()}
    eng.step()
    assert not wd.check(now=300.0) and not wd.stalled
    assert "slo.stall_recovered" in {s["span"] for s in eng.tracer.dump()}


def test_watchdog_idle_engine_never_fires(trio):
    _, _, pm = trio
    eng = _engine(pm)
    wd = eng.watchdog(timeout_s=0.01)
    assert not wd.check(now=0.0)
    assert not wd.check(now=100.0)
    assert eng.registry.counter("slo_stalls_total").value == 0


def test_watchdog_thread_lifecycle(trio, tmp_path):
    _, _, pm = trio
    eng = _engine(pm, slots=1, postmortem_dir=str(tmp_path))
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
    wd = eng.watchdog(timeout_s=0.05, interval_s=0.01).start()
    assert wd.start() is wd
    deadline = time.monotonic() + 10
    while not wd.stalled and time.monotonic() < deadline:
        time.sleep(0.01)
    wd.stop()
    assert wd.stalled and wd.last_dump


def test_server_watchdog_fires_on_a_held_loop(trio, serve, tmp_path):
    """A control call that holds the loop thread while requests queue is
    a stall: the server's watchdog writes a postmortem that renders, and
    the queued request completes once the loop is released."""
    _, _, pm = trio
    eng = _engine(pm, postmortem_dir=str(tmp_path))
    srv = serve(eng, watchdog_timeout_s=0.1)
    srv._watchdog.interval_s = 0.02
    c = serve.client(srv)
    prompt = np.arange(1, 9, dtype=np.int32)
    holding = threading.Event()

    def hold():  # until the watchdog fires (the request is queued)
        holding.set()
        deadline = time.monotonic() + TIMEOUT
        while (not srv._watchdog.stalled
               and time.monotonic() < deadline):
            time.sleep(0.01)

    t = threading.Thread(target=eng.call_in_loop, args=(hold, TIMEOUT))
    t.start()
    assert holding.wait(TIMEOUT)
    rid = c.generate(prompt, max_new_tokens=4)
    t.join(TIMEOUT)
    assert c.result(rid) == (_want(pm, prompt, 4), "length")
    dumps = glob.glob(str(tmp_path / "distkeras-postmortem-*-stall-*"))
    assert dumps and srv._watchdog.last_dump in dumps
    out = io.StringIO()
    telemetry_report.report_flight(dumps[0], out=out)
    assert "reason=stall" in out.getvalue()


# -- telemetry ops ------------------------------------------------------------


def test_server_flight_and_alerts_ops(trio, serve):
    _, _, pm = trio
    eng = _engine(pm)
    mon = SloMonitor(default_serving_rules(), registry=eng.registry,
                     tracer=eng.tracer, interval_s=0.05)
    srv = serve(eng, slo=mon, watchdog_timeout_s=60.0)
    c = serve.client(srv)
    toks, _ = c.result(c.generate(list(range(1, 6)), max_new_tokens=4))
    assert len(toks) == 4
    fl = c.flight()
    assert fl["meta"]["kind"] == "flight_meta"
    assert len(fl["ticks"]) >= 4
    assert len(c.flight(last=2)["ticks"]) == 2
    assert {a["rule"] for a in c.alerts()} == {
        "itl_p99_ms", "ttft_p99_ms", "queue_depth", "expiry_rate"}


def test_server_flight_disabled_is_an_error(trio, serve):
    _, _, pm = trio
    srv = serve(_engine(pm, flight=None))
    c = serve.client(srv)
    with pytest.raises(RuntimeError, match="flight recorder disabled"):
        c.flight()
    assert c.alerts() == []


def test_server_timeseries_and_events_ops(trio, serve):
    _, _, pm = trio
    srv = serve(_engine(pm))
    c = serve.client(srv)
    _, reason = c.result(c.generate(list(range(1, 6)), max_new_tokens=4))
    assert reason == "length"
    srv.timeseries.sample()
    srv.timeseries.sample()
    ts = c.timeseries()
    assert ts["meta"]["samples"] >= 2
    keys = set().union(*(p["series"] for p in ts["points"]))
    assert any(k.startswith("serving_tokens_total") for k in keys)
    assert c.timeseries(last=1)["points"][0] == ts["points"][-1]
    c.drain()
    c.undrain()
    assert c.reconfigure("decode") == "decode"
    ev = c.events()
    assert [e["action"] for e in ev["events"]] == [
        "drain", "undrain", "reconfigure"]
    assert ev["events"][2]["target"] == "decode"
    assert ev["meta"]["actor"] == "engine"
    assert c.events(last=1)["events"][0]["action"] == "reconfigure"
    c.reconfigure("decode")
    assert len(c.events()["events"]) == 3


def test_server_timeseries_disabled_refuses(trio, serve):
    _, _, pm = trio
    srv = serve(_engine(pm, slots=1), timeseries=False)
    c = serve.client(srv)
    with pytest.raises(RuntimeError, match="disabled"):
        c.timeseries()
    assert c.events()["events"] == []


def test_weight_push_lands_in_engine_journal(trio, serve):
    _, params, pm = trio
    srv = serve(_engine(pm, slots=1), timeseries=False)
    c = serve.client(srv)
    c.push_weights(U.jax.tree.map(np.asarray, params), version=7)
    evs = c.events()["events"]
    assert [e["action"] for e in evs] == ["weight_push"]
    assert evs[0]["version"] == 7 and evs[0]["swap_ms"] >= 0


def test_telemetry_server_scrapes_a_port_engine(trio, serve, capsys):
    """The exposition copy over a serving port engine: /metrics renders
    Prometheus text, /flight the tick ring, and ``report --live`` polls
    the /timeseries and /events panes."""
    import urllib.request

    from distkeras_torch.telemetry import TelemetryServer

    _, _, pm = trio
    eng = _engine(pm)
    srv = serve(eng)
    c = serve.client(srv)
    c.result(c.generate(list(range(1, 6)), max_new_tokens=4))
    srv.timeseries.sample()
    srv.timeseries.sample()
    c.drain()
    ts = TelemetryServer(registry=eng.registry, tracer=eng.tracer,
                         flight=eng.flight, timeseries=srv.timeseries,
                         events=eng.journal).start()
    try:
        url = f"http://127.0.0.1:{ts.port}"
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            assert "serving_tokens_total 4" in r.read().decode()
        with urllib.request.urlopen(url + "/flight", timeout=10) as r:
            assert r.status == 200 and b"flight_meta" in r.read()
        assert telemetry_report.main(["--live", url, "--polls", "1",
                                      "--poll-interval", "0"]) in (0, None)
    finally:
        ts.stop()
    out = capsys.readouterr().out
    assert "drain" in out
