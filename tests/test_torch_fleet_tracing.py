"""Fleet-wide tracing through the port's router on the CPU (the router
tests of the reference's ``tests/test_tracing.py`` over port replicas):
one trace id from client submit through ``router.route`` to the replica's
engine spans across tracer processes, the router's merged ``trace_dump``,
critical-path phase sums against the client's own stopwatch, the
``chrome_trace`` export, the archive outliving every live ring, the
original id kept through a failover replay, and distinct ids under
concurrent clients.

Each replica has its own tracer process identity (``pid``), as
in-process replicas stand in for replica processes. Tolerances: the
critical-path sum within 5% of the client's latency, floored at 15 ms
(the reference's bound); token counts exactly."""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
import torch_fleet_util as FU  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401
from torch_fleet_util import fleet  # noqa: E402,F401
from torch_lockorder_util import lock_order  # noqa: E402,F401

from distkeras_torch import telemetry  # noqa: E402
from distkeras_torch.telemetry.trace import Tracer, critical_path  # noqa: E402

V = U.V
FLEET_CHAIN = {"router.route", "router.stream", "queued", "prefill",
               "decode", "finish", "stream"}


def _fleet(fleet, n=2, slots=2, **router_kw):
    servers = [fleet.server(FU.engine(FU.model(0), slots=slots,
                                      pid=1000 + i)) for i in range(n)]
    router = fleet.router(servers, **FU.router_kw(
        tracer=Tracer(pid=1), **router_kw))
    return servers, router


def _assert_chrome_valid(doc, expect_flow=False):
    json.loads(json.dumps(doc))
    events = doc["traceEvents"]
    assert events, "no events exported"
    for e in events:
        for k in ("ph", "ts", "pid", "tid"):
            assert k in e, (k, e)
        if e["ph"] == "X":
            assert "dur" in e and e["dur"] >= 0
    starts = {e["id"] for e in events if e["ph"] == "s"}
    finishes = {e["id"] for e in events if e["ph"] == "f"}
    assert starts == finishes, (starts, finishes)
    if expect_flow:
        assert starts, "expected flow events for a cross-process chain"
    names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert any(n.startswith("process") for n in names)
    return events


def test_router_one_trace_across_fleet(fleet):
    """ONE trace id spans client submit -> router.route -> replica
    queued/prefill/decode/stream -> finish across >= 2 tracer processes;
    the critical-path phase sums land within 5% of the client-observed
    latency; chrome_trace exports a valid document; the archive answers
    after every live ring is cleared."""
    servers, router = _fleet(fleet, n=2)
    client = fleet.client(router.port, request_timeout=120)
    rng = np.random.default_rng(0)
    for _ in range(2):
        for sz in (6, 7):
            client.result(client.generate(
                rng.integers(0, V, size=sz).astype(np.int32),
                max_new_tokens=2), timeout=120)
    prompt = rng.integers(0, V, size=6).astype(np.int32)
    t0 = time.monotonic()
    rid = client.generate(prompt, max_new_tokens=24)
    toks, reason = client.result(rid, timeout=120)
    client_ms = (time.monotonic() - t0) * 1e3
    assert len(toks) == 24 and reason == "length"
    tid = client.trace_of(rid)
    assert tid is not None
    chain = client.trace_dump(trace=tid)
    assert {s["trace"] for s in chain} == {tid}
    assert FLEET_CHAIN <= {s["span"] for s in chain}
    assert len({s["pid"] for s in chain}) >= 2
    cp = critical_path(chain)
    assert set(cp["phases"]) == set(telemetry.CRITICAL_PATH_PHASES)
    total = sum(cp["phases"].values())
    assert abs(total - client_ms) <= max(0.05 * client_ms, 15.0), (
        total, client_ms, cp)
    events = _assert_chrome_valid(client.chrome_trace(trace=tid),
                                  expect_flow=True)
    assert {e["id"] for e in events if e["ph"] == "s"} == {tid}
    st = client.stats()["router"]
    assert st["trace_archive"]["archived"] >= 1
    assert st["trace_archive"]["errors"] == 0
    router.tracer.clear()
    for s in servers:
        s.engine.tracer.clear()
    assert FLEET_CHAIN <= {s["span"] for s in client.trace_dump(trace=tid)}
    assert st["critical_path_ms"]["router"]["p50"] is not None


@pytest.mark.slow  # as its twin, tests/test_tracing.py
def test_failover_replay_keeps_trace_id(fleet):
    """Kill the replica serving streams mid-flight: the replayed stream
    completes under the ORIGINAL trace id, and the merged chain gains
    the router.failover link span and the survivor's engine spans."""
    servers, router = _fleet(fleet, n=2)
    client = fleet.client(router.port, request_timeout=120)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, V, size=6).astype(np.int32)
               for _ in range(4)]
    rids = [client.generate(p, max_new_tokens=40) for p in prompts]
    tids = {rid: client.trace_of(rid) for rid in rids}
    deadline = time.monotonic() + 10
    by = {}
    while time.monotonic() < deadline:
        by = router.stats()["router"]["inflight_by_replica"]
        if by and max(by.values()) >= 2:
            break
        time.sleep(0.01)
    victim = max(by, key=by.get)
    servers[int(victim[1:])].stop()
    for rid in rids:
        toks, reason = client.result(rid, timeout=120)
        assert len(toks) == 40 and reason == "length"
    st = client.stats()["router"]
    assert st["failed"] == 0 and st["failed_over"] >= 1
    failed_over = [s for tid in tids.values()
                   for s in client.trace_dump(trace=tid)
                   if s["span"] == "router.failover"]
    assert failed_over, "no failover link span on any trace"
    replayed_tid = failed_over[0]["trace"]
    assert replayed_tid in tids.values()
    chain = client.trace_dump(trace=replayed_tid)
    assert {s["trace"] for s in chain} == {replayed_tid}
    names = [s["span"] for s in chain]
    assert "router.failover" in names
    assert {"queued", "prefill", "decode", "finish",
            "router.stream"} <= set(names)
    rstream = [s for s in chain if s["span"] == "router.stream"]
    assert rstream and rstream[0]["replays"] >= 1


def test_router_trace_concurrent_clients_distinct_ids(fleet):
    """Concurrent submits through one router: every request gets its
    own id, every merged chain is complete, and no span leaks across
    chains."""
    servers, router = _fleet(fleet, n=2)
    client = fleet.client(router.port, request_timeout=120)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, V, size=6).astype(np.int32)
               for _ in range(8)]
    results = {}
    lock = threading.Lock()

    def worker(i):
        rid = client.generate(prompts[i], max_new_tokens=6)
        toks, reason = client.result(rid, timeout=120)
        with lock:
            results[i] = (client.trace_of(rid), toks, reason)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert len(results) == len(prompts)
    tids = [tid for tid, _, _ in results.values()]
    assert len(set(tids)) == len(tids)
    for tid, toks, reason in results.values():
        assert reason == "length" and len(toks) == 6
        chain = client.trace_dump(trace=tid)
        assert {s["trace"] for s in chain} == {tid}
        assert FLEET_CHAIN <= {s["span"] for s in chain}
