"""The port's multi-replica fabric on the CPU (the reference's
``tests/test_router.py`` over port replicas): prefix-affinity routing,
load-aware spill, kill-one-replica failover with zero lost streams,
graceful drain, typed overload signalling, fleet stats/metrics
aggregation, a plain ``ServingClient`` against the router, and the
routing-policy units (consistent-hash stability, affinity-index
eviction, metric-snapshot merging).

Every replica is a port ``LMServer`` over its own f32 model made from
one seed (``torch_fleet_util``); the router is the port's copy of the
reference's. Tolerances: token streams are compared exactly with the
port's ``generate()``; counters and merged metrics by their values."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
import torch_fleet_util as FU  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401
from torch_fleet_util import BS, fleet  # noqa: E402,F401
from torch_lockorder_util import lock_order  # noqa: E402,F401

from distkeras_torch import telemetry  # noqa: E402
from distkeras_torch.serving import (  # noqa: E402
    DISCONNECTED,
    DrainingError,
    FIFOScheduler,
    OverloadedError,
    Router,
    ServingConnectionError,
    UnknownOpError,
    merge_metric_snapshots,
)
from distkeras_torch.serving.fleet import Replica  # noqa: E402
from distkeras_torch.serving.router import (  # noqa: E402
    PrefixAffinityIndex,
    _HashRing,
)

V = U.V


@pytest.fixture(scope="module")
def ref_model():
    """The weights every replica carries, for the reference streams."""
    return FU.model(0)


def _fleet(fleet, n=3, paged=False, slots=2, **router_kw):
    servers = fleet.replicas(n, paged=paged, slots=slots)
    router = fleet.router(servers, **FU.router_kw(**router_kw))
    return servers, router


def _rand(rng, n):
    return rng.integers(0, V, size=n).astype(np.int32)


# -- wire compatibility + routing ---------------------------------------------


def test_router_wire_compat_and_parity(ref_model, fleet):
    """A plain ServingClient pointed at the router works unchanged:
    generate acks with rid+trace, tokens stream equal to generate(),
    stats/metrics/alerts/trace_dump answer, an unknown op errors without
    dropping the connection."""
    servers, router = _fleet(fleet, n=3)
    client = fleet.client(router.port)
    rng = np.random.default_rng(0)
    prompts = [_rand(rng, 6) for _ in range(5)]
    rids = [client.generate(p, max_new_tokens=5) for p in prompts]
    assert len(set(rids)) == 5
    for p, rid in zip(prompts, rids):
        toks, reason = client.result(rid, timeout=60)
        assert toks == FU.solo(ref_model, p, 5)
        assert reason == "length"
        assert client.trace_of(rid) is not None
    router.manager.probe_all()
    st = client.stats()
    assert st["requests_completed"] == 5
    assert st["tokens_generated"] == 25
    assert st["replicas_routable"] == 3
    assert st["router"]["routed"] == 5
    assert st["router"]["failed"] == 0
    merged = client.metrics()
    assert "serving_tokens_total" in merged
    assert "router_requests_routed_total" in merged
    assert client.alerts() == []
    spans = {s["span"]
             for s in client.trace_dump(trace=client.trace_of(rids[0]))}
    assert {"router.route", "router.stream"} <= spans
    with pytest.raises(UnknownOpError, match="nope") as ei:
        client._call({"op": "nope"})
    assert ei.value.op == "nope"
    assert client.stats()["router"]["routed"] == 5


def test_affinity_same_prefix_same_replica(ref_model, fleet):
    """Requests sharing a prompt prefix all land on the replica that
    served the first one, the routed counter records the affine
    decisions, and the winner prefix-hits in its KV cache."""
    servers, router = _fleet(fleet, n=3, paged=True)
    client = fleet.client(router.port)
    rng = np.random.default_rng(1)
    system = _rand(rng, 2 * BS)
    n = 6
    for _ in range(n):
        p = np.concatenate([system, _rand(rng, 4)])
        toks, _ = client.result(client.generate(p, max_new_tokens=4),
                                timeout=60)
        assert toks == FU.solo(ref_model, p, 4)
    router.manager.probe_all()
    st = client.stats()
    served = {name: rep.get("stats", {}).get("requests_completed", 0)
              for name, rep in st["replicas"].items()}
    assert sorted(served.values()) == [0, 0, n], served
    fam = router.registry.get("router_requests_routed_total")
    by_decision = {}
    for s in fam.snapshot()["series"]:
        d = s["labels"]["decision"]
        by_decision[d] = by_decision.get(d, 0) + s["value"]
    assert by_decision.get("affine", 0) == n - 1
    winner = max(served, key=served.get)
    assert st["replicas"][winner]["stats"]["prefix_hit_fraction"] > 0.5


def test_spill_under_induced_saturation(ref_model, fleet):
    """When the affine replica's polled stats report queue saturation, a
    same-prefix request goes to the least-loaded peer."""
    servers, router = _fleet(fleet, n=2, slots=1, spill_queue_depth=2)
    client = fleet.client(router.port)
    rng = np.random.default_rng(2)
    system = _rand(rng, 2 * BS)
    p0 = np.concatenate([system, _rand(rng, 2)])
    client.result(client.generate(p0, max_new_tokens=4), timeout=60)
    router.manager.probe_all()
    st = client.stats()
    owner = max(st["replicas"], key=lambda r: st["replicas"][r].get(
        "stats", {}).get("requests_completed", 0))
    direct = fleet.client(servers[int(owner[1:])].port)
    busy = [direct.generate(_rand(rng, 6), max_new_tokens=24)
            for _ in range(4)]
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        router.manager.probe_all()
        if router.manager.get(owner).last_stats.get("queue_depth", 0) >= 2:
            break
    p1 = np.concatenate([system, _rand(rng, 2)])
    toks, reason = client.result(client.generate(p1, max_new_tokens=4),
                                 timeout=60)
    assert toks == FU.solo(ref_model, p1, 4)
    assert reason == "length"
    assert router.registry.counter(
        "router_requests_spilled_total").value >= 1
    router.manager.probe_all()
    st = client.stats()
    other = next(n for n in st["replicas"] if n != owner)
    assert st["replicas"][other]["stats"]["requests_completed"] >= 1
    for b in busy:
        direct.result(b, timeout=120)


def _wait_inflight(router, at_least, timeout=10):
    deadline = time.monotonic() + timeout
    by = {}
    while time.monotonic() < deadline:
        by = router.stats()["router"]["inflight_by_replica"]
        if by and max(by.values()) >= at_least:
            break
        time.sleep(0.01)
    return by


def test_failover_zero_lost_streams(ref_model, fleet):
    """Kill the busiest replica mid-stream: every accepted stream still
    completes equal to generate() (replay-with-skip on survivors
    re-derives the seeded stream), and nothing is reported failed."""
    servers, router = _fleet(fleet, n=3)
    client = fleet.client(router.port, request_timeout=120)
    rng = np.random.default_rng(3)
    prompts = [_rand(rng, 6) for _ in range(6)]
    rids = [client.generate(p, max_new_tokens=40) for p in prompts]
    by = _wait_inflight(router, 2)
    victim = max(by, key=by.get)
    servers[int(victim[1:])].stop()  # closes live conns = crash
    for p, rid in zip(prompts, rids):
        toks, reason = client.result(rid, timeout=120)
        assert toks == FU.solo(ref_model, p, 40)
        assert reason == "length"
    st = client.stats()
    assert st["router"]["failed"] == 0
    assert st["router"]["failed_over"] >= 1
    assert st["router"]["failovers"] >= 1
    assert st["replicas"][victim]["state"] == "down"


def test_failover_requeues_unstarted_requests(ref_model, fleet):
    """A queued-but-unstarted request on the dead replica is requeued,
    not replayed (the failed-over counter's kind label), and completes
    equal to generate()."""
    servers, router = _fleet(fleet, n=2, slots=1, spill_queue_depth=1000)
    client = fleet.client(router.port, request_timeout=120)
    rng = np.random.default_rng(4)
    system = _rand(rng, 2 * BS)
    prompts = [np.concatenate([system, _rand(rng, 2)]) for _ in range(3)]
    rids = [client.generate(p, max_new_tokens=30) for p in prompts]
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        by = router.stats()["router"]["inflight_by_replica"]
        if by.get(max(by, key=by.get), 0) == 3:
            break
        time.sleep(0.01)
    victim = max(by, key=by.get)
    frames0 = client.frames(rids[0], timeout=120)
    toks0 = []
    for kind, val in frames0:
        if kind == "tok":
            toks0.append(val)
        if len(toks0) >= 2:
            break
    servers[int(victim[1:])].stop()
    reason0 = None
    for kind, val in frames0:
        if kind == "tok":
            toks0.append(val)
        else:
            reason0 = val
    assert toks0 == FU.solo(ref_model, prompts[0], 30)
    assert reason0 == "length"
    for p, rid in zip(prompts[1:], rids[1:]):
        toks, reason = client.result(rid, timeout=120)
        assert toks == FU.solo(ref_model, p, 30)
        assert reason == "length"
    fam = router.registry.get("router_requests_failed_over_total")
    kinds = {s["labels"]["kind"]: s["value"]
             for s in fam.snapshot()["series"]}
    assert kinds.get("requeued", 0) >= 1, kinds
    assert client.stats()["router"]["failed"] == 0


# -- drain ---------------------------------------------------------------------


def test_lmserver_drain_semantics(ref_model, fleet):
    """The drain op closes admissions (typed DrainingError), in-flight
    streams finish, and stats report draining -> drained."""
    servers = fleet.replicas(1)
    client = fleet.client(servers[0].port)
    p = np.arange(1, 7, dtype=np.int32)
    rid = client.generate(p, max_new_tokens=20)
    reply = client.drain()
    assert set(reply) == {"active", "queued"}
    with pytest.raises(DrainingError, match="draining"):
        client.generate(p, max_new_tokens=4)
    toks, reason = client.result(rid, timeout=60)
    assert toks == FU.solo(ref_model, p, 20)
    assert reason == "length"
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        st = client.stats()
        if st["drained"]:
            break
        time.sleep(0.02)
    assert st["draining"] and st["drained"]
    assert servers[0].engine.draining and servers[0].engine.drained


def test_router_drain_and_replica_drain(ref_model, fleet):
    """Draining one replica through the router routes all new traffic to
    the survivor; draining the router refuses new submits with the typed
    error while the in-flight one finishes."""
    servers, router = _fleet(fleet, n=2)
    client = fleet.client(router.port)
    rng = np.random.default_rng(5)
    assert client.drain(replica="r0") == {"active": 0, "queued": 0}
    for _ in range(4):
        p = _rand(rng, 6)
        toks, _ = client.result(client.generate(p, max_new_tokens=4),
                                timeout=60)
        assert toks == FU.solo(ref_model, p, 4)
    router.manager.probe_all()
    st = client.stats()
    assert st["replicas"]["r0"]["state"] == "draining"
    assert st["replicas"]["r0"].get("stats", {}).get(
        "requests_completed", 0) == 0
    assert st["replicas"]["r1"]["stats"]["requests_completed"] == 4
    p = _rand(rng, 6)
    rid = client.generate(p, max_new_tokens=20)
    assert client._call({"op": "drain"})["draining"] == 1
    with pytest.raises(DrainingError):
        client.generate(p, max_new_tokens=4)
    toks, reason = client.result(rid, timeout=60)
    assert toks == FU.solo(ref_model, p, 20)
    assert reason == "length"
    st = client.stats()
    assert st["router"]["draining"] and st["router"]["drained"]


def test_drain_forgets_affinity_placements(ref_model, fleet):
    """A drained replica's affinity placements are forgotten, whether
    the drain is issued through the router or the probe loop finds an
    engine that began draining on its own."""
    servers, router = _fleet(fleet, n=2, paged=True)
    client = fleet.client(router.port)
    rng = np.random.default_rng(17)
    prompt = _rand(rng, 4 * BS)
    client.result(client.generate(prompt, max_new_tokens=2), timeout=60)
    with router._route_lock:
        owner, hit = router.index.lookup(prompt)
    assert owner in ("r0", "r1") and hit > 0
    client.drain(replica=owner)
    with router._route_lock:
        assert router.index.lookup(prompt)[0] is None
    toks, _ = client.result(client.generate(prompt, max_new_tokens=2),
                            timeout=60)
    assert toks == FU.solo(ref_model, prompt, 2)
    survivor = "r1" if owner == "r0" else "r0"
    with router._route_lock:
        assert router.index.lookup(prompt)[0] == survivor
    servers[int(survivor[1:])].engine.begin_drain()
    router.manager.probe_all()
    assert router.manager.get(survivor).state == "draining"
    with router._route_lock:
        assert router.index.lookup(prompt)[0] is None


# -- typed overload + connection robustness -------------------------------------


def test_overloaded_typed_error_end_to_end(ref_model, fleet):
    """QueueFullError at the server surfaces as a typed OverloadedError
    carrying queue_depth; the accepted requests still complete."""
    sched = FIFOScheduler(max_queue_depth=1, tick_token_budget=64,
                          registry=telemetry.MetricRegistry(),
                          tracer=telemetry.Tracer())
    srv = fleet.server(FU.engine(FU.model(0), slots=1, scheduler=sched))
    client = fleet.client(srv.port, request_timeout=120)
    p = np.arange(1, 7, dtype=np.int32)
    rids, err = [], None
    try:
        for _ in range(10):
            rids.append(client.generate(p, max_new_tokens=24))
    except OverloadedError as e:
        err = e
    assert err is not None
    assert err.queue_depth == 1
    assert isinstance(err, RuntimeError)
    for rid in rids:
        toks, _ = client.result(rid, timeout=120)
        assert toks == FU.solo(ref_model, p, 24)


def test_client_connection_robustness(ref_model, fleet):
    """Typed connection errors name host:port; a socket dying mid-stream
    delivers the terminal DISCONNECTED frame; close() is idempotent;
    calls on a dead connection fail fast with the typed error."""
    with pytest.raises(ServingConnectionError, match="127.0.0.1:1"):
        FU.client(1)
    server = fleet.replicas(1)[0]
    client = FU.client(server.port, timeout=30)
    p = np.arange(1, 7, dtype=np.int32)
    rid = client.generate(p, max_new_tokens=40)
    got, reason = [], None
    for kind, val in client.frames(rid, timeout=30):
        if kind == "end":
            reason = val
            break
        got.append(val)
        if len(got) == 2:
            server.stop()
    assert reason == DISCONNECTED
    assert len(got) < 40
    assert got == FU.solo(ref_model, p, 40)[:len(got)]
    assert client.result(999, timeout=5) == ([], DISCONNECTED)
    with pytest.raises(ServingConnectionError,
                       match=f"127.0.0.1:{server.port}"):
        client.stats()
    client.close()
    client.close()


# -- aggregation -----------------------------------------------------------------


def test_aggregated_stats_and_metrics_vs_per_replica_sums(fleet):
    """Fleet stats are the per-replica sums, and the merged metrics'
    token counter equals the sum of each replica's own."""
    servers, router = _fleet(fleet, n=3)
    client = fleet.client(router.port)
    directs = [fleet.client(s.port) for s in servers]
    rng = np.random.default_rng(6)
    for _ in range(7):
        client.result(client.generate(_rand(rng, 6), max_new_tokens=5),
                      timeout=60)
    router.manager.probe_all()
    agg = client.stats()
    per = [d.stats() for d in directs]
    for key in ("requests_completed", "tokens_generated", "ticks"):
        assert agg[key] == sum(s[key] for s in per), key
    assert agg["requests_completed"] == 7

    def tokens_total(metrics):
        series = metrics["serving_tokens_total"]["series"]
        return series[0]["value"] if series else 0

    want = sum(tokens_total(d.metrics()) for d in directs)
    assert tokens_total(client.metrics()) == want == 35


def test_merge_metric_snapshots_unit():
    """Counters/gauges sum by label key, histograms merge bucket by
    bucket, series unions are kept, and type-skewed families keep the
    first replica's view."""
    a = telemetry.MetricRegistry()
    b = telemetry.MetricRegistry()
    a.counter("c", labelnames=("x",)).labels(x="1").inc(3)
    b.counter("c", labelnames=("x",)).labels(x="1").inc(4)
    b.counter("c", labelnames=("x",)).labels(x="2").inc(5)
    a.gauge("g").set(2)
    b.gauge("g").set(8)
    a.histogram("h", buckets=(1.0, 10.0)).observe(0.5)
    b.histogram("h", buckets=(1.0, 10.0)).observe(5.0)
    b.histogram("h", buckets=(1.0, 10.0)).observe(100.0)
    b.gauge("c_skew").set(1)
    a.counter("c_skew").inc()
    m = merge_metric_snapshots([a.collect(), b.collect()])
    series = {tuple(sorted(s["labels"].items())): s["value"]
              for s in m["c"]["series"]}
    assert series[(("x", "1"),)] == 7
    assert series[(("x", "2"),)] == 5
    assert m["g"]["series"][0]["value"] == 10
    h = m["h"]["series"][0]
    assert h["count"] == 3
    assert h["sum"] == pytest.approx(105.5)
    assert h["buckets"]["1.0"] == 1
    assert h["buckets"]["10.0"] == 1
    assert h["buckets"]["+Inf"] == 1
    assert m["c_skew"]["type"] == "counter"


# -- policy units ------------------------------------------------------------------


def test_hash_ring_stability():
    """Removing a replica from the alive set only remaps the keys that
    pointed at it."""
    names = [f"r{i}" for i in range(4)]
    ring = _HashRing(names)
    keys = [f"key-{i}".encode() for i in range(200)]
    full = {k: ring.lookup(k, set(names)) for k in keys}
    assert len(set(full.values())) == 4
    alive = set(names) - {"r2"}
    for k in keys:
        now = ring.lookup(k, alive)
        if full[k] != "r2":
            assert now == full[k]
        else:
            assert now in alive


def test_prefix_affinity_index_unit():
    """Lookup follows the deepest owned chunk, first placement wins under
    overlap, forget() retires one owner's chunks, the node cap evicts
    LRU."""
    idx = PrefixAffinityIndex(block_size=4, max_nodes=8)
    t1 = list(range(12))
    idx.place(t1, "rA")
    owner, hit = idx.lookup(t1 + [99])
    assert owner == "rA" and hit == 12
    t2 = t1[:8] + [7, 7, 7, 7]
    idx.place(t2, "rB")
    assert idx.lookup(t1 + [99])[0] == "rA"
    owner2, hit2 = idx.lookup(t2 + [99])
    assert owner2 == "rB" and hit2 == 12
    assert idx.lookup([1, 2])[0] is None
    idx.forget("rB")
    assert idx.lookup(t2 + [99])[0] == "rA"
    assert idx.lookup(t1 + [99])[0] == "rA"
    for i in range(20):
        idx.place([100 + i] * 4, "rC")
    assert len(idx) <= 8


def test_replica_recovery_after_restart(ref_model, fleet):
    """A downed replica is re-probed under backoff and returns to
    rotation once a server listens on its address again."""
    servers, router = _fleet(fleet, n=2)
    client = fleet.client(router.port)
    port0 = servers[0].port
    servers[0].stop()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if router.manager.get("r0").state == "down":
            break
        time.sleep(0.02)
    assert router.manager.get("r0").state == "down"
    p = np.arange(1, 7, dtype=np.int32)
    assert client.result(client.generate(p, max_new_tokens=4),
                         timeout=60)[0] == FU.solo(ref_model, p, 4)
    fleet.server(FU.engine(FU.model(0)), port=port0)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if router.manager.get("r0").state == "healthy":
            break
        time.sleep(0.02)
    assert router.manager.get("r0").state == "healthy"
    assert len(router.manager.routable()) == 2


def test_router_rejects_unknown_policy_and_bad_replica(fleet):
    with pytest.raises(ValueError, match="policy"):
        Router([("127.0.0.1", 1)], policy="lru")
    servers, router = _fleet(fleet, n=2)
    client = fleet.client(router.port)
    with pytest.raises(RuntimeError, match="no replica named"):
        client._call({"op": "drain", "replica": "nope"})
    with pytest.raises(RuntimeError, match="per replica"):
        client.flight()


def test_replica_snapshot_reads_state_under_lock():
    """snapshot() reads state and last_stats under the replica lock."""
    r = Replica("127.0.0.1", 1, name="r0")
    r.state = "healthy"
    r.last_stats = {"queue_depth": 3}
    real = r._lock
    acquired = []

    class ProbeLock:
        def __enter__(self):
            acquired.append(True)
            return real.__enter__()

        def __exit__(self, *exc):
            return real.__exit__(*exc)

    r._lock = ProbeLock()
    try:
        snap = r.snapshot()
    finally:
        r._lock = real
    assert acquired
    assert snap["state"] == "healthy"
    assert snap["stats"] == {"queue_depth": 3}


def _hold_loop(engine):
    """Hold ``engine``'s loop at the top of its next step (no token is
    emitted meanwhile); returns the Event that releases it."""
    held, release = threading.Event(), threading.Event()

    def hold():
        held.set()
        release.wait(30)

    threading.Thread(target=engine.call_in_loop, args=(hold, 60.0),
                     daemon=True).start()
    assert held.wait(30)
    return release


def _stop_while_held(server, release=None):
    """Stop ``server`` while its loop is held: the connections close at
    once, then the caller releases the loop so ``stop()`` can join it."""
    release = release or _hold_loop(server.engine)
    t = threading.Thread(target=server.stop, daemon=True)
    t.start()
    return release, t


def test_stopped_replica_disconnects_every_proxied_stream(ref_model, fleet):
    """A stopping port LMServer does not wait for its pump threads, yet
    every stream a client (the router's replica connection) holds on it
    ends with DISCONNECTED at once; through the router, every stream in
    flight on the stopped replica fails over (replayed or requeued) and
    completes equal to generate()."""
    server = fleet.replicas(1, slots=4)[0]
    direct = FU.client(server.port, timeout=30)
    prompts = [np.arange(1, 7, dtype=np.int32) + i for i in range(3)]
    rids = [direct.generate(p, max_new_tokens=60) for p in prompts]
    frames = [direct.frames(r, timeout=30) for r in rids]
    assert all(next(f)[0] == "tok" for f in frames)
    release, stopper = _stop_while_held(server)
    ends = []
    for f in frames:
        ends.append(next(val for kind, val in f if kind == "end"))
    release.set()
    stopper.join(30)
    assert ends == [DISCONNECTED] * 3
    direct.close()

    servers, router = _fleet(fleet, n=2)
    client = fleet.client(router.port, request_timeout=120)
    rng = np.random.default_rng(21)
    prompts = [_rand(rng, 6) for _ in range(4)]
    rids = [client.generate(p, max_new_tokens=60) for p in prompts]
    by = _wait_inflight(router, 2)
    victim = max(by, key=by.get)
    held = servers[int(victim[1:])]
    release = _hold_loop(held.engine)
    time.sleep(0.2)  # frames already sent reach the router
    on_victim = router.stats()["router"]["inflight_by_replica"][victim]
    release, stopper = _stop_while_held(held, release)
    for p, rid in zip(prompts, rids):
        assert client.result(rid, timeout=120) == (
            FU.solo(ref_model, p, 60), "length")
    release.set()
    stopper.join(30)
    fam = router.registry.get("router_requests_failed_over_total")
    moved = sum(s["value"] for s in fam.snapshot()["series"])
    assert moved == on_victim >= 2
    assert client.stats()["router"]["failed"] == 0
