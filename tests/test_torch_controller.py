"""The port's elastic fleet controller and QoS classes on the CPU (the
reference's ``tests/test_controller.py`` over port replicas): the
DecisionEngine's no-flap law under injected signal timelines, the
Autoscaler's replay determinism and live actuation against a fleet of
port ``LMServer`` replicas (scale-up from a warm spare, drain-and-retire
scale-down, role rebalancing with zero lost streams), the QoS scheduler's
strict priority and batch-first preemption, and the fleet satellites
(gauge merge policy, probe phase jitter, backoff reset).

Tolerances: token streams are compared exactly with the port's
``generate()``; decisions and counters by their values."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
import torch_fleet_util as FU  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401
from torch_fleet_util import BS, fleet  # noqa: E402,F401

from distkeras_torch import telemetry  # noqa: E402
from distkeras_torch.serving import (  # noqa: E402
    Autoscaler,
    DecisionEngine,
    FIFOScheduler,
    Request,
    merge_metric_snapshots,
)
from distkeras_torch.serving.fleet import (  # noqa: E402
    HEALTHY,
    Replica,
    ReplicaManager,
)
from distkeras_torch.serving.scheduler import QOS_TIERS  # noqa: E402

V = U.V


@pytest.fixture(scope="module")
def ref_model():
    return FU.model(0)


def _servers(fleet, n, slots=2):
    return fleet.replicas(n, slots=slots, paged=True)


def _router_over(fleet, servers, names=None, **kw):
    return fleet.router(servers, names=names, **FU.router_kw(**kw))


# -- DecisionEngine: the pure control law ----------------------------------------


def _sig(n=1, q=0.0, ttft=False, itl=False, recl=None, roles=None):
    return {"replicas": n, "queue_depth": q, "ttft_burn": ttft,
            "itl_burn": itl, "blocks_reclaimable": recl,
            "roles": roles or {"mixed": n}}


def test_scale_up_needs_streak_then_cooldown_gates_the_next():
    law = DecisionEngine(max_replicas=4, queue_high=2.0, queue_low=0.5,
                         up_consecutive=3, cooldown_s=5.0)
    n = 1
    acts = []
    for t in range(30):
        a = law.decide(_sig(n=n, q=10 * n), float(t))
        if a:
            acts.append((t, a["action"]))
            n += 1
    assert acts[0] == (2, "scale_up")
    assert [a for _, a in acts] == ["scale_up"] * 3
    assert all(t2 - t1 >= 5 for (t1, _), (t2, _) in zip(acts, acts[1:]))


def test_hysteresis_band_and_alternation_never_act():
    law = DecisionEngine(max_replicas=4, queue_high=4.0, queue_low=0.5,
                         up_consecutive=2, down_consecutive=2,
                         cooldown_s=0.0)
    for t in range(50):
        assert law.decide(_sig(n=2, q=2 * 2.0), float(t)) is None
    for t in range(50):
        q = 100.0 if t % 2 == 0 else 0.0
        assert law.decide(_sig(n=2, q=q), float(t + 100)) is None


def test_scale_down_floors_at_min_replicas():
    law = DecisionEngine(min_replicas=1, max_replicas=4,
                         down_consecutive=2, cooldown_s=0.0)
    n = 3
    acts = []
    for t in range(20):
        a = law.decide(_sig(n=n, q=0.0), float(t))
        if a:
            acts.append(a["action"])
            n -= 1
    assert acts == ["scale_down", "scale_down"]
    assert n == 1
    for t in range(20, 40):
        assert law.decide(_sig(n=1, q=0.0), float(t)) is None


def test_rebalance_decisions_and_guards():
    law = DecisionEngine(max_replicas=3, up_consecutive=2, cooldown_s=0.0)
    roles = {"mixed": 3, "prefill": 0, "decode": 0}
    assert law.decide(_sig(n=3, ttft=True, roles=roles), 0.0) is None
    a = law.decide(_sig(n=3, ttft=True, roles=roles), 1.0)
    assert a == {"action": "rebalance", "role": "prefill",
                 "reason": "ttft_burn"}
    law = DecisionEngine(max_replicas=3, up_consecutive=1, cooldown_s=0.0)
    a = law.decide(_sig(n=3, itl=True, roles=roles), 0.0)
    assert a == {"action": "rebalance", "role": "decode",
                 "reason": "itl_burn"}
    law = DecisionEngine(max_replicas=3, up_consecutive=1, cooldown_s=0.0)
    have = {"mixed": 2, "prefill": 1, "decode": 0}
    assert law.decide(_sig(n=3, ttft=True, roles=have), 0.0) is None
    law = DecisionEngine(max_replicas=3, up_consecutive=1, cooldown_s=0.0)
    thin = {"mixed": 1, "prefill": 1, "decode": 1}
    assert law.decide(_sig(n=3, ttft=True, roles=thin), 0.0) is None
    law = DecisionEngine(max_replicas=4, up_consecutive=1, cooldown_s=0.0)
    a = law.decide(_sig(n=3, ttft=True, roles=roles), 0.0)
    assert a["action"] == "scale_up" and a["reason"] == "slo_burn"


def test_law_is_deterministic_over_a_seeded_timeline():
    rng = np.random.default_rng(3)
    timeline = [(float(t), _sig(n=int(rng.integers(1, 5)),
                                q=float(rng.uniform(0, 20)),
                                ttft=bool(rng.random() < 0.1)))
                for t in range(200)]
    runs = []
    for _ in range(2):
        law = DecisionEngine(max_replicas=4, cooldown_s=3.0)
        runs.append([(t, law.decide(s, t)) for t, s in timeline])
    assert runs[0] == runs[1]
    assert any(a for _, a in runs[0])


def test_law_validation():
    with pytest.raises(ValueError):
        DecisionEngine(queue_low=4.0, queue_high=4.0)
    with pytest.raises(ValueError):
        DecisionEngine(min_replicas=0)
    with pytest.raises(ValueError):
        DecisionEngine(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        DecisionEngine(up_consecutive=0)


# -- QoS scheduler: strict priority + batch-first preemption -------------------------


def _req(n_prompt=8, tier="interactive", **kw):
    return Request(prompt=np.zeros(n_prompt, np.int32), max_new_tokens=4,
                   tier=tier, **kw)


def _sched(**kw):
    return FIFOScheduler(registry=telemetry.MetricRegistry(),
                         tracer=telemetry.Tracer(), **kw)


def test_qos_admission_strict_priority_then_fifo():
    s = _sched()
    b1, i1, b2, i2 = (_req(tier="batch"), _req(), _req(tier="batch"),
                      _req())
    for r in (b1, i1, b2, i2):
        s.submit(r)
    assert s.depth() == 4
    assert s.depth_by_tier() == {"interactive": 2, "batch": 2}
    admitted, expired = s.pop_admissible(4)
    assert not expired
    assert [r.rid for r in admitted] == [i1.rid, i2.rid, b1.rid, b2.rid]


def test_qos_blocked_interactive_head_blocks_batch_too():
    s = _sched()
    i1, b1 = _req(), _req(tier="batch")
    s.submit(i1)
    s.submit(b1)
    admitted, _ = s.pop_admissible(
        2, admissible=lambda r: r.tier != "interactive")
    assert admitted == []
    assert s.depth() == 2


def test_qos_plan_prefill_preempts_batch_first():
    s = _sched(tick_token_budget=40)
    out = s.plan_prefill(0, [64, 64], 32, tiers=["batch", "interactive"])
    assert out == [8, 32]
    assert s._m_qos_preempted.labels(tier="batch").value == 1
    assert s._m_qos_preempted.labels(tier="interactive").value == 0
    s2 = _sched(tick_token_budget=40)
    assert s2.plan_prefill(0, [64, 64], 32) == [32, 8]
    assert s2._m_qos_preempted.labels(tier="batch").value == 0


def test_qos_all_interactive_matches_legacy_order():
    a = _sched(tick_token_budget=50)
    b = _sched(tick_token_budget=50)
    lens = [40, 16, 64]
    assert (a.plan_prefill(4, lens, 32, tiers=["interactive"] * 3)
            == b.plan_prefill(4, lens, 32))


def test_qos_tier_validation_and_depth_gauges():
    s = _sched()
    with pytest.raises(ValueError):
        s.submit(_req(tier="platinum"))
    s.submit(_req(tier="batch"))
    depth = s.registry.gauge("serving_qos_queue_depth", labelnames=("tier",))
    assert depth.labels(tier="batch").value == 1
    assert depth.labels(tier="interactive").value == 0
    assert tuple(QOS_TIERS) == ("interactive", "batch")


def test_engine_threads_tier_to_qos_stats():
    eng = FU.engine(FU.model(0), paged=True)
    stop = threading.Event()
    thread = threading.Thread(target=eng.serve_forever, args=(stop,),
                              daemon=True)
    thread.start()
    try:
        prompt = np.arange(8, dtype=np.int32) % V
        ri = eng.submit(prompt, max_new_tokens=4)
        rb = eng.submit(prompt, max_new_tokens=4, tier="batch")
        for r in (ri, rb):
            r.stream.tokens(timeout=60)
        st = eng.stats()
        assert set(st["qos"]) == set(QOS_TIERS)
        for t in QOS_TIERS:
            assert st["qos"][t]["queue_depth"] == 0
        ttft = eng.registry.histogram("serving_qos_ttft_ms",
                                      labelnames=("tier",))
        assert ttft.labels(tier="interactive").value["count"] == 1
        assert ttft.labels(tier="batch").value["count"] == 1
        with pytest.raises(ValueError):
            eng.submit(prompt, max_new_tokens=4, tier="gold")
    finally:
        stop.set()
        thread.join(timeout=10)


# -- fleet satellites: merge policy, probe jitter, backoff recovery -------------------


def test_merge_policy_version_gauges_max_counters_sum():
    """Versions and up/alert flags merge as MAX; counters and capacity
    gauges sum."""
    a = telemetry.MetricRegistry()
    b = telemetry.MetricRegistry()
    a.gauge("serving_weight_version").set(3)
    b.gauge("serving_weight_version").set(5)
    a.gauge("slo_alert_active", labelnames=("rule",)).labels(
        rule="itl_p99_ms").set(1)
    b.gauge("slo_alert_active", labelnames=("rule",)).labels(
        rule="itl_p99_ms").set(0)
    a.gauge("serving_queue_depth").set(2)
    b.gauge("serving_queue_depth").set(3)
    a.counter("serving_requests_total").inc(7)
    b.counter("serving_requests_total").inc(11)
    m = merge_metric_snapshots([a.collect(), b.collect()])
    assert m["serving_weight_version"]["series"][0]["value"] == 5
    assert m["slo_alert_active"]["series"][0]["value"] == 1
    assert m["serving_queue_depth"]["series"][0]["value"] == 5
    assert m["serving_requests_total"]["series"][0]["value"] == 18


def test_aggregate_stats_takes_max_of_weight_version():
    r1 = Replica("127.0.0.1", 1, "a")
    r2 = Replica("127.0.0.1", 2, "b")
    mgr = ReplicaManager([r1, r2], registry=telemetry.MetricRegistry())
    r1.last_stats = {"weight_version": 3, "requests_completed": 4}
    r2.last_stats = {"weight_version": 5, "requests_completed": 6}
    fleet_ = mgr.aggregate_stats()["fleet"]
    assert fleet_["weight_version"] == 5
    assert fleet_["requests_completed"] == 10


def test_probe_phase_jitter_spreads_replicas():
    replicas = [Replica("127.0.0.1", 1000 + i, f"r{i}") for i in range(8)]
    mgr = ReplicaManager(replicas, poll_interval=1.0,
                         registry=telemetry.MetricRegistry())
    phases = [mgr._phase(r.name) for r in replicas]
    assert all(0.0 <= p < 1.0 for p in phases)
    assert len(set(phases)) == len(phases)
    assert phases == [mgr._phase(r.name) for r in replicas]


def test_probe_backoff_resets_to_healthy_cadence(fleet):
    srv = _servers(fleet, 1)[0]
    replica = Replica("127.0.0.1", srv.port, "r0")
    mgr = ReplicaManager([replica], poll_interval=0.05, probe_timeout=2.0,
                         down_after=1, backoff_base=0.05,
                         registry=telemetry.MetricRegistry())
    mgr.probe(replica)
    assert replica.state == HEALTHY
    replica.failures = 4
    replica.backoff_s = 1.6
    replica.next_attempt_t = time.monotonic() - 1.0
    mgr.probe(replica)
    assert replica.state == HEALTHY
    assert replica.failures == 0
    assert replica.backoff_s == 0.0
    mgr.stop()


# -- live fleet: drain cycling, role flips, the Autoscaler end to end ---------------------


def test_drain_undrain_drain_cycle_forgets_affinity_each_time(fleet):
    """drain -> undrain -> drain on a live replica: admissions close and
    reopen each cycle, and the router forgets the replica's placements
    on every drain."""
    servers = _servers(fleet, 2)
    router = _router_over(fleet, servers)
    client = fleet.client(router.port)
    prefix = np.arange(2 * BS, dtype=np.int32) % V
    full = np.concatenate([prefix, np.array([1, 2], np.int32)])

    def route_of():
        client.result(client.generate(full, max_new_tokens=2), timeout=60)

    route_of()
    with router._route_lock:
        owner, hit = router.index.lookup(full)
    assert owner in ("r0", "r1") and hit > 0
    for _ in range(2):
        client.drain(replica=owner)
        with router._route_lock:
            assert router.index.lookup(full)[0] is None
        client.undrain(replica=owner)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            router.manager.probe_all()
            if any(r.name == owner and r.state == HEALTHY
                   for r in router.manager.routable()):
                break
            time.sleep(0.02)
        route_of()
        with router._route_lock:
            owner, hit = router.index.lookup(full)
        assert owner is not None and hit > 0


def test_live_role_flip_zero_lost_streams(ref_model, fleet):
    """drain -> reconfigure -> undrain of a live replica through the
    wire while streams are in flight: every stream completes equal to
    generate(), and the new role shows in stats."""
    servers = _servers(fleet, 3)
    router = _router_over(fleet, servers)
    client = fleet.client(router.port)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, V, size=8).astype(np.int32)
               for _ in range(9)]
    rids = [client.generate(p, max_new_tokens=8) for p in prompts]
    client.drain(replica="r2")
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if client.stats()["replicas"]["r2"]["stats"].get("drained"):
            break
        time.sleep(0.02)
    assert client.reconfigure("prefill", replica="r2") == "prefill"
    client.undrain(replica="r2")
    for p, rid in zip(prompts, rids):
        toks, reason = client.result(rid, timeout=60)
        assert reason == "length"
        assert toks == FU.solo(ref_model, p, 8)
    assert servers[2].engine.role == "prefill"
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if client.stats()["replicas"]["r2"]["stats"].get("role") == "prefill":
            break
        time.sleep(0.05)
    assert client.stats()["replicas"]["r2"]["stats"]["role"] == "prefill"
    direct = fleet.client(servers[0].port)
    with pytest.raises(RuntimeError):
        direct.reconfigure("sorter")


def test_autoscaler_live_scale_up_down_and_replay(ref_model, fleet):
    """Stepped with injected clocks against a live fleet: queue pressure
    scales up from the warm spare, idleness drains and retires back down,
    and replaying the recorded signal log through a fresh law reproduces
    the live decisions exactly."""
    active, spare = _servers(fleet, 2, slots=1)
    router = _router_over(fleet, [active], names=["r0"])
    client = fleet.client(router.port)
    retired = []

    def spawn():
        spare.engine.end_drain()
        return ("127.0.0.1", spare.port, "r1")

    auto = Autoscaler(router, spawn=spawn, retire=retired.append,
                      registry=telemetry.MetricRegistry(),
                      tracer=telemetry.Tracer(),
                      min_replicas=1, max_replicas=2,
                      queue_high=2.0, queue_low=0.5,
                      up_consecutive=2, down_consecutive=2,
                      cooldown_s=0.5, rebalance=False)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, V, size=8).astype(np.int32)
               for _ in range(6)]
    rids = [client.generate(p, max_new_tokens=12) for p in prompts]
    now, acted = 0.0, None
    for _ in range(20):
        router.manager.probe_all()
        acted = auto.step(now=now)
        now += 1.0
        if acted:
            break
    assert acted and acted["action"] == "scale_up"
    assert acted["ok"], acted
    assert {r.name for r in router.manager.routable()} == {"r0", "r1"}
    for p, rid in zip(prompts, rids):
        toks, reason = client.result(rid, timeout=60)
        assert reason == "length"
        assert toks == FU.solo(ref_model, p, 12)
    acted = None
    for _ in range(20):
        router.manager.probe_all()
        acted = auto.step(now=now)
        now += 1.0
        if acted:
            break
    assert acted and acted["action"] == "scale_down"
    assert acted["ok"], acted
    assert len(router.manager.routable()) == 1
    assert retired
    assert [e["action"] for e in auto.events] == ["scale_up", "scale_down"]
    assert auto.replay() == auto.decisions()


def test_autoscaler_rebalance_actuation_live(ref_model, fleet):
    """The rebalance actuator against a live 3-replica fleet: drain the
    least-loaded mixed replica, flip its role over the wire, undrain it;
    the in-flight streams survive, and a flip that would leave fewer
    than 2 mixed replicas is refused."""
    servers = _servers(fleet, 3)
    router = _router_over(fleet, servers)
    client = fleet.client(router.port)
    auto = Autoscaler(router, registry=telemetry.MetricRegistry(),
                      tracer=telemetry.Tracer(), max_replicas=3)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, V, size=8).astype(np.int32)
               for _ in range(6)]
    rids = [client.generate(p, max_new_tokens=8) for p in prompts]
    router.manager.probe_all()
    action = {"action": "rebalance", "role": "decode"}
    auto._actuate(action)
    victim = action["replica"]
    for p, rid in zip(prompts, rids):
        toks, reason = client.result(rid, timeout=60)
        assert reason == "length"
        assert toks == FU.solo(ref_model, p, 8)
    router.manager.probe_all()
    roles = {r.name: r.role for r in router.manager.routable()}
    assert roles[victim] == "decode"
    assert sorted(roles.values()) == ["decode", "mixed", "mixed"]
    auto._actuate({"action": "rebalance", "role": "prefill"})
    router.manager.probe_all()
    with pytest.raises(RuntimeError, match="fewer than 2 mixed"):
        auto._actuate({"action": "rebalance", "role": "prefill"})
