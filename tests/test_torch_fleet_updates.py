"""Live weight updates across a fleet of port replicas on the CPU (the
router and fleet tests of the reference's ``tests/test_live_update.py``):
``Router.rolling_update`` takes replicas out one at a time (never below
N-1 routable), converges through the backoff machinery when a replica's
connection dies mid-push, the SLO-burn guard re-pushes the previous
version with zero lost streams, a bad tree is refused through the
router, and the fault-injection seams (``networking.FaultInjector`` and
the manager's ``probe_fault``) are deterministic.

Each replica has a model of its own: a port model passed to two engines
shares its parameters, and a rolling update would then land on every
replica at the first push. Tolerances: greedy streams exactly equal the
port's ``generate()`` on the weights the fleet should serve; counters
and versions by their values."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_fleet_util as FU  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401
from torch_fleet_util import fleet  # noqa: E402,F401

from distkeras_torch import telemetry  # noqa: E402
from distkeras_torch.networking import (  # noqa: E402
    FaultInjector,
    FrameError,
    install_fault_injector,
    recv_frame,
    send_frame,
    uninstall_fault_injector,
)
from distkeras_torch.serving import WeightPushError  # noqa: E402
from distkeras_torch.serving.fleet import (  # noqa: E402
    DOWN,
    Replica,
    ReplicaManager,
)

MAXLEN = 160
PROMPT = np.arange(1, 9, dtype=np.int32)


@pytest.fixture(scope="module")
def weights():
    """(model A, model B, tree A, tree B): two same-shape weight sets."""
    ma, mb = FU.model(0, max_len=MAXLEN), FU.model(1, max_len=MAXLEN)
    return ma, mb, FU.tree(ma), FU.tree(mb)


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    uninstall_fault_injector()


def _fleet(fleet, n=3, **router_kw):
    servers = [fleet.server(FU.engine(
        FU.model(0, max_len=MAXLEN), paged=True, block_size=16,
        pid=2000 + i)) for i in range(n)]
    router_kw.setdefault("poll_interval", 0.05)
    router_kw.setdefault("down_after", 1)
    router_kw.setdefault("backoff_base", 0.05)
    router = fleet.router(servers, registry=telemetry.MetricRegistry(),
                          tracer=telemetry.Tracer(pid=1), **router_kw)
    return servers, router


def test_rolling_update_one_at_a_time_never_below_n_minus_1(weights, fleet):
    _, mb, _, tb = weights
    servers, router = _fleet(fleet)
    min_routable = [len(router.manager.routable())]
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            min_routable[0] = min(min_routable[0],
                                  len(router.manager.routable()))
            time.sleep(0.005)

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    report = router.rolling_update(tb, version=2)
    stop.set()
    t.join(timeout=5)
    assert report["failed"] == [] and len(report["updated"]) == 3
    evs = report["events"]
    assert [e["replica"] for e in evs] == report["updated"]
    for a, b in zip(evs, evs[1:]):
        assert a["undrain_t"] <= b["drain_t"]
    assert min_routable[0] >= 2
    for s in servers:
        assert s.engine.weight_version == 2
    c = fleet.client(router.port, request_timeout=120.0)
    toks, _ = c.result(c.generate(PROMPT, max_new_tokens=6))
    assert toks == FU.solo(mb, PROMPT, 6)
    st = c.stats()
    assert st["router"]["weights"]["version"] == 2
    assert st["router"]["weights"]["updates"] == 1


def test_rolling_update_converges_after_midpush_kill(weights, fleet):
    """The transport seam kills a connection at the 2nd weight chunk:
    the manager's backoff reconnects the replica, the update converges,
    and the streams in flight throughout complete."""
    _, _, _, tb = weights
    servers, router = _fleet(fleet)
    c = fleet.client(router.port, request_timeout=120.0)
    rids = [c.generate(PROMPT, max_new_tokens=24, seed=i) for i in range(4)]
    fi = FaultInjector(seed=7)
    rule = fi.rule("kill", direction="send", nth=2, min_bytes=8 << 10)
    install_fault_injector(fi)
    report = router.rolling_update(tb, version=2, retry_timeout_s=60.0)
    uninstall_fault_injector()
    assert rule.fired == 1
    assert report["failed"] == [], report
    assert sorted(report["updated"]) == ["r0", "r1", "r2"]
    for s in servers:
        assert s.engine.weight_version == 2
    results = [c.result(rid, timeout=120) for rid in rids]
    assert all(len(t) == 24 and r == "length" for t, r in results)
    assert c.stats()["router"]["failed"] == 0


class _FakeMonitor:
    """A deterministic SLO stand-in: fires when told to."""

    def __init__(self):
        self.firing = threading.Event()

    def alerts(self):
        return [{"rule": "fake_burn", "firing": self.firing.is_set()}]


def test_auto_rollback_on_slo_burn(weights, fleet):
    ma, _, ta, tb = weights
    servers, router = _fleet(fleet)
    router.rolling_update(ta, version=2)
    mon = _FakeMonitor()
    report = router.rolling_update(tb, version=3, guard_window_s=30.0,
                                   monitor=mon)
    assert report["rollback_armed"]
    c = fleet.client(router.port, request_timeout=120.0)
    rids = [c.generate(PROMPT, max_new_tokens=24, seed=i) for i in range(3)]
    mon.firing.set()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        w = router.stats()["router"]["weights"]
        if w["rollbacks"] >= 1 and w["last_outcome"] == "rollback":
            break
        time.sleep(0.05)
    w = router.stats()["router"]["weights"]
    assert w["rollbacks"] == 1, w
    assert router.registry.counter(
        "router_weight_rollbacks_total").value == 1
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            s.engine.weight_version < 4 for s in servers):
        time.sleep(0.05)
    toks, _ = c.result(c.generate(PROMPT, max_new_tokens=6))
    assert toks == FU.solo(ma, PROMPT, 6)
    results = [c.result(rid, timeout=120) for rid in rids]
    assert all(len(t) == 24 and r == "length" for t, r in results)


def test_rollback_without_history_is_recorded(weights, fleet):
    _, _, _, tb = weights
    servers, router = _fleet(fleet, n=2)
    mon = _FakeMonitor()
    mon.firing.set()
    router.rolling_update(tb, version=2, guard_window_s=10.0, monitor=mon)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if router.stats()["router"]["weights"]["rollbacks"] >= 1:
            break
        time.sleep(0.05)
    w = router.stats()["router"]["weights"]
    assert w["rollbacks"] == 1
    assert w["last_outcome"] == "rollback_unavailable"
    assert all(s.engine.weight_version == 2 for s in servers)


def test_bad_checkpoint_refused_through_router(fleet):
    servers, router = _fleet(fleet, n=2)
    c = fleet.client(router.port, request_timeout=120.0)
    bad = {"params": {"garbage": np.zeros((3,), np.float32)}}
    with pytest.raises(WeightPushError):
        c.push_weights(bad, chunk_bytes=4096, timeout=120.0)
    assert all(s.engine.weight_version == 1 for s in servers)
    toks, reason = c.result(c.generate(PROMPT, max_new_tokens=4))
    assert reason == "length" and len(toks) == 4


# -- fault-injection seams ------------------------------------------------------


def _socket_pair():
    import socket

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    a = socket.socket()
    a.connect(srv.getsockname())
    b, _ = srv.accept()
    srv.close()
    return a, b


def test_fault_injector_deterministic_actions():
    fi = FaultInjector(seed=0)
    rule = fi.rule("drop", nth=2, min_bytes=100)
    install_fault_injector(fi)
    a, b = _socket_pair()
    big = b"x" * 200
    send_frame(a, big)
    send_frame(a, big)      # dropped
    send_frame(a, b"tiny")  # under min_bytes: unaffected
    send_frame(a, big)
    uninstall_fault_injector()
    assert recv_frame(b) == big
    assert recv_frame(b) == b"tiny"
    assert recv_frame(b) == big
    assert rule.matched == 3 and rule.fired == 1
    a.close()
    b.close()
    fi = FaultInjector(seed=0)
    fi.rule("kill", nth=3)
    install_fault_injector(fi)
    a, b = _socket_pair()
    send_frame(a, b"one")
    send_frame(a, b"two")
    with pytest.raises(ConnectionError, match="fault injected"):
        send_frame(a, b"three")
    uninstall_fault_injector()
    assert recv_frame(b) == b"one"
    assert recv_frame(b) == b"two"
    assert recv_frame(b) is None
    a.close()
    b.close()
    fi = FaultInjector(seed=0)
    fi.rule("truncate", nth=1, min_bytes=10)
    install_fault_injector(fi)
    a, b = _socket_pair()
    with pytest.raises(ConnectionError):
        send_frame(a, b"y" * 64)
    uninstall_fault_injector()
    with pytest.raises(FrameError, match="truncated"):
        recv_frame(b)
    a.close()
    b.close()


def test_fault_injector_seeded_prob_reproducible():
    fired = []
    for _ in range(2):
        fi = FaultInjector(seed=123)
        rule = fi.rule("drop", prob=0.5, repeat=True)
        hits = [fi.check("send", 1) is not None for _ in range(32)]
        fired.append(hits)
        assert rule.fired == sum(hits)
    assert fired[0] == fired[1]


def test_probe_fault_seam_downs_and_recovers(fleet):
    srv = fleet.server(FU.engine(FU.model(0, max_len=MAXLEN)))
    faulty = threading.Event()
    mgr = ReplicaManager(
        [Replica("127.0.0.1", srv.port, "r0")],
        poll_interval=0.05, down_after=1, backoff_base=0.01,
        registry=telemetry.MetricRegistry(),
        probe_fault=lambda r: faulty.is_set())
    r = mgr.replicas[0]
    mgr.probe(r)
    assert r.state != DOWN
    faulty.set()
    mgr.probe(r)
    assert r.state == DOWN
    faulty.clear()
    time.sleep(0.05)
    mgr.probe(r)
    assert r.state != DOWN
    mgr.stop()
