"""The fleet's wire across packages: the JAX ``Router`` in front of port
``LMServer`` replicas, and the port's ``Router`` in front of JAX
``LMServer`` replicas, on one tiny model whose weights are the same in
both (``torch_engine_util.pair()``, f32). The router speaks to its
replicas over the reference's framing and op set, so each package's
router drives the other's servers unchanged: greedy streams equal the
JAX package's ``generate()``, ``stats`` / ``metrics`` aggregate the
fleet, and a killed replica's streams fail over with none lost.

Tolerances: greedy token streams are compared exactly (f32 weights; the
JAX engines attend through their gather reference); counters by their
values."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
import torch_fleet_util as FU  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401
from torch_lockorder_util import lock_order  # noqa: E402,F401

from distkeras_tpu import telemetry as jax_telemetry  # noqa: E402
from distkeras_tpu.models.transformer import generate as jax_generate  # noqa: E402
from distkeras_tpu.serving import LMServer as JaxServer  # noqa: E402
from distkeras_tpu.serving import Router as JaxRouter  # noqa: E402
from distkeras_tpu.serving import ServingClient as JaxClient  # noqa: E402
from distkeras_torch import telemetry  # noqa: E402
from distkeras_torch.serving import LMServer, Router, ServingClient  # noqa: E402

TIMEOUT = 120.0
N_NEW = 24


@pytest.fixture(scope="module")
def weights():
    """(jax module, params, the numpy tree) of one seed."""
    jm, params, _ = U.pair(seed=0)
    return jm, params, U.jax.tree.map(np.asarray, params)


def _jax_want(jm, params, prompt, n):
    out = jax_generate(jm, params, U.jnp.asarray(prompt)[None], n)
    return np.asarray(out)[0, len(prompt):].tolist()


def _prompts(seed, n=4, size=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, U.V, size=size).astype(np.int32)
            for _ in range(n)]


@pytest.fixture
def stack(request):
    items = []

    def fin():
        for x in reversed(items):
            try:
                x.close() if hasattr(x, "close") else x.stop()
            except Exception:
                pass

    request.addfinalizer(fin)
    return items


def _router_kw(registry, tracer):
    return dict(block_size=FU.BS, poll_interval=0.05, down_after=1,
                backoff_base=0.05, probe_timeout=5.0,
                registry=registry, tracer=tracer)


def _drive(client, router, servers, prompts, want):
    """Greedy streams through the router, then one failover: the replica
    with the most streams in flight is stopped and every stream still
    completes equal to ``want``. The router's fleet stats are its last
    probes' view, so they are read after fresh probes (a replica counts
    a request just after its last frame is out)."""
    rids = [client.generate(p, max_new_tokens=N_NEW) for p in prompts]
    for p, rid in zip(prompts, rids):
        assert client.result(rid, timeout=TIMEOUT) == (want(p), "length")
    deadline = time.monotonic() + 30
    while True:
        router.manager.probe_all()
        st = client.stats()
        if (st["requests_completed"] == len(prompts)
                or time.monotonic() > deadline):
            break
        time.sleep(0.05)
    assert st["requests_completed"] == len(prompts)
    assert st["tokens_generated"] == N_NEW * len(prompts)
    assert st["router"]["routed"] == len(prompts)
    assert st["replicas_routable"] == len(servers)
    series = client.metrics()["serving_tokens_total"]["series"]
    assert series and series[0]["value"] == N_NEW * len(prompts)
    # failover
    more = _prompts(11, n=6)
    rids = [client.generate(p, max_new_tokens=N_NEW) for p in more]
    deadline = time.monotonic() + 30
    by = {}
    while time.monotonic() < deadline:
        by = router.stats()["router"]["inflight_by_replica"]
        if by and max(by.values()) >= 2:
            break
        time.sleep(0.005)
    victim = max(by, key=by.get)
    servers[int(victim[1:])].stop()
    for p, rid in zip(more, rids):
        assert client.result(rid, timeout=TIMEOUT) == (want(p), "length")
    st = client.stats()
    assert st["router"]["failed"] == 0
    assert st["router"]["failed_over"] >= 1
    assert st["replicas"][victim]["state"] == "down"


def test_jax_router_fronts_port_replicas(weights, stack):
    jm, params, tree = weights
    servers = []
    for _ in range(2):
        srv = LMServer(FU.engine(FU.model(tree=tree), slots=2)).start()
        stack.append(srv)
        servers.append(srv)
    router = JaxRouter([("127.0.0.1", s.port, f"r{i}")
                        for i, s in enumerate(servers)],
                       **_router_kw(jax_telemetry.MetricRegistry(),
                                    jax_telemetry.Tracer())).start()
    stack.append(router)
    client = JaxClient("127.0.0.1", router.port, timeout=TIMEOUT,
                       request_timeout=TIMEOUT)
    stack.append(client)
    _drive(client, router, servers, _prompts(0),
           lambda p: _jax_want(jm, params, p, N_NEW))


def test_port_router_fronts_jax_replicas(weights, stack):
    jm, params, _ = weights
    servers = []
    for _ in range(2):
        srv = JaxServer(U.jax_engine(jm, params)).start()
        stack.append(srv)
        servers.append(srv)
    router = Router([("127.0.0.1", s.port, f"r{i}")
                     for i, s in enumerate(servers)],
                    **_router_kw(telemetry.MetricRegistry(),
                                 telemetry.Tracer())).start()
    stack.append(router)
    client = ServingClient("127.0.0.1", router.port, timeout=TIMEOUT,
                           request_timeout=TIMEOUT)
    stack.append(client)
    _drive(client, router, servers, _prompts(0),
           lambda p: _jax_want(jm, params, p, N_NEW))
