"""Shared pieces of the port's fleet tests (``tests/test_torch_router.py``,
``test_torch_controller.py``, ``test_torch_fleet_*.py``): port
``LMServer`` replicas on the CPU behind the port's ``Router``, each
replica with a model of its own (a port model passed to two engines
shares its parameters, so a push to one would swap the other's too),
all built from one seed so every replica carries the same weights.

Probe cadence as the reference's fleet tests: ``poll_interval=0.05``,
``down_after=1``, ``backoff_base=0.05``. Every client call the tests make
has a timeout, and the fixtures stop every router and server when the
test ends."""

import numpy as np
import pytest
import torch

import torch_engine_util as U

from distkeras_torch import bridge, telemetry
from distkeras_torch.models import get_model
from distkeras_torch.models.transformer import generate
from distkeras_torch.serving import (
    LMServer,
    Router,
    ServingClient,
    ServingEngine,
)

TIMEOUT = 60.0
BS = 8  # paged block size AND router affinity chunk size


def model(seed=0, tree=None, **over):
    """A fresh f32 port model of ``U.KW`` updated by ``over``: made from
    ``seed``, or carrying the flax-layout numpy ``tree``."""
    kw = dict(U.KW)
    kw.update(over)
    pm = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                   seed=seed, **kw)
    if tree is not None:
        bridge.params_from_jax(tree, pm)
    return pm


def tree(pm):
    """The flax-layout numpy tree of a port model's weights."""
    return bridge.params_to_jax(pm)


def solo(pm, prompt, n, **kw):
    """The port's ``generate()`` stream of ``n`` new tokens."""
    return generate(pm, torch.as_tensor(np.asarray(prompt))[None], n,
                    **kw)[0, len(prompt):].tolist()


def engine(pm, slots=2, paged=False, scheduler=None, pid=None, **kw):
    if paged:
        kw.setdefault("block_size", BS)
    return ServingEngine(
        pm, slots=slots, paged=paged, scheduler=scheduler, device="cpu",
        registry=telemetry.MetricRegistry(),
        tracer=telemetry.Tracer() if pid is None else telemetry.Tracer(
            pid=pid), **kw)


def client(port, **kw):
    kw.setdefault("timeout", TIMEOUT)
    kw.setdefault("request_timeout", TIMEOUT)
    return ServingClient("127.0.0.1", port, **kw)


def router_kw(**over):
    kw = dict(block_size=BS, poll_interval=0.05, down_after=1,
              backoff_base=0.05, probe_timeout=2.0,
              registry=telemetry.MetricRegistry(),
              tracer=telemetry.Tracer())
    kw.update(over)
    return kw


class Fleet:
    """Servers, routers and clients of one test, stopped and closed (in
    reverse order of creation) by :func:`fleet`'s finalizer."""

    def __init__(self):
        self.items = []

    def server(self, eng, **kw):
        srv = LMServer(eng, **kw).start()
        self.items.append(srv)
        return srv

    def router(self, servers, names=None, **kw):
        names = names or [f"r{i}" for i in range(len(servers))]
        r = Router([("127.0.0.1", s.port, n)
                    for s, n in zip(servers, names)], **kw).start()
        self.items.append(r)
        return r

    def client(self, port, **kw):
        c = client(port, **kw)
        self.items.append(c)
        return c

    def replicas(self, n, seed=0, slots=2, paged=False, **eng_kw):
        """``n`` started servers, each over its own model from ``seed``."""
        return [self.server(engine(model(seed), slots=slots, paged=paged,
                                   **eng_kw)) for _ in range(n)]

    def close(self):
        for x in reversed(self.items):
            try:
                if isinstance(x, ServingClient):
                    x.close()
                elif isinstance(x, Router):
                    x.stop()
                else:
                    x.stop(timeout=10.0)
            except Exception:
                pass


@pytest.fixture
def fleet(request):
    f = Fleet()
    request.addfinalizer(f.close)
    return f
