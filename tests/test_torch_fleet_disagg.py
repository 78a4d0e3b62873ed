"""Disaggregated serving through the port's router on the CPU (the
router tests of the reference's ``tests/test_disagg.py`` over port
replicas): long prompts run on a ``prefill``-role replica, their KV
blocks migrate to a ``decode``-role replica over ``export_kv`` /
``import_kv``, short prompts never touch the prefill pool, a repeated
long prompt skips the redundant migration, migration racing eviction
loses no stream, and the router refuses the raw KV ops.

Tolerances: every stream, migrated or fallen back, is compared exactly
with the port's ``generate()``; counters by their values."""

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

V = U.V
MAXLEN = 256


@pytest.fixture(scope="module")
def ref_model():
    return FU.model(0, max_len=MAXLEN)


def _server(fleet, role, chunk=16, num_blocks=128):
    return fleet.server(FU.engine(
        FU.model(0, max_len=MAXLEN), paged=True, num_blocks=num_blocks,
        prefill_chunk=chunk, role=role))


def _router(fleet, servers, **kw):
    return fleet.router(servers, block_size=BS, poll_interval=0.1,
                        registry=telemetry.MetricRegistry(),
                        tracer=telemetry.Tracer(), **kw)


def test_router_disagg_end_to_end(ref_model, fleet):
    """A long prompt migrates (the prefill replica computes, a decode
    replica serves off the imported prefix), a short prompt avoids the
    prefill pool, a repeated long prompt is not migrated again, and
    every stream equals generate()."""
    rng = np.random.default_rng(5)
    long_p = rng.integers(0, V, size=128).astype(np.int32)
    short_p = rng.integers(0, V, size=8).astype(np.int32)
    servers = [_server(fleet, r, chunk=32)
               for r in ("prefill", "decode", "decode")]
    router = _router(fleet, servers, disagg_prompt_tokens=64)
    time.sleep(0.3)  # the first poll round classifies the pools
    c = fleet.client(router.port, request_timeout=120)
    toks, reason = c.result(c.generate(short_p, max_new_tokens=4),
                            timeout=120)
    assert (toks, reason) == (FU.solo(ref_model, short_p, 4), "length")
    assert servers[0].engine.requests_completed == 0
    toks, reason = c.result(c.generate(long_p, max_new_tokens=6),
                            timeout=120)
    assert (toks, reason) == (FU.solo(ref_model, long_p, 6), "length")
    st = c.stats()
    assert st["router"]["kv_migrations"] == 1
    assert st["kv_blocks_exported"] >= 1
    assert st["kv_blocks_imported"] >= 1
    assert servers[0].engine.requests_completed == 1
    toks, _ = c.result(c.generate(long_p, max_new_tokens=6), timeout=120)
    assert toks == FU.solo(ref_model, long_p, 6)
    assert c.stats()["router"]["kv_migrations"] == 1
    mig = router.metrics()["serving_kv_migrations_total"]
    assert {tuple(s["labels"].items()): s["value"]
            for s in mig["series"]} == {(("outcome", "ok"),): 1.0}


def test_router_disagg_race_zero_lost_streams(ref_model, fleet):
    """The prefill replica's pool holds about one long prompt and four
    distinct long prompts arrive at once: whatever mix of migrations and
    fallbacks results, every stream equals generate() and none is
    lost."""
    rng = np.random.default_rng(6)
    longs = [rng.integers(0, V, size=96).astype(np.int32)
             for _ in range(4)]
    servers = [_server(fleet, "prefill", chunk=32, num_blocks=16)] + [
        _server(fleet, "decode", chunk=32) for _ in range(2)]
    router = _router(fleet, servers, disagg_prompt_tokens=64)
    time.sleep(0.3)
    c = fleet.client(router.port, request_timeout=180)
    results = {}
    lock = threading.Lock()

    def run(i):
        rid = c.generate(longs[i], max_new_tokens=4)
        out = c.result(rid, timeout=180)
        with lock:
            results[i] = out

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(longs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert len(results) == len(longs)
    for i, (toks, reason) in results.items():
        assert reason == "length", (i, reason)
        assert toks == FU.solo(ref_model, longs[i], 4), i
    st = c.stats()
    assert st["router"]["failed"] == 0
    assert st["router"]["kv_migrations"] == len(longs)


def test_router_refuses_direct_kv_ops(fleet):
    """export_kv / import_kv against the router answer a typed refusal:
    migration is the router's to orchestrate."""
    servers = [_server(fleet, "mixed")]
    router = _router(fleet, servers)
    c = fleet.client(router.port)
    with pytest.raises(RuntimeError, match="orchestrated"):
        c.export_kv([1, 2, 3])
    with pytest.raises(RuntimeError, match="orchestrated"):
        c.import_kv([1, 2, 3], [])
