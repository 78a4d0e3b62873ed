"""Port of the host-RAM KV tier (``ServingEngine(host_blocks=...)``,
``kvpool.HostBlockPool``) on the CPU.

The tier is INVISIBLE except for capacity: streams are bit-identical
with the tier on or off (a restored block holds the demoted bytes),
plain, copy-on-write, pipelined and speculative; greedy streams equal
the JAX engine's with the same tier; RESTORING rows charge no budget and
never over-commit; the host pool keeps its bound with pinned entries
protected; and the restore fallback (an entry lost before its copy)
recomputes bit-identically.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401

from distkeras_torch import telemetry  # noqa: E402
from distkeras_torch.serving import FIFOScheduler  # noqa: E402
from distkeras_torch.serving.kvpool import BlockPool, HostBlockPool  # noqa: E402

BS = 8


@pytest.fixture(scope="module")
def trio():
    return U.pair(cache_dtype="int8")


def _engine(pm, *, host_blocks, num_blocks, slots=2, **kw):
    return U.port_engine(pm, slots=slots, paged=True, block_size=BS,
                         num_blocks=num_blocks, host_blocks=host_blocks,
                         prefill_chunk=BS, **kw)


def _churn_trace(n_prefixes=3, reps=3, prefix_len=32, tail=3, seed=0):
    """Round-robin over shared prefixes: a device pool sized below the
    working set must demote each prefix before its revisit."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, U.V, size=prefix_len).astype(np.int32)
                for _ in range(n_prefixes)]
    out = []
    for _ in range(reps):
        for p in prefixes:
            t = rng.integers(0, U.V, size=tail).astype(np.int32)
            out.append(np.concatenate([p, t]))
    return prefixes, out


def _serve(eng, prompts, max_new=4, temperature=0.7, seed=11):
    streams = []
    for p in prompts:
        r = eng.submit(p, max_new_tokens=max_new, temperature=temperature,
                       seed=seed)
        eng.drain(timeout=300)
        streams.append(r.stream.tokens(timeout=10))
    return streams


def test_greedy_equals_jax_engine_with_tier(trio):
    jm, params, pm = trio
    _, trace = _churn_trace(reps=2)
    want_eng = U.jax_engine(jm, params, paged=True, block_size=BS,
                            prefill_chunk=BS, num_blocks=12, host_blocks=32)
    want = _serve(want_eng, trace, temperature=0.0)
    eng = _engine(pm, host_blocks=32, num_blocks=12)
    assert _serve(eng, trace, temperature=0.0) == want
    assert eng.stats()["block_restores"] > 0
    assert want_eng.stats()["block_restores"] == eng.stats()[
        "block_restores"]


def test_demote_restore_round_trip_bit_identity(trio):
    _, _, pm = trio
    _, trace = _churn_trace()
    eng_t = _engine(pm, host_blocks=32, num_blocks=12)
    eng_d = _engine(pm, host_blocks=None, num_blocks=12)
    toks_t = _serve(eng_t, trace)
    s = eng_t.stats()
    assert s["block_demotions"] > 0 and s["block_restores"] > 0
    assert toks_t == _serve(eng_d, trace)
    assert s["prefix_hit_fraction"] > eng_d.stats()["prefix_hit_fraction"]
    assert s["restore_wait_ms"]["p50"] is not None


@pytest.mark.parametrize("mode", ["pipeline", "spec"])
def test_pipelined_and_speculative_restore_parity(trio, mode):
    """The tier under the pipelined loop (restores overlap the in-flight
    tick) and under speculation: streams equal the tier-less engine's in
    the same mode."""
    _, _, pm = trio
    _, trace = _churn_trace()
    kw = (dict(pipeline=True) if mode == "pipeline"
          else dict(draft="ngram", spec_k=3))
    eng = _engine(pm, host_blocks=32, num_blocks=12, **kw)
    toks = _serve(eng, trace)
    assert eng.stats()["block_restores"] > 0
    assert toks == _serve(_engine(pm, host_blocks=None, num_blocks=12,
                                  **kw), trace)


def test_cow_on_restored_block(trio):
    """A request diverging MID-BLOCK inside a restored span copies on
    write off the restored block; streams equal a tier-less engine's."""
    _, _, pm = trio
    prefixes, _ = _churn_trace()
    P = prefixes[0]
    tail = np.random.default_rng(5).integers(0, U.V, size=3).astype(np.int32)
    div = np.concatenate([P[:28], (P[28:32] + 1) % U.V, tail])
    warm = [np.concatenate([p, tail]) for p in prefixes]
    probe = [np.concatenate([P, tail]), div]

    def run(host_blocks, num_blocks):
        eng = _engine(pm, host_blocks=host_blocks, num_blocks=num_blocks)
        return eng, _serve(eng, warm + warm[1:] + probe)

    eng_t, toks_t = run(32, 12)
    s = eng_t.stats()
    assert s["block_demotions"] > 0 and s["block_restores"] > 0
    assert s["prefix_hit_tokens"] % BS != 0
    assert toks_t == run(None, 64)[1]


def test_restore_fallback_recomputes_bit_identical(trio):
    """A RESTORING row whose host entries vanish before their copies
    falls back to seeded replay: the spans recompute through chunked
    prefill into the same blocks, bit-identically."""
    _, _, pm = trio
    prefixes, _ = _churn_trace()
    rng = np.random.default_rng(6)
    tails = [rng.integers(0, U.V, size=3).astype(np.int32)
             for _ in range(6)]
    warm_p = [prefixes[0], prefixes[1], prefixes[2], prefixes[1],
              prefixes[2]]
    warm = [np.concatenate([p, t]) for p, t in zip(warm_p, tails)]
    probe = np.concatenate([prefixes[0], tails[5]])
    eng = _engine(pm, host_blocks=32, num_blocks=12,
                  scheduler=FIFOScheduler(restore_budget=1))
    toks = _serve(eng, warm)
    assert eng.stats()["block_demotions"] > 0
    req = eng.submit(probe, max_new_tokens=4, temperature=0.7, seed=11)
    eng.step()  # admits the row RESTORING; the first restore issues
    st = next(s for s in eng._slots if s is not None)
    assert st.restoring, "probe should be admitted RESTORING"
    for h, _ in list(st.restoring):
        eng.host.discard(h)
    eng.drain(timeout=300)
    ref = _serve(_engine(pm, host_blocks=None, num_blocks=64),
                 warm + [probe])
    assert toks + [req.stream.tokens(timeout=10)] == ref
    s = eng.stats()
    assert 0 <= s["prefix_hit_tokens"] <= s["prompt_tokens"]
    ps = eng.pool.stats()
    assert ps["live"] == 0 and ps["in_use"] == ps["cached"]


def test_restoring_row_charges_no_budget_and_never_overcommits(trio):
    """While a row restores, a live decode keeps emitting, the pool never
    over-commits, and the restoring row emits nothing."""
    _, _, pm = trio
    prefixes, _ = _churn_trace()
    rng = np.random.default_rng(7)
    tails = [rng.integers(0, U.V, size=3).astype(np.int32)
             for _ in range(5)]
    warm = [np.concatenate([p, t]) for p, t in zip(prefixes, tails)]
    eng = _engine(pm, host_blocks=32, num_blocks=13,
                  scheduler=FIFOScheduler(restore_budget=1))
    _serve(eng, warm)
    assert eng.stats()["block_demotions"] > 0
    dec = eng.submit(warm[2][:9], max_new_tokens=20, temperature=0.7,
                     seed=3)
    for _ in range(3):
        eng.step()
    res = eng.submit(np.concatenate([prefixes[0], tails[4]]),
                     max_new_tokens=4, temperature=0.7, seed=11)
    seen_restoring = decode_progress = 0
    for _ in range(40):
        before = eng.tokens_generated
        eng.step()
        restoring = [s for s in eng._slots
                     if s is not None and s.restoring is not None]
        if restoring:
            seen_restoring += 1
            assert restoring[0].req.first_token_t is None
            if eng.tokens_generated > before:
                decode_progress += 1
        ps = eng.pool.stats()
        assert ps["in_use"] + ps["free"] == ps["total"]
    assert seen_restoring > 0 and decode_progress > 0
    eng.drain(timeout=300)
    assert dec.stream.tokens(timeout=10)
    assert len(res.stream.tokens(timeout=10)) == 4


def test_host_pool_lru_bound_and_pinning():
    reg = telemetry.MetricRegistry()
    pool = HostBlockPool(capacity=3, block_size=8, registry=reg)

    def leaves(v):
        return [torch.full((8, 2, 4), float(v))]

    handles = []
    for i in range(3):
        h, ev = pool.put(leaves(i))
        assert h is not None and ev == []
        handles.append(h)
    h4, ev = pool.put(leaves(3))
    assert ev == [handles[0]] and pool.count() == 3
    pool.touch(handles[1])
    _, ev = pool.put(leaves(4))
    assert ev == [handles[2]]
    pool.pin(handles[1])
    _, ev = pool.put(leaves(5))
    assert handles[1] not in ev
    for h in list(pool._entries):
        pool.pin(h)
    h_refused, _ = pool.put(leaves(6))
    assert h_refused is None and pool.count() == 3
    got = pool.take(handles[1])
    assert got is not None and float(got[0][0, 0, 0]) == 1.0
    assert pool.take(handles[1]) is None
    assert reg.counter("serving_block_restores_total").value == 1
    assert reg.gauge("host_blocks_cached").value == pool.count()
    assert reg.gauge("host_bytes").value == pool.stats()["bytes"]
    assert pool.stats()["bytes"] == pool.count() * 8 * 2 * 4 * 4


def test_host_pool_capacity_bound_under_engine_churn(trio):
    _, _, pm = trio
    _, trace = _churn_trace(n_prefixes=4, reps=3)
    eng = _engine(pm, host_blocks=6, num_blocks=12)
    toks = _serve(eng, trace)
    assert eng.host.count() <= 6 and eng.stats()["block_demotions"] > 0
    assert toks == _serve(_engine(pm, host_blocks=None, num_blocks=12),
                          trace)


def test_blockpool_evict_returns_handle_and_stats_decomposition():
    reg = telemetry.MetricRegistry()
    host = HostBlockPool(capacity=4, block_size=4, registry=reg)
    pool = BlockPool(8, 4, registry=reg, host_tier=host)
    blocks = pool.alloc(3)
    pool.incref(blocks)
    assert pool.decref([blocks[0]]) == [blocks[0]]
    assert pool.evict(blocks[0]) == blocks[0]
    host.put([torch.zeros((4, 2))])
    s = pool.stats()
    assert s["total"] == 7 and s["live"] == 2 and s["cached"] == 0
    assert s["in_use"] == 2 and s["free"] == 5 and s["host"] == 1


def test_engine_host_tier_validation(trio):
    _, _, pm = trio
    with pytest.raises(ValueError, match="paged"):
        U.port_engine(pm, host_blocks=4)
    with pytest.raises(ValueError, match="prefix_cache"):
        _engine(pm, host_blocks=4, num_blocks=12, prefix_cache=False)
    with pytest.raises(ValueError, match="chunked"):
        U.port_engine(pm, paged=True, num_blocks=12, host_blocks=4,
                      prefill_chunk=None)
    with pytest.raises(ValueError, match="host_blocks"):
        _engine(pm, host_blocks=0, num_blocks=12)


def test_tier_telemetry_and_flight(trio):
    _, _, pm = trio
    _, trace = _churn_trace()
    eng = _engine(pm, host_blocks=32, num_blocks=12,
                  scheduler=FIFOScheduler(restore_budget=1))
    _serve(eng, trace)
    s = eng.stats()
    assert s["block_demotions"] > 0 and s["block_restores"] > 0
    assert s["host_blocks_cached"] > 0 and s["host_bytes"] > 0
    names = set(eng.registry.collect())
    for fam in ("serving_block_demotions_total",
                "serving_block_restores_total", "serving_restore_wait_ms",
                "host_blocks_cached", "host_bytes"):
        assert fam in names, fam
    snaps = [r for r in eng.flight.snapshots() if r.get("kind") == "tick"]
    assert any(r.get("restored", 0) > 0 for r in snaps)
    assert any(r.get("demoted", 0) > 0 for r in snaps)
    assert any((sl or {}).get("state") == "restore"
               for r in snaps for sl in (r.get("slots") or []))


def test_prefix_residency_transitions():
    """The port's radix index through demote / promote / drop_host, as
    the reference's: bottom-up victims, the match walking the device
    chain then the host chain, inserts stopping at a host node."""
    from distkeras_torch.serving import RadixPrefixIndex

    idx = RadixPrefixIndex(2)
    toks = [1, 2, 3, 4, 5, 6, 7]
    idx.insert(toks, [10, 11, 12])
    ref = np.zeros(64, np.int32)
    assert idx.peek_evictable(ref) == 12
    idx.demote(12, handle=100)
    assert idx.host_count() == 1 and not idx.contains_block(12)
    assert idx.has_host(100) and idx.host_handles() == [100]
    assert idx.peek_evictable(ref) == 11
    idx.demote(11, handle=101)
    m = idx.match(toks)
    assert m.blocks == [10] and m.host == [101, 100] and m.hit_tokens == 6
    assert idx.insert(toks, [20, 21, 22]) == []
    idx.promote(101, 30)
    assert idx.match(toks).blocks == [10, 30]
    idx.promote(100, 31)
    assert idx.host_count() == 0 and sorted(idx.blocks()) == [10, 30, 31]
    idx.demote(31, handle=200)
    idx.demote(30, handle=201)
    assert sorted(idx.drop_host(201)) == [200, 201]
    assert idx.match(toks).blocks == [10] and idx.match(toks).host == []


def test_scheduler_restore_budget():
    s = FIFOScheduler(restore_budget=3)
    assert s.plan_restore(0) == 0
    assert s.plan_restore(2) == 2
    assert s.plan_restore(9) == 3
    with pytest.raises(ValueError):
        FIFOScheduler(restore_budget=0)


def test_prefix_cow_not_offered_from_host_frontier():
    from distkeras_torch.serving import RadixPrefixIndex

    idx = RadixPrefixIndex(4)
    idx.insert(range(8), [5, 6])
    idx.demote(6, handle=9)
    m = idx.match([0, 1, 2, 3, 4, 5, 99, 98, 97])
    assert m.blocks == [5] and m.host == [] and m.cow is None
    m = idx.match(list(range(8)) + [42])
    assert m.blocks == [5] and m.host == [9]
