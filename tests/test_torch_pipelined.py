"""Port ServingEngine's pipelined loop (``pipeline=True``) and monolithic
prefill (``prefill_chunk=None``) on the CPU, slot and paged layouts:

- greedy streams equal the JAX engine's in the same mode (its gather /
  dense attends) on the same weights;
- pipelined streams equal the sync loop's bit for bit, sampled rows
  included, chunked and monolithic; late EOS overruns are dropped;
- the monolithic slot prefill leaves the bytes of the reference's merge:
  the whole cache row replaced, zeros past the prompt;
- the packed control buffer round-trips, an unchanged plan is not
  uploaded again, and the flight recorder carries the overlap fields.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401

from distkeras_torch.models.transformer import generate  # noqa: E402
from distkeras_torch.serving.engine import (  # noqa: E402
    _pack_i32,
    _unpack_i32,
)


@pytest.fixture(scope="module")
def trio():
    return U.pair(cache_dtype="int8")


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("chunk", [8, None])
def test_pipelined_greedy_equals_jax_engine(trio, paged, chunk):
    jm, params, pm = trio
    ps = U.prompts()
    cfgs = U.greedy((10, 13, 6, 9))
    want = U.serve(U.jax_engine(jm, params, paged=paged, prefill_chunk=chunk,
                                pipeline=True), ps, cfgs)
    got = U.serve(U.port_engine(pm, paged=paged, prefill_chunk=chunk,
                                pipeline=True), ps, cfgs)
    assert got == want


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("chunk", [8, None])
def test_pipelined_equals_sync_bit_for_bit(trio, paged, chunk):
    """Mixed greedy / sampled requests, more than the slots: the
    pipelined loop's streams equal the sync loop's, and the sync loop's
    equal solo generate() (its per-slot generators)."""
    _, _, pm = trio
    ps = U.prompts()
    sync = U.serve(U.port_engine(pm, paged=paged, prefill_chunk=chunk),
                   ps, U.MIXED)
    eng = U.port_engine(pm, paged=paged, prefill_chunk=chunk, pipeline=True)
    pipe = U.serve(eng, ps, U.MIXED)
    assert pipe == sync
    for p, c, s in zip(ps, U.MIXED, sync):
        ref = generate(pm, p[None], c["max_new_tokens"],
                       temperature=c.get("temperature", 0.0),
                       seed=c.get("seed", 0), top_k=c.get("top_k"),
                       top_p=c.get("top_p"))
        assert s == ref[0, len(p):].tolist()
    st = eng.stats()
    assert st["pipeline"] and st["overrun_tokens"] >= 1
    assert st["requests_completed"] == len(ps)


def test_eos_on_pipeline_boundary(trio):
    """A row that samples its eos while the next tick is in flight:
    the overrun token is dropped before any consumer sees it."""
    _, _, pm = trio
    p = U.prompts(1)[0]
    ref = generate(pm, p[None], 16)[0, len(p):].tolist()
    eos = ref[len(ref) // 2]

    def run(pipeline, paged):
        eng = U.port_engine(pm, paged=paged, prefill_chunk=4,
                            pipeline=pipeline)
        req = eng.submit(p, max_new_tokens=16, eos_id=eos)
        eng.drain()
        return req.stream.tokens(timeout=10), req, eng

    for paged in (False, True):
        sync, rs, _ = run(False, paged)
        pipe, rp, eng = run(True, paged)
        assert sync == pipe == ref[:ref.index(eos) + 1]
        assert rs.stream.finish_reason == rp.stream.finish_reason == "eos"
        assert eng.stats()["overrun_tokens"] >= 1


def test_eos_refill_from_queue_under_pipeline(trio):
    """An EOS'd slot is refilled from the queue on tick N+2; the
    replacement's stream is untouched by the overrun."""
    _, _, pm = trio
    ps = U.prompts(6)
    ref = generate(pm, ps[0][None], 12)[0, len(ps[0]):].tolist()
    eos = ref[3]

    def run(pipeline, paged):
        eng = U.port_engine(pm, paged=paged, prefill_chunk=4,
                            pipeline=pipeline)
        reqs = [eng.submit(p, max_new_tokens=12, temperature=0.8 * (i % 2),
                           seed=i, eos_id=eos if i == 0 else None)
                for i, p in enumerate(ps)]
        eng.drain()
        return [r.stream.tokens(timeout=10) for r in reqs]

    for paged in (False, True):
        assert run(True, paged) == run(False, paged)


def test_paged_pipeline_no_double_admit_under_block_pressure(trio):
    """A pool sized so admission waits for finishes: slots and blocks
    are freed only at reconciliation, so the optimistic plan-ahead never
    admits against capacity an in-flight finish will free."""
    _, _, pm = trio
    rng = np.random.default_rng(3)
    ps = [rng.integers(0, U.V, size=9).astype(np.int32) for _ in range(6)]

    def run(pipeline):
        eng = U.port_engine(pm, paged=True, prefill_chunk=4,
                            pipeline=pipeline, num_blocks=8,
                            prefix_cache=False)
        out = U.serve(eng, ps, [dict(max_new_tokens=12, seed=i)
                                for i in range(len(ps))])
        return out, eng

    sync, _ = run(False)
    pipe, eng = run(True)
    assert pipe == sync and all(len(s) == 12 for s in pipe)
    assert eng.pool.in_use_count() == 0


def test_monolithic_slot_prefill_leaves_the_merged_row(trio):
    """The monolithic slot prefill replaces the WHOLE cache row, as the
    reference's merge does: a short prompt admitted into a slot a longer
    sequence used leaves zeros (int8: unit scales) past its length, its
    cursor at the prompt length, and K/V equal to the JAX engine's
    prefill of the same prompt."""
    jm, jparams, pm = U.pair(cache_dtype="model")
    long_p, short_p = U.prompts(2, system=16, tails=(20, 1))
    eng = U.port_engine(pm, slots=1, prefill_chunk=None)
    jeng = U.jax_engine(jm, jparams, slots=1, prefill_chunk=None)
    for e in (eng, jeng):
        U.serve(e, [long_p], U.greedy((4,)))
        e.submit(short_p, max_new_tokens=4)
        with torch.no_grad():
            e._admit()  # the monolithic prefill runs at admission
    Tp = len(short_p)
    L = eng._cache.length
    assert int(eng._cache.index[0]) == Tp
    jcache = U.jax.tree_util.tree_leaves_with_path(jeng._cache)
    jk = {U.jax.tree_util.keystr(p): np.asarray(v) for p, v in jcache}
    for i, layer in enumerate(eng._cache.layers):
        for name, jname in (("key", "cached_key"), ("value", "cached_value")):
            got = eng._cache.view(layer, name)[0].numpy()  # [L, Hk, hd]
            want = next(v for p, v in jk.items()
                        if f"Block_{i}'" in p and jname in p)[0]
            assert got.shape == want.shape == (L,) + got.shape[1:]
            assert not got[Tp:].any() and not want[Tp:].any()
            np.testing.assert_allclose(got[:Tp], want[:Tp], atol=1e-5)


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    tables = rng.integers(0, 9, size=(3, 4)).astype(np.int32)
    lens = rng.integers(0, 5, size=(3,)).astype(np.int32)
    fed = rng.integers(0, 64, size=(3, 6)).astype(np.int32)
    valid = rng.integers(0, 6, size=(3,)).astype(np.int32)
    mask = np.array([1, 0, 1], np.int32)
    packed = _pack_i32(tables, lens, fed, valid, mask)
    assert packed.dtype == np.int32 and packed.ndim == 1
    out = _unpack_i32(torch.from_numpy(packed),
                      ((3, 4), (3,), (3, 6), (3,), (3,)))
    for got, want in zip(out, (tables, lens, fed, valid, mask)):
        assert np.array_equal(got.numpy(), want)


def test_upload_reuses_unchanged_plan(trio):
    """An unchanged control plan is not uploaded again; a changed one
    is, into a fresh device buffer that never aliases the host array."""
    _, _, pm = trio
    eng = U.port_engine(pm, pipeline=True)
    host = np.arange(5, dtype=np.int32)
    a = eng._upload(host)
    assert eng._upload(np.arange(5, dtype=np.int32)) is a
    host[0] = 99
    assert int(a[0]) == 0
    assert eng._upload(np.arange(6, dtype=np.int32)) is not a


def test_flight_records_overlap_fields(trio):
    _, _, pm = trio
    ps = U.prompts()
    eng = U.port_engine(pm, pipeline=True)
    U.serve(eng, ps, U.greedy((12, 12, 12, 12)))
    snaps = [s for s in eng.flight.snapshots() if s["kind"] == "tick"]
    assert snaps and all(
        "device_wait_ms" in s and "dispatch_ms" in s
        and "pipeline_depth" in s and "overrun_tokens" in s for s in snaps)
    assert max(s["pipeline_depth"] for s in snaps) >= 1
    assert sum(s["overrun_tokens"] for s in snaps) >= 1
    assert eng.stats()["device_wait_ms"]["p50"] is not None


def test_monolithic_counts_decode_stalls(trio):
    """A monolithic prefill admitted while another row decodes stalls it
    (counted); the chunked engine never does."""
    _, _, pm = trio
    ps = U.prompts(3)
    mono = U.port_engine(pm, slots=2, prefill_chunk=None)
    U.serve(mono, ps, U.greedy((6, 6, 6)))
    assert mono.stats()["decode_stalls"] >= 1
    chunked = U.port_engine(pm, slots=2)
    U.serve(chunked, ps, U.greedy((6, 6, 6)))
    assert chunked.stats()["decode_stalls"] == 0


def test_expiry_during_flight(trio):
    """Requests whose deadline passes while ticks are in flight expire
    without admission (the stream's sentinel says so), and the served
    stream keeps its parity."""
    import time

    _, _, pm = trio
    ps = U.prompts(4)
    eng = U.port_engine(pm, slots=1, prefill_chunk=4, pipeline=True)
    keep = eng.submit(ps[0], max_new_tokens=20)
    doomed = [eng.submit(p, max_new_tokens=4, deadline_s=0.0)
              for p in ps[1:]]
    time.sleep(0.01)
    eng.drain()
    assert keep.stream.tokens(timeout=10) == generate(
        pm, ps[0][None], 20)[0, len(ps[0]):].tolist()
    for r in doomed:
        assert r.stream.tokens(timeout=10) == []
        assert r.stream.finish_reason == "expired"


def _sched():
    from distkeras_torch import telemetry
    from distkeras_torch.serving import FIFOScheduler

    return FIFOScheduler(registry=telemetry.MetricRegistry(),
                         tracer=telemetry.Tracer())


def _req(deadline_s=None):
    from distkeras_torch.serving import Request

    return Request(prompt=np.asarray((1, 2), np.int32), max_new_tokens=4,
                   deadline_s=deadline_s)


def test_head_blocked_short_circuit():
    """A head failing the admission gate twice running is short-
    circuited until ``note_capacity_change()`` — and expiry still
    sweeps it."""
    import time

    s = _sched()
    s.submit(_req())
    calls = [0]

    def gate(req):
        calls[0] += 1
        return False

    for _ in range(4):
        assert s.pop_admissible(1, admissible=gate) == ([], [])
    assert calls[0] == 2 and s.head_blocked_skips == 2
    s.note_capacity_change()
    admitted, _ = s.pop_admissible(1, admissible=lambda r: True)
    assert len(admitted) == 1 and s.depth() == 0
    s.submit(_req(deadline_s=0.01))
    s.pop_admissible(1, admissible=gate)
    s.pop_admissible(1, admissible=gate)
    time.sleep(0.02)
    admitted, expired = s.pop_admissible(1, admissible=gate)
    assert admitted == [] and len(expired) == 1
    assert expired[0].stream.tokens(timeout=5) == []
    assert expired[0].stream.finish_reason == "expired"


def test_engine_completion_invalidates_short_circuit(trio):
    """A paged pipelined engine whose gate keeps blocking the head (two
    slots, blocks for one request) engages the short-circuit, and a
    completion disarms it: every request finishes."""
    _, _, pm = trio
    eng = U.port_engine(pm, paged=True, prefill_chunk=4, num_blocks=5,
                        prefix_cache=False, pipeline=True)
    rng = np.random.default_rng(0)
    ps = [rng.integers(0, U.V, size=9).astype(np.int32) for _ in range(3)]
    out = U.serve(eng, ps, U.greedy((8, 8, 8)))
    assert all(len(t) == 8 for t in out)
    assert eng.scheduler.head_blocked_skips > 0
