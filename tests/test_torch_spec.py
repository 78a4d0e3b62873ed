"""Port ServingEngine's speculative decoding (``draft="ngram"`` or a draft
``TransformerLM``) on the CPU, slot and paged layouts, and sampled
streams in distribution:

- greedy streams equal the JAX engine's speculative streams (n-gram and
  model drafts, the same draft weights bridged) and the port's plain
  engine's, sync and pipelined;
- sampled speculative streams are identical across cache layouts;
- chi-square at the 0.001 critical value, fixed seeds: the port's
  ``generate()`` sampled marginals against JAX's ``generate()``, and the
  speculative engine's against the plain engine's (n-gram and model
  draft — the rejection-sampling residual at work);
- EOS inside an accepted prefix, budget sharing with chunked prefill,
  rollback leaking no block, telemetry and validation.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401

from distkeras_torch import telemetry  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.models.transformer import generate  # noqa: E402
from distkeras_torch.serving import FIFOScheduler, ServingEngine  # noqa: E402
from distkeras_torch.serving.engine import _ngram_propose  # noqa: E402

DRAFT_KW = dict(d_model=32, num_heads=2, num_layers=1)


@pytest.fixture(scope="module")
def setup():
    """(jax model, params, port model, jax draft, draft params, port
    draft) on shared weights."""
    jm, params, pm = U.pair(cache_dtype="int8")
    jd, dparams, pd = U.pair(seed=7, **DRAFT_KW)
    return jm, params, pm, jd, dparams, pd


def _prompts():
    rng = np.random.default_rng(1)
    # repetitive tails give the n-gram drafter matches to propose
    base = rng.integers(0, U.V, size=6)
    return [np.concatenate([base, base[:k], rng.integers(0, U.V, size=3)])
            .astype(np.int32) for k in (2, 5, 4, 6)]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_spec_greedy_equals_jax_engine(setup, paged, kind):
    jm, params, pm, jd, dparams, pd = setup
    ps = _prompts()
    cfgs = U.greedy((12, 9, 14, 7))
    jkw = (dict(draft="ngram") if kind == "ngram"
           else dict(draft=jd, draft_params=dparams))
    want = U.serve(U.jax_engine(jm, params, paged=paged, spec_k=3, **jkw),
                   ps, cfgs)
    eng = U.port_engine(pm, paged=paged, spec_k=3,
                        draft="ngram" if kind == "ngram" else pd)
    assert U.serve(eng, ps, cfgs) == want
    assert eng.stats()["draft_tokens"] > 0


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kind", ["ngram", "model"])
@pytest.mark.parametrize("pipeline", [False, True])
def test_spec_greedy_equals_plain_engine(setup, paged, kind, pipeline):
    _, _, pm, _, _, pd = setup
    ps = _prompts()
    cfgs = [dict(c, eos_id=None) for c in U.greedy((12, 9, 14, 7))]
    plain = U.serve(U.port_engine(pm, paged=paged), ps, cfgs)
    eng = U.port_engine(pm, paged=paged, spec_k=4, pipeline=pipeline,
                        draft="ngram" if kind == "ngram" else pd)
    assert U.serve(eng, ps, cfgs) == plain
    st = eng.stats()
    assert st["draft"] == kind and 0.0 <= st["acceptance_rate"] <= 1.0


@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_spec_sampled_streams_identical_across_layouts(setup, kind):
    """Sampled speculative streams equal each other across the slot and
    paged layouts: accept draws and the residual ride each slot's own
    generator, consumed identically on both."""
    _, _, pm, _, _, pd = setup
    ps = _prompts()

    def run(paged, pipeline=False):
        eng = U.port_engine(pm, paged=paged, spec_k=3, pipeline=pipeline,
                            draft="ngram" if kind == "ngram" else pd)
        return U.serve(eng, ps, U.MIXED)

    slot = run(False)
    assert slot == run(True) == run(True, pipeline=True)


# -- sampled streams in distribution ---------------------------------------


def _tiny(seed):
    return U.pair(seed, base={}, vocab_size=16, d_model=16, num_heads=2,
                  num_layers=1, max_len=16)


def test_generate_marginals_match_jax():
    """The port's ``generate()`` sampled marginals at each of 3 positions
    (2,000 rows; temperature 0.9 with top-k 12 and top-p 0.95, so both
    filters act) against the reference's ``generate()`` on the same
    weights: chi-square below the 0.001 critical value (df 15).
    Threefry and Philox streams differ, so this holds distributions, not
    bits."""
    from distkeras_tpu.models.transformer import generate as jgenerate

    jm, params, pm = _tiny(0)
    prompt = np.random.default_rng(0).integers(0, 16, size=4)
    rows = np.tile(prompt, (2000, 1)).astype(np.int32)
    cfg = dict(temperature=0.9, top_k=12, top_p=0.95)
    want = np.asarray(jgenerate(jm, params, U.jnp.asarray(rows), 3,
                                seed=3, **cfg))[:, 4:]
    got = generate(pm, rows, 3, seed=3, **cfg)[:, 4:].numpy()
    for pos in range(3):
        stat = U.chi2_two_sample(got[:, pos], want[:, pos], 16)
        assert stat < U.CHI2_CRIT[15], (pos, stat)


def _marginals(pm, prompt, n, t, **spec_kw):
    eng = ServingEngine(
        pm, slots=8, prefill_chunk=4, device="cpu",
        registry=telemetry.MetricRegistry(), tracer=telemetry.Tracer(),
        scheduler=FIFOScheduler(max_queue_depth=n + 1,
                                registry=telemetry.MetricRegistry(),
                                tracer=telemetry.Tracer()),
        **spec_kw)
    reqs = [eng.submit(prompt, max_new_tokens=t, temperature=1.0,
                       seed=1000 + i) for i in range(n)]
    eng.drain()
    return np.array([r.stream.tokens(timeout=10) for r in reqs]), eng


@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_spec_rejection_sampling_marginals(kind):
    """Per-position token marginals through the speculative engine match
    the plain engine's (whose streams equal solo generate()): the
    n-gram drafter's one-hot q makes the residual fire constantly; a
    random draft model's full q makes ``norm(max(p - q, 0))`` dominate.
    Fixed seeds: deterministic, not a flaky statistical test."""
    _, _, pm = _tiny(0)
    prompt = np.random.default_rng(0).integers(0, 16, size=4).astype(
        np.int32)
    n, t = 250, 3
    base, _ = _marginals(pm, prompt, n, t)
    draft = "ngram" if kind == "ngram" else _tiny(5)[2]
    spec, eng = _marginals(pm, prompt, n, t, draft=draft, spec_k=3)
    assert eng.stats()["draft_tokens"] > 0
    for pos in range(t):
        stat = U.chi2_two_sample(base[:, pos], spec[:, pos], 16)
        assert stat < U.CHI2_CRIT[15], (pos, stat)


# -- engine behaviour -------------------------------------------------------


def test_eos_inside_accepted_prefix_same_tick_refill(setup):
    """A window can carry the eos mid-prefix: the stream truncates at
    it, the finish reason is 'eos', and the freed slot refills in the
    same step."""
    _, _, pm, _, _, _ = setup
    p0, p1 = _prompts()[:2]
    probe = generate(pm, p0[None], 10)[0, len(p0):].tolist()
    eos = probe[4]
    eng = U.port_engine(pm, slots=1, prefill_chunk=4, draft="ngram",
                        spec_k=4)
    r0 = eng.submit(p0, max_new_tokens=10, eos_id=eos)
    r1 = eng.submit(p1, max_new_tokens=4)
    while eng.scheduler.depth() > 0 or r0.stream.finish_reason is None:
        before = eng.slot_requests
        if not eng.step():
            break
        if r0.stream.finish_reason is not None and before[0] == r0.rid:
            assert eng.slot_requests[0] == r1.rid
            break
    eng.drain()
    assert r0.stream.tokens(timeout=10) == probe[:probe.index(eos) + 1]
    assert r0.stream.finish_reason == "eos"
    assert r1.stream.tokens(timeout=10) == generate(
        pm, p1[None], 4)[0, len(p1):].tolist()


def test_spec_and_chunked_prefill_share_budget(setup):
    """Verify tokens charge the tick budget with prompt chunks: decode
    reserves first, prefill progresses, windows shrink — streams stay
    exact."""
    _, _, pm, _, _, _ = setup
    rng = np.random.default_rng(3)
    short = rng.integers(0, U.V, size=4).astype(np.int32)
    longp = rng.integers(0, U.V, size=24).astype(np.int32)
    sched = FIFOScheduler(tick_token_budget=6,
                          registry=telemetry.MetricRegistry(),
                          tracer=telemetry.Tracer())
    eng = U.port_engine(pm, slots=2, prefill_chunk=4, scheduler=sched,
                        draft="ngram", spec_k=4)
    got = U.serve(eng, [short, longp], U.greedy((16, 4)))
    assert got == [generate(pm, p[None], n)[0, len(p):].tolist()
                   for p, n in ((short, 16), (longp, 4))]


def test_block_pool_leaks_nothing_after_spec_ticks(setup):
    """Rejected-draft rollback under pressure: windows straddle block
    boundaries (block_size 4 < spec_k + 1) with a random model draft;
    the drained pool returns every block."""
    _, _, pm, _, _, pd = setup
    rng = np.random.default_rng(4)
    eng = U.port_engine(pm, paged=True, block_size=4, prefill_chunk=4,
                        draft=pd, spec_k=6, prefix_cache=False)
    for _ in range(6):
        reqs = [eng.submit(rng.integers(0, U.V, size=int(n)).astype(
                    np.int32), max_new_tokens=int(m))
                for n, m in zip(rng.integers(3, 14, size=4),
                                rng.integers(4, 20, size=4))]
        eng.drain()
        for r in reqs:
            r.stream.tokens(timeout=10)
    st = eng.pool.stats()
    assert st["live"] == 0 and st["in_use"] == 0
    assert st["free"] == st["total"] and not eng.pool.ref.any()


def test_spec_telemetry_exposed(setup):
    _, _, pm, _, _, _ = setup
    eng = U.port_engine(pm, draft="ngram", spec_k=3)
    U.serve(eng, _prompts(), U.greedy((10, 10, 10, 10)))
    st = eng.stats()
    assert st["draft_tokens"] > 0
    assert 0 <= st["accepted_tokens"] <= st["draft_tokens"]
    snaps = [s for s in eng.flight.snapshots() if "draft_tokens" in s]
    assert snaps and sum(s["draft_tokens"] for s in snaps) == (
        st["draft_tokens"])
    reg = eng.registry
    assert reg.counter("serving_draft_tokens_total").value == (
        st["draft_tokens"])


def test_spec_validation(setup):
    _, _, pm, _, _, _ = setup
    with pytest.raises(ValueError, match="chunked prefill"):
        U.port_engine(pm, draft="ngram", prefill_chunk=None)
    with pytest.raises(ValueError, match="Unknown draft"):
        U.port_engine(pm, draft="bigram")
    with pytest.raises(ValueError, match="spec_k"):
        U.port_engine(pm, draft="ngram", spec_k=0)
    other = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                      **dict(U.KW, vocab_size=50))
    with pytest.raises(ValueError, match="vocab_size"):
        U.port_engine(pm, draft=other)
    with pytest.raises(TypeError):
        U.port_engine(pm, draft=other, draft_params={})


def test_ngram_propose():
    h = np.asarray([1, 2, 3, 1, 2], np.int32)
    toks, found = _ngram_propose(h, 3)
    assert found == 3 and toks.tolist() == [3, 1, 2]
    toks, found = _ngram_propose(np.asarray([4, 4], np.int32), 3)
    assert found == 3 and toks.tolist() == [4, 4, 4]
    toks, found = _ngram_propose(np.asarray([1, 2, 3], np.int32), 2)
    assert found == 0 and toks.tolist() == [0, 0]


def test_block_accounting_with_prefix_cache_under_spec(setup):
    """Rollback pressure with the radix prefix cache on: cached blocks
    may stay allocated, but in_use always decomposes into live + cached
    and live returns to 0 at drain."""
    _, _, pm, _, _, _ = setup
    rng = np.random.default_rng(5)
    system = rng.integers(0, U.V, size=8).astype(np.int32)
    eng = U.port_engine(pm, paged=True, block_size=4, prefill_chunk=4,
                        draft="ngram", spec_k=6)
    for _ in range(4):
        U.serve(eng, [np.concatenate([system, rng.integers(
            0, U.V, size=3).astype(np.int32)]) for _ in range(3)],
            U.greedy((8, 8, 8)))
    st = eng.pool.stats()
    assert st["live"] == 0 and st["in_use"] == st["cached"]
    assert eng.stats()["prefix_hit_tokens"] > 0


def test_plan_spec_allocation():
    """The port's scheduler deals verify windows after decodes and
    prompt chunks, as the reference's does."""
    sched = FIFOScheduler(tick_token_budget=12,
                          registry=telemetry.MetricRegistry(),
                          tracer=telemetry.Tracer())
    takes, widths = sched.plan_spec(2, [20], 8, [4, 4])
    assert takes == [8] and widths == [2, 0]
    takes, widths = sched.plan_spec(2, [], 8, [4, 4])
    assert takes == [] and widths == [4, 4]
