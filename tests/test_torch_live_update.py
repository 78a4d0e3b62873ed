"""Port ServingEngine's live weight swap (``update_weights``) on the CPU:
the swap lands at the tick boundary — a request served before it equals
``generate()`` on the old weights, one submitted before it but ticked
after equals ``generate()`` on the new weights (and the JAX engine's
stream after the same swap), a mid-stream swap neither corrupts nor
drops the stream — across the paged, pipelined, slot and speculative
engines; the version stays monotonic; a mismatched tree is refused with
a typed ``WeightPushError`` naming its first leaf before anything is
touched."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401

from distkeras_torch import bridge, telemetry  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.models.transformer import generate  # noqa: E402
from distkeras_torch.serving.weights import (  # noqa: E402
    WeightPushError,
    validate_like,
)

PROMPT = np.arange(1, 9, dtype=np.int32)


@pytest.fixture(scope="module")
def weights():
    """(jax module, params A, params B, port model on A, flax-layout
    numpy trees A and B)."""
    jm, pa, pm = U.pair(seed=0)
    _, pb, _ = U.pair(seed=1)
    ta = U.jax.tree.map(np.asarray, pa)
    tb = U.jax.tree.map(np.asarray, pb)
    return jm, pa, pb, pm, ta, tb


def _fresh(ta):
    pm = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                   **U.KW)
    bridge.params_from_jax(ta, pm)
    return pm


def _ref(pm_tree, n):
    pm = _fresh(pm_tree)
    return generate(pm, PROMPT[None], n)[0, len(PROMPT):].tolist()


@pytest.mark.parametrize("mode", ["paged", "pipelined", "slot", "spec"])
def test_swap_boundary_parity(weights, mode):
    jm, pa, pb, _, ta, tb = weights
    kw = {"paged": dict(paged=True, block_size=16),
          "pipelined": dict(paged=True, block_size=16, pipeline=True),
          "slot": {}, "spec": dict(draft="ngram", spec_k=2)}[mode]
    eng = U.port_engine(_fresh(ta), **kw)
    r0 = eng.submit(PROMPT, max_new_tokens=8)
    eng.drain()
    assert r0.stream.tokens() == _ref(ta, 8)
    r1 = eng.submit(PROMPT, max_new_tokens=8)
    eng.update_weights(tb)
    eng.drain()
    t1 = r1.stream.tokens()
    assert t1 == _ref(tb, 8)
    if mode == "pipelined":
        # the JAX engine in the same mode, after the same swap
        jeng = U.jax_engine(jm, pa, **kw)
        jeng.submit(PROMPT, max_new_tokens=8)
        jeng.drain()
        j1 = jeng.submit(PROMPT, max_new_tokens=8)
        jeng.update_weights(pb)
        jeng.drain()
        assert t1 == j1.stream.tokens()
    r2 = eng.submit(PROMPT, max_new_tokens=24)
    for _ in range(6):
        eng.step()
    eng.update_weights(ta)
    eng.drain()
    toks = r2.stream.tokens()
    assert len(toks) == 24 and r2.stream.finish_reason == "length"
    r3 = eng.submit(PROMPT, max_new_tokens=8)
    eng.drain()
    assert r3.stream.tokens() == _ref(ta, 8)
    assert eng.weight_version == 3 and eng.weight_swaps == 2


@pytest.mark.parametrize("host_blocks", [None, 32])
def test_swap_equals_an_engine_built_on_the_new_weights(weights,
                                                        host_blocks):
    """Mixed greedy / sampled streams after a swap equal those of an
    engine built on the new weights, bit for bit — though the prompts
    share a full-block prefix the old weights cached: the swap retires
    the prefix cache (device blocks and host entries), where the
    reference would serve the stale K/V."""
    _, _, _, _, ta, tb = weights
    ps = U.prompts()
    kw = dict(paged=True, host_blocks=host_blocks,
              num_blocks=None if host_blocks is None else 24)
    eng = U.port_engine(_fresh(ta), **kw)
    U.serve(eng, ps, U.MIXED)
    hits = eng.stats()["prefix_hit_tokens"]
    assert hits > 0
    eng.update_weights(tb)
    assert eng.pool.stats()["in_use"] == 0
    got = U.serve(eng, ps, U.MIXED)
    assert got == U.serve(U.port_engine(_fresh(tb), **kw), ps, U.MIXED)
    # the new weights' own prefix is cached again after the swap
    assert eng.stats()["prefix_hit_tokens"] > hits


def test_swap_version_monotonic_and_telemetry(weights):
    _, _, _, _, ta, tb = weights
    eng = U.port_engine(_fresh(ta))
    assert eng.weight_version == 1
    assert eng.update_weights(tb, version=10)["version"] == 10
    assert eng.update_weights(ta, version=4)["version"] == 11
    assert eng.update_weights(tb["params"])["version"] == 12  # bare tree
    assert eng.weight_swaps == 3
    reg = eng.registry
    assert reg.gauge("serving_weight_version").value == 12
    assert reg.counter("serving_weight_swaps_total").value == 3
    assert reg.get("serving_weight_swap_ms").snapshot()["series"][0][
        "count"] == 3
    r = eng.submit(PROMPT, max_new_tokens=4)
    eng.drain()
    r.stream.tokens()
    spans = {s["span"]: s for s in eng.tracer.dump(trace=r.trace_id)}
    assert spans["finish"]["wv"] == 12 and spans["decode"]["wv"] == 12
    ticks = eng.flight.snapshots()
    assert ticks and all(t["weight_version"] == 12 for t in ticks)
    assert eng.stats()["weight_version"] == 12


def test_validation_refusals_name_first_leaf(weights):
    _, _, _, _, ta, tb = weights
    pm = _fresh(ta)
    eng = U.port_engine(pm)
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}

    def mutate(fn):
        out = U.jax.tree.map(lambda x: x, tb)
        emb = out["params"]["Block_0"]["LayerNorm_0"]
        emb["bias"] = fn(emb["bias"])
        return out

    with pytest.raises(WeightPushError) as ei:
        eng.update_weights(mutate(lambda a: np.zeros(a.shape + (1,),
                                                     a.dtype)))
    assert "shape" in str(ei.value) and "Block_0" in ei.value.leaf
    with pytest.raises(WeightPushError, match="dtype"):
        eng.update_weights(mutate(lambda a: a.astype(np.float64)))
    with pytest.raises(WeightPushError, match="missing leaf"):
        eng.update_weights({"params": {"nothing": np.zeros(2, np.float32)}})
    extra = U.jax.tree.map(lambda x: x, tb)
    extra["params"]["bonus"] = np.zeros((2,), np.float32)
    with pytest.raises(WeightPushError, match="unknown leaf"):
        eng.update_weights(extra)
    assert eng.weight_version == 1 and eng.weight_swaps == 0
    for n, p in pm.named_parameters():
        assert torch.equal(p, before[n]), n
    r = eng.submit(PROMPT, max_new_tokens=6)
    eng.drain()
    assert r.stream.tokens() == _ref(ta, 6)


def test_validate_like_order_and_torch_leaves():
    """The first mismatch in flatten order (sorted keys) is the one
    named; torch tensors validate like numpy arrays."""
    cur = {"params": {"b": np.zeros(3, np.float32),
                      "a": np.zeros(2, np.float32)}}
    new = {"params": {"a": torch.zeros(5), "b": torch.zeros(4)}}
    with pytest.raises(WeightPushError) as ei:
        validate_like(cur, new)
    assert ei.value.leaf == "['params']['a']"
    validate_like(cur, {"params": {"a": torch.zeros(2),
                                   "b": np.ones(3, np.float32)}})
    with pytest.raises(WeightPushError, match="dtype"):
        validate_like(cur, {"params": {"a": torch.zeros(2,
                                                        dtype=torch.bfloat16),
                                       "b": np.ones(3, np.float32)}})


def test_role_and_set_role(weights):
    _, _, _, _, ta, _ = weights
    eng = U.port_engine(_fresh(ta), role="prefill")
    assert eng.stats()["role"] == "prefill"
    assert eng.set_role("decode") == "decode"
    assert eng.stats()["role"] == "decode"
    with pytest.raises(ValueError, match="unknown role"):
        eng.set_role("oracle")
    with pytest.raises(ValueError, match="Unknown role"):
        U.port_engine(_fresh(ta), role="oracle")
    assert [e["action"] for e in eng.journal.events()].count(
        "reconfigure") == 1
