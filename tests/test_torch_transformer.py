"""Port TransformerLM (distkeras_torch/models/transformer.py) against the
reference flax module on the same weights: JAX ``init`` ->
``bridge.params_from_jax`` -> port, at f32 on the CPU.

- non-decode logits over MHA/GQA x rope/sinusoidal agree to 1e-4;
- the weight bridge round-trips exactly;
- greedy ``generate()`` token streams equal JAX ``generate()`` on the
  model-dtype and int8 KV-cache configurations;
- features the port defers raise ``NotImplementedError``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distkeras_tpu.models import get_model as jax_get_model  # noqa: E402
from distkeras_tpu.models.transformer import generate as jax_generate  # noqa: E402
from distkeras_torch import bridge  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.models import transformer as tt  # noqa: E402

BASE = dict(vocab_size=97, d_model=64, num_heads=4, num_layers=2,
            max_len=64)


def _pair(seed=0, **over):
    """The reference module, its numpy weights, and the port module
    loaded with them (f32, CPU)."""
    kw = dict(BASE)
    kw.update(over)
    jm = jax_get_model("transformer_lm", dtype=jnp.float32, **kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32))
    np_params = jax.tree.map(np.asarray, params)
    pm = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                   **kw)
    bridge.params_from_jax(np_params, pm)
    return jm, params, np_params, pm


@pytest.mark.parametrize("kv_heads", [None, 2])
@pytest.mark.parametrize("pos_emb", ["sinusoidal", "rope"])
def test_logits_match_jax(kv_heads, pos_emb):
    jm, params, _, pm = _pair(num_kv_heads=kv_heads, pos_emb=pos_emb)
    toks = np.random.default_rng(0).integers(0, 97, size=(2, 24)).astype(
        np.int32)
    want = np.asarray(jm.apply(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = pm(torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4


def test_features_only_matches_jax():
    jm, params, _, pm = _pair(num_kv_heads=2, pos_emb="rope")
    toks = np.random.default_rng(1).integers(0, 97, size=(1, 9)).astype(
        np.int32)
    want = np.asarray(jm.clone(features_only=True).apply(
        params, jnp.asarray(toks)))
    with torch.no_grad():
        got = pm.clone(features_only=True)(torch.from_numpy(toks)).numpy()
    assert np.abs(got - want).max() <= 1e-4


def test_bridge_round_trip_is_exact():
    _, _, np_params, pm = _pair(num_kv_heads=2)
    back = bridge.params_to_jax(pm)
    flat_a = jax.tree_util.tree_leaves_with_path(np_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    # and the reference module runs on the round-tripped tree
    jax_get_model("transformer_lm", dtype=jnp.float32, num_kv_heads=2,
                  **BASE).apply(jax.tree.map(jnp.asarray, back),
                                jnp.zeros((1, 3), jnp.int32))


def test_bridge_rejects_partial_trees():
    _, _, np_params, pm = _pair()
    partial = {"params": dict(np_params["params"])}
    del partial["params"]["ln_f"]
    with pytest.raises(KeyError):
        bridge.params_from_jax(partial, pm)


@pytest.mark.parametrize("cache_dtype", ["model", "int8"])
@pytest.mark.parametrize("kv_heads,pos_emb", [(None, "sinusoidal"),
                                              (2, "rope")])
def test_greedy_generate_matches_jax(cache_dtype, kv_heads, pos_emb):
    jm, params, _, pm = _pair(num_kv_heads=kv_heads, pos_emb=pos_emb,
                              cache_dtype=cache_dtype)
    prompt = np.random.default_rng(2).integers(0, 97, size=(2, 7)).astype(
        np.int32)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompt), 12))
    got = tt.generate(pm, prompt, 12).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_eos_steps_match_jax():
    jm, params, _, pm = _pair(num_kv_heads=2, pos_emb="rope")
    prompt = np.random.default_rng(3).integers(0, 97, size=(1, 5)).astype(
        np.int32)
    free = tt.generate(pm, prompt, 10).numpy()[0, 5:]
    eos = int(free[3])
    want, want_steps = jax_generate(jm, params, jnp.asarray(prompt), 10,
                                    eos_id=eos, return_steps=True)
    got, steps = tt.generate(pm, prompt, 10, eos_id=eos, return_steps=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == want_steps


def test_sampled_generate_is_seeded():
    _, _, _, pm = _pair()
    prompt = np.arange(5, dtype=np.int32)[None]
    a = tt.generate(pm, prompt, 8, temperature=0.9, seed=4, top_k=10,
                    top_p=0.9).numpy()
    b = tt.generate(pm, prompt, 8, temperature=0.9, seed=4, top_k=10,
                    top_p=0.9).numpy()
    np.testing.assert_array_equal(a, b)


def test_filter_logits_matches_jax():
    from distkeras_tpu.models.transformer import filter_logits

    x = np.random.default_rng(5).normal(size=(3, 50)).astype(np.float32)
    for kw in (dict(top_k=7), dict(top_p=0.8), dict(top_k=12, top_p=0.6)):
        want = np.asarray(filter_logits(jnp.asarray(x), 0.7, **kw))
        got = tt.filter_logits(torch.from_numpy(x), 0.7, **kw).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


def test_clone_shares_parameters():
    _, _, _, pm = _pair()
    dm = pm.clone(decode=True, paged=True, num_pages=4)
    assert dm.embed is pm.embed and dm.blocks is pm.blocks
    assert not pm.decode and dm.decode
    with pytest.raises(ValueError):
        pm.clone(d_model=32)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("transformer_lm", **BASE)


@pytest.mark.parametrize("what", ["beam_search", "moe_lm", "remat", "tp",
                                  "ring", "blocked", "pallas", "long_t"])
def test_deferred_features_raise(what):
    kw = dict(BASE, dtype=torch.float32, device="cpu")
    if what == "beam_search":
        with pytest.raises(NotImplementedError, match="A5"):
            tt.beam_search(get_model("transformer_lm", **kw),
                           np.zeros((1, 2), np.int32), 3)
    elif what == "moe_lm":
        with pytest.raises(NotImplementedError, match="A10"):
            get_model("moe_lm", **kw)
    elif what == "remat":
        with pytest.raises(NotImplementedError, match="A4"):
            get_model("transformer_lm", remat="block", **kw)
    elif what == "tp":
        with pytest.raises(NotImplementedError, match="A10"):
            get_model("transformer_lm", tp_size=2, **kw)
    elif what == "long_t":
        m = get_model("transformer_lm", **dict(kw, max_len=1024))
        with pytest.raises(NotImplementedError, match="A2"):
            m(torch.zeros((1, 513), dtype=torch.long))
    else:
        m = get_model("transformer_lm", attention=what, **kw)
        with pytest.raises(NotImplementedError, match="A10" if what == "ring"
                           else "B1"):
            m(torch.zeros((1, 4), dtype=torch.long))
