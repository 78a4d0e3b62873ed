"""Port TransformerLM (distkeras_torch/models/transformer.py) against the
reference flax module on the same weights: JAX ``init`` ->
``bridge.params_from_jax`` -> port, at f32 on the CPU.

- non-decode logits over MHA/GQA x rope/sinusoidal agree to 1e-4;
- the weight bridge round-trips exactly;
- greedy ``generate()`` token streams equal JAX ``generate()`` on the
  model-dtype and int8 KV-cache configurations;
- training-mode attention above the dense limit (T=640: ``'standard'``
  takes the blocked op on the CPU, as the reference does off-TPU) gives
  the reference's logits (1e-4) and parameter gradients (1e-4 of each
  gradient's max: the same blocked algorithm, sums in another order);
  the explicit ``'blocked'`` and ``'pallas'`` modes agree with the
  reference's (the Pallas kernels in interpret mode);
- features the port defers raise ``NotImplementedError``; those ported
  since run.
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
from torch_spawn_util import one_thread  # noqa: E402,F401

BASE = dict(vocab_size=97, d_model=64, num_heads=4, num_layers=2,
            max_len=64)


def _pair(seed=0, init_len=4, **over):
    """The reference module, its numpy weights, and the port module
    loaded with them (f32, CPU)."""
    kw = dict(BASE)
    kw.update(over)
    jm = jax_get_model("transformer_lm", dtype=jnp.float32, **kw)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, init_len), jnp.int32))
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


def _logits_and_grads(apply_j, params, pm, toks):
    """Logits and parameter gradients of ``sum(logits * cot)`` on both
    sides, the port's gradients in the flax layout."""
    cot = np.random.default_rng(7).normal(
        size=toks.shape + (BASE["vocab_size"],)).astype(np.float32)

    def loss(p):
        return jnp.sum(apply_j(p, jnp.asarray(toks)) * cot)

    want = np.asarray(jax.jit(apply_j)(params, jnp.asarray(toks)))
    jgrads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params))
    pm.zero_grad(set_to_none=True)
    logits = pm(torch.from_numpy(toks))
    (logits * torch.from_numpy(cot)).sum().backward()
    tgrads = {"params": {}}
    for name, p in pm.named_parameters():
        node = tgrads["params"]
        path = bridge._jax_path(name)
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.grad.numpy()
    return logits.detach().numpy(), want, tgrads, jgrads


def _assert_grads_close(tgrads, jgrads, tol):
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tgrads))
    flat_j = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(flat_t) == len(flat_j)
    for path, want in flat_j:
        got = flat_t[path]
        assert got.dtype == np.float32
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got - want).max() <= tol * scale, path


def test_long_sequence_logits_and_grads_match_jax():
    """T=640 > the dense limit: 'standard' is the blocked op on both
    sides here (the port's kernels serve CUDA tensors only); GQA and
    rope, so the KV-head repeat runs before the attention call."""
    jm, params, _, pm = _pair(num_kv_heads=2, pos_emb="rope", max_len=640,
                              d_model=128)
    toks = np.random.default_rng(8).integers(0, 97, size=(1, 640)).astype(
        np.int32)
    got, want, tgrads, jgrads = _logits_and_grads(jm.apply, params, pm,
                                                  toks)
    assert np.abs(got - want).max() <= 1e-4
    _assert_grads_close(tgrads, jgrads, 1e-4)


@pytest.mark.parametrize("mode", ["blocked", "pallas"])
def test_explicit_attention_modes_match_jax(mode):
    """hd=128, T=128: the reference's Pallas kernels (interpret mode)
    take this shape at their clamped block; the port's 'pallas' mode on
    CPU tensors is the kernels' dense plain version."""
    jm, params, _, pm = _pair(attention=mode, d_model=256, num_heads=2,
                              max_len=128, init_len=128)
    toks = np.random.default_rng(9).integers(0, 97, size=(1, 128)).astype(
        np.int32)
    got, want, tgrads, jgrads = _logits_and_grads(jm.apply, params, pm,
                                                  toks)
    assert np.abs(got - want).max() <= 1e-4
    _assert_grads_close(tgrads, jgrads, 1e-4)


@pytest.mark.parametrize("what", ["moe_lm", "remat", "tp",
                                  "ring", "blocked", "pallas", "long_t"])
def test_deferred_features_raise(what):
    """Features once deferred: remat, the blocked and pallas modes and
    T > 512 (deferred before the training slice) now run, and so does
    the ring inside a mesh (deferred before the sequence-parallel
    slice); tp_size > 1 needs a bound mesh (deferred before the
    tensor-parallel slice), and so does ep_size > 1; a ``moe_lm`` builds
    and runs, returning one aux loss a layer (deferred before the
    pipeline and expert-parallel slice)."""
    kw = dict(BASE, dtype=torch.float32, device="cpu")
    if what == "moe_lm":
        m = get_model("moe_lm", **dict(kw, moe_experts=4))
        toks = torch.zeros((2, 4), dtype=torch.long)
        logits, auxes = m(toks, return_aux=True)
        assert logits.shape == (2, 4, 97) and len(auxes) == BASE[
            "num_layers"]
        assert all(torch.isfinite(a) for a in auxes)
        torch.testing.assert_close(m(toks), logits)
        with pytest.raises(ValueError, match="bound mesh"):
            get_model("moe_lm", ep_size=2, **dict(kw, moe_experts=4))
    elif what == "remat":
        m = get_model("transformer_lm", remat="block", **kw)
        assert m(torch.zeros((1, 4), dtype=torch.long)).shape == (1, 4, 97)
        with pytest.raises(ValueError, match="remat"):
            get_model("transformer_lm", remat="full", **kw)
    elif what == "tp":
        # ported now: a tp model is built and run inside a bound mesh
        with pytest.raises(ValueError, match="bound mesh"):
            get_model("transformer_lm", tp_size=2, **kw)
    elif what == "long_t":
        m = get_model("transformer_lm", **dict(kw, max_len=1024))
        assert m(torch.zeros((1, 513), dtype=torch.long)).shape == (
            1, 513, 97)
    elif what == "ring":
        from distkeras_torch.parallel.mesh import make_mesh

        m = get_model("transformer_lm", attention=what, **kw)
        toks = torch.zeros((1, 4), dtype=torch.long)
        with pytest.raises(ValueError, match="bound mesh"):
            m(toks)  # the ring shards over a mesh's sp axis
        with make_mesh({"dp": 1, "sp": 1}):
            got = m(toks)
        want = m.clone(attention="standard")(toks)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        m = get_model("transformer_lm", attention=what, **kw)
        assert m(torch.zeros((1, 4), dtype=torch.long)).shape == (1, 4, 97)


def test_remat_recompute_rebinds_the_forward_mesh():
    """A block's recompute under ``remat='block'`` reads its groups from
    the mesh bound at the forward, even where the backward runs outside
    ``with mesh:`` or in another thread (autograd's device thread on a
    card binds no mesh): the gradients equal the stored-activation
    ones. The ring model reads its sp group from the bound mesh."""
    import threading

    from distkeras_torch.parallel.mesh import make_mesh

    kw = dict(BASE, dtype=torch.float32, device="cpu", attention="ring")
    m = get_model("transformer_lm", remat="block", **kw)
    plain = m.clone(remat="none")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, 97, size=(2, 16)))
    mesh = make_mesh({"dp": 1, "sp": 1})
    with mesh:
        want_loss = plain(toks).square().mean()
    want_loss.backward()
    want = {n: p.grad.clone() for n, p in m.named_parameters()}
    m.zero_grad(set_to_none=True)
    with mesh:
        loss = m(toks).square().mean()
    errors = []

    def backward():
        try:
            loss.backward()
        except BaseException as e:  # reported on the test's thread
            errors.append(e)

    t = threading.Thread(target=backward)
    t.start()
    t.join()
    assert not errors, errors
    for n, p in m.named_parameters():
        torch.testing.assert_close(p.grad, want[n], rtol=1e-6, atol=1e-7,
                                   msg=n)
