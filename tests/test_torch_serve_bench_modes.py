"""``distkeras_torch.serve_bench``'s seven single-engine modes on the CPU
(``device='cpu'``: the plain PyTorch path), held against the reference's
``benchmarks/serve_bench.py``:

- every trace helper and inline draw equals the reference's, for three
  seeds;
- the shared-prefix smoke over the same weights in both packages gives
  the same hit counts, evictions and config;
- each mode's smoke records every exact check as held;
- one ``_overfit_cycle`` step equals the reference's jitted optax step;
- the bare ``--smoke`` CLI (the shared-prefix smoke) exits 0;
- an injected fault (a multi-step engine that drops a token, a splash
  stand-in that launches a new configuration on every call) makes the
  smoke raise, naming the check.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from distkeras_torch import serve_bench as sb  # noqa: E402
from torch_spawn_util import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module", autouse=True)
def overfit_once():
    """Three speculative smokes overfit the same model (the same initial
    weights, cycle and steps): the first trains it, the later ones load
    the weights that training left (bit for bit what theirs would leave)
    and its last loss. Calls with other weights, or with ``starts``,
    train."""
    import hashlib

    real, memo = sb._overfit_cycle, {}

    def key(model, corpus, train_steps, kw):
        h = hashlib.sha256(np.ascontiguousarray(corpus).tobytes())
        for name, p in model.state_dict().items():
            h.update(name.encode())
            h.update(p.detach().cpu().numpy().tobytes())
        return h.hexdigest(), train_steps, tuple(sorted(kw.items()))

    def overfit(model, corpus, train_steps, **kw):
        if kw.get("starts") is not None:
            return real(model, corpus, train_steps, **kw)
        k = key(model, corpus, train_steps, kw)
        if k not in memo:
            loss = real(model, corpus, train_steps, **kw)
            memo[k] = ({n: t.detach().clone()
                        for n, t in model.state_dict().items()}, loss)
        state, loss = memo[k]
        model.load_state_dict(state)
        return loss

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sb, "_overfit_cycle", overfit)
        yield


@pytest.fixture(scope="module")
def ref():
    """The reference's ``benchmarks/serve_bench.py``, imported as its own
    tests import it."""
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    import serve_bench

    return serve_bench


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(a, b))
    return a == b and type(a) is type(b)


# -- (a) traces ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_trace_helpers_equal_the_reference(ref, seed):
    assert _same(sb._trace(12, 16, 1024, 0.002, seed=seed),
                 ref._trace(12, 16, 1024, 0.002, seed=seed))
    assert _same(sb._prefix_trace(16, 32, 4, 64, seed=seed),
                 ref._prefix_trace(16, 32, 4, 64, seed=seed))
    assert _same(sb._tier_trace(6, 3, 32, 4, 64, seed=seed),
                 ref._tier_trace(6, 3, 32, 4, 64, seed=seed))


def _ref_interference(V, n_short, short_prompt, short_new, n_long,
                      long_prompt, seed):
    # benchmarks/serve_bench.py:536-546 (inline in the reference)
    rng = np.random.default_rng(seed)
    shorts = [rng.integers(0, V, size=short_prompt).astype(np.int32)
              for _ in range(n_short)]
    short_lens = rng.integers(max(2, short_new // 2), short_new + 1,
                              size=n_short)
    longs = [rng.integers(0, V, size=long_prompt).astype(np.int32)
             for _ in range(n_long)]
    return shorts, short_lens, longs


def _ref_spec(V, period, n_requests, max_new, seed):
    # benchmarks/serve_bench.py:811-813 and :838-841 (inline; the model's
    # init and training between them draw nothing from ``rng``)
    rng = np.random.default_rng(seed)
    cycle = rng.integers(0, V, size=period).astype(np.int32)
    corpus = np.tile(cycle, 64)
    lens = rng.integers(max(4, max_new // 2), max_new + 1,
                        size=n_requests)
    prompts = [np.concatenate([cycle, cycle[:int(o)]]).astype(np.int32)
               for o in rng.integers(1, period, size=n_requests)]
    return cycle, corpus, lens, prompts


def _ref_mixed(V, n_requests, prompt_len, max_new, seed):
    # benchmarks/serve_bench.py:1039-1044 (pipeline) and :1187-1192
    # (multi-step), the same lines in both
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, V, size=prompt_len).astype(np.int32)
               for _ in range(n_requests)]
    lens = rng.integers(max(4, max_new // 2), max_new + 1,
                        size=n_requests)
    temps = [0.0 if i % 2 == 0 else 0.8 for i in range(n_requests)]
    return prompts, lens, temps


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_inline_draws_equal_the_reference(seed):
    args = (1024, 24, 16, 32, 6, 1024)
    assert _same(sb._interference_trace(*args, seed=seed),
                 _ref_interference(*args, seed))
    assert _same(sb._spec_trace(64, 8, 12, 48, seed=seed),
                 _ref_spec(64, 8, 12, 48, seed))
    assert _same(sb._mixed_requests(1024, 16, 16, 48, seed=seed),
                 _ref_mixed(1024, 16, 16, 48, seed))


def test_default_seeds_are_the_references():
    """The modes draw with the reference's seeds (0, 7, 0)."""
    assert _same(sb._interference_trace(64, 8, 8, 8, 3, 1024),
                 _ref_interference(64, 8, 8, 8, 3, 1024, 0))
    assert _same(sb._spec_trace(64, 8, 6, 32), _ref_spec(64, 8, 6, 32, 7))
    assert _same(sb._mixed_requests(64, 8, 8, 24),
                 _ref_mixed(64, 8, 8, 24, 0))


# -- (b) across packages -------------------------------------------------------


def test_shared_prefix_smoke_matches_the_reference(ref, monkeypatch, capsys):
    """Both packages' ``bench_shared_prefix(smoke=True)`` over the JAX
    model's ``init(PRNGKey(0))`` weights: the same hit fraction, hit
    tokens, evictions and config, and no steady-state recompile."""
    import jax
    import jax.numpy as jnp

    from distkeras_tpu.models import get_model

    def jax_tree(seed, **kw):
        kw = dict(kw, dtype=jnp.float32)
        model = get_model("transformer_lm", **kw)
        params = model.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 4), jnp.int32))
        return jax.tree.map(np.asarray, params)

    monkeypatch.setattr(sb, "_tree", jax_tree)
    want = ref.bench_shared_prefix(smoke=True)
    got = sb.bench_shared_prefix(smoke=True, device="cpu")
    for key in ("prefix_hit_fraction", "prefix_hit_tokens",
                "block_evictions", "config"):
        assert got[key] == want[key], key
    assert got["steady_recompiles"] == want["steady_recompiles"] == {}
    assert all(got["checks"]["exact"].values())
    capsys.readouterr()


# -- (c) each mode's smoke -----------------------------------------------------

_SMOKES = {
    # the Poisson bench has no smoke sizes: narrow it by its keywords
    "bench": dict(V=64, D=32, H=2, L=2, slots=2, n_requests=6),
    "bench_shared_prefix": dict(smoke=True),
    "bench_host_tier": dict(smoke=True),
    "bench_long_prompt_interference": dict(smoke=True),
    "bench_speculative": dict(smoke=True),
    # the two-model drafter: a small port TransformerLM passed as draft=
    "bench_speculative[model]": dict(smoke=True, draft="model"),
    "bench_pipeline": dict(smoke=True),
    "bench_multistep": dict(smoke=True),
}


@pytest.mark.parametrize("mode", list(_SMOKES))
def test_smoke_holds_every_exact_check(mode, capsys):
    fn = getattr(sb, mode.split("[")[0])
    r = fn(device="cpu", checks=False, **_SMOKES[mode])
    exact = r["checks"]["exact"]
    assert exact and all(exact.values()), exact
    assert set(r["checks"]) == {"exact", "timing"}
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")][-1]
    assert json.loads(line)["checks"] == r["checks"]


# -- (d) one training step -----------------------------------------------------


def test_overfit_step_matches_the_reference(ref):
    """One ``_overfit_cycle`` step from the same weights on the same batch
    (the reference's own threefry starts, handed to the port) leaves
    every parameter within 1e-5 of the reference's jitted optax step."""
    import jax

    from distkeras_torch import bridge
    from torch_engine_util import pair

    jm, params, pm = pair(seed=0, vocab_size=64, d_model=32, num_heads=2,
                          num_layers=1, max_len=64, attention="dense")
    corpus = np.tile(np.random.default_rng(7).integers(
        0, 64, size=8).astype(np.int32), 64)
    T, B = 32, 8
    # the reference's draw (benchmarks/serve_bench.py:768-772)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    starts = np.asarray(jax.random.randint(sub, (B,), 0,
                                           len(corpus) - T - 1))
    want, want_loss = ref._overfit_cycle(jm, params, corpus, 1)
    got_loss = sb._overfit_cycle(pm, corpus, 1, starts=[starts])
    assert abs(got_loss - want_loss) <= 1e-5
    got = bridge.params_to_jax(pm)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        np.testing.assert_allclose(flat_g[path], np.asarray(leaf),
                                   rtol=0, atol=1e-5, err_msg=str(path))


# -- (e) the CLI ---------------------------------------------------------------


def test_cli_bare_smoke_is_the_shared_prefix_smoke():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "distkeras_torch.serve_bench", "--smoke",
         "--no-checks", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads([ln for ln in out.stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert res["config"].endswith("-bs8-float32-smoke")
    assert "prefix_hit_fraction" in res
    assert res["checks"]["exact"] and all(res["checks"]["exact"].values())


# -- (f) injected faults -------------------------------------------------------


def _drop_a_multistep_token(monkeypatch):
    """A multi-step engine drops the third token of the first request of
    every pass (the one submitted with seed 0)."""
    from distkeras_torch.serving import ServingEngine

    real = ServingEngine.submit

    def submit(self, *a, **kw):
        req = real(self, *a, **kw)
        if self.multi_step_k > 1 and kw.get("seed") == 0:
            put, seen = req.stream._put, [0]

            def dropping(tok):
                seen[0] += 1
                if seen[0] != 3:
                    put(tok)
            req.stream._put = dropping
        return req

    monkeypatch.setattr(ServingEngine, "submit", submit)
    return "bench_multistep", ["parity"]


def _splash_relaunches(monkeypatch):
    """The splash kernel stood in (its gate passes, as on a card) by its
    plain version that notes a new launch configuration on every call."""
    from distkeras_torch.kernels import build
    from distkeras_torch.ops import splash_prefill as sp

    calls = [0]

    def standin(q, keys, vals, starts):
        calls[0] += 1
        build.note_launch("standin_splash", (calls[0],))
        return sp.splash_prefill_reference(q, keys, vals, starts)

    monkeypatch.setattr(sp, "splash_prefill_attention", standin)
    monkeypatch.setattr(sp, "preferred",
                        lambda T, hd, L, device=None: sp.supports(T, hd, L))
    return "bench_speculative", ["spec_steady_recompiles == {}",
                                 "baseline_steady_recompiles == {}"]


@pytest.mark.parametrize("fault", [_drop_a_multistep_token,
                                   _splash_relaunches])
def test_smoke_raises_on_an_injected_fault(monkeypatch, capsys, fault):
    mode, names = fault(monkeypatch)
    with pytest.raises(AssertionError) as err:
        getattr(sb, mode)(smoke=True, device="cpu")
    failed = re.search(r"self-checks failed: (\[.*?\]); result",
                       str(err.value)).group(1)
    for name in names:
        assert repr(name) in failed, (name, failed)
    capsys.readouterr()
