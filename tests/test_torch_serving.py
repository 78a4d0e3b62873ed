"""Port ServingEngine (distkeras_torch/serving/engine.py) on the CPU,
slot and paged layouts, chunked prefill (chunk 8), more requests than
slots and a shared full-block system prefix:

- greedy streams equal the reference JAX engine's greedy streams
  (``prefill_kernel``/``paged_kernel='gather'``) on the same weights;
- mixed greedy / temperature / top-k / top-p streams equal the port's
  own ``generate()`` with the same seeds (the engine samples each slot
  on a ``[1, vocab]`` slice with its own generator);
- the paged layout hits the prefix cache, and with
  ``prefix_cache=False`` returns every block after drain;
- what is not a serving mesh is refused, and ``LMServer`` over a mesh
  of one position serves as the mesh-less server does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distkeras_tpu import telemetry as jax_telemetry  # noqa: E402
from distkeras_tpu.models import get_model as jax_get_model  # noqa: E402
from distkeras_tpu.serving import ServingEngine as JaxEngine  # noqa: E402
from distkeras_torch import bridge, telemetry  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.models.transformer import generate  # noqa: E402
from distkeras_torch.parallel.mesh import local_mesh  # noqa: E402
from distkeras_torch.serving import ServingEngine  # noqa: E402
from torch_lockorder_util import lock_order  # noqa: E402,F401
from torch_spawn_util import one_thread  # noqa: E402,F401

KW = dict(vocab_size=97, d_model=64, num_heads=4, num_layers=2, max_len=64,
          num_kv_heads=2, pos_emb="rope")


def _pair(**over):
    kw = dict(KW)
    kw.update(over)
    jm = jax_get_model("transformer_lm", dtype=jnp.float32, **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    pm = get_model("transformer_lm", dtype=torch.float32, device="cpu", **kw)
    bridge.params_from_jax(jax.tree.map(np.asarray, params), pm)
    return jm, params, pm


def _prompts(n=5):
    """A 16-token system prefix (two full 8-token blocks) shared by every
    prompt, then a private tail."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, 97, size=16)
    return [np.concatenate([system, rng.integers(0, 97, size=k)]).astype(
        np.int32) for k in (3, 9, 5, 12, 7)[:n]]


def _port_engine(pm, **kw):
    return ServingEngine(pm, slots=2, prefill_chunk=8, block_size=8,
                         device="cpu", registry=telemetry.MetricRegistry(),
                         tracer=telemetry.Tracer(), **kw)


def _serve(eng, prompts, cfgs):
    reqs = [eng.submit(p, **c) for p, c in zip(prompts, cfgs)]
    eng.drain()
    return [r.stream.tokens(timeout=10) for r in reqs]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("cache_dtype", ["model", "int8"])
def test_greedy_streams_equal_jax_engine(paged, cache_dtype):
    jm, params, pm = _pair(cache_dtype=cache_dtype)
    prompts = _prompts()
    cfgs = [dict(max_new_tokens=n) for n in (6, 9, 4, 7, 5)]
    jeng = JaxEngine(jm, params, slots=2, prefill_chunk=8, paged=paged,
                     block_size=8, paged_kernel="gather",
                     prefill_kernel="gather",
                     registry=jax_telemetry.MetricRegistry(),
                     tracer=jax_telemetry.Tracer())
    want = _serve(jeng, prompts, cfgs)
    got = _serve(_port_engine(pm, paged=paged), prompts, cfgs)
    assert got == want


@pytest.mark.parametrize("paged", [False, True])
def test_mixed_sampling_streams_equal_own_generate(paged):
    _, _, pm = _pair(cache_dtype="int8")
    prompts = _prompts()
    cfgs = [
        dict(max_new_tokens=6),
        dict(max_new_tokens=9, temperature=1.0, seed=7),
        dict(max_new_tokens=5, temperature=0.8, seed=3, top_k=8),
        dict(max_new_tokens=7, temperature=0.9, seed=11, top_p=0.9),
        dict(max_new_tokens=4, temperature=0.7, seed=5, top_k=20,
             top_p=0.8),
    ]
    eng = _port_engine(pm, paged=paged)
    got = _serve(eng, prompts, cfgs)
    for p, c, toks in zip(prompts, cfgs, got):
        ref = generate(pm, p[None], c["max_new_tokens"],
                       temperature=c.get("temperature", 0.0),
                       seed=c.get("seed", 0), top_k=c.get("top_k"),
                       top_p=c.get("top_p"))
        assert toks == ref[0, len(p):].tolist()
    st = eng.stats()
    assert st["requests_completed"] == 5 and st["mean_occupancy"] > 1.0
    if paged:
        assert st["prefix_hit_tokens"] > 0


def test_eos_stops_stream():
    _, _, pm = _pair()
    p = _prompts(1)[0]
    free = generate(pm, p[None], 8)[0, len(p):].tolist()
    eos = free[3]
    eng = _port_engine(pm, paged=True)
    r = eng.submit(p, max_new_tokens=8, eos_id=eos)
    eng.drain()
    toks = r.stream.tokens(timeout=10)
    assert toks == free[:free.index(eos) + 1]
    assert r.stream.finish_reason == "eos"


def test_paged_pool_is_clean_after_drain():
    _, _, pm = _pair(cache_dtype="int8")
    eng = _port_engine(pm, paged=True, prefix_cache=False)
    _serve(eng, _prompts(), [dict(max_new_tokens=5)] * 5)
    assert eng.pool.stats()["live"] == 0
    assert not eng.pool.ref.any()
    assert eng.pool.free_count() == eng.pool.num_blocks - 1


def test_mid_block_divergence_copies_on_write():
    """A prompt sharing 12 tokens of the system prefix (one full block
    plus half of the next) reuses the first block and copies the second
    before writing its own tail — streams still equal generate()."""
    _, _, pm = _pair()
    p0 = _prompts(1)[0]
    p1 = np.concatenate([p0[:12], np.asarray([1, 2, 3, 4, 5], np.int32)])
    eng = _port_engine(pm, paged=True)
    first = _serve(eng, [p0], [dict(max_new_tokens=4)])
    second = _serve(eng, [p1], [dict(max_new_tokens=6)])
    assert first[0] == generate(pm, p0[None], 4)[0, len(p0):].tolist()
    assert second[0] == generate(pm, p1[None], 6)[0, len(p1):].tolist()
    assert eng.stats()["prefix_hit_tokens"] == 12


@pytest.mark.parametrize("kw,match", [
    (dict(mesh=object()), "make_mesh"),
    (dict(mesh=local_mesh({"dp": 1})), "no 'model' axis"),
])
def test_deferred_engine_options_raise(kw, match):
    """mesh= is ported (tests/test_torch_tp_serving.py): what is not a
    serving mesh is refused."""
    _, _, pm = _pair()
    with pytest.raises(ValueError, match=match):
        ServingEngine(pm, **kw)


@pytest.mark.parametrize("item", ["A11c"])
def test_deferred_engine_methods_raise(item):
    """What ROADMAP A11c deferred is ported: LMServer serves a mesh=
    engine (tp > 1 across ranks in tests/test_torch_tp_server.py). Over
    a mesh of one position it is the mesh-less server: the same streams,
    greedy and sampled, token for token."""
    from distkeras_torch.serving import LMServer, ServingClient

    _, _, pm = _pair()
    prompts = _prompts(3)
    cfgs = [dict(max_new_tokens=6),
            dict(max_new_tokens=5, temperature=1.0, seed=3),
            dict(max_new_tokens=7, temperature=0.8, seed=5, top_k=8)]
    streams = []
    for where in (dict(mesh=local_mesh({"model": 1})), dict(device="cpu")):
        eng = ServingEngine(pm, slots=2, prefill_chunk=8, block_size=8,
                            paged=True, registry=telemetry.MetricRegistry(),
                            tracer=telemetry.Tracer(), **where)
        srv = LMServer(eng).start()
        try:
            assert srv.leader and srv.port
            c = ServingClient("127.0.0.1", srv.port, timeout=60,
                              request_timeout=60)
            rids = [c.generate(p, **cfg) for p, cfg in zip(prompts, cfgs)]
            streams.append([c.result(r) for r in rids])
            c.close()
        finally:
            srv.stop()
    assert streams[0] == streams[1]
    assert all(r == "length" for _, r in streams[0])


def test_engine_refuses_a_model_on_another_device():
    _, _, pm = _pair()
    if torch.cuda.is_available():
        with pytest.raises(ValueError):
            ServingEngine(pm, device="cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(pm)
