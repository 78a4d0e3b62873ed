"""The port's sequence parallelism (``distkeras_torch.ops.ring_attention``,
``parallel.mesh``, ``parallel.collectives``, the model's
``attention='ring'``, the dp x sp LM step and ``LMTrainer``) on the CPU.

- A ring of one rank (no process group) against the JAX ring on a
  1-device mesh and against dense causal attention, values and
  gradients, with the pair op forced on (``DK_RING_PALLAS=1``: its plain
  version) and off (the blocked loop).
- Four gloo ranks (``torch.multiprocessing`` spawn, one spawn for the
  module running every case in turn, rendezvous through a file in
  ``tmp_path`` so parallel test workers never share a port): the port's
  zigzag and naive rings equal JAX's ring on the 4-device CPU mesh,
  values and gradients; ``TransformerLM`` with ``'ring'`` equals the standard model
  (logits and parameter gradients, global positions on every shard);
  three ``make_lm_train_step`` steps and an ``LMTrainer`` epoch on a
  dp=2 x sp=2 mesh give the losses and parameters of the unsharded
  port step; the step's gradients summed in flat buckets (one
  all-reduce a bucket) follow the per-parameter reduce within 1e-6,
  bit-identical across the ranks.

All in f32. Tolerances: 2e-5 on attention values, 1e-4 on gradients and
trained parameters (the ring sums in another order than the dense or
unsharded reference). The JAX side runs in this process; the ranks
import only torch and the port (this module imports jax lazily).
"""

import datetime
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from distkeras_torch.data.dataset import PartitionedDataset  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.ops import ring_attention as ra  # noqa: E402
from distkeras_torch.parallel import collectives as col  # noqa: E402
from distkeras_torch.parallel.mesh import (  # noqa: E402
    current_mesh,
    local_mesh,
    make_mesh,
)
from distkeras_torch.parallel.spmd import make_lm_train_step  # noqa: E402
from distkeras_torch.trainers import LMTrainer  # noqa: E402
from distkeras_torch.utils.losses import get_optimizer  # noqa: E402

WORLD = 4
TINY = dict(vocab_size=61, d_model=32, num_heads=2, num_layers=2,
            max_len=64, dtype=torch.float32, device="cpu")


def _qkv(seed, B=2, T=64, H=2, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, H, hd)).astype(np.float32)
            for _ in range(4)]  # q, k, v and an output cotangent


def _dense_causal(q, k, v):
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k)
    s = s / np.sqrt(q.shape[-1])
    T = q.shape[1]
    s = np.where(np.tril(np.ones((T, T), bool)), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


def _jax_ring(q, k, v, r, sp, causal=True, impl="auto"):
    """JAX's ring on an sp-device CPU mesh: (out, (dq, dk, dv)) of
    ``sum(out * r)``."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from distkeras_tpu.ops.ring_attention import ring_attention
    from distkeras_tpu.parallel.mesh import make_mesh as jax_mesh

    mesh = jax_mesh({"sp": sp})

    def run(q, k, v):
        return shard_map(
            lambda q, k, v: ring_attention(q, k, v, "sp", causal=causal,
                                           impl=impl),
            mesh=mesh, in_specs=(P(None, "sp"),) * 3,
            out_specs=P(None, "sp"))(q, k, v)

    args = [jnp.asarray(a) for a in (q, k, v)]
    out = jax.jit(run)(*args)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(run(q, k, v) * r),
                             argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_ring(q, k, v, r, group=None, shard=slice(None), **kw):
    ts = [torch.from_numpy(np.ascontiguousarray(a[:, shard]))
          .requires_grad_(True) for a in (q, k, v)]
    out = ra.ring_attention(*ts, group=group, **kw)
    (out * torch.from_numpy(np.ascontiguousarray(r[:, shard]))).sum() \
        .backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


# -- one rank ------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["zigzag", "naive"])
@pytest.mark.parametrize("flag", ["0", "1"])
def test_ring_of_one_matches_jax_and_dense(monkeypatch, impl, flag):
    q, k, v, r = _qkv(0)
    # the reference reads the same variable: its blocked loop is the
    # anchor (its forced pair kernel needs hd % 128 == 0)
    monkeypatch.delenv("DK_RING_PALLAS", raising=False)
    want_out, want_grads = _jax_ring(q, k, v, r, 1, impl=impl)
    monkeypatch.setenv("DK_RING_PALLAS", flag)
    out, grads = _port_ring(q, k, v, r, impl=impl)
    np.testing.assert_allclose(out, want_out, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, _dense_causal(q, k, v), rtol=2e-5,
                               atol=2e-5)
    for g, w, name in zip(grads, want_grads, "qkv"):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


def test_ring_gates_and_errors(monkeypatch):
    q, k, v, r = _qkv(1, T=18)  # C = 9
    x = torch.from_numpy(q)
    with pytest.raises(ValueError, match="ring impl"):
        ra.ring_attention(x, x, x, impl="ulysses")
    with pytest.raises(ValueError, match="zigzag"):
        ra.ring_attention(x, x, x, causal=False, impl="zigzag")
    odd = torch.from_numpy(_qkv(1, T=9)[0])
    with pytest.raises(ValueError, match="zigzag"):
        ra.ring_attention(odd, odd, odd, impl="zigzag")
    # auto falls back to the naive ring for an odd shard: still exact
    out = ra.ring_attention(odd, odd, odd).numpy()
    np.testing.assert_allclose(out, _dense_causal(*[odd.numpy()] * 3),
                               rtol=2e-5, atol=2e-5)
    # the pair-op gate: CUDA takes the Hopper gate, CPU only the override
    bf, f32 = torch.bfloat16, torch.float32
    monkeypatch.delenv("DK_RING_PALLAS", raising=False)
    assert ra._pair_kernel_block(1024, 256, bf, "cuda") == 64
    assert ra._pair_kernel_block(1024, 96, bf, "cuda") is None
    assert ra._pair_kernel_block(1024, 256, bf, "cpu") is None
    monkeypatch.setenv("DK_RING_PALLAS", "1")
    assert ra._pair_kernel_block(32, 16, f32, "cpu") == 64
    with pytest.raises(ValueError, match="DK_RING_PALLAS=1"):
        ra._pair_kernel_block(1024, 256, f32, "cuda")
    monkeypatch.setenv("DK_RING_PALLAS", "0")
    assert ra._pair_kernel_block(1024, 256, bf, "cuda") is None


def test_mesh_and_collectives_of_one():
    mesh = make_mesh({"dp": 1, "sp": 1})
    assert mesh.group("sp") is None and mesh.group() is None
    assert mesh.index("sp") == 0 and mesh.axis_size("dp") == 1
    with pytest.raises(ValueError, match="need 2 processes"):
        make_mesh({"dp": 2, "sp": 1})
    with pytest.raises(ValueError, match="no axes"):
        mesh.group("tp")
    assert current_mesh() is None
    with mesh:
        assert current_mesh() is mesh
    assert current_mesh() is None
    x = torch.arange(6.0)
    assert col.ppermute(x, [(0, 0)]) is x
    assert col.psum(x) is x
    with pytest.raises(ValueError, match="partial permutation"):
        col.ppermute(x, [(0, 1)])
    # the exchange and the gradient reduce of a group of one do nothing
    assert col.all_to_all(x[None]).data_ptr() == x.data_ptr()
    with pytest.raises(ValueError, match="leading axis"):
        col.all_to_all(x)
    p = torch.nn.Parameter(x.clone())
    assert col.reduce_grads([p]) == 0 and p.grad is None
    ring = get_model("transformer_lm", attention="ring", **TINY)
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="bound mesh"):
        ring(toks)
    with local_mesh({"dp": 1}):  # a mesh without the model's seq_axis
        with pytest.raises(ValueError, match="'sp' axis"):
            ring(toks)


# -- four gloo ranks -----------------------------------------------------------


def _entry(rank, name, init, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        globals()[name](rank, *args)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, worker, *args):
    """Run ``worker(rank, out, *args)`` on WORLD gloo ranks."""
    out = str(tmp_path)
    torch.multiprocessing.spawn(
        _entry, args=(worker.__name__, f"file://{out}/rendezvous",
                      (out,) + args),
        nprocs=WORLD)


def _saved(out):
    """Each rank's saved arrays under ``out``."""
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(WORLD)]


RING_CASES = (("zigzag-blocked", "zigzag", True, "0"),
              ("zigzag-pair", "zigzag", True, "1"),
              ("naive-causal", "naive", True, "0"),
              ("naive-full", "naive", False, "0"))


def _ring_worker(rank, out, q, k, v, r):
    T_l = q.shape[1] // WORLD
    shard = slice(rank * T_l, (rank + 1) * T_l)
    saved = {}
    for name, impl, causal, flag in RING_CASES:
        os.environ["DK_RING_PALLAS"] = flag
        o, grads = _port_ring(q, k, v, r, dist.group.WORLD, shard,
                              causal=causal, impl=impl)
        saved[name] = o
        for g, n in zip(grads, "qkv"):
            saved[f"{name}-d{n}"] = g
    np.savez(os.path.join(out, f"rank{rank}.npz"), **saved)


def test_four_rank_ring_matches_jax_ring(four_ranks):
    q, k, v, r = _qkv(2)
    ranks = four_ranks["ring"]
    for name, impl, causal, _ in RING_CASES:
        want_out, want_grads = _jax_ring(q, k, v, r, WORLD, causal=causal,
                                         impl=impl)
        got = np.concatenate([d[name] for d in ranks], axis=1)
        np.testing.assert_allclose(got, want_out, rtol=2e-5, atol=2e-5,
                                   err_msg=name)
        for n, w in zip("qkv", want_grads):
            g = np.concatenate([d[f"{name}-d{n}"] for d in ranks], axis=1)
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name} d{n}")


MODEL_CASES = (("sinusoidal", dict(pos_emb="sinusoidal")),
               ("rope-gqa", dict(pos_emb="rope", num_kv_heads=1)))


def _model_grads(model, toks, r):
    model.zero_grad(set_to_none=True)
    logits = model(torch.from_numpy(toks))
    (logits * torch.from_numpy(r)).sum().backward()
    return logits.detach().numpy(), {n: p.grad.numpy() for n, p in
                                     model.named_parameters()}


def _model_worker(rank, out, toks, r):
    T_l = toks.shape[1] // WORLD
    shard = slice(rank * T_l, (rank + 1) * T_l)
    saved = {}
    mesh = make_mesh({"sp": WORLD})
    for name, kw in MODEL_CASES:
        ring = get_model("transformer_lm", attention="ring", seed=7,
                         **kw, **TINY)
        with mesh:
            logits, grads = _model_grads(
                ring, np.ascontiguousarray(toks[:, shard]),
                np.ascontiguousarray(r[:, shard]))
        saved[name] = logits
        for n, g in grads.items():
            gt = torch.from_numpy(g)
            dist.all_reduce(gt)
            saved[f"{name}/{n}"] = gt.numpy()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **saved)


def _model_data():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, TINY["vocab_size"], size=(2, 64))
    r = rng.normal(size=(2, 64, TINY["vocab_size"])).astype(np.float32)
    return toks, r


def test_four_rank_transformer_ring_equals_standard(four_ranks):
    toks, r = _model_data()
    ranks = four_ranks["model"]
    for name, kw in MODEL_CASES:
        std = get_model("transformer_lm", seed=7, **kw, **TINY)
        logits, grads = _model_grads(std, toks, r)
        got = np.concatenate([d[name] for d in ranks], axis=1)
        np.testing.assert_allclose(got, logits, rtol=2e-5, atol=2e-5,
                                   err_msg=name)
        for n, g in grads.items():
            np.testing.assert_allclose(ranks[0][f"{name}/{n}"], g,
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name} {n}")


def _params(model):
    return {n: p.detach().numpy().copy() for n, p in
            model.named_parameters()}


def _train_worker(rank, out, batches, rows):
    mesh = make_mesh({"dp": 2, "sp": 2})
    ring = get_model("transformer_lm", attention="ring", seed=5, **TINY)
    calls = col.reduce_grads.calls
    step = make_lm_train_step(ring, get_optimizer("sgd", 0.1), mesh=mesh,
                              window=True)
    saved = {"losses": step(batches).numpy()}
    saved["allreduces"] = np.asarray(col.reduce_grads.calls - calls)
    saved.update({f"step/{n}": a for n, a in _params(ring).items()})
    # the per-parameter reduce (one all-reduce a gradient), as before the
    # bucketed one: buckets of one byte hold one gradient each
    leaf = get_model("transformer_lm", attention="ring", seed=5, **TINY)
    step = make_lm_train_step(leaf, get_optimizer("sgd", 0.1), mesh=mesh,
                              window=True)
    bucket, col.GRAD_BUCKET_BYTES = col.GRAD_BUCKET_BYTES, 1
    try:
        saved["per_leaf_losses"] = step(batches).numpy()
    finally:
        col.GRAD_BUCKET_BYTES = bucket
    saved.update({f"per_leaf/{n}": a for n, a in _params(leaf).items()})
    model = get_model("transformer_lm", attention="ring", seed=6, **TINY)
    trainer = LMTrainer(model, worker_optimizer="sgd", learning_rate=0.1,
                        batch_size=4, axes={"dp": 2, "sp": 2})
    trained = trainer.train(PartitionedDataset.from_arrays({"tokens": rows}))
    saved["history"] = np.asarray([h["loss"] for h in trainer.history])
    saved.update({f"trainer/{n}": a for n, a in _params(model).items()})
    assert trained.module.attention == "standard"
    np.savez(os.path.join(out, f"rank{rank}.npz"), **saved)


def _train_data():
    rng = np.random.default_rng(4)
    batches = rng.integers(0, TINY["vocab_size"], size=(3, 4, 32))
    rows = rng.integers(0, TINY["vocab_size"], size=(12, 32))
    return batches, rows


def _all_worker(rank, out, ring, model, train):
    """Every four-rank case in turn, each saving under its own
    directory; the ring cases' pair-op flag is dropped after them."""
    _ring_worker(rank, os.path.join(out, "ring"), *ring)
    os.environ.pop("DK_RING_PALLAS", None)
    _model_worker(rank, os.path.join(out, "model"), *model)
    _train_worker(rank, os.path.join(out, "train"), *train)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One spawn of the four ranks for the module (the pair-op flag unset
    in the parent, so the ranks start from the default)."""
    out = tmp_path_factory.mktemp("four_ranks")
    for name in ("ring", "model", "train"):
        (out / name).mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("DK_RING_PALLAS", raising=False)
        _spawn(out, _all_worker, _qkv(2), _model_data(), _train_data())
    return {name: _saved(str(out / name))
            for name in ("ring", "model", "train")}


@pytest.fixture(scope="module")
def train_ranks(four_ranks):
    return four_ranks["train"]


def test_dp2_sp2_step_and_trainer_match_unsharded(train_ranks):
    batches, rows = _train_data()
    ranks = train_ranks

    std = get_model("transformer_lm", seed=5, **TINY)
    want = make_lm_train_step(std, get_optimizer("sgd", 0.1),
                              window=True)(batches).numpy()
    model = get_model("transformer_lm", seed=6, **TINY)
    trainer = LMTrainer(model, worker_optimizer="sgd", learning_rate=0.1,
                        batch_size=4)
    trainer.train(PartitionedDataset.from_arrays({"tokens": rows}))
    hist = np.asarray([h["loss"] for h in trainer.history])
    for d in ranks:  # every rank holds the same replica and losses
        np.testing.assert_allclose(d["losses"], want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(d["history"], hist, rtol=1e-4,
                                   atol=1e-4)
        for prefix, m in (("step", std), ("trainer", model)):
            for n, a in _params(m).items():
                np.testing.assert_allclose(d[f"{prefix}/{n}"], a, rtol=1e-4,
                                           atol=1e-4,
                                           err_msg=f"{prefix} {n}")


def test_dp2_sp2_bucketed_reduce_matches_the_per_leaf_reduce(train_ranks):
    """The step's gradients summed in flat buckets (one all-reduce a
    bucket: one here, every gradient f32 and the model small) give the
    per-parameter reduce's trajectory within 1e-6, every replica bit for
    bit the same."""
    n_params = len(list(get_model("transformer_lm", **TINY).parameters()))
    for d in train_ranks:
        assert int(d["allreduces"]) == 3  # one bucket a step, 3 steps
        np.testing.assert_allclose(d["losses"], d["per_leaf_losses"],
                                   rtol=0, atol=1e-6)
        for n in _params(get_model("transformer_lm", **TINY)):
            np.testing.assert_allclose(d[f"step/{n}"], d[f"per_leaf/{n}"],
                                       rtol=0, atol=1e-6, err_msg=n)
    assert n_params > 3
    for d in train_ranks[1:]:
        np.testing.assert_array_equal(d["losses"], train_ranks[0]["losses"])
        for n in _params(get_model("transformer_lm", **TINY)):
            np.testing.assert_array_equal(d[f"step/{n}"],
                                          train_ranks[0][f"step/{n}"])
