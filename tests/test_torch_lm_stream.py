"""``LMTrainer`` over a disk-sharded corpus on the CPU
(``distkeras_torch/trainers.py``): the materialize-or-stream choice, the
streamed trajectory, checkpoint resume and the multi-process stride
arithmetic, against the port's in-memory run and the JAX package:

- a corpus under ``stage_limit_bytes`` loads; over it, it streams in
  windows, and the history equals the in-memory run's bit for bit
  (``shuffle=False``); the first window follows the jitted reference
  ``lm_bench`` step (``one``, as ``tests/test_torch_training.py`` holds
  the in-memory trainer; the reference's ``LMTrainer`` itself raises on
  this JAX build) within 1e-4;
- ``shuffle=True`` streams the reference's ``_stream_steps`` batches
  (the two-level per-epoch reshuffle), token for token;
- a streamed run stopped after epoch 1 resumes to epoch 2 on the
  trajectory of a run that never stopped, bit for bit (AdamW with its
  bf16 first moment);
- ``_shard_slice`` gives each replica group the reference's stride and
  step cap, and ``replica_groups`` the reference's grouping for the
  port's one-process-per-position meshes;
- two gloo ranks (``axes={"dp": 2}``, one ``torch.multiprocessing``
  spawn) each stream their dp group's stride, ``batch_size / 2`` rows a
  step, and end with equal weights that equal (1e-5: the all-reduce
  sums in another order) one process trained on the same global
  batches.
"""

import datetime
import os


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from distkeras_torch.data.dataset import PartitionedDataset  # noqa: E402
from distkeras_torch.data.shard_io import (ShardedDataset,  # noqa: E402
                                           write_shards)
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.ops import rules  # noqa: E402
from distkeras_torch.trainers import LMTrainer  # noqa: E402
from distkeras_torch.utils.losses import get_optimizer  # noqa: E402

TINY = dict(vocab_size=61, d_model=32, num_heads=2, num_layers=2,
            max_len=16)


def _lm(seed=0):
    return get_model("transformer_lm", dtype=torch.float32, device="cpu",
                     seed=seed, **TINY)


def _corpus(tmp_path, n=44, rows=10, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], size=(n, 16)).astype(np.int32)
    d = write_shards(PartitionedDataset.from_arrays({"tokens": toks}),
                     str(tmp_path / "s"), rows)
    return toks, ShardedDataset(d)


def test_small_corpus_loads_large_one_streams(tmp_path):
    toks, sd = _corpus(tmp_path)
    ds, sharded = LMTrainer(_lm(), batch_size=4)._maybe_materialize(sd)
    assert not sharded and isinstance(ds, PartitionedDataset)
    np.testing.assert_array_equal(ds.column("tokens"), toks)
    ds, sharded = LMTrainer(_lm(), batch_size=4,
                            stage_limit_bytes=1)._maybe_materialize(sd)
    assert sharded and ds is sd


def test_streamed_history_equals_in_memory_and_follows_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    import optax

    from distkeras_tpu.models import get_model as jax_get_model
    from distkeras_tpu.ops import fused_ce as jce
    from distkeras_torch import bridge

    torch.set_num_threads(1)
    toks, sd = _corpus(tmp_path)
    jm = jax_get_model("transformer_lm", dtype=jnp.float32, **TINY)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 4), jnp.int32)))
    kw = dict(batch_size=4, num_epoch=2, learning_rate=3e-3, params=params,
              worker_optimizer=get_optimizer("adamw", 3e-3,
                                             mu_dtype=torch.bfloat16))
    mem = LMTrainer(_lm(), **kw)
    mem.train(PartitionedDataset.from_arrays({"tokens": toks}))
    disk = LMTrainer(_lm(), stage_limit_bytes=1, **dict(
        kw, worker_optimizer=get_optimizer("adamw", 3e-3,
                                           mu_dtype=torch.bfloat16)))
    disk.STREAM_GROUP = 4
    disk.train(sd)
    assert len(mem.history) == 2 * (44 // 4)
    assert disk.history == mem.history
    for k, v in rules.flatten(mem.params).items():
        np.testing.assert_array_equal(rules.flatten(disk.params)[k], v)

    # the reference lm_bench step (bench.py · lm_bench's `one`), jitted
    feat = jm.clone(features_only=True)
    opt = optax.adamw(3e-3, mu_dtype=jnp.bfloat16)

    def loss_fn(p, tok):
        feats = feat.apply(p, tok)
        targets = jnp.concatenate([tok[:, 1:], jnp.zeros_like(tok[:, :1])],
                                  axis=1)
        mask = jnp.ones(tok.shape, jnp.float32).at[:, -1].set(0.0)
        s, n = jce.lm_head_loss(feats, p["params"]["head"], targets, mask)
        return s / n

    @jax.jit
    def one(p, s, tok):
        loss, grads = jax.value_and_grad(loss_fn)(p, tok)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    p, s = jax.tree.map(jnp.asarray, params), opt.init(params)
    want = []
    for b in range(LMTrainer.STREAM_GROUP if 44 // 4 > 16 else 44 // 4):
        p, s, loss = one(p, s, jnp.asarray(toks[b * 4:(b + 1) * 4]))
        want.append(float(loss))
    got = [r["loss"] for r in disk.history[:len(want)]]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.all(np.isfinite([r["loss"] for r in disk.history]))
    bridge.params_to_jax(disk.model)


def test_shuffled_stream_is_the_references(tmp_path):
    import jax.numpy as jnp

    from distkeras_tpu.data.shard_io import ShardedDataset as JSD
    from distkeras_tpu.models import get_model as jax_get_model
    from distkeras_tpu.trainers import LMTrainer as JLMTrainer

    _, sd = _corpus(tmp_path, seed=3)
    port = LMTrainer(_lm(), batch_size=4, seed=9)
    ref = JLMTrainer(jax_get_model("transformer_lm", dtype=jnp.float32,
                                   **TINY), batch_size=4, seed=9)
    for epoch in (0, 1):
        got = list(port._stream_steps(sd, 4, True, epoch, None, None))
        want = list(ref._stream_steps(JSD(sd.directory), 4, True, epoch,
                                      None, None))
        assert len(got) == len(want) == 44 // 4  # leftovers carry over
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_streamed_resume_equals_an_uninterrupted_run(tmp_path):
    from distkeras_torch.checkpoint import Checkpointer

    torch.set_num_threads(1)
    _, sd = _corpus(tmp_path, seed=4)

    def run(epochs, ck=None):
        t = LMTrainer(_lm(), batch_size=4, num_epoch=epochs,
                      stage_limit_bytes=1, checkpointer=ck,
                      worker_optimizer=get_optimizer(
                          "adamw", 1e-2, mu_dtype=torch.bfloat16))
        t.train(sd, shuffle=True)
        return t

    whole = run(2)
    ck = str(tmp_path / "ck")
    first = run(1, Checkpointer(ck, every_steps=1))
    resumed = run(2, Checkpointer(ck, every_steps=1))
    assert first.history == whole.history[:len(first.history)]
    assert resumed.history == whole.history[len(first.history):]
    for k, v in rules.flatten(whole.params).items():
        np.testing.assert_array_equal(rules.flatten(resumed.params)[k], v)
    step, state = Checkpointer(ck).restore()
    assert step == 2 and state["extra"] == {"epoch": 2}
    mus = [s["mu"] for s in state["opt_state"]["state"].values()]
    assert mus and all(m.dtype == torch.bfloat16 for m in mus)


def test_shard_slice_and_replica_groups_follow_the_reference(tmp_path,
                                                            monkeypatch):
    from distkeras_torch.parallel.mesh import Mesh, replica_groups

    rng = np.random.default_rng(0)
    rows = [7, 9, 4, 12, 5]
    parts = [{"tokens": rng.integers(0, 9, size=(r, 16)).astype(np.int32)}
             for r in rows]
    sd = ShardedDataset(write_shards(PartitionedDataset(parts),
                                     str(tmp_path / "r")))
    tr = LMTrainer(_lm(), batch_size=4)
    assert tr._shard_slice(sd, 2, group=(0, 2)) == (None, None)  # 1 process
    monkeypatch.setattr(LMTrainer, "_world", staticmethod(lambda: 4))
    for gid in (0, 1):
        shards, cap = tr._shard_slice(sd, 2, group=(gid, 2))
        assert shards == list(range(gid, 5, 2))
        assert cap == min((7 + 4 + 5) // 2, (9 + 12) // 2)
    with pytest.raises(ValueError, match="shards"):
        tr._shard_slice(sd, 2, group=(0, 6))
    with pytest.raises(ValueError, match="fewer rows"):
        tr._shard_slice(sd, 64, group=(0, 2))
    # dp x sp positions: the dp coordinate is the replica group
    for coords, want in (({"dp": 1, "sp": 0}, (1, 2)),
                         ({"dp": 0, "sp": 1}, (0, 2))):
        mesh = Mesh({"dp": 2, "sp": 2}, coords, {})
        assert replica_groups(mesh, "dp") == want


def _dp_rank(rank, init, out, directory):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        tr = LMTrainer(_lm(), batch_size=4, num_epoch=1, stage_limit_bytes=1,
                       axes={"dp": 2}, worker_optimizer="sgd",
                       learning_rate=0.1)
        tr.train(ShardedDataset(directory))
        np.savez(os.path.join(out, f"rank{rank}.npz"),
                 losses=[h["loss"] for h in tr.history],
                 **rules.flatten(tr.params))
    finally:
        dist.destroy_process_group()


def test_two_ranks_stream_their_dp_strides(tmp_path):
    rng = np.random.default_rng(6)
    rows = [10, 12, 9, 11]
    parts = [{"tokens": rng.integers(0, TINY["vocab_size"], size=(r, 16))
              .astype(np.int32)} for r in rows]
    sd = ShardedDataset(write_shards(PartitionedDataset(parts),
                                     str(tmp_path / "s")))
    torch.multiprocessing.spawn(
        _dp_rank, args=(f"file://{tmp_path}/rendezvous", str(tmp_path),
                        sd.directory), nprocs=2)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in (0, 1)]
    cap = min((10 + 9) // 2, (12 + 11) // 2)
    assert len(ranks[0]["losses"]) == cap
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    # one process over the same global batches: dp 0's rows, then dp 1's
    streams = [[b["tokens"] for _, b in zip(range(cap), sd.batches(
        2, shards=[g, g + 2]))] for g in (0, 1)]
    glob = np.concatenate([np.concatenate([streams[0][i], streams[1][i]])
                           for i in range(cap)])
    torch.set_num_threads(1)
    one = LMTrainer(_lm(), batch_size=4, num_epoch=1,
                    worker_optimizer="sgd", learning_rate=0.1)
    one.train(PartitionedDataset.from_arrays({"tokens": glob}))
    np.testing.assert_allclose(ranks[0]["losses"],
                               [h["loss"] for h in one.history],
                               rtol=1e-5, atol=1e-5)
    for k, v in rules.flatten(one.params).items():
        np.testing.assert_allclose(ranks[0][k], v, rtol=0, atol=1e-5)
