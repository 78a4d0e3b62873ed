"""The dist-keras trainers over a disk-sharded dataset on the CPU
(``distkeras_torch/trainers.py``: the streaming path of
``DataParallelTrainer``, the per-worker shard partitions of the PS
family), against the port's in-memory path and the JAX package:

- ``DataParallelTrainer`` streamed from shards (shuffle off) equals the
  same trainer on the rows held in memory, bit for bit, at f32 and with
  the loader's bf16 cast on a bf16 model; and follows the reference's
  ``DataParallelTrainer(num_workers=1)`` from the same shards within
  1e-4 (shuffle on: the same two-level per-epoch order), the tolerance
  of the in-memory comparison in ``tests/test_torch_dk_trainers.py``;
- resume from a checkpoint on the streaming path equals a run that never
  stopped;
- the PS family's worker ``i`` reads shards ``order[i::n]`` of the
  reference's seeded shard order, rows shuffled by the reference's seed,
  and an ``ADAG`` run from shards trains; too few shards raise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distkeras_torch import trainers as tt  # noqa: E402
from distkeras_torch.data.dataset import PartitionedDataset  # noqa: E402
from distkeras_torch.data.shard_io import (ShardedDataset,  # noqa: E402
                                           write_shards)
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.ops import rules  # noqa: E402

DIM, CLASSES = 8, 4
KW = dict(worker_optimizer="momentum", learning_rate=0.05, batch_size=8,
          num_epoch=2)


def _cols(n=200, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(CLASSES, DIM)) * 3.0
    labels = rng.integers(0, CLASSES, size=n)
    feats = (centers[labels] + rng.normal(size=(n, DIM))).astype(np.float32)
    return {"features": feats,
            "label": np.eye(CLASSES, dtype=np.float32)[labels]}


def _mlp(dtype=torch.float32):
    return get_model("mlp", features=(16,), num_classes=CLASSES, dtype=dtype,
                     in_features=DIM, device="cpu", seed=3)


def _shards(tmp_path, cols, rows=48):
    return ShardedDataset(write_shards(PartitionedDataset.from_arrays(cols),
                                       str(tmp_path / "s"), rows))


def _same_params(a, b):
    fa, fb = rules.flatten(a), rules.flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_equals_in_memory_bit_for_bit(tmp_path, dtype):
    torch.set_num_threads(1)
    cols = _cols()
    dt = getattr(torch, dtype)
    mem = tt.DataParallelTrainer(_mlp(dt), **KW)
    mem.train(PartitionedDataset.from_arrays(cols))
    disk = tt.DataParallelTrainer(_mlp(dt), **KW)
    disk.STREAM_GROUP = 5  # several windows an epoch
    disk.train(_shards(tmp_path, cols))
    assert len(mem.history) == 2 * (200 // 8)
    assert disk.history == mem.history
    _same_params(mem.params, disk.params)


def test_streamed_follows_jax_from_the_same_shards(tmp_path):
    import jax
    import jax.numpy as jnp

    from distkeras_tpu import trainers as jt
    from distkeras_tpu.data.shard_io import ShardedDataset as JSD
    from distkeras_tpu.models import get_model as jax_get_model

    torch.set_num_threads(1)
    cols = _cols(seed=1)
    sd = _shards(tmp_path, cols, rows=40)
    jm = jax_get_model("mlp", features=(16,), num_classes=CLASSES,
                       dtype=jnp.float32)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, DIM), jnp.float32)))
    ref = jt.DataParallelTrainer(jm, params=p, num_workers=1, **KW)
    ref.train(JSD(sd.directory), shuffle=True)
    port = tt.DataParallelTrainer(_mlp(), params=p, **KW)
    port.train(sd, shuffle=True)
    want = np.array([[r["loss"], r["accuracy"]] for r in ref.history])
    got = np.array([[r["loss"], r["accuracy"]] for r in port.history])
    assert got.shape == want.shape == (2 * (200 // 8), 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for k, v in rules.flatten(jax.tree.map(np.asarray, ref.params)).items():
        np.testing.assert_allclose(rules.flatten(port.params)[k], v,
                                   rtol=0, atol=1e-4)


def test_streamed_resume_equals_an_uninterrupted_run(tmp_path):
    from distkeras_torch.checkpoint import Checkpointer

    torch.set_num_threads(1)
    sd = _shards(tmp_path, _cols(seed=2))
    whole = tt.DataParallelTrainer(_mlp(), **KW)
    whole.train(sd, shuffle=True)
    ck = str(tmp_path / "ck")
    tt.DataParallelTrainer(_mlp(), checkpointer=Checkpointer(ck, 1),
                           **dict(KW, num_epoch=1)).train(sd, shuffle=True)
    resumed = tt.DataParallelTrainer(_mlp(), checkpointer=Checkpointer(ck, 1),
                                     **KW)
    resumed.train(sd, shuffle=True)
    assert resumed.history == whole.history[len(whole.history) // 2:]
    _same_params(whole.params, resumed.params)


def test_ps_family_partitions_follow_the_reference(tmp_path):
    torch.set_num_threads(1)
    cols = _cols(seed=4)
    sd = _shards(tmp_path, cols, rows=30)  # 7 shards
    trainer = tt.ADAG(_mlp(), num_workers=2, communication_window=2, seed=5,
                      **dict(KW, worker_optimizer="sgd"))
    get = trainer._partitions(sd, 2, shuffle=True)
    order = np.random.default_rng(5).permutation(sd.num_shards)
    for i in range(2):
        rows = np.concatenate([sd.read_shard(int(s))["features"]
                               for s in order[i::2]])
        perm = np.random.default_rng(5 + 1 + i).permutation(len(rows))
        np.testing.assert_array_equal(get(i)["features"], rows[perm])
    plain = trainer._partitions(sd, 2, shuffle=False)
    np.testing.assert_array_equal(
        plain(1)["label"], np.concatenate([sd.read_shard(s)["label"]
                                           for s in (1, 3, 5)]))
    trainer.train(sd, shuffle=True)
    assert len(trainer.executor_histories) == 2
    assert all(np.isfinite(r["loss"]) for h in trainer.executor_histories
               for r in h)
    with pytest.raises(ValueError, match="cannot feed"):
        tt.ADAG(_mlp(), num_workers=8, **KW).train(sd)
