"""The port's dist-keras training path (``distkeras_torch.workers``, the
dist-keras trainers and the optimizers they use) against the JAX package
on the CPU, from the same numpy data and the same weights (JAX ``init``,
handed to both sides as ``params=``).

- ``make_window_step``: 10 steps of the f32 MLP against the reference's
  window step for every optimizer (sgd, momentum, adam, adagrad, rmsprop,
  adadelta): losses within 1e-5 relative, trained weights within 1e-4.
- ``SingleTrainer``, ``AveragingTrainer`` and ``EnsembleTrainer(2)``:
  per-worker histories within 1e-4 of the reference trainers', the
  trained weights too; the ensemble's lock-step truncation warns on
  both sides and keeps the same steps.
- ``DataParallelTrainer``: a world of one at 8x the batch equals
  ``SingleTrainer`` at that batch exactly and follows the reference's
  ``DataParallelTrainer(num_workers=8)`` (1e-4); two gloo ranks (one
  ``torch.multiprocessing`` spawn) follow the reference's
  ``num_workers=2`` on the CPU mesh within 2e-4, as
  ``tests/test_trainers.py`` holds the reference itself, and end with
  equal weights on both ranks.
- ``profile_dir=`` writes a Chrome trace; ``metrics_path=`` a JSONL;
  ``checkpointer=`` saves each epoch and a second run resumes past them;
  a ``ShardedDataset`` trains as its rows in memory do.

The JAX side is imported inside the tests: the spawned ranks import this
module and must load only torch and the port.
"""

import datetime
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from distkeras_torch import trainers as tt  # noqa: E402
from distkeras_torch.data.dataset import PartitionedDataset  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.utils.losses import (  # noqa: E402
    get_loss,
    get_optimizer,
    resolve_metrics,
)
from distkeras_torch.workers import (  # noqa: E402
    make_train_step,
    make_window_step,
)

DIM, CLASSES = 16, 4
MLP_KW = dict(features=(32, 16), num_classes=CLASSES)
TRAIN_KW = dict(worker_optimizer="sgd", learning_rate=0.05,
                label_col="label_encoded", batch_size=16, num_epoch=2)
WORLD = 2


def _columns(n=256, seed=0):
    """Gaussian blobs per class (tests/test_trainers.py's task), one-hot
    labels beside the integer ones."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(CLASSES, DIM)) * 3.0
    labels = rng.integers(0, CLASSES, size=n)
    feats = (centers[labels] + rng.normal(size=(n, DIM))).astype(np.float32)
    return {"features": feats, "label": labels,
            "label_encoded": np.eye(CLASSES, dtype=np.float32)[labels]}


def _port_mlp():
    return get_model("mlp", dtype=torch.float32, in_features=DIM,
                     device="cpu", **MLP_KW)


def _jax_mlp(seed=0):
    """The reference MLP and its numpy init from PRNGKey(seed)."""
    import jax
    import jax.numpy as jnp

    from distkeras_tpu.models import get_model as jax_get_model

    jm = jax_get_model("mlp", dtype=jnp.float32, **MLP_KW)
    p = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, DIM), jnp.float32))
    return jm, jax.tree.map(np.asarray, p)


def _hist(h):
    return np.array([[r["loss"], r["accuracy"]] for r in h])


def _close(a, b, tol):
    """max |a - b| <= tol * max(1, |a|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(a).max()), (
        np.abs(a - b).max())


def _tree_close(want, got, tol):
    import jax

    wl, gl = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


# -- the window step ---------------------------------------------------------


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adagrad",
                                  "rmsprop", "adadelta"])
def test_window_step_matches_jax(name):
    """10 steps of one window, f32: losses within 1e-5 relative, weights
    within 1e-4 (the same optax formulas; XLA and eager PyTorch sum the
    products in other orders)."""
    import jax.numpy as jnp

    from distkeras_tpu.utils.losses import get_loss as jax_loss
    from distkeras_tpu.utils.losses import get_optimizer as jax_opt
    from distkeras_tpu.utils.losses import resolve_metrics as jax_metrics
    from distkeras_tpu.workers import make_window_step as jax_window

    from distkeras_torch import bridge

    cols = _columns(160, seed=1)
    xs = cols["features"].reshape(10, 16, DIM)
    ys = cols["label_encoded"].reshape(10, 16, CLASSES)
    jm, p = _jax_mlp(seed=2)
    opt = jax_opt(name, 0.05)
    window = jax_window(jm.apply, jax_loss("categorical_crossentropy"), opt,
                        jax_metrics(["accuracy"]))
    jp, _, jms = window(p, opt.init(p), jnp.asarray(xs), jnp.asarray(ys))

    pm = _port_mlp()
    bridge.params_from_jax(p, pm)
    step = make_window_step(pm, get_loss("categorical_crossentropy"),
                            get_optimizer(name, 0.05),
                            resolve_metrics(["accuracy"]))
    ms = step(torch.from_numpy(xs), torch.from_numpy(ys))
    assert set(ms) == {"loss", "accuracy"} and ms["loss"].shape == (10,)
    _close(np.asarray(jms["loss"]), ms["loss"].numpy(), 1e-5)
    np.testing.assert_array_equal(np.asarray(jms["accuracy"]),
                                  ms["accuracy"].numpy())
    _tree_close(jp, bridge.params_to_jax(pm), 1e-4)


def test_train_step_is_one_step_of_the_window():
    cols = _columns(32, seed=3)
    x = torch.from_numpy(cols["features"][:16])
    y = torch.from_numpy(cols["label_encoded"][:16])
    a, b = _port_mlp(), _port_mlp()
    loss = get_loss("categorical_crossentropy")
    metrics = resolve_metrics(["accuracy", "mse"])
    one = make_train_step(a, loss, get_optimizer("adam", 1e-2), metrics)(x, y)
    win = make_window_step(b, loss, get_optimizer("adam", 1e-2),
                           metrics)(x[None], y[None])
    assert set(one) == {"loss", "accuracy", "mse"} and one["loss"].dim() == 0
    for k in one:
        assert float(one[k]) == float(win[k][0])
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


# -- the trainers against the reference's ------------------------------------


@pytest.mark.parametrize("kind", ["single", "averaging", "ensemble"])
def test_trainer_histories_match_jax(kind):
    """Same data, same initial weights: per-worker histories within 1e-4,
    and (Single, Averaging) the trained weights."""
    import jax
    import jax.numpy as jnp

    from distkeras_tpu import trainers as jt
    from distkeras_tpu.data.dataset import PartitionedDataset as JaxDataset

    cols = _columns(256, seed=4)
    jm, p = _jax_mlp(seed=5)
    cls, extra = {"single": ("SingleTrainer", {}),
                  "averaging": ("AveragingTrainer", dict(num_workers=2)),
                  "ensemble": ("EnsembleTrainer", dict(num_models=2))}[kind]
    ref = getattr(jt, cls)(jm, params=p, seed=7, **TRAIN_KW, **extra)
    ref_out = ref.train(JaxDataset.from_arrays(cols, 3), shuffle=True)
    port_params = p
    if kind == "ensemble":
        # the reference's members start from PRNGKey(seed + i) and ignore
        # params=; the port takes those trees as its members' inits
        port_params = [jax.tree.map(np.asarray, jm.init(
            jax.random.PRNGKey(7 + i), jnp.zeros((1, DIM), jnp.float32)))
            for i in range(2)]
    port = getattr(tt, cls)(_port_mlp(), params=port_params, seed=7,
                            **TRAIN_KW, **extra)
    out = port.train(PartitionedDataset.from_arrays(cols, 3), shuffle=True)
    assert len(port.executor_histories) == len(ref.executor_histories)
    for hj, ht in zip(ref.executor_histories, port.executor_histories):
        assert len(hj) == len(ht) > 0
        _close(_hist(hj), _hist(ht), 1e-4)
    if kind == "ensemble":
        from distkeras_torch import bridge

        assert len(out) == 2
        for mj, mt in zip(ref_out, out):
            _tree_close(mj.params, bridge.params_to_jax(mt.module), 1e-4)
    else:
        _tree_close(ref.params, port.params, 1e-4)
        assert out.module is port.model
    if kind == "single":
        assert port.history == port.executor_histories[0]


def test_ensemble_truncation_warns_like_the_reference():
    """511 rows over 2 models at batch 16: 15 and 16 batches; both
    packages warn and train 15 steps an epoch per model."""
    from distkeras_tpu import trainers as jt
    from distkeras_tpu.data.dataset import PartitionedDataset as JaxDataset

    cols = _columns(511, seed=6)
    jm, p = _jax_mlp()
    kw = dict(TRAIN_KW, num_epoch=1)
    with pytest.warns(RuntimeWarning, match="truncated 1 trailing"):
        ref = jt.AveragingTrainer(jm, params=p, num_workers=2, **kw)
        ref.train(JaxDataset.from_arrays(cols))
    with pytest.warns(RuntimeWarning, match="truncated 1 trailing"):
        port = tt.AveragingTrainer(_port_mlp(), params=p, num_workers=2,
                                   **kw)
        port.train(PartitionedDataset.from_arrays(cols))
    assert [len(h) for h in port.executor_histories] == [15, 15]
    for hj, ht in zip(ref.executor_histories, port.executor_histories):
        _close(_hist(hj), _hist(ht), 1e-4)


def test_data_parallel_world_of_one_is_single_at_8x_batch():
    """No process group: DataParallelTrainer at batch 8B equals
    SingleTrainer at 8B exactly, and follows the reference's
    DataParallelTrainer over 8 CPU devices at batch B (1e-4)."""
    from distkeras_tpu import trainers as jt
    from distkeras_tpu.data.dataset import PartitionedDataset as JaxDataset

    cols = _columns(512, seed=8)
    jm, p = _jax_mlp(seed=9)
    kw = dict(TRAIN_KW, batch_size=8 * TRAIN_KW["batch_size"])
    dp = tt.DataParallelTrainer(_port_mlp(), params=p, **kw)
    dp.train(PartitionedDataset.from_arrays(cols, 2))
    single = tt.SingleTrainer(_port_mlp(), params=p, **kw)
    single.train(PartitionedDataset.from_arrays(cols, 2))
    assert dp.history == single.history and len(dp.history) == 8
    _tree_close(single.params, dp.params, 0.0)
    ref = jt.DataParallelTrainer(jm, params=p, num_workers=8, **TRAIN_KW)
    ref.train(JaxDataset.from_arrays(cols, 2))
    _close(_hist(ref.history), _hist(dp.history), 1e-4)
    _tree_close(ref.params, dp.params, 1e-4)
    with pytest.raises(ValueError, match="num_workers=2"):
        tt.DataParallelTrainer(_port_mlp(), num_workers=2, **kw).train(
            PartitionedDataset.from_arrays(cols))


# -- two gloo ranks ------------------------------------------------------------


def _entry(rank, name, init, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        globals()[name](rank, *args)
    finally:
        dist.destroy_process_group()


def _dp_worker(rank, out, cols, params):
    from distkeras_torch import bridge

    trainer = tt.DataParallelTrainer(_port_mlp(), params=params,
                                     num_workers=WORLD, **TRAIN_KW)
    trainer.train(PartitionedDataset.from_arrays(cols))
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "flax", "optax", "distkeras_tpu"))
    assert not loaded, loaded  # a rank runs on torch and the port alone
    leaves = bridge.params_to_jax(trainer.model)["params"]
    np.savez(os.path.join(out, f"rank{rank}.npz"), hist=_hist(
        trainer.history), **{f"{k}/{n}": v for k, d in leaves.items()
                             for n, v in d.items()})


def test_two_rank_data_parallel_matches_jax(tmp_path):
    from distkeras_tpu import trainers as jt
    from distkeras_tpu.data.dataset import PartitionedDataset as JaxDataset

    cols = _columns(256, seed=10)
    jm, p = _jax_mlp(seed=11)
    ref = jt.DataParallelTrainer(jm, params=p, num_workers=WORLD,
                                 **TRAIN_KW)
    ref.train(JaxDataset.from_arrays(cols))
    out = str(tmp_path)
    torch.multiprocessing.spawn(
        _entry, args=("_dp_worker", f"file://{out}/rendezvous",
                      (out, cols, p)), nprocs=WORLD)
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
             for r in range(WORLD)]
    _close(_hist(ref.history), ranks[0]["hist"], 2e-4)
    for key, want in ranks[0].items():
        np.testing.assert_array_equal(ranks[1][key], want)
        if key != "hist":
            layer, leaf = key.split("/")
            np.testing.assert_allclose(want, ref.params["params"][layer][leaf],
                                       rtol=0, atol=2e-4)


# -- every card of the host over NCCL ----------------------------------------

NCCL_ROWS = 8192
NCCL_KW = dict(worker_optimizer="momentum", learning_rate=0.02,
               label_col="label_encoded", batch_size=64, num_epoch=1)
# f32 with TF32 off: the ranks' all-reduced gradients and one card's
# bigger batch differ only in the order of their sums (4 H100s: history
# 4.8e-7, weights 7.4e-6; PERF.md)
NCCL_TOL = 1e-4


def _nccl_columns():
    """MNIST-shaped rows, a noisy prototype per class, one-hot labels."""
    rng = np.random.default_rng(0)
    protos = rng.uniform(0, 1, size=(10, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=NCCL_ROWS)
    x = protos[y] + rng.normal(scale=0.25, size=(NCCL_ROWS, 28, 28, 1))
    return {"features": x.astype(np.float32),
            "label_encoded": np.eye(10, dtype=np.float32)[y]}


def _set_tf32(cudnn: bool, matmul: bool):
    """Set TF32 for cuDNN and cuBLAS; returns the settings it replaced."""
    was = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    return was


def _f32_cnn(device):
    return get_model("mnist_cnn", dtype=torch.float32, device=device, seed=0)


def _leaves(trainer):
    return {f"{k}/{n}": v for k, d in trainer.params["params"].items()
            for n, v in d.items()}


def _nccl_rank(rank, world, out):
    torch.cuda.set_device(rank)
    _set_tf32(False, False)
    dist.init_process_group("nccl", init_method=f"file://{out}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        trainer = tt.DataParallelTrainer(_f32_cnn(f"cuda:{rank}"),
                                         num_workers=world, **NCCL_KW)
        trainer.train(PartitionedDataset.from_arrays(_nccl_columns()))
        np.savez(os.path.join(out, f"rank{rank}.npz"),
                 hist=_hist(trainer.history),
                 wall=trainer.get_training_time(), **_leaves(trainer))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_data_parallel_over_nccl_is_single_at_n_times_the_batch(tmp_path):
    """Every card of the host as one NCCL rank of DataParallelTrainer
    (mnist_cnn in f32, momentum, 8192 rows): the ranks end bit-identical,
    and rank 0's history and weights stay within NCCL_TOL of
    SingleTrainer at n x the batch on one card. Prints the gaps and the
    ranks' training times as one JSON line."""
    world = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world < 2:
        pytest.skip("needs two or more CUDA devices (one NCCL rank each)")
    out = str(tmp_path)
    torch.multiprocessing.spawn(_nccl_rank, args=(world, out), nprocs=world)
    was = _set_tf32(False, False)
    try:
        single = tt.SingleTrainer(
            _f32_cnn("cuda:0"),
            **dict(NCCL_KW, batch_size=world * NCCL_KW["batch_size"]))
        single.train(PartitionedDataset.from_arrays(_nccl_columns()))
    finally:
        _set_tf32(*was)
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
             for r in range(world)]
    walls = [float(rk.pop("wall")) for rk in ranks]
    for rk in ranks[1:]:
        assert rk.keys() == ranks[0].keys()
        for key, want in ranks[0].items():
            np.testing.assert_array_equal(rk[key], want)
    ref = _hist(single.history)
    assert ranks[0]["hist"].shape == ref.shape
    hist_gap = float(np.abs(ranks[0]["hist"] - ref).max())
    param_gap = max(float(np.abs(ranks[0][k] - v).max())
                    for k, v in _leaves(single).items())
    print(json.dumps({"world": world, "backend": "nccl",
                      "steps": len(ref), "ranks_identical": True,
                      "history_gap_vs_single": hist_gap,
                      "param_gap_vs_single": param_gap,
                      "final_loss": float(ref[-1, 0]),
                      "rank_train_s": walls}))
    assert hist_gap <= NCCL_TOL and param_gap <= NCCL_TOL


# -- observability and what still raises ---------------------------------------


def test_profile_dir_and_metrics_path(tmp_path):
    cols = _columns(64)
    trace_dir = tmp_path / "trace"
    trainer = tt.SingleTrainer(_port_mlp(), profile_dir=str(trace_dir),
                               metrics_path=str(tmp_path / "m.jsonl"),
                               **TRAIN_KW)
    trainer.train(PartitionedDataset.from_arrays(cols))
    traces = list(trace_dir.glob("trace-*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    rows = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    steps = [r for r in rows if "step" in r]
    assert len(steps) == len(trainer.history) == 8
    assert rows[-1]["kind"] == "throughput"


@pytest.mark.parametrize("what", ["checkpointer", "sharded"])
def test_dist_keras_trainers_raise_for_a9(what, tmp_path):
    if what == "checkpointer":
        # ported now: SingleTrainer saves its weights, optimizer state and
        # epoch after each epoch, and a second run resumes past them
        from distkeras_torch.checkpoint import Checkpointer

        ds = PartitionedDataset.from_arrays(_columns(64))
        ck = Checkpointer(str(tmp_path / "ck"), every_steps=1)
        trainer = tt.SingleTrainer(_port_mlp(), checkpointer=ck, **TRAIN_KW)
        trainer.train(ds)
        assert ck.all_steps() == [1, 2] and len(trainer.history) == 8
        step, state = ck.restore()
        assert state["extra"] == {"epoch": 2}
        _tree_close(trainer.params, state["params"], 0)
        again = tt.SingleTrainer(_port_mlp(), checkpointer=ck, **TRAIN_KW)
        again.train(ds)
        assert again.history == []
        _tree_close(trainer.params, again.params, 0)
        return

    # ported now: a ShardedDataset loads and trains as the same rows in
    # memory do, bit for bit
    from distkeras_torch.data.shard_io import ShardedDataset, write_shards

    cols = _columns(64)
    write_shards(PartitionedDataset.from_arrays(cols), str(tmp_path / "s"),
                 rows_per_shard=24)
    mem = tt.SingleTrainer(_port_mlp(), **TRAIN_KW)
    mem.train(PartitionedDataset.from_arrays(cols))
    disk = tt.SingleTrainer(_port_mlp(), **TRAIN_KW)
    disk.train(ShardedDataset(str(tmp_path / "s")))
    assert disk.history == mem.history and len(mem.history) == 8
    _tree_close(mem.params, disk.params, 0)


def test_trainers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("mlp")
