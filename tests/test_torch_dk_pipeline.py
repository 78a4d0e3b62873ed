"""The port's dist-keras pipeline stages (``distkeras_torch.transformers``,
``predictors`` and ``evaluators``) against the JAX package on the CPU,
from the same numpy datasets and weights.

- Every transformer: the port's output column equals the reference's
  exactly (integer and one-hot columns bit for bit; the float columns
  are the same numpy arithmetic, so exact too).
- ``ModelPredictor``: empty, one-row, tail and multi-batch partitions,
  f32 models within 1e-5 of the reference predictor on the same weights
  and the right ``[0, ...]`` shape for an empty partition; a bf16 CNN
  matches the port's own ``Model.predict`` (the host-side narrowing cast
  gives the values the model's own cast gives).
- Evaluators: ``AccuracyEvaluator`` (index, vector and one-hot columns)
  exact; ``PerplexityEvaluator`` on the port's ``TransformerLM`` within
  1e-5 of the reference's on bridged weights, ragged tail included;
  ``LossEvaluator`` within 1e-5.
- The slice as a whole: the MNIST workflow's stages (MinMax -> Reshape
  -> OneHot -> SingleTrainer -> ModelPredictor -> LabelIndex ->
  AccuracyEvaluator) through both packages from the same weights gives
  the same predictions and accuracy.
- The disk-sharded entry points (``transform_sharded``,
  ``predict_sharded``, evaluators over shards) equal the reference's on a
  2-shard directory.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distkeras_tpu import evaluators as je  # noqa: E402
from distkeras_tpu import predictors as jp  # noqa: E402
from distkeras_tpu import transformers as jtf  # noqa: E402
from distkeras_tpu.data.dataset import PartitionedDataset as JDS  # noqa: E402
from distkeras_tpu.models import get_model as jax_get_model  # noqa: E402
from distkeras_tpu.models.wrapper import Model as JaxModel  # noqa: E402
from distkeras_torch import bridge  # noqa: E402
from distkeras_torch import evaluators as te  # noqa: E402
from distkeras_torch import predictors as tp  # noqa: E402
from distkeras_torch import transformers as ttf  # noqa: E402
from distkeras_torch.data.dataset import PartitionedDataset as TDS  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.models.wrapper import Model  # noqa: E402


def _both(cols, parts):
    return (JDS.from_arrays(cols, parts), TDS.from_arrays(cols, parts))


def _same_columns(a, b):
    assert a.columns == b.columns
    assert [len(p[a.columns[0]]) for p in a.partitions()] == \
        [len(p[b.columns[0]]) for p in b.partitions()]
    for c in a.columns:
        x, y = a.column(c), b.column(c)
        assert x.dtype == y.dtype and x.shape == y.shape, c
        if x.dtype == object:  # per-row index/value arrays
            for xr, yr in zip(x, y):
                np.testing.assert_array_equal(xr, yr)
        else:
            np.testing.assert_array_equal(x, y)


def _loaded(name, dtype, seed, **kw):
    """(reference Model, port Model) over the same seeded weights."""
    port_kw = kw.pop("port_kw", {})
    jm = jax_get_model(name, dtype=getattr(jnp, dtype), **kw)
    pm = get_model(name, dtype=getattr(torch, dtype), device="cpu", **kw,
                   **port_kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) / np.sqrt(
            int(np.prod(a.shape[:-1])) or 10)).astype(np.float32),
        bridge.params_to_jax(pm))
    bridge.params_from_jax(tree, pm)
    return JaxModel(jm, tree), Model(pm)


# -- transformers ---------------------------------------------------------------


def _stage_cases(rng):
    flat = rng.uniform(-3, 5, size=(23, 12)).astype(np.float32)
    labels = rng.integers(0, 6, size=23)
    preds = rng.normal(size=(23, 6)).astype(np.float32)
    idx = np.empty(23, dtype=object)
    val = np.empty(23, dtype=object)
    for r in range(23):
        k = rng.integers(0, 4)
        idx[r] = rng.choice(9, size=k, replace=False)
        val[r] = rng.normal(size=k).astype(np.float32)
    cols = {"features": flat, "label": labels, "prediction": preds,
            "indices": idx, "values": val}
    return cols, {
        "onehot": lambda m: m.OneHotTransformer(6, "label", "label_encoded"),
        "minmax_fit": lambda m: m.MinMaxTransformer(n_min=-1.0, n_max=2.0),
        "minmax_stated": lambda m: m.MinMaxTransformer(
            o_min=-3.0, o_max=5.0, input_col="features", output_col="scaled"),
        "dense": lambda m: m.DenseTransformer(9, output_col="dense"),
        "reshape": lambda m: m.ReshapeTransformer("features", "matrix",
                                                  (3, 4, 1)),
        "label_index": lambda m: m.LabelIndexTransformer(
            input_col="prediction"),
    }


@pytest.mark.parametrize("stage", ["onehot", "minmax_fit", "minmax_stated",
                                   "dense", "reshape", "label_index"])
def test_transformer_matches_jax(stage):
    cols, stages = _stage_cases(np.random.default_rng(0))
    jds, tds = _both(cols, 3)
    _same_columns(stages[stage](jtf).transform(jds),
                  stages[stage](ttf).transform(tds))


def test_sharded_entry_points_raise_a9(tmp_path):
    # ported now: on a 2-shard directory, transform_sharded ->
    # predict_sharded -> AccuracyEvaluator equal the reference's, and the
    # loaded-dataset forms (predict, evaluate) equal the sharded ones
    from distkeras_tpu.data.shard_io import ShardedDataset as JSD
    from distkeras_tpu.data.shard_io import write_shards as jwrite
    from distkeras_torch.data.shard_io import ShardedDataset, write_shards

    rng = np.random.default_rng(8)
    cols = {"features": rng.normal(size=(37, 3)).astype(np.float32),
            "label": rng.integers(0, 4, size=37)}
    write_shards(TDS.from_arrays(cols), str(tmp_path / "t"),
                 rows_per_shard=20)
    jwrite(JDS.from_arrays(cols), str(tmp_path / "j"), rows_per_shard=20)
    tsd, jsd = ShardedDataset(str(tmp_path / "t")), JSD(str(tmp_path / "j"))
    assert tsd.num_shards == 2
    jm, pm = _loaded("mlp", "float32", 0, features=(4,), num_classes=4,
                     port_kw=dict(in_features=3))
    got = ttf.OneHotTransformer(4, "label", "label_encoded").transform_sharded(
        tsd, str(tmp_path / "t1"))
    want = jtf.OneHotTransformer(4, "label", "label_encoded"
                                 ).transform_sharded(jsd, str(tmp_path / "j1"))
    got = tp.ModelPredictor(pm).predict_sharded(ShardedDataset(got),
                                                str(tmp_path / "t2"))
    want = jp.ModelPredictor(jm).predict_sharded(JSD(want),
                                                 str(tmp_path / "j2"))
    got = ttf.LabelIndexTransformer(4).transform_sharded(
        ShardedDataset(got), str(tmp_path / "t3"))
    want = jtf.LabelIndexTransformer(4).transform_sharded(
        JSD(want), str(tmp_path / "j3"))
    tout, jout = ShardedDataset(got), JSD(want)
    assert tout.shard_rows == jout.shard_rows == [18, 19]
    for i in range(2):
        a, b = tout.read_shard(i), jout.read_shard(i)
        assert sorted(a) == sorted(b)
        for c in a:
            np.testing.assert_allclose(a[c], b[c], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(a["predicted_index"],
                                      b["predicted_index"])
    acc = te.AccuracyEvaluator(label_col="label_encoded").evaluate(tout)
    assert acc == je.AccuracyEvaluator(label_col="label_encoded"
                                       ).evaluate(jout)
    assert acc == te.AccuracyEvaluator(label_col="label_encoded"
                                       ).evaluate(tout.load())
    loaded = tp.ModelPredictor(pm).predict(tsd)
    np.testing.assert_array_equal(loaded.column("prediction"),
                                  tout.load().column("prediction"))
    with pytest.raises(ValueError, match="o_min/o_max"):
        ttf.MinMaxTransformer().transform_sharded(tsd, str(tmp_path / "x"))
    with pytest.raises(TypeError, match="ShardedDataset"):
        tp.ModelPredictor(pm).predict_sharded(TDS.from_arrays(cols),
                                              str(tmp_path / "y"))


# -- the predictor --------------------------------------------------------------


@pytest.mark.parametrize("sizes", [(0, 5), (1, 8, 0), (17, 3, 9)])
def test_model_predictor_matches_jax(sizes):
    """Partitions of the given row counts at batch 8: empty partitions give
    ``[0, C]``, tails are padded and sliced; f32 MLP within 1e-5."""
    jm, tm = _loaded("mlp", "float32", 1, features=(16,), num_classes=5,
                     port_kw=dict(in_features=12))
    rng = np.random.default_rng(2)
    parts = [{"features": rng.normal(size=(n, 12)).astype(np.float32)}
             for n in sizes]
    want = jp.ModelPredictor(jm, batch_size=8).predict(
        JDS.from_partitions(parts))
    got = tp.ModelPredictor(tm, batch_size=8).predict(
        TDS.from_partitions(parts))
    for w, g, n in zip(want.partitions(), got.partitions(), sizes):
        assert g["prediction"].shape == (n, 5) == w["prediction"].shape
        assert g["prediction"].dtype == np.float32
        np.testing.assert_allclose(g["prediction"], w["prediction"],
                                   rtol=0, atol=1e-5)


def test_model_predictor_bf16_cnn_host_cast():
    """A bf16 CNN: features narrowed on the host give the model's own
    cast's values (Model.predict uploads f32); against the reference
    predictor at bf16 tolerance (2e-2 of the largest logit)."""
    jm, tm = _loaded("mnist_cnn", "bfloat16", 3)
    x = np.random.default_rng(4).normal(size=(11, 28, 28, 1)).astype(
        np.float32)
    pred = tp.ModelPredictor(tm, batch_size=4)
    assert pred.transfer_dtype == torch.bfloat16
    got = pred.predict(TDS.from_arrays({"features": x})).column("prediction")
    np.testing.assert_allclose(got, tm.predict(x), rtol=0, atol=1e-5)
    want = jp.ModelPredictor(jm, batch_size=4).predict(
        JDS.from_arrays({"features": x})).column("prediction")
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


# -- evaluators -------------------------------------------------------------------


def test_accuracy_evaluator_matches_jax():
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 4, size=40)
    vecs = rng.normal(size=(40, 4)).astype(np.float32)
    cols = {"label": labels, "label_encoded": np.eye(4, dtype=np.float32)[
        labels], "prediction": vecs, "predicted_index": vecs.argmax(-1)}
    jds, tds = _both(cols, 3)
    for pred_col in ("prediction", "predicted_index"):
        for label_col in ("label", "label_encoded"):
            want = je.AccuracyEvaluator(pred_col, label_col).evaluate(jds)
            got = te.AccuracyEvaluator(pred_col, label_col).evaluate(tds)
            assert got == want


@pytest.mark.parametrize("loss", ["mse", "mae", "categorical_crossentropy"])
def test_loss_evaluator_matches_jax(loss):
    rng = np.random.default_rng(6)
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=30)]
    cols = {"prediction": rng.normal(size=(30, 5)).astype(np.float32),
            "label": labels}
    jds, tds = _both(cols, 2)
    want = je.LossEvaluator(loss).evaluate(jds)
    got = te.LossEvaluator(loss).evaluate(tds)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_perplexity_evaluator_matches_jax():
    """f32 TransformerLM on bridged weights, 13 rows in partitions of 7 and
    6 at batch 4 (ragged tails padded and masked)."""
    tiny = dict(vocab_size=37, d_model=16, num_heads=2, num_layers=1,
                max_len=12)
    jm = jax_get_model("transformer_lm", dtype=jnp.float32, **tiny)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
    pm = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                   **tiny)
    bridge.params_from_jax(params, pm)
    toks = np.random.default_rng(7).integers(0, 37, size=(13, 12)).astype(
        np.int32)
    jds, tds = _both({"tokens": toks}, 2)
    want = je.PerplexityEvaluator(JaxModel(jm, params), batch_size=4
                                  ).evaluate(jds)
    got = te.PerplexityEvaluator(Model(pm), batch_size=4).evaluate(tds)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match="N, T"):
        te.PerplexityEvaluator(Model(pm)).evaluate(
            TDS.from_arrays({"tokens": toks[:, 0]}))


# -- the slice as a whole ---------------------------------------------------------


def test_mnist_workflow_matches_jax():
    """examples/mnist_workflow.py's stages at a tiny size, f32 MLP, both
    packages from the same weights: equal losses (1e-4), predictions
    (1e-4) and accuracy."""
    from distkeras_tpu.trainers import SingleTrainer as JaxSingle
    from distkeras_torch.trainers import SingleTrainer

    rng = np.random.default_rng(8)
    protos = rng.uniform(0, 255, size=(10, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=192)
    x = np.clip(protos[y] + rng.normal(scale=64.0, size=(192, 784)), 0,
                255).astype(np.float32)
    jmodel, tmodel = _loaded("mlp", "float32", 9, features=(32,))
    out = {}
    for pkg, tf, pr, ev, trainer, model, ds in (
            ("jax", jtf, jp, je, JaxSingle, jmodel.module, JDS),
            ("torch", ttf, tp, te, SingleTrainer, tmodel.module, TDS)):
        d = ds.from_arrays({"features": x, "label": y}, num_partitions=2)
        d = tf.MinMaxTransformer(o_min=0.0, o_max=255.0, input_col="features",
                                 output_col="norm").transform(d)
        d = tf.ReshapeTransformer("norm", "matrix", (28, 28, 1)).transform(d)
        d = tf.OneHotTransformer(10, "label", "label_encoded").transform(d)
        t = trainer(model, params=jmodel.params, worker_optimizer="adam",
                    learning_rate=1e-2, features_col="matrix",
                    label_col="label_encoded", batch_size=32, num_epoch=2)
        trained = t.train(d, shuffle=True)
        d = pr.ModelPredictor(trained, features_col="matrix").predict(d)
        d = tf.LabelIndexTransformer(input_col="prediction").transform(d)
        out[pkg] = (np.array([r["loss"] for r in t.history]),
                    d.column("prediction"), d.column("predicted_index"),
                    ev.AccuracyEvaluator("predicted_index", "label"
                                         ).evaluate(d))
    (jl, jpred, jidx, jacc), (tl, tpred, tidx, tacc) = out["jax"], out["torch"]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tpred, jpred, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tidx, jidx)
    assert tacc == jacc > 0.5
