"""The port's Keras importer (``distkeras_torch/utils/keras_import.py``)
against the JAX package's on the CPU: the same Keras configs (written
here as the dicts ``model.get_config()`` gives, so no keras is needed)
and the same seeded weight lists through both ``from_keras_config``s.

- every layer kind ``_apply_layer`` handles, and every merge of the graph
  importer, predicts within 1e-5 of the reference's imported module;
- ``train_mode`` BatchNorm: a training-mode forward equals the
  reference's, moving statistics included;
- ``to_keras_config`` round-trips exactly (config and weights), and a
  re-import predicts the same;
- where keras is installed, a live model predicts as the import does
  (keras imported inside those tests only);
- importing the module loads no keras (``keras_available`` finds it
  without importing it).
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distkeras_torch.utils import keras_import as tk  # noqa: E402

TOL = 1e-5


def _layer(cls, **cfg):
    return {"class_name": cls, "config": dict(cfg, name=cfg.get("name"))}


def _seq(layers, shape):
    return {"name": "seq", "layers": [
        _layer("InputLayer", batch_shape=[None] + list(shape))] + layers}


def _w(rng, *shape, scale=0.3):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# (name, layers, input shape, weight shapes, integer input vocabulary)
def _cases():
    C = 3
    return {
        "dense": ([_layer("Dense", units=5, activation="tanh")], (7,),
                  [(7, 5), (5,)], None),
        "dense_nobias_gelu": ([_layer("Dense", units=4, activation="gelu",
                                      use_bias=False)], (6,), [(6, 4)], None),
        "conv2d_same_stride": ([_layer("Conv2D", filters=4,
                                       kernel_size=[3, 3], strides=[2, 2],
                                       padding="same", activation="relu")],
                               (7, 6, C), [(3, 3, C, 4), (4,)], None),
        "conv2d_valid": ([_layer("Conv2D", filters=2, kernel_size=[2, 3],
                                 padding="valid", activation="elu")],
                         (5, 6, C), [(2, 3, C, 2), (2,)], None),
        "conv1d": ([_layer("Conv1D", filters=4, kernel_size=[3],
                           strides=[2], padding="same",
                           activation="sigmoid")], (9, C),
                   [(3, C, 4), (4,)], None),
        "dwconv2d": ([_layer("DepthwiseConv2D", kernel_size=[3, 3],
                             depth_multiplier=2, padding="same")],
                     (6, 6, C), [(3, 3, C, 2), (2 * C,)], None),
        "sepconv2d": ([_layer("SeparableConv2D", filters=5,
                              kernel_size=[3, 3], strides=[2, 2],
                              depth_multiplier=2, padding="same",
                              activation="relu")], (7, 7, C),
                      [(3, 3, C, 2), (1, 1, 2 * C, 5), (5,)], None),
        "maxpool_same": ([_layer("MaxPooling2D", pool_size=[2, 2],
                                 strides=[2, 2], padding="same")],
                         (5, 7, C), [], None),
        "avgpool_same": ([_layer("AveragePooling2D", pool_size=[3, 3],
                                 strides=[2, 2], padding="same")],
                         (5, 7, C), [], None),
        "avgpool_valid": ([_layer("AveragePooling2D", pool_size=[2, 2],
                                  padding="valid")], (6, 6, C), [], None),
        "gap_gmp": ([_layer("GlobalAveragePooling2D", keepdims=True),
                     _layer("GlobalMaxPooling2D")], (4, 5, C), [], None),
        "batchnorm": ([_layer("BatchNormalization", epsilon=1e-3)],
                      (4, 4, C), [(C,), (C,), (C,), "var"], None),
        "layernorm": ([_layer("LayerNormalization", epsilon=1e-5)], (5, 6),
                      [(6,), (6,)], None),
        "dropout_flatten_reshape": ([_layer("Dropout", rate=0.5),
                                     _layer("Flatten"),
                                     _layer("Reshape",
                                            target_shape=[C, 12])],
                                    (3, 4, C), [], None),
        "activation_relu_softmax": ([_layer("Activation", activation="tanh"),
                                     _layer("ReLU"), _layer("Softmax")],
                                    (6,), [], None),
        "embedding_lstm": ([_layer("Embedding", input_dim=11, output_dim=6),
                            _layer("LSTM", units=5, return_sequences=True),
                            _layer("LSTM", units=4)], (7,),
                           [(11, 6), (6, 20), (5, 20), (20,), (5, 16),
                            (4, 16), (16,)], 11),
        "gru_reset_after": ([_layer("GRU", units=5, return_sequences=True)],
                            (6, 3), [(3, 15), (5, 15), (2, 15)], None),
        "gru_reset_before": ([_layer("GRU", units=4, reset_after=False)],
                             (6, 3), [(3, 12), (4, 12), (12,)], None),
        "simplernn": ([_layer("SimpleRNN", units=4, activation="relu")],
                      (5, 3), [(3, 4), (4, 4), (4,)], None),
    }


def _weights(shapes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        if s == "var":  # a BatchNorm moving variance: positive
            out.append((rng.random(size=out[-1].shape) + 0.5)
                       .astype(np.float32))
        else:
            out.append(_w(rng, *s))
    return out


def _input(shape, vocab, seed, n=4):
    rng = np.random.default_rng(seed)
    if vocab:
        return rng.integers(0, vocab, size=(n,) + shape).astype(np.int32)
    return rng.normal(size=(n,) + shape).astype(np.float32)


def _both(config, weights, **kw):
    from distkeras_tpu.utils import keras_import as jk

    jm = jk.from_keras_config(config, [w.copy() for w in weights], **kw)
    pm = tk.from_keras_config(config, [w.copy() for w in weights],
                              device="cpu", **kw)
    return jm, pm


def _predict(pm, x):
    with torch.no_grad():
        out = pm.module(x)
    if isinstance(out, tuple):
        return [o.numpy() for o in out]
    return out.numpy()


@pytest.mark.parametrize("name", sorted(_cases()))
def test_layer_kind_matches_jax(name):
    torch.set_num_threads(1)
    layers, shape, wshapes, vocab = _cases()[name]
    config = _seq(layers, shape)
    weights = _weights(wshapes, seed=len(name))
    jm, pm = _both(config, weights)
    x = _input(shape, vocab, seed=1)
    np.testing.assert_allclose(_predict(pm, x), jm.predict(x), rtol=TOL,
                               atol=TOL)


def _node(cls, name, parents, **cfg):
    return {"class_name": cls, "name": name,
            "config": dict(cfg, name=name),
            "inbound_nodes": [[[p, 0, 0, {}] for p in parents]]
            if parents else []}


def _graph(merge, n_branches, **merge_cfg):
    """input -> n Dense branches -> merge -> Dense head (Keras 2 refs)."""
    layers = [_node("InputLayer", "in", [], batch_shape=[None, 6])]
    for i in range(n_branches):
        layers.append(_node("Dense", f"b{i}", ["in"], units=4,
                            activation="relu"))
    layers.append(_node(merge, "m", [f"b{i}" for i in range(n_branches)],
                        **merge_cfg))
    layers.append(_node("Dense", "out", ["m"], units=3))
    width = 4 * n_branches if merge == "Concatenate" else 4
    shapes = [(6, 4), (4,)] * n_branches + [(width, 3), (3,)]
    cfg = {"name": "g", "layers": layers, "input_layers": [["in", 0, 0]],
           "output_layers": [["out", 0, 0]]}
    return cfg, shapes


@pytest.mark.parametrize("merge,n", [("Add", 2), ("Multiply", 3),
                                     ("Average", 2), ("Subtract", 2),
                                     ("Maximum", 3), ("Minimum", 2),
                                     ("Concatenate", 3)])
def test_merge_matches_jax(merge, n):
    torch.set_num_threads(1)
    config, shapes = _graph(merge, n)
    weights = _weights(shapes, seed=n)
    jm, pm = _both(config, weights)
    assert isinstance(pm.module, tk.KerasImportedGraph)
    x = _input((6,), None, seed=2)
    np.testing.assert_allclose(_predict(pm, x), jm.predict(x), rtol=TOL,
                               atol=TOL)


def test_multi_input_multi_output_graph_matches_jax():
    layers = [_node("InputLayer", "a", [], batch_shape=[None, 5]),
              _node("InputLayer", "b", [], batch_shape=[None, 5]),
              _node("Dense", "da", ["a"], units=4),
              _node("Dense", "db", ["b"], units=4),
              _node("Add", "s", ["da", "db"]),
              _node("Dense", "o1", ["s"], units=2),
              _node("Dense", "o2", ["da"], units=3, activation="softmax")]
    config = {"name": "mimo", "layers": layers,
              "input_layers": [["a", 0, 0], ["b", 0, 0]],
              "output_layers": [["o1", 0, 0], ["o2", 0, 0]]}
    weights = _weights([(5, 4), (4,), (5, 4), (4,), (4, 2), (2,), (4, 3),
                        (3,)], seed=5)
    jm, pm = _both(config, weights)
    xs = [_input((5,), None, seed=s) for s in (3, 4)]
    import jax.numpy as jnp

    want = jm.module.apply(jm.params, tuple(jnp.asarray(x) for x in xs))
    got = _predict(pm, tuple(torch.as_tensor(x) for x in xs))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)


def test_train_mode_batchnorm_matches_jax():
    torch.set_num_threads(1)
    layers, shape, wshapes, _ = _cases()["batchnorm"]
    layers = [dict(layers[0], config=dict(layers[0]["config"],
                                          momentum=0.9))]
    config = _seq(layers, shape)
    weights = _weights(wshapes, seed=7)
    jm, pm = _both(config, weights, train_mode=True)
    x = _input(shape, None, seed=3)
    import jax.numpy as jnp

    out, upd = jm.module.apply(jm.params, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    got = pm.module(torch.as_tensor(x), train=True).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(out), rtol=TOL, atol=TOL)
    stats = pm.module.batch_stats()["layer_0"]
    for key in ("mean", "var"):
        np.testing.assert_allclose(
            stats[key], np.asarray(upd["batch_stats"]["layer_0"][key]),
            rtol=TOL, atol=TOL)
    # inference uses the moving statistics, as the reference does
    np.testing.assert_allclose(
        _predict(pm, x),
        np.asarray(jm.module.apply({**jm.params, **upd}, jnp.asarray(x))),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["conv2d_same_stride", "sepconv2d",
                                  "dwconv2d", "embedding_lstm",
                                  "batchnorm", "layernorm"])
def test_to_keras_config_round_trips(name):
    layers, shape, wshapes, vocab = _cases()[name]
    config = _seq(layers, shape)
    weights = _weights(wshapes, seed=11)
    pm = tk.from_keras_config(config, weights, device="cpu")
    from distkeras_tpu.utils import keras_import as jk

    want_cfg, want_w = jk.to_keras_config(jk.from_keras_config(config,
                                                               weights))
    got_cfg, got_w = tk.to_keras_config(pm)
    assert got_cfg == want_cfg
    assert len(got_w) == len(want_w)
    for a, b in zip(got_w, want_w):
        np.testing.assert_array_equal(a, np.asarray(b))
    again = tk.from_keras_config(got_cfg, got_w, device="cpu")
    x = _input(shape, vocab, seed=5)
    np.testing.assert_allclose(_predict(again, x), _predict(pm, x),
                               rtol=1e-6, atol=1e-6)


def test_strict_and_unsupported_configs_raise_like_the_reference():
    with pytest.raises(ValueError, match="mask_zero"):
        tk.keras_config_to_spec(_seq([_layer("Embedding", input_dim=3,
                                             output_dim=2, mask_zero=True)],
                                     (4,)))
    with pytest.raises(ValueError, match="Unsupported Keras layer 'Bogus'"):
        tk.keras_config_to_spec(_seq([_layer("Bogus")], (4,)))
    config, shapes = _graph("Add", 2)
    config["layers"][1]["inbound_nodes"].append([["in", 0, 0, {}]])
    with pytest.raises(ValueError, match="layer reuse"):
        tk.keras_config_to_graph_spec(config)


def test_imported_cnn_trains_in_single_trainer():
    from distkeras_torch.data.dataset import PartitionedDataset
    from distkeras_torch.trainers import SingleTrainer

    torch.set_num_threads(1)
    layers = [_layer("Conv2D", filters=4, kernel_size=[3, 3],
                     padding="same", activation="relu"),
              _layer("MaxPooling2D", pool_size=[2, 2]),
              _layer("Flatten"),
              _layer("Dense", units=3, activation="softmax")]
    config = _seq(layers, (6, 6, 2))
    weights = _weights([(3, 3, 2, 4), (4,), (36, 3), (3,)], seed=2)
    pm = tk.from_keras_config(config, weights, strip_final_softmax=True,
                              device="cpu")
    rng = np.random.default_rng(0)
    y = rng.integers(0, 3, 64)
    ds = PartitionedDataset.from_arrays(
        {"features": rng.normal(size=(64, 6, 6, 2)).astype(np.float32),
         "label": np.eye(3, dtype=np.float32)[y]})
    tr = SingleTrainer(pm.module, batch_size=16, num_epoch=2,
                       learning_rate=0.05)
    tr.train(ds)
    losses = [r["loss"] for r in tr.history]
    assert len(losses) == 8 and np.all(np.isfinite(losses))
    assert np.mean(losses[4:]) < np.mean(losses[:4])


def test_import_loads_no_keras():
    import subprocess

    code = ("import sys; import distkeras_torch.utils.keras_import as k; "
            "k.keras_available(); "
            "assert 'keras' not in sys.modules and 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)


def test_live_keras_model_matches_import():
    keras = pytest.importorskip("keras")
    torch.set_num_threads(1)
    km = keras.Sequential([
        keras.layers.Input((8, 8, 3)),
        keras.layers.Conv2D(4, (3, 3), padding="same", activation="relu"),
        keras.layers.BatchNormalization(),
        keras.layers.MaxPooling2D((2, 2)),
        keras.layers.Flatten(),
        keras.layers.Dense(5, activation="softmax"),
    ])
    pm = tk.from_keras(km, device="cpu")
    x = _input((8, 8, 3), None, seed=9)
    np.testing.assert_allclose(_predict(pm, x), km.predict(x, verbose=0),
                               rtol=1e-4, atol=1e-5)
    back = tk.to_keras(pm, x)
    np.testing.assert_allclose(back.predict(x, verbose=0), _predict(pm, x),
                               rtol=1e-4, atol=1e-5)
