"""The port's streaming inference (``distkeras_torch/streaming.py``)
against the JAX package's on the CPU: the same records through the same
MLP weights (bridged), over an iterator and over a socket fed by either
package's ``RecordProducer`` — predictions within 1e-5 at f32, in order,
with the reference's micro-batch count; a producer that dies mid-stream
raises, as the reference's does; every flush calls the model at one
shape."""

import socket
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distkeras_tpu import streaming as js  # noqa: E402
from distkeras_tpu.models import get_model as jax_get_model  # noqa: E402
from distkeras_tpu.models.wrapper import Model as JModel  # noqa: E402
from distkeras_torch import bridge  # noqa: E402
from distkeras_torch import streaming as ts  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.models.wrapper import Model  # noqa: E402

DIM, CLASSES = 8, 4


def _models(seed=0):
    jm = jax_get_model("mlp", features=(16,), num_classes=CLASSES,
                       dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), np.zeros((1, DIM), np.float32)))
    pm = get_model("mlp", features=(16,), num_classes=CLASSES,
                   dtype=torch.float32, in_features=DIM, device="cpu")
    bridge.params_from_jax(params, pm)
    return JModel(jm, params), Model(pm)


def _records(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"id": i, "features": rng.normal(size=DIM).astype(np.float32)}
            for i in range(n)]


def _check(out, want, n):
    assert [r["id"] for r in out] == list(range(n))
    np.testing.assert_allclose(np.stack([r["prediction"] for r in out]),
                               np.stack([r["prediction"] for r in want]),
                               rtol=1e-5, atol=1e-5)


def test_iterator_stream_matches_jax():
    torch.set_num_threads(1)
    jm, pm = _models()
    recs = _records(50)
    tpred = ts.StreamingPredictor(pm, batch_size=16, max_latency_s=None)
    jpred = js.StreamingPredictor(jm, batch_size=16, max_latency_s=None)
    out = list(tpred.predict_stream(ts.iterator_source(recs)))
    _check(out, list(jpred.predict_stream(js.iterator_source(recs))), 50)
    assert tpred.batches_run == jpred.batches_run == 4
    assert tpred.records_seen == 50 and len(tpred.flush_ms) == 4


@pytest.mark.parametrize("producer", ["port", "jax"])
def test_socket_stream_matches_jax(producer):
    torch.set_num_threads(1)
    jm, pm = _models(1)
    recs = _records(40, seed=2)
    mod = ts if producer == "port" else js
    prod = mod.RecordProducer(recs, chunk=7).start()
    pred = ts.StreamingPredictor(pm, batch_size=16, max_latency_s=0.05)
    out = list(pred.predict_stream(ts.socket_source(prod.host, prod.port,
                                                    timeout=20)))
    prod.join()
    want = list(js.StreamingPredictor(jm, batch_size=16).predict_stream(
        js.iterator_source(recs)))
    _check(out, want, 40)


def test_dead_producer_raises_not_truncates():
    from distkeras_torch.networking import send_msg

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def serve():
        conn, _ = srv.accept()
        send_msg(conn, _records(3))
        conn.close()  # no __end__ sentinel
        srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    with pytest.raises(ConnectionError, match="__end__"):
        list(ts.socket_source("127.0.0.1", port, timeout=20))
    t.join(5)


def test_every_flush_has_one_shape_and_kafka_is_gated():
    _, pm = _models()
    shapes = []
    orig = pm.module.forward

    def spy(x):
        shapes.append(tuple(x.shape))
        return orig(x)

    pm.module.forward = spy
    pred = ts.StreamingPredictor(pm, batch_size=8, max_latency_s=None)
    list(pred.predict_stream(ts.iterator_source(_records(21))))
    assert set(shapes) == {(8, DIM)} and len(shapes) == 3
    with pytest.raises(ImportError, match="kafka-python"):
        next(ts.kafka_source("topic", bytes.decode))
