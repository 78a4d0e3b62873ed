"""The port's msgpack model blob (``distkeras_torch.utils.serde``) and
wire (``distkeras_torch.networking``) against the JAX package's, on the
CPU.

- Serde: a blob written by the reference (``Model.serialize``) loads
  into the port and, written again by the port, back into the reference
  with every parameter bit-exact; the same the other way round — for the
  MLP, both CNNs and the TransformerLM. Trees of every leaf kind the
  codec knows round-trip, and a template restores their structure.
- The wire: a JAX ``RemoteParameterServer`` commits to and pulls from a
  port ``ParameterServerService`` over loopback, and a port client from a
  JAX service, the centers exactly equal to a server driven directly,
  with the native C transport and with the Python one. The frame limit,
  a torn frame and the injected faults raise as the reference's do; a
  ``DOWNPOUR`` trainer trains through ``remote_ps=``; the barrier server
  answers ``commit_and_wait`` over the wire.
"""

import socket
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import distkeras_torch as dk  # noqa: E402
from distkeras_torch import bridge  # noqa: E402
from distkeras_torch import networking as net  # noqa: E402
from distkeras_torch import parameter_servers as pps  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.models.wrapper import Model  # noqa: E402
from distkeras_torch.ops import rules  # noqa: E402
from distkeras_torch.utils import serde  # noqa: E402

CASES = {
    "mlp": (dict(features=(8,), num_classes=4), dict(in_features=12),
            (1, 12)),
    "mnist_cnn": ({}, {}, (1, 28, 28, 1)),
    "cifar_cnn": (dict(widths=(8, 16, 32)), {}, (1, 32, 32, 3)),
    "transformer_lm": (dict(vocab_size=32, d_model=16, num_heads=2,
                            num_layers=1, max_len=8), {}, (1, 8)),
}


def _leaves_equal(a, b):
    fa, fb = rules.flatten(a), rules.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_blob_round_trips_between_the_packages(name, writer):
    import jax
    import jax.numpy as jnp

    from distkeras_tpu.models import get_model as jax_get_model
    from distkeras_tpu.models.wrapper import Model as JaxModel

    kw, port_kw, shape = CASES[name]
    if writer == "jax":
        jm = jax_get_model(name, dtype=jnp.float32, **kw)
        x = (jnp.zeros(shape, jnp.int32) if name == "transformer_lm"
             else jnp.zeros(shape, jnp.float32))
        params = jax.tree.map(np.asarray, jax.jit(jm.init)(
            jax.random.PRNGKey(0), x))
        blob = JaxModel(jm, params).serialize()
        port = Model.deserialize(blob, device="cpu")
        _leaves_equal(params, bridge.params_to_jax(port.module))
        back = JaxModel.deserialize(port.serialize())
        _leaves_equal(params, jax.tree.map(np.asarray, back.params))
        assert back.module == jm
    else:
        pm = get_model(name, dtype=torch.float32, device="cpu", seed=1,
                       **kw, **port_kw)
        params = bridge.params_to_jax(pm)
        blob = Model(pm).serialize()
        jmodel = JaxModel.deserialize(blob)
        _leaves_equal(params, jax.tree.map(np.asarray, jmodel.params))
        again = Model.deserialize(jmodel.serialize(), device="cpu")
        _leaves_equal(params, bridge.params_to_jax(again.module))
        assert again.module.config() == pm.config()


def test_trainer_serialize_and_tree_codec():
    """``Trainer.serialize`` writes the trained weights; every leaf kind
    flax's codec knows (arrays of each dtype, numpy scalars, complex,
    Python scalars, strings, lists) round-trips, and ``like=`` restores
    tuples and tensors."""
    model = get_model("mlp", features=(8,), num_classes=4, in_features=12,
                      dtype=torch.float32, device="cpu")
    trainer = dk.SingleTrainer(model)
    blob = trainer.serialize()
    assert blob["model"]["name"] == "mlp"
    assert blob["model"]["torch_kwargs"] == {"in_features": 12}
    assert blob["model"]["kwargs"]["dtype"] == {"__dtype__": "float32"}
    _leaves_equal(bridge.params_to_jax(model),
                  serde.deserialize_pytree(blob["weights"]))
    tree = {"f32": np.arange(6, dtype=np.float32).reshape(2, 3),
            "i64": np.arange(3), "u8": np.ones(2, np.uint8),
            "scalar": np.float64(2.5), "c": 1 + 2j, "n": 7, "s": "x",
            "l": [np.zeros(2, np.float16), 3.0],
            "t": torch.arange(4, dtype=torch.float64)}
    back = serde.unpackb(serde.packb(tree))
    np.testing.assert_array_equal(back["f32"], tree["f32"])
    assert back["i64"].dtype == np.int64 and back["u8"].dtype == np.uint8
    assert back["scalar"] == 2.5 and isinstance(back["scalar"], np.float64)
    assert back["c"] == 1 + 2j and back["n"] == 7 and back["s"] == "x"
    assert back["l"][0].dtype == np.float16 and back["l"][1] == 3.0
    np.testing.assert_array_equal(back["t"], np.arange(4.0))
    like = {"a": (torch.zeros(2), torch.zeros(3, dtype=torch.float64))}
    data = serde.serialize_pytree({"a": (np.ones(2, np.float32),
                                         np.ones(3))})
    restored = serde.deserialize_pytree(data, like=like)
    assert isinstance(restored["a"], tuple)
    assert restored["a"][1].dtype == torch.float64


def test_chunked_arrays_match_flax(monkeypatch):
    """An array over the chunk limit travels as flax's chunked dict; the
    bytes equal flax's own encoding at the same limit."""
    from flax import serialization as fs

    monkeypatch.setattr(serde, "MAX_CHUNK_SIZE", 16)
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 16)
    tree = {"big": np.arange(10, dtype=np.float32), "small": np.ones(2)}
    assert serde.packb(tree) == fs.msgpack_serialize(tree)
    back = serde.unpackb(fs.msgpack_serialize(tree))
    np.testing.assert_array_equal(back["big"], tree["big"])


# -- the wire --------------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                       "b": rng.normal(size=(5,)).astype(np.float32)}}


def _transport(native, monkeypatch):
    from distkeras_tpu import networking as jnet

    for mod in (net, jnet):
        if native:
            if not mod.native_transport_active():
                pytest.skip("no C compiler for the native transport")
        else:
            monkeypatch.setattr(mod, "_native", False)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("client", ["jax", "port"])
def test_wire_between_the_packages(client, native, monkeypatch):
    """DynSGD's server behind one package's service, the other package's
    client committing and pulling (clocks included): the served center
    equals the client's pull and a server of the service's package driven
    directly, exactly."""
    from distkeras_tpu import networking as jnet
    from distkeras_tpu import parameter_servers as jps

    _transport(native, monkeypatch)
    init = _tree(0)
    if client == "jax":
        served = pps.DynSGDParameterServer(init, device="cpu")
        direct = pps.DynSGDParameterServer(init, device="cpu")
        service = net.ParameterServerService(served)
        remote = jnet.RemoteParameterServer("127.0.0.1", service.port)
    else:
        served = jps.DynSGDParameterServer(init)
        direct = jps.DynSGDParameterServer(init)
        service = jnet.ParameterServerService(served)
        remote = net.RemoteParameterServer("127.0.0.1", service.port)
    service.start()
    try:
        for i in range(5):
            _, clock = remote.pull_with_clock()
            delta = _tree(10 + i)
            if client == "port":
                delta = rules.to_tensors(delta, "cpu")
            remote.commit(delta, worker=i % 2, worker_clock=clock - i % 2)
            direct.commit(_tree(10 + i), worker=i % 2,
                          worker_clock=max(0, clock - i % 2))
        pulled = remote.pull()
        if client == "port":
            assert all(isinstance(v, torch.Tensor) for v in pulled.values())
            pulled = rules.to_numpy(pulled)
        _leaves_equal(served.get_model(), pulled)
        _leaves_equal(direct.get_model(), served.get_model())
        assert served.staleness_log == direct.staleness_log
        assert remote.num_updates == 5
        remote.close()
    finally:
        service.stop()


def _pair():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cli = socket.create_connection(srv.getsockname())
    conn, _ = srv.accept()
    srv.close()
    return cli, conn


@pytest.mark.parametrize("native", [True, False])
def test_frames_limits_and_faults(native, monkeypatch):
    """Frames round-trip; a header over ``max_bytes`` raises FrameError
    naming the limit; a truncate fault makes the peer see a torn frame;
    a kill fault raises at the sender; counters count what moved."""
    _transport(native, monkeypatch)
    cli, srv = _pair()
    try:
        for p in (b"", b"x", b"hello" * 1000):
            net.send_frame(cli, p)
            assert net.recv_frame(srv) == p
        net.send_msg(cli, {"a": np.arange(3.0)})
        np.testing.assert_array_equal(net.recv_msg(srv)["a"], np.arange(3.0))
        net.send_frame(cli, b"y" * 100)
        with pytest.raises(net.FrameError, match="max_bytes=10") as e:
            net.recv_frame(srv, max_bytes=10)
        assert e.value.limit == 10 and e.value.size == 100
    finally:
        cli.close()
        srv.close()
    cli, srv = _pair()
    fi = net.FaultInjector(seed=0)
    fi.rule("truncate", direction="send", min_bytes=64)
    net.install_fault_injector(fi)
    try:
        net.send_frame(cli, b"ok")
        assert net.recv_frame(srv) == b"ok"
        with pytest.raises(ConnectionError):
            net.send_frame(cli, b"z" * 128)
        with pytest.raises(net.FrameError, match="truncated"):
            net.recv_frame(srv)
        assert fi.rules[0].fired == 1
    finally:
        net.uninstall_fault_injector()
        cli.close()
        srv.close()
    with pytest.raises(ValueError, match="unknown fault action"):
        net.FaultRule("explode")


def test_training_and_the_barrier_over_the_wire():
    """DOWNPOUR with ``remote_ps=`` trains against a port service (every
    window's commit arrives); two port clients run EASGD rounds through
    ``commit_and_wait`` and ``leave``; ``stats`` reports the updates."""
    from distkeras_torch.data.dataset import PartitionedDataset

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 16)) * 3.0
    labels = rng.integers(0, 4, size=256)
    x = (centers[labels] + rng.normal(size=(256, 16))).astype(np.float32)
    cols = {"features": x, "label": np.eye(4, dtype=np.float32)[labels]}
    model = get_model("mlp", features=(24,), num_classes=4, in_features=16,
                      dtype=torch.float32, device="cpu")
    ps = pps.DeltaParameterServer(bridge.params_to_jax(model), device="cpu")
    service = net.ParameterServerService(ps)
    service.start()
    try:
        t = dk.DOWNPOUR(model, num_workers=2, communication_window=2,
                        remote_ps=("127.0.0.1", service.port),
                        worker_optimizer="sgd", learning_rate=0.1,
                        label_col="label", batch_size=32, num_epoch=2)
        out = t.train(PartitionedDataset.from_arrays(cols, 2))
        assert ps.num_updates == 2 * 2 * 2
        _leaves_equal(ps.get_model(), t.params)
        assert (out.predict(x).argmax(1) == labels).mean() > 0.9
        assert service.remote_done == 1
        stats = net.RemoteParameterServer("127.0.0.1", service.port).stats()
        assert stats["num_updates"] == 8
    finally:
        service.stop()
    barrier = pps.EASGDParameterServer(_tree(0), num_workers=2, rho=1.0,
                                       elastic_lr=0.25, device="cpu")
    service = net.ParameterServerService(barrier)
    service.start()
    try:
        seen = [None, None]

        def worker(i):
            remote = net.RemoteParameterServer("127.0.0.1", service.port)
            seen[i] = remote.commit_and_wait(_tree(1 + i), worker=i)
            remote.leave(i)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        _leaves_equal(rules.to_numpy(seen[0]), _tree(0))
        _leaves_equal(rules.to_numpy(seen[1]), _tree(0))
        assert barrier.num_updates == 1
    finally:
        service.stop()
