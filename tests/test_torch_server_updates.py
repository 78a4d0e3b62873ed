"""Live weight updates through the port's server on the CPU: the
``push_weights`` wire op (chunk reassembly, typed refusals, mid-stream
pushes that drop nothing), the payload codec against flax's, and the two
feeders — ``CheckpointWatcher`` over the port's ``Checkpointer`` and
``ParameterServerFeed`` over the port's parameter servers, local and
remote.

Tolerances: greedy token streams are compared exactly against the port's
``generate()`` on the pushed weights (f32); codec blobs byte for byte."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401
from torch_lockorder_util import lock_order  # noqa: E402,F401

from distkeras_torch import bridge, networking  # noqa: E402
from distkeras_torch.checkpoint import Checkpointer  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.models.transformer import generate  # noqa: E402
from distkeras_torch.parameter_servers import DeltaParameterServer  # noqa: E402
from distkeras_torch.serving import (  # noqa: E402
    CheckpointWatcher,
    LMServer,
    ParameterServerFeed,
    ServingClient,
    WeightPushError,
    deserialize_weights,
    serialize_weights,
)
from distkeras_torch.serving.weights import chunk_payload  # noqa: E402
from distkeras_torch.telemetry import EventJournal  # noqa: E402

TIMEOUT = 60.0
PROMPT = np.arange(1, 9, dtype=np.int32)


@pytest.fixture(scope="module")
def trees():
    """Flax-layout numpy trees A and B (two seeds of the tiny model)."""
    _, pa, _ = U.pair(seed=0)
    _, pb, _ = U.pair(seed=1)
    return U.jax.tree.map(np.asarray, pa), U.jax.tree.map(np.asarray, pb)


def _model(tree):
    pm = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                   **U.KW)
    bridge.params_from_jax(tree, pm)
    return pm


def _ref(tree, n, prompt=PROMPT):
    return generate(_model(tree), torch.as_tensor(prompt)[None], n)[
        0, len(prompt):].tolist()


@pytest.fixture
def server(request):
    """``server(tree, **engine_kw)`` -> (LMServer, client); both are
    closed when the test ends."""
    items = []

    def make(tree, **kw):
        kw.setdefault("paged", True)
        srv = LMServer(U.port_engine(_model(tree), **kw)).start()
        c = ServingClient("127.0.0.1", srv.port, timeout=TIMEOUT,
                          request_timeout=TIMEOUT)
        items.append((srv, c))
        return srv, c

    def fin():
        for srv, c in items:
            c.close()
            srv.stop(timeout=10.0)

    request.addfinalizer(fin)
    return make


# -- the codec ----------------------------------------------------------------


def test_payload_codec_is_flax_msgpack(trees):
    """serialize_weights writes flax's bytes (numpy or tensor leaves);
    a flax blob decodes to the same tree."""
    from flax import serialization

    ta, _ = trees
    blob = serialize_weights(ta)
    assert blob == serialization.msgpack_serialize(ta)
    as_tensors = U.jax.tree.map(lambda a: torch.tensor(np.array(a)), ta)
    assert serialize_weights(as_tensors) == blob
    back = deserialize_weights(serialization.msgpack_serialize(ta))
    flat = U.jax.tree_util.tree_leaves_with_path(ta)
    assert len(flat) == len(U.jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)


def test_chunk_payload():
    assert chunk_payload(b"", 4) == [b""]
    assert chunk_payload(b"abcdefghij", 4) == [b"abcd", b"efgh", b"ij"]
    with pytest.raises(ValueError, match="chunk_bytes"):
        chunk_payload(b"x", 0)


# -- the push_weights op -------------------------------------------------------


@pytest.mark.parametrize("mode", ["paged", "pipelined", "slot"])
def test_push_weights_wire_roundtrip_and_refusal(trees, server, mode):
    ta, tb = trees
    kw = {"paged": {}, "pipelined": dict(pipeline=True),
          "slot": dict(paged=False)}[mode]
    srv, c = server(ta, **kw)
    out = c.push_weights(tb, version=3, chunk_bytes=2048)
    assert out["version"] == 3 and out["swap_ms"] is not None
    assert c.result(c.generate(PROMPT, max_new_tokens=6)) == (
        _ref(tb, 6), "length")
    bad = U.jax.tree.map(
        lambda a: np.zeros(np.shape(a) + (1,), np.asarray(a).dtype), tb)
    with pytest.raises(WeightPushError, match="shape"):
        c.push_weights(bad, chunk_bytes=2048)
    with pytest.raises(WeightPushError, match="undecodable"):
        c.push_weights(payload=b"\xc1 not msgpack")
    assert c.stats()["weight_version"] == 3
    with pytest.raises(WeightPushError, match="out-of-order"):
        c._call({"op": "push_weights", "seq": 1, "n": 2, "chunk": b"xx"})


def test_midstream_wire_pushes_drop_nothing(trees, server):
    """Pushes arriving while streams are in flight: every stream ends
    with its full token count, none disconnects; a request admitted
    after the last ack equals generate() on the last pushed weights."""
    ta, tb = trees
    srv, c = server(ta, slots=3, pipeline=True)
    rids = [c.generate(PROMPT, max_new_tokens=24, temperature=1.0, seed=i)
            for i in range(5)]
    pusher = ServingClient("127.0.0.1", srv.port, timeout=TIMEOUT,
                           request_timeout=TIMEOUT)
    try:
        for tree in (tb, ta, tb):
            pusher.push_weights(tree, chunk_bytes=4096)
    finally:
        pusher.close()
    results = [c.result(rid) for rid in rids]
    assert all(reason == "length" and len(toks) == 24
               for toks, reason in results), results
    assert c.stats()["weight_swaps"] == 3
    assert c.result(c.generate(PROMPT, max_new_tokens=6)) == (
        _ref(tb, 6), "length")


def test_undrain_roundtrip(trees, server):
    ta, _ = trees
    _, c = server(ta)
    c.drain()
    assert c.stats()["draining"]
    c.undrain()
    assert not c.stats()["draining"]
    toks, reason = c.result(c.generate(PROMPT, max_new_tokens=2))
    assert reason == "length" and len(toks) == 2


# -- feeders -------------------------------------------------------------------


def test_checkpoint_watcher_pushes_new_steps(trees, server, tmp_path):
    ta, tb = trees
    srv, c = server(ta)
    eng = srv.engine
    ck = Checkpointer(str(tmp_path / "ok"), every_steps=1)
    ck.maybe_save(5, tb["params"])
    journal = EventJournal(actor="deploy")
    w = CheckpointWatcher(str(tmp_path / "ok"), c, journal=journal)
    assert w.poll_once()
    assert not w.poll_once()  # same step: no re-push
    assert eng.weight_version == 5
    assert c.result(c.generate(PROMPT, max_new_tokens=6)) == (
        _ref(tb, 6), "length")
    ck.maybe_save(6, ta["params"])
    assert w.poll_once()
    assert eng.weight_version == 6
    # a bad checkpoint is refused, recorded, and does not stop a watcher
    ck2 = Checkpointer(str(tmp_path / "bad"), every_steps=1)
    ck2.maybe_save(1, {"nope": np.zeros((2,), np.float32)})
    wbad = CheckpointWatcher(str(tmp_path / "bad"), c, journal=journal)
    assert not wbad.poll_once()
    assert wbad.errors and wbad.errors[0][0] == 1
    assert eng.weight_version == 6
    assert [(e["version"], e["outcome"]) for e in journal.events()] == [
        (5, "ok"), (6, "ok"), (1, "refused")]
    # the thread: a step written later is pushed by the running watcher
    w.interval_s = 0.02
    w.start()
    try:
        ck.maybe_save(9, tb["params"])
        deadline = time.monotonic() + TIMEOUT
        while eng.weight_version != 9 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        w.stop()
        wbad.stop()
    assert eng.weight_version == 9 and w.pushed == 3


@pytest.mark.parametrize("where", ["local", "remote"])
def test_parameter_server_feed_follows_commits(trees, server, where):
    ta, _ = trees
    srv, c = server(ta)
    eng = srv.engine
    ps = DeltaParameterServer(ta, device="cpu")
    service = None
    if where == "remote":
        service = networking.ParameterServerService(ps)
        service.start()
        source = networking.RemoteParameterServer("127.0.0.1", service.port)
    else:
        source = ps
    try:
        feed = ParameterServerFeed(source, c, min_updates=1)
        assert not feed.poll_once()  # no commits yet
        delta = U.jax.tree.map(lambda a: np.full_like(a, 0.01), ta)
        ps.commit(delta)
        assert feed.poll_once()
        # version 1 is the engine's own: a push of 1 bumps to 2
        assert eng.weight_version == 2
        center = ps.get_model()
        assert c.result(c.generate(PROMPT, max_new_tokens=6)) == (
            _ref(center, 6), "length")
        assert not feed.poll_once()  # no new commits: no re-push
        ps.commit(delta)
        assert feed.poll_once()
        assert feed.pushed == 2 and eng.weight_version == 3
        feed.stop()
    finally:
        if service is not None:
            source.close()
            service.stop()
