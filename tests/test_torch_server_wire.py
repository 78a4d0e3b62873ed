"""The wire contract across packages: a JAX ``ServingClient`` drives the
port's ``LMServer`` and a port ``ServingClient`` drives the JAX
``LMServer``, on one tiny model whose weights are the same in both
(``torch_engine_util.pair()``). The framing, the op set, the reply
fields and the typed error codes are the reference's, so every call
below goes through unchanged.

Tolerances: greedy token streams are compared exactly (f32 weights; the
JAX engine attends through its gather reference)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401
from torch_lockorder_util import lock_order  # noqa: E402,F401

from distkeras_tpu.serving import LMServer as JaxServer  # noqa: E402
from distkeras_tpu.serving import ServingClient as JaxClient  # noqa: E402
from distkeras_tpu.serving import WeightPushError as JaxWeightPushError  # noqa: E402
from distkeras_torch import bridge  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.models.transformer import generate  # noqa: E402
from distkeras_torch.serving import (  # noqa: E402
    LMServer,
    ServingClient,
    UnknownOpError,
    WeightPushError,
)

TIMEOUT = 60.0
PROMPTS = [np.arange(1, 9, dtype=np.int32),
           np.array([5, 17, 3, 88, 41, 9, 60], np.int32)]


@pytest.fixture(scope="module")
def weights():
    """(jax module, params A, numpy trees A and B)."""
    jm, pa, _ = U.pair(seed=0)
    _, pb, _ = U.pair(seed=1)
    return (jm, pa, U.jax.tree.map(np.asarray, pa),
            U.jax.tree.map(np.asarray, pb))


def _model(tree):
    pm = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                   **U.KW)
    bridge.params_from_jax(tree, pm)
    return pm


def _want(tree, prompt, n):
    return generate(_model(tree), torch.as_tensor(prompt)[None], n)[
        0, len(prompt):].tolist()


@pytest.fixture
def stack(request):
    """Servers and clients to stop and close when the test ends."""
    items = []
    request.addfinalizer(lambda: [
        (x.close() if hasattr(x, "close") else x.stop(timeout=10.0))
        for x in reversed(items)])
    return items


def test_jax_client_drives_a_port_server(weights, stack):
    """generate, stats, a flax push_weights payload and its typed
    refusal, all from the reference's client."""
    _, _, ta, tb = weights
    eng = U.port_engine(_model(ta), paged=True)
    srv = LMServer(eng).start()
    stack.append(srv)
    c = JaxClient("127.0.0.1", srv.port, timeout=TIMEOUT,
                  request_timeout=TIMEOUT)
    stack.append(c)
    rids = [c.generate(p, max_new_tokens=6) for p in PROMPTS]
    for p, rid in zip(PROMPTS, rids):
        assert c.result(rid) == (_want(ta, p, 6), "length")
    st = c.stats()
    assert st["requests_completed"] == 2 and st["tokens_generated"] == 12
    out = c.push_weights(tb, version=5, chunk_bytes=4096)
    assert out["version"] == 5 and out["swap_ms"] is not None
    for p in PROMPTS:
        assert c.result(c.generate(p, max_new_tokens=6)) == (
            _want(tb, p, 6), "length")
    bad = {"params": dict(tb["params"])}
    bad["params"].pop("ln_f")
    with pytest.raises(JaxWeightPushError, match="ln_f"):
        c.push_weights(bad, chunk_bytes=4096)
    assert c.stats()["weight_version"] == 5


def test_port_client_drives_a_jax_server(weights, stack):
    """The port's client against the reference's server: greedy streams
    equal the port's generate(), a pushed port tree (tensor leaves)
    swaps the JAX engine's weights, refusals arrive typed."""
    jm, pa, ta, tb = weights
    srv = JaxServer(U.jax_engine(jm, pa, paged=True)).start()
    stack.append(srv)
    c = ServingClient("127.0.0.1", srv.port, timeout=TIMEOUT,
                      request_timeout=TIMEOUT)
    stack.append(c)
    for p in PROMPTS:
        assert c.result(c.generate(p, max_new_tokens=6)) == (
            _want(ta, p, 6), "length")
    with pytest.raises(UnknownOpError):
        c._call({"op": "nope"})
    port_b = {"params": {name: dict(leaves)
                         for name, leaves in tb["params"].items()}}
    for leaves in port_b["params"].values():  # tensor leaves on the wire
        for k in list(leaves):
            if not isinstance(leaves[k], dict):
                leaves[k] = torch.as_tensor(np.array(leaves[k]))
    out = c.push_weights(port_b, version=3, chunk_bytes=4096)
    assert out["version"] == 3
    # a prompt the JAX engine never served: the reference keeps its
    # prefix cache across a swap, so a block it cached under the old
    # weights would be reused (the port retires its cache)
    p = np.array([70, 2, 33, 9, 14, 61, 25, 7, 50], np.int32)
    assert c.result(c.generate(p, max_new_tokens=6)) == (
        _want(tb, p, 6), "length")
    with pytest.raises(WeightPushError, match="shape"):
        c.push_weights({"params": {**tb["params"], "ln_f": {
            k: np.zeros((3,), np.float32)
            for k in tb["params"]["ln_f"]}}}, chunk_bytes=4096)
