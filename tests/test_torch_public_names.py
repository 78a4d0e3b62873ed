"""The last public names the port took from the reference, each against
the reference's own on the CPU, and the name-by-name inventory of both
packages.

- ``Model.beam_search`` (``distkeras_torch.models.wrapper``): its beams
  equal the reference method's on the same weights, over the beam sizes
  and length penalties ``tests/test_torch_beam.py`` holds the function
  at; both packages raise ``TypeError`` on an ``mlp``.
- ``networking.determine_host_address``: equal to the reference's on
  this host and an IPv4 address; ``127.0.0.1`` in both packages when
  the socket's ``connect`` raises ``OSError``.
- Every public function, class and method of ``distkeras_tpu`` (read
  from its syntax trees, nothing imported) has a namesake in the same
  module of ``distkeras_torch``, except the JAX-only names ``ROADMAP.md``
  records with the reason the port has none.
"""

import ast
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401

from distkeras_torch import networking  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.models.transformer import beam_search  # noqa: E402
from distkeras_torch.models.wrapper import Model  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# public names of the reference with no counterpart in the port, each
# for a reason ROADMAP.md records: eager torch has no compiled step to
# share; the port shards by parameter name (tp_dim / ep_dim /
# shard_state / shard_opt_state) instead of PartitionSpec trees
JAX_ONLY = {
    "workers": {"share_compiled", "Worker.set_compiled"},
    "parallel.spmd": {"opt_state_specs", "serving_cache_specs"},
}


@pytest.fixture(scope="module")
def trio():
    return U.pair(cache_dtype="int8")


@pytest.mark.parametrize("kw", [
    dict(beam_size=3),
    dict(beam_size=4, eos="probe", length_penalty=0.6),
])
def test_beam_search_method_equals_jax(trio, kw):
    from distkeras_tpu.models.wrapper import Model as JaxModel

    jm, params, pm = trio
    kw = dict(kw)
    prompt = np.random.default_rng(0).integers(0, U.V, size=(2, 9)).astype(
        np.int32)
    if kw.pop("eos", None):
        free = beam_search(pm, prompt, 8, **kw)
        kw["eos_id"] = int(free[0, 10])
    want = JaxModel(jm, params).beam_search(prompt, 8, **kw)
    got = Model(pm).beam_search(prompt, 8, **kw)
    assert isinstance(got, np.ndarray)
    assert got.tolist() == want.tolist()
    assert got.tolist() == beam_search(pm, prompt, 8, **kw).tolist()


def test_beam_search_method_raises_on_a_classifier():
    import jax
    import jax.numpy as jnp

    from distkeras_tpu.models import get_model as jax_get_model
    from distkeras_tpu.models.wrapper import Model as JaxModel

    jm = jax_get_model("mlp", features=(8,), num_classes=4,
                       dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.float32))
    pm = get_model("mlp", features=(8,), num_classes=4, in_features=8,
                   dtype=torch.float32, device="cpu", seed=0)
    prompt = np.zeros((1, 4), np.int32)
    for model in (JaxModel(jm, params), Model(pm)):
        with pytest.raises(TypeError, match="MLP is not a language model; "
                           "beam_search"):
            model.beam_search(prompt, 4)


def test_determine_host_address_equals_jax():
    from distkeras_tpu import networking as jax_networking

    addr = networking.determine_host_address()
    socket.inet_aton(addr)  # parses as IPv4
    assert addr == jax_networking.determine_host_address()


class _Unroutable(socket.socket):
    def connect(self, address):
        raise OSError("Network is unreachable")


def test_determine_host_address_falls_back_to_loopback(monkeypatch):
    from distkeras_tpu import networking as jax_networking

    monkeypatch.setattr(socket, "socket", _Unroutable)
    assert networking.determine_host_address() == "127.0.0.1"
    assert jax_networking.determine_host_address() == "127.0.0.1"


def _public_names(package):
    """``{module: {name, Class.method, ...}}`` of ``package``'s top-level
    public functions and classes and their public methods."""
    base = os.path.join(ROOT, package)
    out = {}
    for folder, _, files in os.walk(base):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(folder, f)
            module = os.path.relpath(path, base)[:-3].replace(os.sep, ".")
            with open(path) as fh:
                tree = ast.parse(fh.read())
            names = set()
            for node in tree.body:
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.ClassDef)) or \
                        node.name.startswith("_"):
                    continue
                names.add(node.name)
                if isinstance(node, ast.ClassDef):
                    names |= {f"{node.name}.{m.name}" for m in node.body
                              if isinstance(m, (ast.FunctionDef,
                                                ast.AsyncFunctionDef))
                              and not m.name.startswith("_")}
            out[module] = names
    return out


def test_every_public_name_of_the_reference_has_a_counterpart():
    ref, port = _public_names("distkeras_tpu"), _public_names(
        "distkeras_torch")
    missing = {m: names - port.get(m, set())
               for m, names in ref.items()}
    missing = {m: sorted(n) for m, n in missing.items() if n}
    assert missing == {m: sorted(n) for m, n in JAX_ONLY.items()}
