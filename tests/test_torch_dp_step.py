"""The port's data-parallel step and default mesh
(``distkeras_torch.parallel.spmd.make_dp_train_step``,
``distkeras_torch.parallel.mesh.default_mesh``) against the reference's
on the CPU.

- Two gloo ranks (one spawn for the module) run an ``mlp`` (16 hidden,
  4 classes, 64 global rows) for 3 steps with SGD 0.1 and with Adam
  1e-2 over ``default_mesh()``; losses and weights stay within the
  reference test's ``rtol=1e-5, atol=1e-6`` (``tests/test_spmd.py``) of
  the reference's ``make_dp_train_step`` over ``make_mesh({"dp": 2})``
  on its CPU mesh, the ranks end bit-identical, and no rank loads
  ``jax`` or the JAX package.
- On the same two ranks, a mesh whose dp axis has size 1 beside an axis
  of 2 replicates the batch: each rank equals the world of one.
- ``default_mesh`` is ``{"dp": 2}`` on the two ranks with ``index("dp")``
  the rank, ``{"dp": 1}`` at a world of one, and a ``num_workers`` other
  than the world's size raises ``ValueError`` naming both counts.
- At a world of one the step equals ``workers.make_train_step`` bit for
  bit.

The JAX side is imported inside the tests: the spawned ranks import this
module and must load only torch and the port.
"""

import datetime
import os
import sys
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from distkeras_torch import bridge  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.parallel import default_mesh  # noqa: E402
from distkeras_torch.parallel.mesh import make_mesh  # noqa: E402
from distkeras_torch.parallel.spmd import make_dp_train_step  # noqa: E402
from distkeras_torch.utils.losses import get_loss, get_optimizer  # noqa: E402
from distkeras_torch.workers import make_train_step  # noqa: E402

from torch_spawn_util import one_thread, spawn_ranks  # noqa: E402,F401

WORLD = 2
TIMEOUT_S = 120
DIM, CLASSES, ROWS, STEPS = 8, 4, 64, 3
MLP_KW = dict(features=(16,), num_classes=CLASSES)
OPTS = {"sgd": ("sgd", 0.1), "adam": ("adam", 1e-2)}
# tests/test_spmd.py::test_dp_step_equals_global_batch_grad's tolerance
RTOL, ATOL = 1e-5, 1e-6


def _data():
    """STEPS global batches of ROWS rows: normal features, one-hot labels
    (tests/test_spmd.py's, one batch a step)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(STEPS, ROWS, DIM)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES,
                                                       (STEPS, ROWS))]
    return x, y


def _leaves(tree):
    return {f"{k}/{n}": np.asarray(v) for k, d in tree["params"].items()
            for n, v in d.items()}


def _port_run(opt, params, mesh=None):
    """The port's dp step over ``mesh`` from ``params`` (a flax tree):
    the STEPS losses and the trained weights by flax path."""
    model = get_model("mlp", dtype=torch.float32, in_features=DIM,
                      device="cpu", **MLP_KW)
    bridge.params_from_jax(params, model)
    step = make_dp_train_step(model, get_loss("categorical_crossentropy"),
                              get_optimizer(*OPTS[opt]), mesh)
    x, y = _data()
    losses = torch.stack([step(x[i], y[i]) for i in range(STEPS)])
    return {"loss": losses.numpy(),
            **_leaves(bridge.params_to_jax(model))}


def _rank(rank, init, out, params):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    saved = {}
    try:
        mesh = default_mesh()
        saved["mesh"] = np.asarray([mesh.axis_size("dp"), mesh.index("dp")])
        with pytest.raises(ValueError) as err:
            default_mesh(WORLD + 1)
        saved["wrong_workers"] = np.asarray(str(err.value))
        for opt in OPTS:
            saved.update({f"{opt}/{k}": v for k, v in _port_run(
                opt, params, mesh).items()})
        rep = make_mesh({"dp": 1, "rep": WORLD})
        saved.update({f"rep/{k}": v for k, v in _port_run(
            "sgd", params, rep).items()})
        saved["loaded"] = np.asarray(sorted(
            m for m in sys.modules if m.split(".")[0] in (
                "jax", "flax", "optax", "distkeras_tpu")), dtype=str)
        np.savez(os.path.join(out, f"rank{rank}.npz"), **saved)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _jax_params(seed=1):
    import jax
    import jax.numpy as jnp

    from distkeras_tpu.models import get_model as jax_get_model

    jm = jax_get_model("mlp", dtype=jnp.float32, **MLP_KW)
    p = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, DIM), jnp.float32))
    return jm, jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of the two ranks for the module, from the reference's
    init; returns it with each rank's saved arrays."""
    out = str(tmp_path_factory.mktemp("dp_ranks"))
    jm, params = _jax_params()
    spawn_ranks(_rank, WORLD, out, TIMEOUT_S, params)
    return jm, params, [dict(np.load(os.path.join(out, f"rank{r}.npz")))
                        for r in range(WORLD)]


def _jax_run(jm, params, opt):
    """The reference's dp step over its CPU mesh of WORLD devices."""
    import jax
    import jax.numpy as jnp

    from distkeras_tpu.parallel.mesh import make_mesh as jax_mesh
    from distkeras_tpu.parallel.spmd import make_dp_train_step as jax_dp
    from distkeras_tpu.utils.losses import get_loss as jax_loss
    from distkeras_tpu.utils.losses import get_optimizer as jax_opt

    optimizer = jax_opt(*OPTS[opt])
    step = jax_dp(jm.apply, jax_loss("categorical_crossentropy"), optimizer,
                  jax_mesh({"dp": WORLD}))
    p, s = params, optimizer.init(params)
    x, y = _data()
    losses = []
    for i in range(STEPS):
        p, s, loss = step(p, s, jnp.asarray(x[i]), jnp.asarray(y[i]))
        losses.append(float(loss))
    return {"loss": np.asarray(losses),
            **_leaves(jax.tree.map(np.asarray, p))}


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_two_rank_dp_step_matches_jax(two_ranks, opt):
    jm, params, ranks = two_ranks
    want = _jax_run(jm, params, opt)
    mine = {k.split("/", 1)[1]: v for k, v in ranks[0].items()
            if k.startswith(f"{opt}/")}
    assert mine.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(mine[key], w, rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    for key, v in ranks[0].items():
        if key.startswith(f"{opt}/"):
            np.testing.assert_array_equal(ranks[1][key], v, err_msg=key)


def test_ranks_load_no_jax(two_ranks):
    for r in two_ranks[2]:
        assert r["loaded"].tolist() == []


def test_default_mesh_over_two_ranks(two_ranks):
    for rank, r in enumerate(two_ranks[2]):
        assert r["mesh"].tolist() == [WORLD, rank]
        msg = str(r["wrong_workers"])
        assert f"num_workers={WORLD + 1}" in msg and f"has {WORLD}" in msg


def test_dp_of_one_beside_a_replica_axis_is_the_world_of_one(two_ranks):
    """A {"dp": 1, "rep": 2} mesh: both ranks train on the whole batch
    and equal one process's step bit for bit."""
    _, params, ranks = two_ranks
    want = _port_run("sgd", params)
    for r in ranks:
        for key, w in want.items():
            np.testing.assert_array_equal(r[f"rep/{key}"], w, err_msg=key)


def test_default_mesh_world_of_one():
    mesh = default_mesh()
    assert mesh.shape == {"dp": 1} and mesh.index("dp") == 0
    assert mesh.group("dp") is None
    assert default_mesh(1).shape == {"dp": 1}
    with pytest.raises(ValueError, match="num_workers=2 .* has 1"):
        default_mesh(2)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_world_of_one_is_make_train_step(opt):
    """No process group: the dp step and the single-batch step run the
    same ops, so the losses and weights agree bit for bit."""
    _, params = _jax_params(seed=2)
    got = _port_run(opt, params, default_mesh())
    model = get_model("mlp", dtype=torch.float32, in_features=DIM,
                      device="cpu", **MLP_KW)
    bridge.params_from_jax(params, model)
    step = make_train_step(model, get_loss("categorical_crossentropy"),
                           get_optimizer(*OPTS[opt]))
    x, y = _data()
    losses = torch.stack([step(torch.as_tensor(x[i]), torch.as_tensor(y[i]))
                          ["loss"] for i in range(STEPS)])
    want = {"loss": losses.numpy(), **_leaves(bridge.params_to_jax(model))}
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_dp_step_rejects_a_batch_or_mesh_it_cannot_split():
    model = get_model("mlp", dtype=torch.float32, in_features=DIM,
                      device="cpu", seed=0, **MLP_KW)
    loss = get_loss("categorical_crossentropy")
    with pytest.raises(ValueError, match="no 'dp' axis"):
        make_dp_train_step(model, loss, get_optimizer("sgd", 0.1),
                           make_mesh({"data": 1}))
    step = make_dp_train_step(model, loss, get_optimizer("sgd", 0.1))
    x, y = _data()
    with pytest.raises(ValueError, match="labels 63"):
        step(x[0], y[0, :-1])
