"""Switch-MoE and expert parallelism in the port (``distkeras_torch.ops.
moe``, :class:`MoeLM`, ``make_moe_lm_train_step``) against the JAX
package, on the CPU.

Single process, from the same numpy inputs and weights:

- ``switch_moe`` against JAX's ``switch_moe`` (1e-6, the aux 1e-7; the
  gradients of x and the router 1e-5) at k=1, k=2, a capacity overflow
  (the dropped rows exactly 0 on both sides) and ties (an all-zero
  router: both send every token to the lowest experts);
- ``MoeLM`` logits and every gradient of ``sum(logits * w) + mean
  aux`` against JAX's ``apply`` / ``grad`` with the sown aux (1e-4);
  greedy ``generate`` on a ``MoeLM`` equal to JAX's; the ep specs and
  the ep init (the slices of the ``ep_size=1`` init).

Four gloo ranks, spawned ONCE for the module (``ep_world``), laid out
``{'dp': 2, 'ep': 2}``; each dp coordinate's pair of ranks is also a
``{'dp': 1, 'ep': 2}`` mesh of its own (``_ep_pair``):

- the ep=2 layer against JAX's unsharded layer applied per source block
  (the counterpart of ``test_moe.py``'s sharded-equals-blockwise case);
- the port's dp x ep step at dp=1 x ep=2, 3 AdamW steps, against JAX's
  ``make_moe_lm_train_step`` on its CPU mesh (``{'dp': 1, 'ep': 2}``):
  losses and gathered parameters within 1e-4;
- the same at dp=2 x ep=2 with ``remat='block'``, against JAX's step on
  ``{'dp': 2, 'ep': 2}`` with its ``nn.remat`` blocks (the expert
  gradients summed over dp, the recompute outside ``with mesh:``);
- ``LMTrainer(axes={'dp': 2, 'ep': 2})`` on that remat model: its
  history equals the step's, and its plain-layout checkpoint loads into
  an ``ep_size=1`` model.

The worker functions import no JAX.
"""

import datetime
import os
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from distkeras_torch import bridge  # noqa: E402
from distkeras_torch.checkpoint import Checkpointer  # noqa: E402
from distkeras_torch.data.dataset import PartitionedDataset  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.models.transformer import generate  # noqa: E402
from distkeras_torch.ops.moe import switch_moe  # noqa: E402
from distkeras_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from distkeras_torch.parallel.spmd import (  # noqa: E402
    ep_dim, lm_param_specs, make_moe_lm_train_step, shard_state)
from distkeras_torch.trainers import LMTrainer  # noqa: E402
from distkeras_torch.utils.losses import get_optimizer  # noqa: E402

from torch_spawn_util import spawn_ranks  # noqa: E402

EP = 2
DP = 2  # the world is {dp: DP, ep: EP}
TIMEOUT_S = 240
E, D, F = 8, 16, 32
S_LOCAL = 24  # tokens per source rank
# the reference's MoE LM (tests/test_moe.py) at 16 positions
KW = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2, max_len=16,
          dtype=torch.float32, device="cpu", moe_experts=8)
LR = 3e-3
STEPS = 3


def _layer_inputs(seed=0, zero_router=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(EP * S_LOCAL, D)).astype(np.float32)
    router = rng.normal(size=(D, E)).astype(np.float32) * 0.5
    if zero_router:
        router = np.zeros_like(router)
    w1 = rng.normal(size=(E, D, F)).astype(np.float32) * 0.1
    b1 = rng.normal(size=(E, F)).astype(np.float32) * 0.1
    w2 = rng.normal(size=(E, F, D)).astype(np.float32) * 0.1
    b2 = rng.normal(size=(E, D)).astype(np.float32) * 0.1
    return x, router, w1, b1, w2, b2


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], size=shape).astype(np.int64)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _jax_model(**over):
    import jax.numpy as jnp

    from distkeras_tpu.models import get_model as jax_get_model

    kw = {k: v for k, v in KW.items() if k not in ("dtype", "device")}
    return jax_get_model("moe_lm", dtype=jnp.float32, **dict(kw, **over))


# -- single process -------------------------------------------------------------


CASES = {"top1": (1, 1.25, {}), "top2": (2, 1.25, {}),
         "overflow": (1, 0.1, {}), "ties_top1": (1, 1.25, {"zero": True}),
         "ties_top2": (2, 1.25, {"zero": True})}


@pytest.mark.parametrize("case", sorted(CASES))
def test_switch_moe_matches_jax(case):
    import jax
    import jax.numpy as jnp

    from distkeras_tpu.ops.moe import switch_moe as jax_switch_moe

    k, cf, opt = CASES[case]
    x, router, w1, b1, w2, b2 = _layer_inputs(1, opt.get("zero", False))
    x = x[:S_LOCAL]
    g = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jf(x, router):
        y, aux = jax_switch_moe(x, router, w1, b1, w2, b2,
                                capacity_factor=cf, dtype=jnp.float32,
                                top_k=k)
        return jnp.sum(y * g) + aux, (y, aux)

    (_, (jy, jaux)), (jdx, jdr) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jnp.asarray(x),
                                           jnp.asarray(router))
    tx = torch.tensor(x, requires_grad=True)
    tr = torch.tensor(router, requires_grad=True)
    y, aux = switch_moe(tx, tr, *(torch.tensor(a) for a in (w1, b1, w2,
                                                            b2)),
                        capacity_factor=cf, top_k=k)
    ((y * torch.tensor(g)).sum() + aux).backward()
    jy = np.asarray(jy)
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=0, atol=1e-6)
    assert abs(aux.item() - float(jaux)) <= 1e-7
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jdr), rtol=1e-5,
                               atol=1e-5)
    dropped = np.all(jy == 0.0, axis=-1)
    assert np.array_equal(np.all(y.detach().numpy() == 0.0, axis=-1),
                          dropped)
    if case == "overflow":
        # C = max(1, int(0.1 * 24 / 8)) = 1 slot an expert: at most E rows
        assert dropped.sum() >= S_LOCAL - E
    if opt.get("zero"):
        # uniform probabilities: every first choice is expert 0 (and every
        # second expert 1), so only C tokens per choice are kept
        C = max(1, int(cf * k * S_LOCAL / E))
        assert (~dropped).sum() == C


def _moe_pair(seed=0, **over):
    """The reference MoeLM, its numpy weights (the port's init from
    ``seed``) and the port MoeLM loaded with them."""
    pm = get_model("moe_lm", seed=seed, **dict(KW, **over))
    return _jax_model(**over), bridge.params_to_jax(pm), pm


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_lm_logits_and_grads_match_jax(top_k):
    import jax
    import jax.numpy as jnp

    jm, tree, pm = _moe_pair(3, moe_top_k=top_k)
    toks = _tokens(4, (2, 16))
    w = np.random.default_rng(5).normal(
        size=(2, 16, KW["vocab_size"])).astype(np.float32)

    def jloss(p):
        logits, state = jm.apply(p, jnp.asarray(toks, jnp.int32),
                                 mutable=["intermediates"])
        auxes = jax.tree.leaves(state["intermediates"])
        return (jnp.sum(logits * w) + sum(auxes) / len(auxes)), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    logits, auxes = pm(torch.as_tensor(toks), return_aux=True)
    assert len(auxes) == KW["num_layers"]
    ((logits * torch.as_tensor(w)).sum() + sum(auxes) / len(auxes)
     ).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    grads = {bridge.flax_key(n)[len("params/"):]: p.grad.numpy()
             for n, p in pm.named_parameters()}
    jflat = _flat(jax.tree.map(np.asarray, jgrads)["params"])
    assert sorted(grads) == sorted(jflat)
    for k, g in jflat.items():
        np.testing.assert_allclose(grads[k], g, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_moe_lm_generates_like_jax():
    from distkeras_tpu.models.transformer import generate as jax_generate

    jm, tree, pm = _moe_pair(6)
    prompt = _tokens(8, (2, 5))
    want = np.asarray(jax_generate(jm, tree, prompt.astype(np.int32), 8))
    got = generate(pm, prompt, 8).numpy()
    np.testing.assert_array_equal(got, want)
    from distkeras_torch.models.transformer import beam_search

    # beam 1 is greedy, through the decode path's MoE layers
    np.testing.assert_array_equal(beam_search(pm, prompt, 8, beam_size=1)
                                  .numpy(), want)


def test_ep_specs_and_init_are_the_unsharded_slices():
    full = get_model("moe_lm", seed=5, **KW)
    specs = lm_param_specs(full, ep_axis="ep")
    assert specs["blocks.0.moe.router"] == ()
    assert specs["blocks.0.moe.w1"] == ("ep", None, None)
    assert specs["blocks.1.moe.b2"] == ("ep", None)
    assert specs["blocks.0.CausalSelfAttention_0.qkv.kernel"] == ()
    assert ep_dim("Block_0/moe/w2") == 0 and ep_dim("blocks.0.moe.router") \
        is None
    for r in range(EP):
        with Mesh({"dp": 1, "ep": EP}, {"dp": 0, "ep": r}, {}):
            m = get_model("moe_lm", seed=5, ep_size=EP, **KW)
        assert m.ep_rank == r and m.blocks[0].moe.w1.shape[0] == E // EP
        want = shard_state(full.state_dict(), 0, 1, r, EP)
        for k, v in m.state_dict().items():
            assert torch.equal(v, want[k]), k
    with pytest.raises(ValueError, match="bound mesh"):
        m(torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="not divisible"):
        get_model("moe_lm", **dict(KW, moe_experts=3, ep_size=2))
    with pytest.raises(ValueError, match="model.ep_size=1 != mesh"):
        make_moe_lm_train_step(full, get_optimizer("sgd"), mesh=Mesh(
            {"dp": 1, "ep": 2}, {"dp": 0, "ep": 0}, {}))
    # the trainer's MoE path refuses what the reference's refuses, before
    # it builds a mesh
    ds = PartitionedDataset.from_arrays({"tokens": _tokens(0, (8, 16))})
    for axes, match in (({"dp": 2}, "needs an 'ep' mesh axis"),
                        ({"ep": 2, "sp": 2}, "drop sp"),
                        ({"ep": 2, "tp": 2}, "drop tp")):
        with pytest.raises(ValueError, match=match):
            LMTrainer(m, batch_size=4, axes=axes).train(ds)


# -- two gloo ranks -------------------------------------------------------------


def _ep_pair(mesh):
    """This rank's ``{dp: 1, ep: 2}`` mesh: its dp coordinate's pair of
    ranks of the ``{dp: 2, ep: 2}`` world."""
    g = mesh.group("ep")
    return Mesh({"dp": 1, "ep": EP}, {"dp": 0, "ep": mesh.index("ep")},
                {("ep",): g, ("dp", "ep"): g})


# the dp x ep step's runs: (mesh of the world or of an ep pair, rows a
# step, remat)
RUNS = {"step": ("pair", 4, "none"), "dpep": ("world", 8, "block")}


def _case_layer(mesh, saved):
    x, router, w1, b1, w2, b2 = _layer_inputs(0)
    r = mesh.index("ep")
    lo = r * (E // EP)
    mine = slice(r * S_LOCAL, (r + 1) * S_LOCAL)
    for k in (1, 2):
        y, aux = switch_moe(torch.tensor(x[mine]), torch.tensor(router),
                            *(torch.tensor(a[lo:lo + E // EP])
                              for a in (w1, b1, w2, b2)),
                            ep_size=EP, group=mesh.group("ep"), top_k=k)
        saved[f"layer/k{k}/y"] = y.numpy()
        saved[f"layer/k{k}/aux"] = np.asarray(float(aux))


def _case_step(mesh, saved, tree, run):
    _, rows, remat = RUNS[run]
    with mesh:
        m = get_model("moe_lm", seed=9, ep_size=EP, remat=remat, **KW)
    bridge.params_from_jax(tree, m)
    step = make_moe_lm_train_step(m, get_optimizer("adamw", LR), mesh=mesh,
                                  window=True)
    saved[f"{run}/losses"] = step(_tokens(0, (STEPS, rows, 16))).numpy()
    with mesh:
        for k, v in _flat(bridge.params_to_jax(m)).items():
            saved[f"{run}/params/{k}"] = v


def _case_trainer(mesh, saved, tree, out):
    with mesh:
        m = get_model("moe_lm", seed=9, ep_size=EP, remat="block", **KW)
    trainer = LMTrainer(m, params=tree, batch_size=8,
                        axes={"dp": DP, "ep": EP},
                        worker_optimizer=get_optimizer("adamw", LR),
                        checkpointer=Checkpointer(os.path.join(out, "ck"),
                                                  every_steps=1))
    trainer.train(PartitionedDataset.from_arrays(
        {"tokens": _tokens(0, (STEPS, 8, 16)).reshape(-1, 16)}))
    saved["trainer/history"] = np.asarray(
        [h["loss"] for h in trainer.history])
    for k, v in _flat(trainer.params).items():
        saved[f"trainer/params/{k}"] = v


def _ep_entry(rank, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=DP * EP,
                            timeout=datetime.timedelta(seconds=120))
    saved = {}
    try:
        world = make_mesh({"dp": DP, "ep": EP})
        pair = _ep_pair(world)
        tree = bridge.params_to_jax(get_model("moe_lm", seed=1, **KW))
        _case_layer(pair, saved)
        for run, (where, _, _) in RUNS.items():
            _case_step(pair if where == "pair" else world, saved, tree, run)
        _case_trainer(world, saved, tree, out)
        np.savez(os.path.join(out, f"rank{rank}.npz"), **saved)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ep_world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ep_world"))
    spawn_ranks(_ep_entry, DP * EP, out, TIMEOUT_S)
    return out, [dict(np.load(os.path.join(out, f"rank{r}.npz")))
                 for r in range(DP * EP)]


@pytest.mark.parametrize("k", [1, 2])
def test_ep2_layer_equals_jax_blockwise(ep_world, k):
    import jax
    import jax.numpy as jnp

    from distkeras_tpu.ops.moe import switch_moe as jax_switch_moe

    _, ranks = ep_world
    x, router, w1, b1, w2, b2 = _layer_inputs(0)
    for r, got in enumerate(ranks):
        e = r % EP  # the world is laid out {dp, ep}, ep fastest
        y, aux = jax.jit(lambda xs: jax_switch_moe(
            xs, router, w1, b1, w2, b2, dtype=jnp.float32, top_k=k))(
                jnp.asarray(x[e * S_LOCAL:(e + 1) * S_LOCAL]))
        np.testing.assert_allclose(got[f"layer/k{k}/y"], np.asarray(y),
                                   rtol=1e-6, atol=1e-6, err_msg=f"rank {r}")
        assert abs(float(got[f"layer/k{k}/aux"]) - float(aux)) <= 1e-7


def _jax_moe_steps(run):
    import jax
    import jax.numpy as jnp
    import optax

    from distkeras_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from distkeras_tpu.parallel.spmd import make_moe_lm_train_step as jstep

    where, rows, remat = RUNS[run]
    tree = bridge.params_to_jax(get_model("moe_lm", seed=1, **KW))
    params = jax.tree.map(jnp.asarray, tree)
    mesh = jax_make_mesh({"dp": DP if where == "world" else 1, "ep": EP})
    opt = optax.adamw(LR)
    step = jstep(_jax_model(ep_size=EP, ep_axis="ep", remat=remat), opt,
                 mesh, params_template=params, window=True)
    p, _, losses = step(params, opt.init(params),
                        jnp.asarray(_tokens(0, (STEPS, rows, 16)),
                                    jnp.int32))
    return np.asarray(losses), _flat(jax.tree.map(np.asarray, p))


def _assert_matches_jax(ranks, run):
    want, params = _jax_moe_steps(run)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{run}/losses"], want, rtol=1e-4,
                                   atol=1e-4, err_msg=f"rank {r}")
        for k, v in params.items():
            g = got[f"{run}/params/{k}"]
            if k.endswith("qkv/bias"):
                # the key bias shifts every logit of a query row alike, so
                # softmax makes its gradient 0 up to rounding, and Adam
                # turns that rounding into steps of up to lr either way:
                # held to that bound, the query and value biases at 1e-4
                np.testing.assert_allclose(g[1], v[1], rtol=0,
                                           atol=2 * STEPS * LR)
                g, v = g[[0, 2]], v[[0, 2]]
            np.testing.assert_allclose(g, v, rtol=1e-4, atol=1e-4,
                                       err_msg=f"rank {r} {k}")


def test_ep2_step_and_trainer_match_jax_moe_step(ep_world):
    out, ranks = ep_world
    _assert_matches_jax(ranks, "step")
    for r, got in enumerate(ranks):
        # the trainer runs the dp=2 x ep=2 step on the same rows
        np.testing.assert_array_equal(got["trainer/history"],
                                      got["dpep/losses"])
        for k in _flat(bridge.params_to_jax(get_model("moe_lm", **KW))):
            np.testing.assert_array_equal(got[f"trainer/params/{k}"],
                                          got[f"dpep/params/{k}"])
    # its checkpoint is the plain layout: it loads into an ep_size=1 model
    from distkeras_torch.checkpoint import Checkpointer as Ck

    _, state = Ck(os.path.join(out, "ck")).restore()
    one = get_model("moe_lm", **KW)
    bridge.params_from_jax(state["params"], one)
    for k, v in _flat(bridge.params_to_jax(one)).items():
        np.testing.assert_array_equal(v, ranks[0][f"trainer/params/{k}"])
    assert len(state["opt_state"]["state"]) == len(list(one.parameters()))


def test_dp2_ep2_remat_step_matches_jax_moe_step(ep_world):
    """dp=2 x ep=2: the expert banks' gradients summed over dp only, the
    replicated ones over dp x ep; under remat the blocks' recompute runs
    in the backward, outside the step's ``with mesh:``."""
    _, ranks = ep_world
    _assert_matches_jax(ranks, "dpep")
