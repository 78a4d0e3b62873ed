"""Tensor parallelism in the port's training path against the unsharded
math, on the CPU.

Single process: the partition rules (the port of
``test_spmd.py::test_lm_param_specs_gqa_tp_shardable``), the
``shard_state`` / ``gather_state`` movers, the tp init (exactly the
slices of the ``tp_size=1`` init from the same seed) and the checks that
keep a tp model from running unsharded.

Four gloo ranks, spawned ONCE for the module (``tp_world``, with a
timeout of its own that names the stalled ranks), run every
multi-process case; the tests read their results:

- the tp=2 model (MHA and GQA) against JAX's unsharded ``apply`` and
  ``grad`` on the bridged parameters: logits and every gradient within
  1e-5;
- dp2 x tp2: 3 AdamW steps of ``make_lm_train_step(tp_axis='tp')``, the
  gathered parameters within 1e-5 of the port's unsharded step (and the
  losses within 1e-4 of the jitted unsharded JAX step, the reference's
  own tp step failing on this JAX build);
- sp2 x tp2 with ``attention='ring'``: the loss equals the unsharded
  loss;
- ``LMTrainer(axes={'dp': 2, 'tp': 2})``: a checkpoint of epoch 1
  resumes at tp=1 to the trajectory of a run that never stopped, and a
  tp=1 checkpoint resumes at tp=2 the same way.

The worker functions import no JAX (the ranks are spawned processes
that import this module).
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
from distkeras_torch.parallel import collectives as col  # noqa: E402
from distkeras_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from distkeras_torch.parallel.spmd import (  # noqa: E402
    draft_param_specs, gather_state, lm_param_specs, make_lm_train_step,
    shard_state, tp_dim)
from distkeras_torch.trainers import LMTrainer  # noqa: E402
from distkeras_torch.utils.losses import get_optimizer  # noqa: E402

from torch_spawn_util import spawn_ranks  # noqa: E402

WORLD = 4
TIMEOUT_S = 240
# the reference's KW (tests/test_tp_serving.py) at f32, 16 positions
KW = dict(vocab_size=64, d_model=32, num_heads=8, num_layers=2, max_len=16,
          dtype=torch.float32, device="cpu")
HEADS = {"mha": {}, "gqa": {"num_kv_heads": 4}}
LR = 3e-4
STEPS = 3
TRAINER_LR = 1e-2


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], size=shape).astype(np.int64)


def _full_tree(seed, **over):
    """The numpy flax tree of the tp=1 port model drawn from ``seed``."""
    return bridge.params_to_jax(get_model("transformer_lm", seed=seed,
                                          **dict(KW, **over)))


def _fake_mesh(axes, coords):
    """A mesh of several positions seen from one of them, without a
    world: enough for building tp models and for validation (no
    collective runs)."""
    return Mesh(axes, coords, {})


# -- single process -------------------------------------------------------------


def test_lm_param_specs_gqa_tp_shardable():
    """Every attention / MLP parameter of a GQA model carries the tp axis
    on the dimension TPDenseGeneral shards, and that dimension divides
    by the mesh; the rest is replicated."""
    tp = 4
    model = get_model("transformer_lm", **dict(KW, num_kv_heads=4))
    specs = lm_param_specs(model, tp_axis="tp")
    want = {
        "q_proj.kernel": (None, "tp", None),
        "q_proj.bias": ("tp", None),
        "kv_proj.kernel": (None, None, "tp", None),
        "kv_proj.bias": (None, "tp", None),
        "out.kernel": ("tp", None, None),
        "out.bias": (),
        "mlp_up.kernel": (None, "tp"),
        "mlp_up.bias": ("tp",),
        "mlp_down.kernel": ("tp", None),
        "mlp_down.bias": (),
    }
    seen = set()
    for name, p in model.named_parameters():
        key = ".".join(name.split(".")[-2:])
        spec = specs[name]
        assert spec == want.get(key, ()), name
        seen.add(key if key in want else None)
        for dim, axis in enumerate(spec):
            if axis is not None:
                assert p.shape[dim] % tp == 0, name
                assert tp_dim(name) == dim
    assert seen - {None} == set(want)
    assert all(s == () for s in lm_param_specs(model).values())
    # the flax path names the same rule
    assert tp_dim("Block_1/CausalSelfAttention_0/kv_proj/kernel") == 2


@pytest.mark.parametrize("heads", sorted(HEADS))
def test_tp_init_is_the_slices_of_the_unsharded_init(heads):
    full = get_model("transformer_lm", seed=5, **dict(KW, **HEADS[heads]))
    parts = []
    for r in range(2):
        with _fake_mesh({"dp": 1, "tp": 2}, {"dp": 0, "tp": r}):
            m = get_model("transformer_lm", seed=5, tp_size=2,
                          **dict(KW, **HEADS[heads]))
        assert m.tp_rank == r
        want = shard_state(full.state_dict(), r, 2)
        got = m.state_dict()
        assert sorted(got) == sorted(want)
        for k in got:
            assert torch.equal(got[k], want[k]), k
        parts.append(got)
    # the slices put back together are the whole
    for k, v in full.state_dict().items():
        d = tp_dim(k)
        joined = (parts[0][k] if d is None
                  else torch.cat([parts[0][k], parts[1][k]], dim=d))
        assert torch.equal(joined, v), k
    # shard() makes the same slices from a model's weights, contiguous
    mesh = _fake_mesh({"model": 2}, {"model": 1})
    twin = full.shard(mesh, "model")
    assert twin.tp_size == 2 and twin.tp_axis == "model"
    for k, v in twin.state_dict().items():
        assert v.is_contiguous() and torch.equal(v, parts[1][k]), k
    # a tp model of one rank's shapes: local heads, Hk/tp cache heads
    attn = twin.blocks[0].CausalSelfAttention_0
    Hk = (HEADS[heads].get("num_kv_heads") or KW["num_heads"])
    assert (attn.num_heads, attn.num_kv_heads) == (4, Hk // 2)
    cache = twin.clone(decode=True).init_cache(2)
    assert cache.layers[0]["key"].shape[-2] == Hk // 2


def test_state_movers_of_one_rank():
    model = get_model("transformer_lm", **KW)
    state = model.state_dict()
    assert shard_state(state, 0, 1) == state
    got = gather_state(model)
    for k, v in state.items():
        assert torch.equal(got[k], v)
    # a draft whose heads do not divide the mesh is replicated whole
    draft = get_model("transformer_lm", **dict(KW, num_heads=2,
                                                num_kv_heads=1, d_model=16))
    specs, dtp = draft_param_specs(draft, 2)
    assert dtp == 1 and all(s == () for s in specs.values())
    specs, dtp = draft_param_specs(model, 2)
    assert dtp == 2 and specs["blocks.0.mlp_up.kernel"] == (None, "model")


def test_tp_model_refuses_to_run_unsharded():
    with pytest.raises(ValueError, match="bound mesh"):
        get_model("transformer_lm", tp_size=2, **KW)
    with pytest.raises(ValueError, match="num_kv_heads=2 not divisible"):
        with _fake_mesh({"tp": 4}, {"tp": 0}):
            get_model("transformer_lm", tp_size=4,
                      **dict(KW, num_kv_heads=2))
    with _fake_mesh({"tp": 2}, {"tp": 1}):
        m = get_model("transformer_lm", tp_size=2, **KW)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="bound mesh"):
        m(toks)  # outside any mesh: never quietly unsharded
    with _fake_mesh({"tp": 2}, {"tp": 0}):
        with pytest.raises(ValueError, match="rank 1's slices"):
            m(toks)
    with pytest.raises(ValueError, match="cannot change 'tp_size'"):
        m.clone(tp_size=1)
    with pytest.raises(ValueError, match="its mesh"):
        gather_state(m)
    # the step checks the model against the mesh
    one = get_model("transformer_lm", **KW)
    with pytest.raises(ValueError, match="no 'tp' axis"):
        make_lm_train_step(one, get_optimizer("sgd"),
                           mesh=make_mesh({"dp": 1, "sp": 1}), tp_axis="tp")
    with pytest.raises(ValueError, match="model.tp_size=2 != mesh"):
        make_lm_train_step(m, get_optimizer("sgd"),
                           mesh=make_mesh({"dp": 1, "sp": 1}))
    # every tp collective is the identity in a group of one
    x = torch.arange(4.0)
    assert col.copy_to_tp(x) is x and col.reduce_from_tp(x) is x
    assert col.all_gather_tp(x) is x


# -- four gloo ranks ------------------------------------------------------------


def _lm_loss_grads(model, tokens, weights):
    """Logits and the gradients of ``sum(logits * weights)``."""
    model.zero_grad(set_to_none=True)
    logits = model(torch.as_tensor(tokens))
    (logits * torch.as_tensor(weights)).sum().backward()
    return logits.detach()


def _case_fwd_grad(rank, mesh, saved):
    tokens = _tokens(0, (2, 8))
    weights = np.random.default_rng(1).normal(
        size=(2, 8, KW["vocab_size"])).astype(np.float32)
    for heads, over in sorted(HEADS.items()):
        tree = _full_tree(3, **over)
        with mesh:
            # drawn from another seed: the bridge must overwrite every slice
            m = get_model("transformer_lm", seed=9, tp_size=2,
                          **dict(KW, **over))
            bridge.params_from_jax(tree, m)
            logits = _lm_loss_grads(m, tokens, weights)
            grads = {}
            for name, p in m.named_parameters():
                d = tp_dim(name)
                grads[name] = (col.all_gather_tp(p.grad, mesh.group("tp"), d)
                               if d is not None else p.grad)
            state = gather_state(m)
        saved[f"{heads}/logits"] = logits.numpy()
        for name, g in grads.items():
            saved[f"{heads}/grad/{bridge.flax_key(name)}"] = g.numpy()
        full = get_model("transformer_lm", **dict(KW, **over))
        bridge.params_from_jax(tree, full)
        saved[f"{heads}/gather_exact"] = np.asarray(all(
            torch.equal(state[k], v) for k, v in full.state_dict().items()))


def _case_dp2_tp2(rank, mesh, saved):
    tree = _full_tree(4, **HEADS["gqa"])
    batches = _tokens(2, (STEPS, 4, 8))
    with mesh:
        m = get_model("transformer_lm", seed=0, tp_size=2,
                      **dict(KW, **HEADS["gqa"]))
    bridge.params_from_jax(tree, m)
    step = make_lm_train_step(m, get_optimizer("adamw", LR), mesh=mesh,
                              tp_axis="tp")
    saved["dp2tp2/losses"] = np.asarray([step(b).item() for b in batches])
    with mesh:
        out = bridge.params_to_jax(m)
    for k, v in _flat(out).items():
        saved[f"dp2tp2/params/{k}"] = v
    # the replicated parameters stayed bit-identical over tp
    rep = torch.cat([p.detach().reshape(-1) for n, p in m.named_parameters()
                     if tp_dim(n) is None])
    other = col.all_gather_tp(rep, mesh.group("tp"), 0).reshape(2, -1)
    saved["dp2tp2/replicated_equal"] = np.asarray(
        torch.equal(other[0], other[1]))


def _case_sp2_tp2(rank, mesh, saved):
    tree = _full_tree(6)
    tokens = _tokens(3, (2, 8))
    with mesh:
        m = get_model("transformer_lm", seed=0, tp_size=2,
                      attention="ring", **KW)
    bridge.params_from_jax(tree, m)
    step = make_lm_train_step(m, get_optimizer("sgd", 0.1), mesh=mesh,
                              tp_axis="tp")
    saved["sp2tp2/losses"] = np.asarray([step(tokens).item()
                                         for _ in range(2)])


def _trainer(model, ckpt, epochs, **kw):
    return LMTrainer(
        model, batch_size=4, num_epoch=epochs,
        worker_optimizer=get_optimizer("adamw", TRAINER_LR,
                                       mu_dtype=torch.bfloat16),
        checkpointer=None if ckpt is None else Checkpointer(
            ckpt, every_steps=1), **kw)


def _trainer_data():
    return PartitionedDataset.from_arrays({"tokens": _tokens(7, (8, 8))})


def _case_trainer(rank, mesh, saved, out):
    axes = {"dp": 2, "tp": 2}

    def tp_model():
        with mesh:
            return get_model("transformer_lm", seed=1, tp_size=2, **KW)

    ds = _trainer_data()
    whole = _trainer(tp_model(), None, 2, axes=axes)
    whole.train(ds)
    saved["trainer/whole"] = np.asarray([h["loss"] for h in whole.history])
    # epoch 1 at tp=2, checkpointed (plain layout) for the tp=1 resume
    _trainer(tp_model(), os.path.join(out, "ck_tp2"), 1, axes=axes).train(ds)
    # a tp=1 checkpoint of epoch 1 (written before the spawn) resumed here
    resumed = _trainer(tp_model(), os.path.join(out, "ck_tp1"), 2, axes=axes)
    resumed.train(ds)
    saved["trainer/resumed_from_tp1"] = np.asarray(
        [h["loss"] for h in resumed.history])
    for k, v in _flat(resumed.params).items():
        saved[f"trainer/resumed_params/{k}"] = v


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _tp_entry(rank, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    saved = {}
    try:
        _case_fwd_grad(rank, make_mesh({"dp": 2, "tp": 2}), saved)
        _case_dp2_tp2(rank, make_mesh({"dp": 2, "sp": 1, "tp": 2}), saved)
        _case_sp2_tp2(rank, make_mesh({"dp": 1, "sp": 2, "tp": 2}), saved)
        _case_trainer(rank, make_mesh({"dp": 2, "tp": 2}), saved, out)
        np.savez(os.path.join(out, f"rank{rank}.npz"), **saved)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_world"))
    # the tp=1 checkpoint of epoch 1 the ranks resume at tp=2
    _trainer(get_model("transformer_lm", seed=1, **KW),
             os.path.join(out, "ck_tp1"), 1).train(_trainer_data())
    spawn_ranks(_tp_entry, WORLD, out, TIMEOUT_S)
    return out, [dict(np.load(os.path.join(out, f"rank{r}.npz")))
                 for r in range(WORLD)]


def _jax_logits_grads(tree, over, tokens, weights):
    import jax
    import jax.numpy as jnp

    from distkeras_tpu.models import get_model as jax_get_model

    kw = {k: v for k, v in KW.items() if k not in ("dtype", "device")}
    jm = jax_get_model("transformer_lm", dtype=jnp.float32,
                       **dict(kw, **over))
    params = jax.tree.map(jnp.asarray, tree)

    def loss(p):
        logits = jm.apply(p, jnp.asarray(tokens, jnp.int32))
        return jnp.sum(logits * weights), logits

    (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(logits), {k: np.asarray(v)
                                for k, v in _flat(grads).items()}


@pytest.mark.parametrize("heads", sorted(HEADS))
def test_tp2_matches_jax_unsharded_forward_and_grads(tp_world, heads):
    _, ranks = tp_world
    tokens = _tokens(0, (2, 8))
    weights = np.random.default_rng(1).normal(
        size=(2, 8, KW["vocab_size"])).astype(np.float32)
    logits, grads = _jax_logits_grads(_full_tree(3, **HEADS[heads]),
                                      HEADS[heads], tokens, weights)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{heads}/logits"], logits,
                                   rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")
        for k, g in grads.items():
            np.testing.assert_allclose(got[f"{heads}/grad/{k}"], g,
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {k}")
        assert bool(got[f"{heads}/gather_exact"])


def test_dp2_tp2_adamw_steps_match_unsharded_step(tp_world):
    _, ranks = tp_world
    tree = _full_tree(4, **HEADS["gqa"])
    batches = _tokens(2, (STEPS, 4, 8))
    one = get_model("transformer_lm", **dict(KW, **HEADS["gqa"]))
    bridge.params_from_jax(tree, one)
    step = make_lm_train_step(one, get_optimizer("adamw", LR))
    want = np.asarray([step(b).item() for b in batches])
    params = _flat(bridge.params_to_jax(one))
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["dp2tp2/losses"], want, rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {r}")
        for k, v in params.items():
            g = got[f"dp2tp2/params/{k}"]
            if k.endswith("kv_proj/bias"):
                # the key bias shifts every logit of a query row alike, so
                # softmax makes its gradient 0 up to rounding, and Adam
                # turns that rounding into steps of up to lr either way:
                # held to that bound, the value bias at 1e-5
                np.testing.assert_allclose(g[0], v[0], rtol=0,
                                           atol=2 * STEPS * LR)
                g, v = g[1], v[1]
            np.testing.assert_allclose(g, v, rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {k}")
        assert bool(got["dp2tp2/replicated_equal"])
    # and the reference step's math: the jitted unsharded JAX step
    import jax
    import jax.numpy as jnp
    import optax

    from distkeras_tpu.models import get_model as jax_get_model
    from distkeras_tpu.ops import fused_ce as jce

    kw = {k: v for k, v in KW.items() if k not in ("dtype", "device")}
    feat = jax_get_model("transformer_lm", dtype=jnp.float32,
                         features_only=True, **dict(kw, **HEADS["gqa"]))
    opt = optax.adamw(LR)
    p = jax.tree.map(jnp.asarray, tree)
    state = opt.init(p)

    @jax.jit
    def jstep(p, s, tok):
        def loss_fn(p):
            feats = feat.apply(p, tok)
            targets = jnp.concatenate([tok[:, 1:], tok[:, :1]], axis=1)
            mask = jnp.ones(tok.shape, jnp.float32).at[:, -1].set(0.0)
            total, n = jce.lm_head_loss(feats, p["params"]["head"], targets,
                                        mask)
            return total / n

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    jl = []
    for b in batches:
        p, state, loss = jstep(p, state, jnp.asarray(b, jnp.int32))
        jl.append(float(loss))
    np.testing.assert_allclose(ranks[0]["dp2tp2/losses"], jl, rtol=1e-4,
                               atol=1e-4)


def test_sp2_tp2_ring_loss_equals_unsharded(tp_world):
    _, ranks = tp_world
    one = get_model("transformer_lm", **KW)
    bridge.params_from_jax(_full_tree(6), one)
    step = make_lm_train_step(one, get_optimizer("sgd", 0.1))
    tokens = _tokens(3, (2, 8))
    want = np.asarray([step(tokens).item() for _ in range(2)])
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["sp2tp2/losses"], want, rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {r}")


def test_lm_trainer_tp_checkpoint_resumes_at_other_tp(tp_world):
    out, ranks = tp_world
    ds = _trainer_data()
    # tp=2 epoch 1 -> tp=1 epoch 2, against the tp=2 run that never
    # stopped (and the tp=1 one)
    resumed = _trainer(get_model("transformer_lm", seed=2, **KW),
                       os.path.join(out, "ck_tp2"), 2)
    resumed.train(ds)
    whole_tp1 = _trainer(get_model("transformer_lm", seed=1, **KW), None, 2)
    whole_tp1.train(ds)
    want = np.asarray([h["loss"] for h in whole_tp1.history])
    got = np.asarray([h["loss"] for h in resumed.history])
    for r, rk in enumerate(ranks):
        np.testing.assert_allclose(rk["trainer/whole"], want, rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(got, rk["trainer/whole"][2:], rtol=1e-5,
                                   atol=1e-5)
        # tp=1 epoch 1 -> tp=2 epoch 2
        np.testing.assert_allclose(rk["trainer/resumed_from_tp1"], want[2:],
                                   rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")
        # the weights: Adam moves one whose gradient is near 0 by up to lr
        # a step, whatever rounding decides its sign (the losses above
        # carry the trajectory at 1e-5)
        for k, v in _flat(whole_tp1.params).items():
            np.testing.assert_allclose(rk[f"trainer/resumed_params/{k}"], v,
                                       rtol=0, atol=2 * TRAINER_LR,
                                       err_msg=f"rank {r} {k}")
