"""The port's training slice against the JAX package on the CPU, from the
same numpy inputs and the same weights (JAX ``init`` ->
``bridge.params_from_jax``):

- fused chunked CE (``ops/fused_ce.py``): value and gradients of
  ``fused_linear_softmax_ce`` / ``lm_head_loss`` against the reference
  op, at the tolerances ``tests/test_fused_ce.py`` holds the reference
  to (value 1e-5 rel / 1e-4 abs; bf16 gradients 3e-2; f32 gradients
  1e-5, both being the same f32 algorithm);
- optimizers: ``get_optimizer`` against the reference's optax table
  after 3 updates from the same gradients (1e-6: the same f32 formula),
  ``adamw(mu_dtype=bf16)`` included, with its bf16 first moment;
- the train step: a 10-step loss trajectory of ``make_lm_train_step``
  against a jitted JAX step of the same math (the reference ``lm_bench``
  step: features-only model + fused CE, ``optax.adamw(3e-4,
  mu_dtype=bf16)``) at f32 (1e-4 per loss: eager PyTorch and XLA sum in
  other orders, and Adam's normalisation carries that into the weights);
- ``LMTrainer``: its history equals the port's own step loop exactly,
  and follows the same jitted JAX step (1e-4). The reference's
  ``LMTrainer`` itself raises on this JAX build (its fused-CE custom VJP
  under ``shard_map`` trips a varying-axes type check — one of the
  pre-existing training-side failures), so the JAX side is the step it
  runs, called batch by batch;
- ``remat='block'`` gradients equal ``remat='none'``;
- the f32-master repair: a bf16 model stores every parameter in f32,
  gets f32 gradients, and round-trips the weight bridge exactly.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from distkeras_tpu.models import get_model as jax_get_model  # noqa: E402
from distkeras_tpu.ops import fused_ce as jce  # noqa: E402
from distkeras_tpu.utils.losses import get_optimizer as jax_optimizer  # noqa: E402
from distkeras_torch import bridge  # noqa: E402
from distkeras_torch.data.dataset import PartitionedDataset  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.models.wrapper import Model  # noqa: E402
from distkeras_torch.ops import fused_ce as tce  # noqa: E402
from distkeras_torch.parallel.spmd import make_lm_train_step  # noqa: E402
from distkeras_torch.trainers import LMTrainer  # noqa: E402
from distkeras_torch.utils.losses import get_optimizer  # noqa: E402
from torch_spawn_util import one_thread  # noqa: E402,F401

TINY = dict(vocab_size=61, d_model=32, num_heads=2, num_layers=2,
            max_len=16)


def _pair(seed=0, dtype="float32", **over):
    """The reference module, its numpy weights, and the port module
    loaded with them (CPU)."""
    kw = dict(TINY, **over)
    jm = jax_get_model("transformer_lm", dtype=getattr(jnp, dtype), **kw)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 4), jnp.int32))
    np_params = jax.tree.map(np.asarray, params)
    pm = get_model("transformer_lm", dtype=getattr(torch, dtype),
                   device="cpu", **kw)
    bridge.params_from_jax(np_params, pm)
    return jm, params, np_params, pm


def _tokens(seed, shape, vocab=TINY["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(
        np.int32)


def _jax_steps(jm, params, batches, opt):
    """The reference lm_bench step (bench.py:168-182), jitted, called
    once per batch: the losses and the final params."""
    feat = jm.clone(features_only=True)

    def loss_fn(p, tok):
        feats = feat.apply(p, tok)
        targets = jnp.concatenate([tok[:, 1:], jnp.zeros_like(tok[:, :1])],
                                  axis=1)
        mask = jnp.ones(tok.shape, jnp.float32).at[:, -1].set(0.0)
        s, n = jce.lm_head_loss(feats, p["params"]["head"], targets, mask)
        return s / n

    @jax.jit
    def one(p, s, tok):
        loss, grads = jax.value_and_grad(loss_fn)(p, tok)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    state = opt.init(params)
    losses = []
    for tok in batches:
        params, state, loss = one(params, state, jnp.asarray(tok))
        losses.append(float(loss))
    return np.asarray(losses), params


# -- fused chunked CE --------------------------------------------------------


def _ce_inputs(seed, N=37, D=16, V=50):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    kernel = (rng.normal(size=(D, V)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=(V,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, V, size=N).astype(np.int32)
    weights = (rng.random(N) > 0.2).astype(np.float32)
    return x, kernel, bias, labels, weights


@pytest.mark.parametrize("chunk", [8, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ce_matches_jax(chunk, dtype):
    x, kernel, bias, labels, weights = _ce_inputs(chunk)

    def jloss(x_, k_, b_, w_):
        return jce.fused_linear_softmax_ce(
            x_.astype(getattr(jnp, dtype)), k_, b_, jnp.asarray(labels),
            w_, chunk)

    want, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, kernel, bias, weights)))
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (x, kernel, bias, weights)]
    got = tce.fused_linear_softmax_ce(
        ts[0].to(getattr(torch, dtype)), ts[1], ts[2],
        torch.from_numpy(labels), ts[3], chunk)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                               atol=1e-4)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    for t, g, name in zip(ts, jgrads, ("dx", "dkernel", "dbias", "dw")):
        assert t.grad.dtype == torch.float32, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=tol,
                                   atol=tol, err_msg=name)


def test_lm_head_loss_matches_jax():
    rng = np.random.default_rng(9)
    B, T, D, V = 2, 7, 16, 40
    feats = rng.normal(size=(B, T, D)).astype(np.float32)
    head = {"kernel": (rng.normal(size=(D, V)) * 0.2).astype(np.float32),
            "bias": np.zeros(V, np.float32)}
    targets = rng.integers(0, V, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    mask[:, -1] = 0.0
    s_j, n_j = jce.lm_head_loss(jnp.asarray(feats),
                                jax.tree.map(jnp.asarray, head),
                                jnp.asarray(targets), jnp.asarray(mask),
                                chunk=4)
    s_t, n_t = tce.lm_head_loss(
        torch.from_numpy(feats),
        {k: torch.from_numpy(v) for k, v in head.items()},
        torch.from_numpy(targets), torch.from_numpy(mask), chunk=4)
    np.testing.assert_allclose(s_t.item(), float(s_j), rtol=1e-5, atol=1e-4)
    assert n_t.item() == float(n_j) == B * (T - 1)


# -- optimizers ----------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("momentum", {}), ("nesterov", {"momentum": 0.8}),
    ("adam", {}), ("adamw", {}), ("adamw", {"mu_dtype": "bfloat16"}),
    ("adamw", {"weight_decay": 0.1, "b1": 0.8}),
])
def test_optimizers_match_optax(name, kw):
    rng = np.random.default_rng(4)
    shapes = ((3, 4), (5,))
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 0.1).astype(np.float32) for s in shapes]
             for _ in range(3)]
    jkw = {k: (getattr(jnp, v) if k == "mu_dtype" else v)
           for k, v in kw.items()}
    tkw = {k: (getattr(torch, v) if k == "mu_dtype" else v)
           for k, v in kw.items()}
    opt = jax_optimizer(name, 0.05, **jkw)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    for g in grads:
        updates, state = opt.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = get_optimizer(name, 0.05, **tkw)(tp)
    for g in grads:
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        topt.step()
    for p, want in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    if kw.get("mu_dtype"):
        mus = [topt.state[p]["mu"] for p in tp]
        assert all(m.dtype == torch.bfloat16 for m in mus)
        jmu = state[0].mu  # optax ScaleByAdamState
        for m, want in zip(mus, jmu):
            assert want.dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                m.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("name", ["categorical_crossentropy",
                                  "sparse_categorical_crossentropy",
                                  "binary_crossentropy", "mse", "mae"])
def test_losses_and_metrics_match_jax(name):
    from distkeras_tpu.utils import losses as jl
    from distkeras_torch.utils import losses as tl

    rng = np.random.default_rng(8)
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    if name == "sparse_categorical_crossentropy":
        labels = rng.integers(0, 5, size=6)
    elif name == "binary_crossentropy":
        labels = (rng.random((6, 5)) > 0.5).astype(np.float32)
    else:
        labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=6)]
    want = float(jl.get_loss(name)(jnp.asarray(logits), jnp.asarray(labels)))
    got = tl.get_loss(name)(torch.from_numpy(logits),
                            torch.from_numpy(labels)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    metrics = (["accuracy"] if name == "sparse_categorical_crossentropy"
               else ["accuracy", "mse", "mae"])
    for (n, fn), (jn, jfn) in zip(tl.resolve_metrics(metrics),
                                  jl.resolve_metrics(metrics)):
        assert n == jn
        np.testing.assert_allclose(
            fn(torch.from_numpy(logits), torch.from_numpy(labels)).item(),
            float(jfn(jnp.asarray(logits), jnp.asarray(labels))),
            rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="Unknown loss"):
        tl.get_loss("hinge")


def test_optimizer_names():
    # rmsprop, adagrad and adadelta are ported now (optax semantics; their
    # trajectories are held to the reference in test_torch_dk_trainers)
    for name in ("rmsprop", "adagrad", "adadelta"):
        p = torch.nn.Parameter(torch.zeros(3))
        assert isinstance(get_optimizer(name, 1e-3)([p]),
                          torch.optim.Optimizer)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        get_optimizer("lamb")
    p = torch.nn.Parameter(torch.zeros(3))
    opt = get_optimizer("adamw", 1e-3)([p])
    assert opt.param_groups[0]["weight_decay"] == 1e-4  # optax's default
    assert get_optimizer(opt) is opt


# -- the train step ------------------------------------------------------------


def test_train_step_trajectory_matches_jax():
    jm, params, _, pm = _pair(seed=1)
    batches = _tokens(2, (10, 4, 16))
    want, _ = _jax_steps(jm, params, batches,
                         optax.adamw(3e-4, mu_dtype=jnp.bfloat16))
    step = make_lm_train_step(
        pm, get_optimizer("adamw", 3e-4, mu_dtype=torch.bfloat16),
        window=True)
    got = step(batches)
    assert got.shape == (10,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_window_step_equals_single_steps_and_unfused_loss():
    """W steps in one window == W single steps (the same ops, exact);
    the unfused full-logits loss agrees with the fused one (sgd, f32)."""
    batches = _tokens(3, (3, 2, 12))
    losses = {}
    for kind in ("window", "single", "unfused"):
        pm = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                       seed=5, **TINY)
        opt = get_optimizer("sgd", 0.1)
        if kind == "window":
            losses[kind] = make_lm_train_step(pm, opt, window=True)(
                batches).numpy()
        else:
            step = make_lm_train_step(pm, opt,
                                      fused_ce=kind != "unfused")
            losses[kind] = np.asarray([step(b).item() for b in batches])
    np.testing.assert_array_equal(losses["window"], losses["single"])
    np.testing.assert_allclose(losses["unfused"], losses["single"],
                               rtol=1e-5, atol=1e-5)


def test_train_steps_emit_a_forward_and_a_backward_span_a_step():
    """A window of W steps of ``make_lm_train_step(window=True)`` and of
    ``make_window_step`` records W ``train.forward`` and W
    ``train.backward`` phase spans on the global tracer, in turn."""
    from distkeras_torch import telemetry
    from distkeras_torch.workers import make_window_step

    tracer = telemetry.get_tracer()
    W = 3
    pm = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                   seed=5, **TINY)
    lm_window = make_lm_train_step(pm, get_optimizer("sgd", 0.1),
                                   window=True)
    lin = torch.nn.Linear(4, 3)
    dense_window = make_window_step(
        lin, lambda logits, y: ((logits - y) ** 2).mean(),
        get_optimizer("sgd", 0.1))
    calls = [lambda: lm_window(_tokens(3, (W, 2, 12))),
             lambda: dense_window(torch.ones(W, 5, 4), torch.zeros(W, 5, 3))]
    for call in calls:
        spans0, dropped0 = tracer.phase_spans()
        call()
        spans, dropped = tracer.phase_spans()
        new = spans[len(spans0) - (dropped - dropped0):]
        mine = [s for s in new if s[4] == threading.get_ident()]
        assert [s[0] for s in mine] == ["train.forward",
                                        "train.backward"] * W
        for a, b in zip(mine, mine[1:]):
            assert a[2] <= b[1]


def test_train_step_deferred_features_raise():
    from distkeras_torch.parallel.mesh import make_mesh

    pm = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                   **TINY)
    mesh = make_mesh({"dp": 1, "sp": 1})
    # tp is ported: a tp_axis the mesh lacks is refused
    with pytest.raises(ValueError, match="no 'tp' axis"):
        make_lm_train_step(pm, get_optimizer("sgd"), mesh=mesh,
                           tp_axis="tp")
    ring = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                     attention="ring", **TINY)
    with pytest.raises(ValueError, match="mesh=make_mesh"):
        make_lm_train_step(ring, get_optimizer("sgd"))
    with pytest.raises(ValueError, match="no 'sp' axis"):
        make_lm_train_step(ring, get_optimizer("sgd"),
                           mesh=make_mesh({"dp": 1}))
    step = make_lm_train_step(pm, get_optimizer("sgd"), window=True)
    with pytest.raises(ValueError, match=r"\[W, B, T\]"):
        step(_tokens(0, (2, 8)))


# -- LMTrainer -------------------------------------------------------------------


def test_lm_trainer_equals_its_step_loop_and_follows_jax(tmp_path):
    jm, params, np_params, _ = _pair(seed=2)
    rows = _tokens(6, (41, 16))  # 20 steps of 2 rows: windows of 16 + 4
    model = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                      seed=9, **TINY)
    path = tmp_path / "m.jsonl"
    trainer = LMTrainer(model, params=np_params, worker_optimizer="adamw",
                        learning_rate=1e-3, batch_size=2,
                        metrics_path=str(path))
    trained = trainer.train(PartitionedDataset.from_arrays({"tokens": rows}))
    hist = np.asarray([h["loss"] for h in trainer.history])
    assert hist.shape == (20,) and np.isfinite(hist).all()

    # the port's own step loop from the same weights
    loop_model = get_model("transformer_lm", dtype=torch.float32,
                           device="cpu", **TINY)
    bridge.params_from_jax(np_params, loop_model)
    step = make_lm_train_step(loop_model, get_optimizer("adamw", 1e-3))
    loop = np.asarray([step(b).item() for b in rows[:40].reshape(20, 2, 16)])
    np.testing.assert_array_equal(hist, loop)

    # the reference step's math, batch by batch
    want, jparams = _jax_steps(jm, params, rows[:40].reshape(20, 2, 16),
                               jax_optimizer("adamw", 1e-3))
    np.testing.assert_allclose(hist, want, rtol=1e-4, atol=1e-4)

    # self.params: the trained weights in the flax layout (2e-3 = two
    # steps of lr: Adam moves a weight whose gradient is near 0 by up to
    # lr a step, whatever fp noise decides its sign)
    for a, b in zip(jax.tree.leaves(trainer.params),
                    jax.tree.leaves(jax.tree.map(np.asarray, jparams))):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)
    assert isinstance(trained, Model) and trained.module is model

    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    steps = [r for r in recs if "loss" in r]
    assert [r["step"] for r in steps] == list(range(1, 21))
    assert recs[-1]["kind"] == "throughput"


def test_lm_trainer_keeps_params_when_training_raises(monkeypatch):
    _, _, np_params, _ = _pair(seed=3)
    model = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                      **TINY)
    trainer = LMTrainer(model, params=np_params, batch_size=2)
    import distkeras_torch.parallel.spmd as spmd

    def broken(*a, **k):
        def step(tokens):
            raise RuntimeError("device fault")
        return step

    monkeypatch.setattr(spmd, "make_lm_train_step", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        trainer.train(PartitionedDataset.from_arrays(
            {"tokens": _tokens(0, (4, 16))}))
    assert trainer.params is np_params
    assert trainer.get_training_time() > 0


@pytest.mark.parametrize("what", ["axes", "microbatches", "checkpointer",
                                  "profile_dir", "sharded", "moe"])
def test_lm_trainer_deferred_features_raise(what, tmp_path):
    kw = dict(TINY, dtype=torch.float32, device="cpu")
    ds = PartitionedDataset.from_arrays({"tokens": _tokens(0, (4, 16))})
    if what == "moe":
        # ported now: an MoE model builds, runs and trains through the
        # LMTrainer (ep_size=1: the dp path, as the reference's)
        moe = get_model("transformer_lm", moe_experts=4, **kw)
        assert moe(torch.zeros((1, 4), dtype=torch.long)).shape == (1, 4, 61)
        trainer = LMTrainer(moe, batch_size=2)
        trainer.train(ds)
        assert len(trainer.history) == 2
        assert np.isfinite([h["loss"] for h in trainer.history]).all()
        return
    model = get_model("transformer_lm", **kw)
    if what == "sharded":
        # ported now: a streamed shard directory trains as its rows in
        # memory do, bit for bit
        from distkeras_torch.data.shard_io import ShardedDataset, write_shards

        write_shards(ds, str(tmp_path / "s"), rows_per_shard=3)
        mem = LMTrainer(model, batch_size=2)
        mem.train(ds)
        disk = LMTrainer(get_model("transformer_lm", **kw), batch_size=2,
                         stage_limit_bytes=1)
        disk.train(ShardedDataset(str(tmp_path / "s")))
        assert disk.history == mem.history and len(mem.history) == 2
        return
    if what == "checkpointer":
        # ported now: a run stopped after epoch 1 resumes to epoch 2 on the
        # trajectory of a run that never stopped
        from distkeras_torch.checkpoint import Checkpointer
        from distkeras_torch.ops import rules

        opt = get_optimizer("adamw", 1e-2, mu_dtype=torch.bfloat16)
        run = dict(batch_size=2, worker_optimizer=opt, num_epoch=2)
        whole = LMTrainer(model, **run)
        whole.train(ds)
        ck = str(tmp_path / "ck")
        LMTrainer(get_model("transformer_lm", **kw), checkpointer=Checkpointer(
            ck, every_steps=1), **dict(run, num_epoch=1)).train(ds)
        resumed = LMTrainer(get_model("transformer_lm", **kw),
                            checkpointer=Checkpointer(ck, every_steps=1),
                            **run)
        resumed.train(ds)
        assert resumed.history == whole.history[2:]
        for k, v in rules.flatten(whole.params).items():
            np.testing.assert_array_equal(rules.flatten(resumed.params)[k],
                                          v)
        return
    if what == "profile_dir":
        # ported now: the epoch runs inside a torch.profiler trace
        trace_dir = tmp_path / "trace"
        trainer = LMTrainer(model, batch_size=2, profile_dir=str(trace_dir))
        trainer.train(ds)
        assert len(trainer.history) == 2
        assert len(list(trace_dir.glob("trace-*.json"))) == 1
        return
    # ported now (tests/test_torch_pipeline.py): pp needs a world of
    # dp x pp processes, and microbatches apply to pp only, as in the
    # reference
    if what == "axes":
        with pytest.raises(ValueError, match="need 2 processes"):
            LMTrainer(model, batch_size=2, axes={"dp": 1, "pp": 2},
                      microbatches=2).train(ds)
        return
    with pytest.raises(ValueError, match="microbatches only applies"):
        LMTrainer(model, batch_size=2, microbatches=4)


def test_model_wrapper_predicts_generates_and_replaces_params():
    _, _, np_params, pm = _pair(seed=4)
    m = Model(pm)
    toks = _tokens(1, (2, 6))
    logits = m.predict(toks)
    assert logits.shape == (2, 6, TINY["vocab_size"])
    with torch.no_grad():
        np.testing.assert_array_equal(
            logits, pm(torch.from_numpy(toks)).numpy())
    out = m.generate(toks[:1], 4)
    assert out.shape == (1, 10)
    twin = m.replace_params(np_params)
    assert twin.module is not pm
    np.testing.assert_array_equal(twin.predict(toks), logits)
    twin2 = m.replace_params(pm.state_dict())
    np.testing.assert_array_equal(twin2.predict(toks), logits)
    # the msgpack blob (ported now): the same logits after a round trip
    back = Model.deserialize(m.serialize(), device="cpu")
    assert back.module is not pm
    np.testing.assert_array_equal(back.predict(toks), logits)


# -- remat and the f32-master repair ---------------------------------------------


def _grads(model, toks):
    model.zero_grad(set_to_none=True)
    logits = model(torch.from_numpy(toks))
    cot = torch.from_numpy(np.random.default_rng(0).normal(
        size=logits.shape).astype(np.float32))
    (logits * cot).sum().backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_block_gradients_equal_no_remat():
    _, _, np_params, pm = _pair(seed=5)
    rm = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                   remat="block", **TINY)
    bridge.params_from_jax(np_params, rm)
    toks = _tokens(2, (2, 12))
    want, got = _grads(pm, toks), _grads(rm, toks)
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=1e-6, atol=1e-6)


def test_bf16_model_keeps_f32_masters_and_round_trips_the_bridge():
    _, _, np_params, pm = _pair(seed=6, dtype="bfloat16")
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    back = bridge.params_to_jax(pm)
    flat_a = jax.tree_util.tree_leaves_with_path(np_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert leaf.dtype == np.float32
        np.testing.assert_array_equal(flat_b[path], leaf)
    grads = _grads(pm, _tokens(3, (1, 8)))
    assert all(g.dtype == torch.float32 for g in grads.values())


def test_bf16_logits_match_jax_bf16():
    """Cast-at-use: a bf16 port model computes with the same bf16 weights
    as the reference's bf16 model (2e-2: bf16 activations rounded in
    other places by the two frameworks' CPU kernels)."""
    jm, params, _, pm = _pair(seed=7, dtype="bfloat16")
    toks = _tokens(4, (2, 10))
    want = np.asarray(jm.apply(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = pm(torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-2 * max(np.abs(want).max(), 1.0)
