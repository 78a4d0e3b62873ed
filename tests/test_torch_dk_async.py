"""The port's parameter-server family (``distkeras_torch.ops.rules``,
``parameter_servers``, the windowed workers, the six PS trainers in both
engines, ``checkpoint``) against the JAX package on the CPU, from the
same numpy data and the same weights (handed to both as ``params=``).

- ``rules``: every rule against the JAX one on the same seeded trees,
  within 1e-6; the lock-step reductions against the serial JAX rules
  they collapse (within 1e-6).
- Parameter servers: the same scripted commit sequence into the port's
  and the JAX class, centers within 1e-6 and DynSGD's clocks and
  staleness logs exactly equal; the port's server copies the caller's
  parameters and hands out copies.
- Trainers: each of the six at ``num_workers=1`` (one worker is
  deterministic) and ``EASGD`` at 2 (its barrier is), in the threaded
  engine and, at 2 workers, in the lock-step engine (``spmd=True``,
  against the JAX engine on the CPU mesh): histories and centers within
  1e-4. The lock-step engine also equals the port's own PS classes
  driven on its schedule (1e-5), and trains every row of ragged
  partitions once.
- The threaded engines at 3 workers: every window commits once, DynSGD's
  staleness stays in bounds; the PS properties of
  ``tests/test_async_properties.py`` (no lost update, no torn pull,
  clocks, the barrier under random leaves) on the port's servers; the
  ``max_retries`` cases of ``tests/test_failure_recovery.py``.
- Checkpoints: saving, a crash and a resume equal an uninterrupted run
  for ``SingleTrainer`` and ``DOWNPOUR``; a lock-step checkpoint refuses
  another engine and another worker count.
- On two or more cards (``cuda``): ``DOWNPOUR`` and ``AEASGD`` over every
  card learn and count every commit; ``DOWNPOUR(spmd=True)`` over four
  cards equals the same engine on one card within 1e-5 at f32.

The JAX side is imported inside the tests, so the card tests run where
JAX is absent.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import distkeras_torch as dk  # noqa: E402
from distkeras_torch import bridge  # noqa: E402
from distkeras_torch import parameter_servers as pps  # noqa: E402
from distkeras_torch.checkpoint import (  # noqa: E402
    CheckpointMismatchError,
    Checkpointer,
)
from distkeras_torch.data.dataset import PartitionedDataset  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.ops import rules  # noqa: E402
from distkeras_torch.utils.metrics import MetricsWriter  # noqa: E402

DIM, CLASSES = 16, 4
MLP_KW = dict(features=(24,), num_classes=CLASSES)
TRAIN_KW = dict(worker_optimizer="momentum", learning_rate=0.05,
                label_col="label", batch_size=32, num_epoch=2,
                communication_window=3, seed=3)
ALGOS = ["DOWNPOUR", "ADAG", "DynSGD", "AEASGD", "EAMSGD", "EASGD"]


def _columns(n=300, seed=0):
    """Gaussian blobs per class, one-hot labels (and the indices)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(CLASSES, DIM)) * 3.0
    labels = rng.integers(0, CLASSES, size=n)
    feats = (centers[labels] + rng.normal(size=(n, DIM))).astype(np.float32)
    return {"features": feats,
            "label": np.eye(CLASSES, dtype=np.float32)[labels]}, labels


def _port_mlp(device="cpu", dtype=torch.float32):
    return get_model("mlp", dtype=dtype, in_features=DIM, device=device,
                     **MLP_KW)


def _np_params(seed=0):
    """Seeded MLP weights as a flax tree of numpy arrays."""
    m = get_model("mlp", dtype=torch.float32, in_features=DIM,
                  device="cpu", seed=seed, **MLP_KW)
    return bridge.params_to_jax(m)


def _kw(name, **over):
    kw = dict(TRAIN_KW, **over)
    if name == "EAMSGD":  # it builds its own Nesterov optimizer
        kw.pop("worker_optimizer")
    return kw


def _hist(histories):
    return np.array([[r["loss"], r["accuracy"]]
                     for h in histories for r in h])


def _tree_close(want, got, tol):
    w, g = rules.flatten(want), rules.flatten(got)
    assert w.keys() == g.keys()
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                   rtol=0, atol=tol, err_msg=k)


def _trees(seed, n=3):
    """``n`` seeded trees of two leaves, as flax-style numpy dicts."""
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(4, 3)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)}
            for _ in range(n)]


def _t(tree):
    return rules.to_tensors(tree, "cpu")


# -- rules ----------------------------------------------------------------

RULES = {
    "tree_sub": lambda r, a, b, c: r.tree_sub(a, b),
    "tree_add": lambda r, a, b, c: r.tree_add(a, b),
    "tree_scale": lambda r, a, b, c: r.tree_scale(a, 0.37),
    "tree_axpy": lambda r, a, b, c: r.tree_axpy(-1.3, a, b),
    "tree_mean": lambda r, a, b, c: r.tree_mean([a, b, c]),
    "tree_zeros_like": lambda r, a, b, c: r.tree_zeros_like(a),
    "downpour_delta": lambda r, a, b, c: r.downpour_delta(a, b),
    "downpour_commit": lambda r, a, b, c: r.downpour_commit(a, b),
    "elastic_difference": lambda r, a, b, c: r.elastic_difference(0.05, a, b),
    "easgd_worker_update": lambda r, a, b, c: r.easgd_worker_update(a, b,
                                                                    0.05),
    "easgd_center_update": lambda r, a, b, c: r.easgd_center_update(
        a, [b, c], 0.05),
    "aeasgd_commit": lambda r, a, b, c: r.aeasgd_commit(a, b),
    "eamsgd_momentum_update": lambda r, a, b, c: r.eamsgd_momentum_update(
        a, b, 0.9),
    "dynsgd_scale": lambda r, a, b, c: r.dynsgd_scale(a, 3),
    "dynsgd_commit": lambda r, a, b, c: r.dynsgd_commit(a, b, 2),
    "adag_commit": lambda r, a, b, c: r.adag_commit(a, b, 3),
}


@pytest.mark.parametrize("name", sorted(RULES))
def test_rule_matches_jax(name):
    import jax.numpy as jnp

    from distkeras_tpu.ops import rules as jrules

    a, b, c = _trees(1)
    want = RULES[name](jrules, *[{k: jnp.asarray(v) for k, v in t.items()}
                                 for t in (a, b, c)])
    got = RULES[name](rules, _t(a), _t(b), _t(c))
    for t in (a, b, c):  # pure: the inputs are untouched
        assert all(np.isfinite(v).all() for v in t.values())
    _tree_close({k: np.asarray(v) for k, v in want.items()},
                {k: v.numpy() for k, v in got.items()}, 1e-6)


@pytest.mark.parametrize("name", ["sum", "mean", "dynsgd", "easgd"])
def test_lockstep_reductions_collapse_the_serial_jax_rules(name):
    """The lock-step forms equal the serial JAX rules they stand for:
    the sum (mean) of the deltas is DOWNPOUR's (ADAG's) commit applied
    once per worker; the DynSGD round is worker ``i``'s commit at
    staleness ``i``; the EASGD round is the barrier server's center
    update and every worker's elastic step."""
    import jax.numpy as jnp

    from distkeras_tpu.ops import rules as jrules

    ws = _trees(2, 3)
    center = _trees(3, 1)[0]
    J = [{k: jnp.asarray(v) for k, v in t.items()} for t in ws]
    jc = {k: jnp.asarray(v) for k, v in center.items()}
    deltas = [jrules.tree_sub(w, jc) for w in J]
    if name in ("sum", "mean"):
        want = jc
        for d in deltas:
            want = (jrules.downpour_commit(want, d) if name == "sum"
                    else jrules.adag_commit(want, d, len(ws)))
        reduce = (rules.allreduce_sum_delta if name == "sum"
                  else rules.allreduce_mean_delta)
        got = rules.tree_add(_t(center), reduce(
            [rules.tree_sub(_t(w), _t(center)) for w in ws], "cpu"))
        want_workers = None
    elif name == "dynsgd":
        want = jc
        for i, d in enumerate(deltas):
            want = jrules.dynsgd_commit(want, d, i)
        pulled, got = rules.allreduce_dynsgd_round([_t(w) for w in ws],
                                                   _t(center))
        want_workers = [want] * len(ws)
        got_workers = pulled
    else:
        want = jrules.easgd_center_update(jc, J, 0.25)
        want_workers = [jrules.easgd_worker_update(w, jc, 0.25) for w in J]
        got_workers, got = rules.allreduce_easgd_round(
            [_t(w) for w in ws], _t(center), 0.25)
    _tree_close({k: np.asarray(v) for k, v in want.items()},
                {k: v.numpy() for k, v in got.items()}, 1e-6)
    if want_workers is not None:
        for w, g in zip(want_workers, got_workers):
            _tree_close({k: np.asarray(v) for k, v in w.items()},
                        {k: v.numpy() for k, v in g.items()}, 1e-6)


def test_tree_layout_round_trips():
    tree = _np_params()
    flat = rules.flatten(tree)
    assert all("/" in k for k in flat)
    assert rules.flatten(flat) == flat
    back = rules.unflatten(flat)
    _tree_close(tree, back, 0)
    model = _port_mlp()
    assert set(bridge.flax_key(n) for n, _ in model.named_parameters()) \
        == set(flat)


# -- parameter servers ---------------------------------------------------------


def _script(seed, n=6):
    """A commit sequence: (delta tree, worker, clock)."""
    rng = np.random.default_rng(seed)
    return [(_trees(100 + i, 1)[0], int(rng.integers(0, 3)),
             int(rng.integers(0, i + 1))) for i in range(n)]


@pytest.mark.parametrize("kind", ["delta", "adag", "dynsgd", "easgd"])
def test_parameter_server_matches_jax_on_a_scripted_sequence(kind):
    """The same commits into the port's and the JAX server: centers within
    1e-6 after every commit; DynSGD's clock and staleness log exactly the
    reference's; EASGD's rounds (three workers, one leaving mid-run) give
    the same pre-round centers."""
    from distkeras_tpu import parameter_servers as jps

    init = _trees(7, 1)[0]
    if kind == "easgd":
        jp = jps.EASGDParameterServer(init, num_workers=3, rho=2.0,
                                      elastic_lr=0.1)
        tp = pps.EASGDParameterServer(init, num_workers=3, rho=2.0,
                                      elastic_lr=0.1, device="cpu")
        seen = {"jax": [], "port": []}

        def drive(ps, key, to_np):
            def worker(i):
                for r in range(3 if i != 2 else 1):
                    c = ps.commit_and_wait(_trees(10 * i + r, 1)[0], worker=i)
                    seen[key].append((i, r, to_np(c)))
                ps.leave(i)

            ts = [threading.Thread(target=worker, args=(i,))
                  for i in range(3)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
                assert not t.is_alive()

        drive(jp, "jax", lambda c: {k: np.asarray(v) for k, v in c.items()})
        drive(tp, "port", lambda c: {k: v.numpy() for k, v in c.items()})
        for (wi, r, a), (wj, s, b) in zip(sorted(seen["jax"], key=str),
                                          sorted(seen["port"], key=str)):
            assert (wi, r) == (wj, s)
            _tree_close(a, b, 1e-6)
        _tree_close(jp.get_model(), tp.get_model(), 1e-6)
        assert jp.num_updates == tp.num_updates == 3
        return
    cls = {"delta": ("DeltaParameterServer", {}),
           "adag": ("ADAGParameterServer", {"num_workers": 3}),
           "dynsgd": ("DynSGDParameterServer", {})}[kind]
    jp = getattr(jps, cls[0])(init, **cls[1])
    tp = getattr(pps, cls[0])(init, device="cpu", **cls[1])
    for delta, worker, clock in _script(8):
        jp.commit(delta, worker=worker, worker_clock=clock)
        tp.commit(_t(delta), worker=worker, worker_clock=clock)
        _tree_close(jp.get_model(), tp.get_model(), 1e-6)
        if kind == "dynsgd":
            _, jclock = jp.pull_with_clock()
            _, tclock = tp.pull_with_clock()
            assert jclock == tclock == jp.clock == tp.clock
    assert jp.num_updates == tp.num_updates == 6
    assert jp.staleness_log == tp.staleness_log


def test_parameter_server_copies_in_and_out():
    """The center is the server's own: mutating the caller's tree, a
    pulled copy or a committed delta afterwards never reaches it."""
    params = {"w": torch.ones(3)}
    ps = pps.DeltaParameterServer(params, device="cpu")
    params["w"].add_(5.0)
    pulled = ps.pull()
    pulled["w"].mul_(0.0)
    delta = {"w": torch.full((3,), 2.0)}
    ps.commit(delta)
    delta["w"].add_(100.0)
    np.testing.assert_array_equal(ps.get_model()["w"], np.full(3, 3.0))
    assert ps.pull()["w"].data_ptr() != ps.center["w"].data_ptr()


# -- the trainers against the reference's --------------------------------------


def _jax_run(name, params, cols, nw, spmd, **over):
    import jax.numpy as jnp

    from distkeras_tpu import trainers as jt
    from distkeras_tpu.data.dataset import PartitionedDataset as JaxDataset
    from distkeras_tpu.models import get_model as jax_get_model

    jm = jax_get_model("mlp", dtype=jnp.float32, **MLP_KW)
    ref = getattr(jt, name)(jm, params=params, num_workers=nw, spmd=spmd,
                            **_kw(name, **over))
    ref.train(JaxDataset.from_arrays(cols, 2), shuffle=True)
    return ref


def _port_run(name, params, cols, nw, spmd, **over):
    t = getattr(dk, name)(_port_mlp(), params=params, num_workers=nw,
                          spmd=spmd, **_kw(name, **over))
    out = t.train(PartitionedDataset.from_arrays(cols, 2), shuffle=True)
    assert out.module is t.model
    return t


@pytest.mark.parametrize("name,nw", [(a, 1) for a in ALGOS]
                         + [("EASGD", 2)])
def test_threaded_trainer_matches_jax(name, nw):
    """One worker (or EASGD's two behind its barrier) is deterministic:
    histories and the center within 1e-4 of the reference's."""
    cols, _ = _columns()
    p = _np_params(seed=1)
    ref = _jax_run(name, p, cols, nw, False)
    port = _port_run(name, p, cols, nw, False)
    assert len(port.executor_histories) == len(ref.executor_histories) == nw
    want, got = _hist(ref.executor_histories), _hist(port.executor_histories)
    assert want.shape == got.shape and len(want) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    _tree_close(ref.params, port.params, 1e-4)
    assert port.parameter_server.num_updates \
        == ref.parameter_server.num_updates


@pytest.mark.parametrize("name", ALGOS)
def test_spmd_engine_matches_jax(name):
    """The lock-step engine at 2 workers against the reference's on the
    CPU mesh: per-worker histories and the center within 1e-4."""
    cols, _ = _columns(seed=2)
    p = _np_params(seed=2)
    ref = _jax_run(name, p, cols, 2, True)
    port = _port_run(name, p, cols, 2, True)
    assert len(port.executor_histories) == 2
    for hj, ht in zip(ref.executor_histories, port.executor_histories):
        np.testing.assert_allclose(_hist([ht]), _hist([hj]), rtol=0,
                                   atol=1e-4)
    _tree_close(ref.params, port.params, 1e-4)


def _ps_lockstep(name, params, cols, nw):
    """The port's PS class driven on the lock-step schedule: every worker
    pulls the same center, runs its window, then all commit in worker
    order (EASGD: one barrier round)."""
    from distkeras_torch.utils.losses import get_loss, get_optimizer
    from distkeras_torch.workers import batch_partition, make_window_step

    t = getattr(dk, name)(_port_mlp(), params=params, num_workers=nw,
                          **_kw(name))
    t.params = {"params": params["params"]}
    ps = t.allocate_parameter_server()
    parts = PartitionedDataset.from_arrays(cols, 2).shuffle(
        seed=TRAIN_KW["seed"]).repartition(nw)
    feeds = [batch_partition(parts.partition(i), "features", "label",
                             TRAIN_KW["batch_size"]) for i in range(nw)]
    models = [_port_mlp() for _ in range(nw)]
    steps = [make_window_step(m, get_loss("categorical_crossentropy"),
                              get_optimizer("momentum", 0.05)) for m in models]
    n_b, W = len(feeds[0][0]), TRAIN_KW["communication_window"]
    locals_ = [{bridge.flax_key(k): v.detach()
                for k, v in m.named_parameters()} for m in models]
    first = True
    for _epoch in range(TRAIN_KW["num_epoch"]):
        for s in range(0, n_b, W):
            if name == "DynSGD":
                pulls = [ps.pull_with_clock() for _ in range(nw)]
            else:
                pulls = [(ps.pull(), 0) for _ in range(nw)]
            if name != "EASGD" or first:  # EASGD workers keep their own
                for local, (center, _) in zip(locals_, pulls):
                    rules.tree_copy_(local, center)
            first = False
            for i in range(nw):
                xb, yb = feeds[i]
                steps[i](torch.from_numpy(xb[s:s + W]),
                         torch.from_numpy(yb[s:s + W]))
            if name == "EASGD":
                out = [None] * nw

                def go(i, local):
                    center = ps.commit_and_wait(local, worker=i)
                    out[i] = rules.easgd_worker_update(local, center,
                                                       ps.alpha)

                ts = [threading.Thread(target=go, args=(i, local))
                      for i, local in enumerate(locals_)]
                for th in ts:
                    th.start()
                for th in ts:
                    th.join(30)
                for local, new in zip(locals_, out):
                    rules.tree_copy_(local, new)
                continue
            for i, local in enumerate(locals_):
                ps.commit(rules.tree_sub(local, pulls[i][0]), worker=i,
                          worker_clock=pulls[i][1])
    return ps.get_model()


@pytest.mark.parametrize("name", ["DOWNPOUR", "ADAG", "DynSGD", "EASGD"])
def test_spmd_engine_equals_ps_classes_on_its_schedule(name):
    cols, _ = _columns(256, seed=4)
    p = _np_params(seed=4)
    want = _ps_lockstep(name, p, cols, 2)
    port = _port_run(name, p, cols, 2, True)
    _tree_close(want, port.params, 1e-5)


@pytest.mark.parametrize("name", ["DOWNPOUR", "ADAG"])
def test_spmd_ragged_delta_family_processes_all_rows(name):
    """Partitions of 4 and 3 batches: the short worker sits out the last
    window but joins its commit; every batch is trained exactly once and
    the engine warns (tests/test_delta_spmd.py's ragged case)."""
    cols, _ = _columns(255, seed=5)  # partitions of 127 and 128 rows
    with pytest.warns(RuntimeWarning, match="unequal"):
        port = _port_run(name, _np_params(), cols, 2, True, num_epoch=1)
    assert sorted(len(h) for h in port.executor_histories) == [3, 4]


def test_spmd_leaves_caller_params_alive():
    p = _np_params()
    before = {k: v.copy() for k, v in rules.flatten(p).items()}
    cols, _ = _columns()
    _port_run("ADAG", p, cols, 2, True, num_epoch=1)
    _tree_close(before, p, 0)


# -- the threaded engines at 3 workers -----------------------------------------


@pytest.mark.parametrize("name", ALGOS)
def test_threaded_engine_counts_every_commit(name):
    """3 workers on ragged partitions: every window of every worker
    commits once (EASGD: one round per window of the longest worker),
    the histories hold every step, DynSGD's staleness is in bounds, and
    the model learns."""
    cols, labels = _columns(600, seed=6)
    t = getattr(dk, name)(_port_mlp(), num_workers=3, **_kw(name))
    model = t.train(PartitionedDataset.from_arrays(cols, 2))
    parts = PartitionedDataset.from_arrays(cols, 2).repartition(3)
    batches = [len(parts.partition(i)["features"]) // 32 for i in range(3)]
    windows = [-(-b // 3) * TRAIN_KW["num_epoch"] for b in batches]
    if name == "EASGD":
        assert t.parameter_server.num_updates == max(windows)
    else:
        assert t.parameter_server.num_updates == sum(windows)
    assert [len(h) for h in t.executor_histories] == \
        [b * TRAIN_KW["num_epoch"] for b in batches]
    if name == "DynSGD":
        log = t.parameter_server.staleness_log
        assert len(log) == sum(windows)
        assert all(0 <= s < len(log) for s in log)
        assert sum(t.staleness.values()) == len(log)
    acc = (model.predict(cols["features"]).argmax(1) == labels).mean()
    assert acc > 0.9


def int_tree(value, shape=(4, 3)):
    return {"w": np.full(shape, float(value)), "b": np.full((5,), float(value))}


def run_threads(fns, timeout=60):
    threads = [threading.Thread(target=f, daemon=True) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "worker thread hung (deadlock)"


@pytest.mark.parametrize("kind", ["delta", "adag"])
def test_ps_no_lost_updates(kind):
    k, n = 4, 40
    ps = (pps.DeltaParameterServer(int_tree(0), device="cpu")
          if kind == "delta" else
          pps.ADAGParameterServer(int_tree(0), num_workers=k, device="cpu"))
    deltas = np.random.default_rng(0).integers(-8, 9, size=(k, n))
    start = threading.Barrier(k)

    def worker(i):
        start.wait()
        for d in deltas[i]:
            ps.commit(int_tree(int(d)), worker=i)

    run_threads([lambda i=i: worker(i) for i in range(k)])
    expected = float(deltas.sum()) / (1 if kind == "delta" else k)
    np.testing.assert_array_equal(ps.get_model()["w"],
                                  np.full((4, 3), expected))
    assert ps.num_updates == k * n


def test_ps_pull_never_tears():
    ps = pps.DeltaParameterServer(int_tree(0), device="cpu")
    stop = threading.Event()
    torn = []

    def committer():
        for _ in range(200):
            ps.commit(int_tree(1))
        stop.set()

    def puller():
        while not stop.is_set():
            snap = ps.pull()
            vals = {float(v) for leaf in snap.values() for v in leaf.ravel()}
            if len(vals) != 1:
                torn.append(vals)

    run_threads([committer] + [puller] * 3)
    assert not torn
    np.testing.assert_array_equal(ps.get_model()["w"], np.full((4, 3), 200.0))


def test_dynsgd_clock_and_staleness():
    """Forced interleaving gives staleness exactly 2; a serial run with the
    worker clock pinned to 0 damps commit t by 1/(t+1); threads keep the
    clock at the commit count with staleness in bounds."""
    ps = pps.DynSGDParameterServer(int_tree(0), device="cpu")
    _, a_clock = ps.pull_with_clock()
    ps.commit(int_tree(1), worker=1, worker_clock=ps.clock)
    ps.commit(int_tree(1), worker=1, worker_clock=ps.clock)
    ps.commit(int_tree(1), worker=0, worker_clock=a_clock)
    assert ps.staleness_log == [0, 0, 2] and ps.clock == 3
    np.testing.assert_allclose(ps.get_model()["w"],
                               np.full((4, 3), 2.0 + 1.0 / 3), rtol=1e-12)
    serial = pps.DynSGDParameterServer(int_tree(0), device="cpu")
    for _ in range(4):
        serial.commit(int_tree(1), worker_clock=0)
    assert serial.staleness_log == [0, 1, 2, 3]
    np.testing.assert_allclose(serial.get_model()["w"],
                               np.full((4, 3), 1 + 1 / 2 + 1 / 3 + 1 / 4),
                               rtol=1e-12)
    k, n = 6, 30
    ps = pps.DynSGDParameterServer(int_tree(0), device="cpu")
    start = threading.Barrier(k)

    def worker(i):
        start.wait()
        for _ in range(n):
            _, clock = ps.pull_with_clock()
            ps.commit(int_tree(1), worker=i, worker_clock=clock)

    run_threads([lambda i=i: worker(i) for i in range(k)])
    assert ps.clock == ps.num_updates == len(ps.staleness_log) == k * n
    assert all(0 <= s < k * n for s in ps.staleness_log)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_easgd_barrier_survives_random_leaves(seed):
    k = 6
    rounds = np.random.default_rng(seed).integers(1, 8, size=k)
    ps = pps.EASGDParameterServer(int_tree(0), num_workers=k, rho=1.0,
                                  elastic_lr=0.1, device="cpu")

    def worker(i):
        for r in range(int(rounds[i])):
            ps.commit_and_wait(int_tree(i + r), worker=i)
        ps.leave(i)

    run_threads([lambda i=i: worker(i) for i in range(k)])
    assert ps.num_updates == int(rounds.max())


def test_easgd_round_returns_one_pre_round_center():
    k, rounds = 4, 5
    ps = pps.EASGDParameterServer(int_tree(0), num_workers=k, rho=1.0,
                                  elastic_lr=0.25, device="cpu")
    seen = [[] for _ in range(k)]

    def worker(i):
        for _ in range(rounds):
            center = ps.commit_and_wait(int_tree(1), worker=i)
            seen[i].append(float(center["w"][0, 0]))
        ps.leave(i)

    run_threads([lambda i=i: worker(i) for i in range(k)])
    c, expect = 0.0, []
    for _ in range(rounds):
        expect.append(c)
        c = c + k * 0.25 * (1.0 - c)
    for i in range(k):
        np.testing.assert_allclose(seen[i], expect, rtol=1e-12)


# -- max_retries (tests/test_failure_recovery.py) ------------------------------


def _inject_faults(trainer, fails):
    remaining = dict(fails)
    allocate = trainer.allocate_worker

    def sabotage(index):
        w = allocate(index)
        if remaining.get(index, 0) > 0:
            on_round = w.on_round

            def failing(idx, ps):
                if remaining.get(index, 0) > 0:
                    remaining[index] -= 1
                    raise RuntimeError(f"injected fault on worker {index}")
                return on_round(idx, ps)

            w.on_round = failing
        return w

    trainer.allocate_worker = sabotage
    return remaining


@pytest.mark.parametrize("case", ["recovers", "exhausted", "fail_fast",
                                  "easgd"])
def test_worker_restart(case, tmp_path):
    """A crashed worker restarts from the current center (a fresh pull,
    so no window is committed twice: the commit count is the full run's
    less the crashed windows); exhausted retries and ``max_retries=0``
    surface the error; a restarted EASGD worker rejoins the barrier."""
    cols, labels = _columns(512, seed=7)
    ds = PartitionedDataset.from_arrays(cols, 4)
    if case == "easgd":
        t = dk.EASGD(_port_mlp(), num_workers=4, max_retries=1,
                     **_kw("EASGD", communication_window=1, num_epoch=1,
                           batch_size=16))
        left = _inject_faults(t, {2: 1})
        t.train(ds)
        assert left[2] == 0 and t.worker_restarts == 1
        assert t.parameter_server.num_updates > 0
        return
    if case == "recovers":
        writer = MetricsWriter(str(tmp_path / "m.jsonl"))
        t = dk.DOWNPOUR(_port_mlp(), num_workers=4, max_retries=2,
                        **_kw("DOWNPOUR", communication_window=2,
                              num_epoch=4))
        t.metrics_writer = writer
        left = _inject_faults(t, {1: 1, 3: 2})
        model = t.train(ds)
        assert all(v == 0 for v in left.values())
        assert t.worker_restarts == 3
        assert len(t.executor_histories) == 4
        # 4 workers x 4 epochs x 2 windows, and each crash dropped the
        # one window it happened in (the first, before its commit)
        assert t.parameter_server.num_updates == 4 * 4 * 2
        acc = (model.predict(cols["features"]).argmax(1) == labels).mean()
        assert acc > 0.9
        failures = [r for r in writer.records if r.get("kind") == "failures"]
        assert failures and failures[0]["worker_restarts"] == 3
        return
    t = dk.DOWNPOUR(_port_mlp(), num_workers=2,
                    max_retries=1 if case == "exhausted" else 0,
                    **_kw("DOWNPOUR", communication_window=1, num_epoch=1))
    _inject_faults(t, {0: 99} if case == "exhausted" else {1: 1})
    with pytest.raises(RuntimeError, match="injected fault"):
        t.train(PartitionedDataset.from_arrays(cols, 2))
    assert t.worker_restarts == (1 if case == "exhausted" else 0)


# -- checkpoints -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["single", "downpour"])
def test_resume_equals_an_uninterrupted_run(kind, tmp_path):
    """Train 1 epoch with a checkpointer (the crash), then a fresh trainer
    over the same directory: SingleTrainer resumes its epoch count and
    trains the one left; DOWNPOUR (one worker) restores the center and
    the worker's momentum and trains its epochs from there. Either way
    the weights equal an uninterrupted 2-epoch run's exactly."""
    cols, _ = _columns(256, seed=8)
    p = _np_params(seed=8)

    def make(num_epoch, ckpt=None):
        kw = dict(params=p, checkpointer=ckpt, **_kw("DOWNPOUR"))
        kw.update(num_epoch=num_epoch)
        if kind == "single":
            kw.pop("communication_window")
            return dk.SingleTrainer(_port_mlp(), **kw)
        return dk.DOWNPOUR(_port_mlp(), num_workers=1, **kw)

    def run(t):
        t.train(PartitionedDataset.from_arrays(cols, 2))
        return t

    full = run(make(2))
    ck = Checkpointer(str(tmp_path / "ck"), every_steps=1)
    first = run(make(1, ck))
    assert ck.latest_step is not None
    resumed = run(make(2 if kind == "single" else 1,
                       Checkpointer(str(tmp_path / "ck"), every_steps=1)))
    _tree_close(full.params, resumed.params, 0)
    if kind == "single":
        assert len(resumed.history) == len(first.history)
        np.testing.assert_array_equal(_hist([resumed.history]),
                                      _hist([full.history[len(
                                          first.history):]]))


def test_lockstep_checkpoint_refuses_another_engine(tmp_path):
    cols, _ = _columns(256, seed=9)
    ds = PartitionedDataset.from_arrays(cols, 2)
    ck = Checkpointer(str(tmp_path / "ck"), every_steps=1)
    dk.ADAG(_port_mlp(), num_workers=2, spmd=True, checkpointer=ck,
            **_kw("ADAG", num_epoch=1)).train(ds)
    with pytest.raises(ValueError, match="engine"):
        dk.DOWNPOUR(_port_mlp(), num_workers=2, spmd=True,
                    checkpointer=Checkpointer(str(tmp_path / "ck")),
                    **_kw("DOWNPOUR")).train(ds)
    with pytest.raises(ValueError, match="workers"):
        dk.ADAG(_port_mlp(), num_workers=3, spmd=True,
                checkpointer=Checkpointer(str(tmp_path / "ck")),
                **_kw("ADAG")).train(ds)
    # the same engine and count resumes: epoch 1 restored, epoch 2 trained
    t = dk.ADAG(_port_mlp(), num_workers=2, spmd=True,
                checkpointer=Checkpointer(str(tmp_path / "ck")),
                **_kw("ADAG"))
    t.train(ds)
    assert [len(h) for h in t.executor_histories] == [4, 4]


def test_checkpointer_cadence_retention_and_template(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), every_steps=2, max_to_keep=2)
    tree = {"params": {"w": np.ones((2, 3), np.float32)}}
    assert not ck.maybe_save(1, tree)
    for step in (2, 4, 6):
        assert ck.maybe_save(step, tree, extra={"epoch": step})
    assert not ck.maybe_save(6, tree, force=True)  # already on disk
    assert ck.all_steps() == [4, 6] and ck.latest_step == 6
    step, state = ck.restore(like={"params": tree, "extra": {"epoch": 0}})
    assert step == 6 and state["extra"]["epoch"] == 6
    np.testing.assert_array_equal(state["params"]["params"]["w"],
                                  tree["params"]["w"])
    bad = {"params": {"w": np.ones((3, 2), np.float32)}}
    with pytest.raises(CheckpointMismatchError, match="params/w"):
        ck.restore(like={"params": bad, "extra": {"epoch": 0}})
    assert Checkpointer(str(tmp_path / "empty")).restore() == (None, None)


# -- several cards ---------------------------------------------------------------


@pytest.mark.cuda
def test_ps_family_over_every_card():
    """Workers round-robin over every visible card, the center on cuda:0:
    DOWNPOUR and AEASGD learn and count every window's commit;
    DOWNPOUR(spmd=True) over four cards equals the same engine on one
    card within 1e-5 (f32, TF32 off)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import json

        cols, labels = _columns(4096, seed=10)
        ds = PartitionedDataset.from_arrays(cols, 4)
        devices = [f"cuda:{i}" for i in range(n)]
        report = {"cards": n}
        for name in ("DOWNPOUR", "AEASGD"):
            t = getattr(dk, name)(_port_mlp("cuda:0"), num_workers=2 * n,
                                  devices=devices,
                                  **_kw(name, num_epoch=2))
            model = t.train(ds)
            assert t.parameter_server.device == torch.device("cuda:0")
            assert {str(w.device) for w in t.workers} == set(devices)
            parts = ds.repartition(2 * n)
            windows = sum(-(-(len(parts.partition(i)["features"]) // 32)
                            // 3) for i in range(2 * n)) * 2
            assert t.parameter_server.num_updates == windows
            acc = (model.predict(cols["features"]).argmax(1)
                   == labels).mean()
            assert acc > 0.9, (name, acc)
            report[name] = {"workers": 2 * n, "commits": windows,
                            "accuracy": float(acc),
                            "train_s": t.get_training_time()}
        cards = devices[:4]
        one = dk.DOWNPOUR(_port_mlp("cuda:0"), params=_np_params(),
                          num_workers=4, spmd=True, devices=["cuda:0"],
                          **_kw("DOWNPOUR"))
        one.train(ds)
        many = dk.DOWNPOUR(_port_mlp("cuda:0"), params=_np_params(),
                           num_workers=4, spmd=True, devices=cards,
                           **_kw("DOWNPOUR"))
        many.train(ds)
        _tree_close(one.params, many.params, 1e-5)
        np.testing.assert_allclose(_hist(many.executor_histories),
                                   _hist(one.executor_histories), rtol=0,
                                   atol=1e-5)
        report["spmd_cards"] = len(cards)
        report["spmd_center_gap"] = max(
            float(np.abs(np.asarray(a) - np.asarray(b)).max())
            for a, b in zip(rules.flatten(one.params).values(),
                            rules.flatten(many.params).values()))
        print(json.dumps(report))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was[0]
        torch.backends.cudnn.allow_tf32 = was[1]
