"""The port's six examples (``distkeras_torch/examples/``) on the CPU.

- Data: the synthetic rows, tokens and prompts are bit-equal to the
  reference scripts' (``examples/*.py``, loaded from their files).
- Smokes: each module at the sizes ``tests/test_examples.py`` runs the
  reference at, with ``--device cpu``; each prints the strings that file
  asserts and its own checks hold (streaming equals a batch predict, the
  evaluation from prediction shards equals the in-memory one, every
  serving stream equals ``generate()``).
- ``lm_serving`` against the reference: the port takes the reference's
  ``init(PRNGKey(0))`` tree through ``bridge.params_from_jax`` and its
  greedy streams equal the reference example's. The reference example
  asserts its own streams equal its ``generate()`` on that tree, so that
  ``generate()`` stands in for running it.
- The cosine schedule against optax's, and twenty Adam steps under it
  against ``optax.adam(schedule)``.
- One 2-process gloo world, spawned once for the module, runs
  ``lm_training --sp 2``, ``--pp 2 --microbatches 2``, ``--moe --ep 2``
  and ``lm_serving --tp 2`` in turn. The reference's smokes run these on
  8 devices (dp4 x sp2, pp2 x dp2 x tp2 with 4 microbatches, dp2 x ep4);
  here each parallel axis gets the world's 2 processes alone (dp 1), at
  the reference smokes' narrow widths.
- ``lm_training --dp 2`` in a world of one process raises naming the
  ``Job`` launch; the text mode trains on a ``tmp_path`` of files.

The worker function imports no JAX (the ranks are spawned processes
that import this module); JAX is imported inside the tests.
"""

import datetime
import importlib.util
import json
import os
import sys
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from distkeras_torch.examples import (  # noqa: E402
    bigdata_pipeline, cifar10_training, lm_serving, lm_training,
    mnist_workflow, streaming_inference)
from distkeras_torch.utils.losses import (  # noqa: E402
    get_optimizer, warmup_cosine_decay_schedule)

from torch_spawn_util import one_thread, spawn_ranks  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
WORLD, TIMEOUT_S = 2, 240
# tests/test_examples.py's sizes; the parallel runs with dp 1
LM_SP = ["--sp", "2", "--n", "64", "--seq-len", "64", "--d-model", "32",
         "--heads", "2", "--batch-size", "16", "--epochs", "2",
         "--vocab", "64"]
LM_PP = ["--pp", "2", "--microbatches", "2", "--n", "64", "--seq-len", "32",
         "--d-model", "32", "--heads", "2", "--layers", "2",
         "--batch-size", "16", "--epochs", "2", "--vocab", "64"]
LM_EP = ["--moe", "--ep", "2", "--experts", "8", "--top-k", "2", "--n",
         "64", "--seq-len", "32", "--d-model", "32", "--heads", "2",
         "--batch-size", "16", "--epochs", "2", "--vocab", "64"]
SERVE = ["--prompts", "3", "--max-new", "8", "--slots", "2",
         "--prompt-len", "6", "--vocab", "64"]


def _ref(name):
    """The reference script ``examples/<name>.py`` as a module."""
    key = f"reference_example_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(REPO, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


# -- data ------------------------------------------------------------------


def test_dist_keras_data_is_bit_equal_to_the_references():
    for port, ref, n in ((mnist_workflow, _ref("mnist_workflow"), 1024),
                         (cifar10_training, _ref("cifar10_training"), 512)):
        (x, y), (rx, ry) = port.load_data(n=n), ref.load_data(n=n)
        assert x.dtype == rx.dtype and y.dtype == ry.dtype
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)


def test_lm_corpus_is_bit_equal_to_the_reference():
    for n, T, V in ((64, 64, 64), (16, 37, 256)):
        a = lm_training.synthetic_corpus(n, T, V)
        b = _ref("lm_training").synthetic_corpus(n, T, V)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


class _Stop(Exception):
    pass


def _reference_prompts(monkeypatch, argv):
    """The prompts the reference example submits, caught at its client
    (its model, engine and server stood in: nothing is built or run)."""
    from types import SimpleNamespace

    from distkeras_tpu import telemetry as jax_telemetry

    ref, got = _ref("lm_serving"), []

    class Client:
        def __init__(self, host, port):
            pass

        def generate(self, p, max_new_tokens):
            got.append(np.asarray(p))
            return len(got) - 1

        def stream(self, rid):
            raise _Stop

        def close(self):
            pass

    server = SimpleNamespace(port=0, stop=lambda: None)
    server.start = lambda: server
    monkeypatch.setattr(ref, "get_model", lambda *a, **k: SimpleNamespace(
        init=lambda *a, **k: None))
    monkeypatch.setattr(ref, "ServingEngine", lambda *a, **k: SimpleNamespace(
        registry=jax_telemetry.MetricRegistry(),
        tracer=jax_telemetry.Tracer()))
    monkeypatch.setattr(ref, "LMServer", lambda *a, **k: server)
    monkeypatch.setattr(ref, "ServingClient", Client)
    monkeypatch.setattr(sys, "argv", ["lm_serving.py"] + argv)
    with pytest.raises(_Stop):
        ref.main()
    return got


@pytest.mark.parametrize("mode", [[], ["--paged"]], ids=["slot", "paged"])
def test_serving_prompts_are_bit_equal_to_the_reference(monkeypatch, mode):
    argv = ["--prompts", "4", "--prompt-len", "9", "--vocab", "50"] + mode
    want = _reference_prompts(monkeypatch, argv)
    got = lm_serving.make_prompts(lm_serving.parse_args(argv))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- the cosine schedule ------------------------------------------------------


# (init, peak, warm-up, decay steps, end): lm_training's shape (warm-up
# a tenth of the run, end a hundredth of the peak) and a run without one
SCHEDULES = [(0.0, 1e-2, 2, 28, 1e-4), (0.0, 3e-3, 20, 200, 3e-5),
             (0.1, 1.0, 0, 50, 0.0)]


@pytest.mark.parametrize("cfg", SCHEDULES, ids=str)
def test_cosine_schedule_equals_optax(cfg):
    """Every step of the run, the warm-up and past decay_steps included:
    optax's value op by op and inside a jitted step, to a few float32
    units in the last place (the cosines round differently)."""
    import jax
    import jax.numpy as jnp
    import optax

    ref = optax.warmup_cosine_decay_schedule(*cfg)
    jitted = jax.jit(ref)
    mine = warmup_cosine_decay_schedule(*cfg)
    for c in range(cfg[3] + 10):
        got = mine(c)
        assert isinstance(got, float)
        for want in (float(ref(jnp.int32(c))), float(jitted(jnp.int32(c)))):
            assert got == pytest.approx(want, rel=1e-5, abs=1e-12), (c, got,
                                                                      want)
    assert mine(cfg[2]) == pytest.approx(cfg[1])
    assert mine(0) == (cfg[0] if cfg[2] else pytest.approx(cfg[1]))
    assert mine(cfg[3] + 5) == pytest.approx(cfg[4], abs=1e-9)


def test_adam_under_the_schedule_matches_optax():
    """Twenty steps of ``get_optimizer('adam', schedule)`` from the same
    weights on the same gradients as ``optax.adam(schedule)``: within
    1e-6."""
    import jax
    import jax.numpy as jnp
    import optax

    cfg = (0.0, 1e-2, 3, 16, 1e-4)
    rng = np.random.default_rng(0)
    w0 = {"a": rng.normal(size=(4, 5)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: np.sin(v * (i + 1)).astype(np.float32)
              for k, v in w0.items()} for i in range(20)]

    opt = optax.adam(optax.warmup_cosine_decay_schedule(*cfg))
    w = {k: jnp.asarray(v) for k, v in w0.items()}
    state = opt.init(w)

    @jax.jit
    def step(w, state, g):
        upd, state = opt.update(g, state, w)
        return optax.apply_updates(w, upd), state

    for g in grads:
        w, state = step(w, state, {k: jnp.asarray(v) for k, v in g.items()})

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in w0.items()}
    port = get_optimizer("adam", warmup_cosine_decay_schedule(*cfg))(
        list(params.values()))
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        port.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w[k]),
                                   rtol=0, atol=1e-6)


# -- smokes ----------------------------------------------------------------


def test_mnist_workflow_smoke(capsys):
    out = mnist_workflow.main(
        ["--trainers", "single,adag", "--workers", "2", "--epochs", "1",
         "--n", "1024", "--batch-size", "64", "--model", "mlp"] + CPU)
    text = capsys.readouterr().out
    assert "accuracy=" in text and "best:" in text
    assert set(out["trainers"]) == {"single", "adag"}
    for r in out["trainers"].values():
        assert np.isfinite(r["losses"]).all() and r["accuracy"] >= 0.9


def test_cifar_example_smoke(capsys):
    out = cifar10_training.main(
        ["--trainer", "dataparallel", "--epochs", "1", "--n", "512",
         "--batch-size", "32", "--workers", "2", "--small"] + CPU)
    text = capsys.readouterr().out
    assert "samples/sec" in text and "accuracy" in text
    assert np.isfinite(out["losses"]).all() and out["samples_per_sec"] > 0


def test_streaming_example_equals_a_batch_predict(capsys):
    out = streaming_inference.main(["--n", "512", "--batch-size", "64"]
                                   + CPU)
    assert "streamed 512 records" in capsys.readouterr().out
    assert out["max_abs_gap_vs_batch"] <= streaming_inference.TOL


def test_bigdata_pipeline_example_smoke(capsys):
    out = bigdata_pipeline.main(
        ["--n", "2048", "--rows-per-shard", "512", "--batch-size", "32",
         "--epochs", "2"] + CPU)
    text = capsys.readouterr().out
    assert "accuracy over 2048 rows" in text and "native loader:" in text
    assert out["accuracy"] == out["accuracy_in_memory"] > 0.9


def test_lm_training_smoke_samples_and_beam(capsys):
    out = lm_training.main(
        ["--n", "64", "--seq-len", "32", "--d-model", "32", "--heads", "2",
         "--batch-size", "16", "--epochs", "2", "--vocab", "64",
         "--sample", "8", "--beam", "2", "--rope", "--kv-heads", "1"] + CPU)
    text = capsys.readouterr().out
    assert "tokens/sec" in text and "loss" in text and "sample[1]" in text
    assert out["axes"] == {"dp": 1} and len(out["samples"]) == 2
    assert out["losses"][-1] < out["losses"][0]


def test_lm_training_text_mode_smoke(tmp_path, capsys):
    (tmp_path / "a.py").write_text("def add(a, b):\n    return a + b\n"
                                   * 120)
    out = lm_training.main(
        ["--text", str(tmp_path), "--seq-len", "64", "--d-model", "32",
         "--heads", "2", "--layers", "2", "--batch-size", "8", "--epochs",
         "2", "--lr", "1e-2", "--lr-schedule", "cosine", "--sample", "16"]
        + CPU)
    text = capsys.readouterr().out
    assert "held-out perplexity" in text and "model continuation" in text
    assert "tokens/sec" in text and out["perplexity"] < 256


def test_lm_training_axes_outside_their_world_raise():
    with pytest.raises(ValueError, match=r"Job\(.*hosts=\['local'\] \* 2"):
        lm_training.main(["--dp", "2"] + CPU)
    with pytest.raises(ValueError, match="launch one process a mesh"):
        lm_serving.main(["--tp", "2"] + CPU)


def test_examples_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (mnist_workflow, cifar10_training, streaming_inference,
                bigdata_pipeline, lm_training, lm_serving):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])


SERVING_MODES = {
    "slot": [],
    "paged": ["--paged", "--prompt-len", "8"],
    "prefill_chunk": ["--prefill-chunk", "2"],
    "monolithic": ["--prefill-chunk", "0"],
    "ngram": ["--vocab", "16", "--max-new", "12", "--draft", "ngram",
              "--spec-k", "3"],
    "draft_model": ["--draft", "model"],
    "pipeline": ["--pipeline"],
    "multi_step": ["--multi-step-k", "4"],
    "replicas": ["--prompts", "4", "--prompt-len", "8", "--paged",
                 "--replicas", "2"],
}


@pytest.mark.parametrize("mode", list(SERVING_MODES))
def test_lm_serving_mode_smoke(mode, capsys, tmp_path):
    extra = list(SERVING_MODES[mode])
    if mode == "slot":
        extra += ["--telemetry-port", "0", "--flight-dump",
                  str(tmp_path / "flight.jsonl")]
    out = lm_serving.main(SERVE + extra + CPU)
    text = capsys.readouterr().out
    n = 4 if mode == "replicas" else 3
    assert text.count("parity OK") == n and "slo:" in text
    assert len(out["streams"]) == n and out["tok_s"] > 0
    if mode == "replicas":
        assert "fabric: 2 replicas behind the router" in text
        assert "per replica:" in text and "routed" in text
    else:
        assert f"served {n} requests" in text and "ticks retained" in text
    if mode == "slot":
        assert "slo: 4 rules" in text and "telemetry: http" in text
        from distkeras_torch.telemetry import report

        assert report.main(["--flight", str(tmp_path / "flight.jsonl")]) \
            in (0, None)
    if mode == "paged":
        assert "prefix hit fraction" in text
    if mode == "ngram":
        assert "speculation:" in text and "draft=ngram" in text
    if mode == "draft_model":
        assert "speculation:" in text and "draft=model" in text


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_lm_serving_streams_equal_the_reference(paged, capsys):
    """The reference's tree (``init(PRNGKey(0))``) through the bridge: the
    port's streams equal the reference example's, i.e. its
    ``generate()`` on that tree."""
    import jax
    import jax.numpy as jnp

    from distkeras_tpu.models import get_model as jax_get_model
    from distkeras_tpu.models.transformer import generate as jax_generate

    argv = SERVE + (["--paged", "--prompt-len", "8"] if paged else [])
    args = lm_serving.parse_args(argv + CPU)
    jm = jax_get_model("transformer_lm", vocab_size=args.vocab, d_model=64,
                       num_heads=2, num_layers=2,
                       max_len=args.prompt_len + args.max_new,
                       dtype=jnp.float32, attention="dense")
    tree = jax.jit(jm.init)(jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))
    want = [np.asarray(jax_generate(jm, tree, jnp.asarray(p)[None],
                                    args.max_new))[0, len(p):].tolist()
            for p in lm_serving.make_prompts(args)]
    out = lm_serving.run(args, params=jax.tree.map(np.asarray, tree))
    assert out["streams"] == want
    assert capsys.readouterr().out.count("parity OK") == 3


# -- one 2-process world ------------------------------------------------------


WORLD_RUNS = (("sp2", lm_training, LM_SP), ("pp2", lm_training, LM_PP),
              ("ep2", lm_training, LM_EP), ("tp2", lm_serving, SERVE))


def _world_entry(rank, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    res = {}
    try:
        for name, mod, argv in WORLD_RUNS:
            extra = ["--tp", "2"] if name == "tp2" else []
            r = mod.main(argv + extra + CPU)
            res[name] = {k: r[k] for k in ("axes", "world", "losses",
                                           "params_sha256", "streams")
                         if k in r}
        with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("examples_world"))
    spawn_ranks(_world_entry, WORLD, out, TIMEOUT_S)
    return [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(WORLD)]


@pytest.mark.parametrize("name,axes", [
    ("sp2", {"sp": 2}), ("pp2", {"pp": 2, "dp": 1}),
    ("ep2", {"ep": 2, "dp": 1})])
def test_lm_training_over_two_processes(world, name, axes):
    """Each rank trains through the example over its axes: the losses
    fall, both ranks see the same losses and end with bit-identical
    (plain-layout) parameters."""
    a, b = world[0][name], world[1][name]
    assert a["axes"] == b["axes"] == axes and a["world"] == 2
    assert np.isfinite(a["losses"]).all()
    assert a["losses"][-1] < a["losses"][0]
    assert a["losses"] == b["losses"]
    assert a["params_sha256"] == b["params_sha256"]


def test_lm_serving_tp2_over_two_processes(world):
    """Rank 0 serves and checks every stream against ``generate()``; rank
    1 follows its loop and returns once the leader stops."""
    assert len(world[0]["tp2"]["streams"]) == 3
    assert world[1]["tp2"] == {}
