"""Tensor-parallel serving in the port (``ServingEngine(mesh=...)``) on
the CPU: two gloo ranks, each building the engine from the same
``tp_size=1`` model over ``make_mesh({"model": 2})``, against the tp=1
engine of the same model in the same rank.

The ranks are spawned ONCE for the module (``tp_serving``, with a
timeout of its own that names the stalled ranks) and run every case;
the tests read the results. Each case: the reference's four ``_CORE``
combinations of ``test_tp_serving.py::test_tp_streams_bit_identical``
(slot / paged x MHA / GQA x model / int8 cache x chunked / monolithic),
the pipelined loop, multi-step decode, n-gram and draft-model
speculation (a draft sharded like the flagship, and one replicated
whole), a live weight swap, the host tier and KV migration both ways
between a tp=2 and a tp=1 engine (the reference's ``*_tp4`` cases at
tp=2). Streams, greedy and sampled, equal the tp=1 engine's token for
token and equal across the ranks; the last logits of the two engines
agree within 1e-5 (the row-parallel partial sums round in another
order than one product, so logits are held to a tolerance and tokens
exactly; a mismatch reports the logit gap).

Single process: the mesh validation of the reference's
``test_tp_mesh_validation``.
"""

import datetime
import json
import os
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from distkeras_torch import bridge, telemetry  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.parallel.mesh import Mesh, local_mesh, make_mesh  # noqa: E402
from distkeras_torch.serving import ServingEngine  # noqa: E402

from torch_spawn_util import spawn_ranks  # noqa: E402

WORLD = 2
TIMEOUT_S = 240
V = 64
KW = dict(vocab_size=V, d_model=32, num_heads=8, num_layers=2, max_len=48,
          dtype=torch.float32, device="cpu", pos_emb="rope")
HEADS = {"mha": {}, "gqa": {"num_kv_heads": 4}}
BS = 8

# (model heads, cache dtype, engine keywords) of every case
CASES = {
    "core-slot-mha-model-chunked": ("mha", "model", dict(prefill_chunk=4)),
    "core-slot-gqa-int8-monolithic": ("gqa", "int8",
                                      dict(prefill_chunk=None)),
    "core-paged-gqa-int8-chunked": ("gqa", "int8",
                                    dict(paged=True, prefill_chunk=4)),
    "core-paged-mha-model-monolithic": ("mha", "model",
                                        dict(paged=True, prefill_chunk=None)),
    "pipelined-paged": ("gqa", "int8", dict(paged=True, pipeline=True)),
    "pipelined-slot": ("gqa", "model", dict(pipeline=True)),
    "multistep-paged": ("gqa", "int8", dict(paged=True, multi_step_k=4)),
    "multistep-slot": ("mha", "model", dict(multi_step_k=4)),
    "ngram-paged": ("gqa", "int8", dict(paged=True, draft="ngram",
                                        spec_k=3)),
    "draft-sharded-paged": ("gqa", "int8", dict(paged=True, draft=(4, 2),
                                                spec_k=3)),
    "draft-replicated-slot": ("gqa", "model", dict(draft=(1, 1), spec_k=3)),
    "swap-paged": ("gqa", "int8", dict(paged=True)),
    "tier-paged": ("gqa", "int8", dict(paged=True, host_blocks=32,
                                       num_blocks=12, prefill_chunk=BS)),
    "migrate-host": ("gqa", "int8", dict(paged=True, host_blocks=32)),
    "migrate-device": ("mha", "model", dict(paged=True)),
}


def _model(heads, cache_dtype, seed=0):
    return get_model("transformer_lm", seed=seed, cache_dtype=cache_dtype,
                     **dict(KW, **HEADS[heads]))


def _workload():
    rng = np.random.default_rng(0)
    sys_ = rng.integers(0, V, size=BS)
    prompts = [np.concatenate([sys_, rng.integers(0, V, size=n)]).astype(
        np.int32) for n in (9, 5, 13)]
    cfgs = [dict(max_new_tokens=7),
            dict(max_new_tokens=8, temperature=1.0, seed=3),
            dict(max_new_tokens=6, temperature=0.8, seed=7, top_k=8)]
    return prompts, cfgs


def _churn():
    """Three shared 32-token prefixes round-robin, twice: a pool of 12
    blocks must demote each prefix before its revisit."""
    rng = np.random.default_rng(1)
    prefixes = [rng.integers(0, V, size=32).astype(np.int32)
                for _ in range(3)]
    return [np.concatenate([p, rng.integers(0, V, size=3).astype(np.int32)])
            for _ in range(2) for p in prefixes]


def _engine(pm, mesh, **kw):
    kw = dict(dict(slots=2, block_size=BS, prefill_chunk=4), **kw)
    if isinstance(kw.get("draft"), tuple):
        h, hk = kw["draft"]
        kw["draft"] = get_model("transformer_lm", seed=1, vocab_size=V,
                                d_model=16, num_heads=h, num_kv_heads=hk,
                                num_layers=1, max_len=KW["max_len"],
                                dtype=torch.float32, device="cpu")
    where = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    return ServingEngine(pm, registry=telemetry.MetricRegistry(),
                         tracer=telemetry.Tracer(), **where, **kw)


def _serve(eng, prompts, cfgs):
    reqs = [eng.submit(p, **c) for p, c in zip(prompts, cfgs)]
    eng.drain(timeout=120)
    return [r.stream.tokens(timeout=10) for r in reqs]


def _run_case(name, heads, cache_dtype, mesh, kw):
    """``(streams, engine)`` of one case on one engine (``mesh=None``: the
    tp=1 engine), over a model of its own (a swap rebinds the tp=1
    engine's weights)."""
    pm = _model(heads, cache_dtype)
    prompts, cfgs = _workload()
    if name.startswith("swap"):
        eng = _engine(pm, mesh, **kw)
        first = _serve(eng, prompts[:1], cfgs[:1])
        new = bridge.params_to_jax(_model("gqa", "int8", seed=2))
        eng.update_weights(new, version=2)
        return first + _serve(eng, prompts, cfgs), eng
    if name.startswith("tier"):
        eng = _engine(pm, mesh, **kw)
        out = []
        for p in _churn():
            out += _serve(eng, [p], [dict(max_new_tokens=4,
                                          temperature=0.7, seed=11)])
        return out, eng
    eng = _engine(pm, mesh, **kw)
    return _serve(eng, prompts, cfgs), eng


def _migrate(pm, mesh, kw):
    """KV blocks exported by a tp=2 engine, imported by a tp=1 one, and
    the reverse: the streams each importer then serves (its prefix
    hit), and the tokens each import covered."""
    prompt = np.random.default_rng(2).integers(0, V, size=28).astype(
        np.int32)
    cfg = dict(max_new_tokens=6, temperature=0.7, seed=5)
    out = {}
    for src_mesh, dst_mesh, tag in ((mesh, None, "tp2_to_tp1"),
                                    (None, mesh, "tp1_to_tp2")):
        src = _engine(pm, src_mesh, **kw)
        _serve(src, [prompt], [dict(max_new_tokens=1)])
        blocks = src.export_blocks(prompt)  # collective on a tp source
        dst = _engine(pm, dst_mesh, **kw)
        imp = dst.import_blocks(prompt, blocks["blocks"])
        out[tag] = dict(stream=_serve(dst, [prompt], [cfg])[0],
                        imported=imp["tokens"], hit=dst.prefix_hit_tokens)
    ref = _engine(pm, None, **kw)
    out["reference"] = _serve(ref, [prompt], [cfg])[0]
    return out


def _serving_entry(rank, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    res = {}
    try:
        mesh = make_mesh({"model": WORLD})
        for name, (heads, cache_dtype, kw) in CASES.items():
            if name.startswith("migrate"):
                res[name] = _migrate(_model(heads, cache_dtype), mesh, kw)
                continue
            want, e1 = _run_case(name, heads, cache_dtype, None, kw)
            got, e2 = _run_case(name, heads, cache_dtype, mesh, kw)
            st = e2.stats()
            res[name] = dict(
                tp1=want, tp2=got, tp=st["tp"],
                logit_gap=float((e1._last_logits - e2._last_logits)
                                .abs().max()),
                restores=st.get("block_restores", 0),
                demotions=st.get("block_demotions", 0),
                draft_tp=getattr(e2, "draft_tp", None),
                steps_multi=0 < st["dispatches"] < st["tokens_generated"])
        try:  # deadlines expire by each rank's clock: refused
            _engine(_model("mha", "model"), mesh).submit(
                [1, 2, 3], 2, deadline_s=1.0)
            res["deadline"] = "accepted"
        except ValueError as e:
            res["deadline"] = str(e)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def tp_serving(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_serving"))
    spawn_ranks(_serving_entry, WORLD, out, TIMEOUT_S)
    return [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(WORLD)]


@pytest.mark.parametrize("name", [n for n in CASES
                                  if not n.startswith("migrate")])
def test_tp2_streams_equal_tp1_engine(tp_serving, name):
    for r, res in enumerate(tp_serving):
        case = res[name]
        assert case["tp"] == 2
        assert case["tp2"] == case["tp1"], (
            f"rank {r} {name}: tp=2 streams differ from tp=1 (last logits "
            f"differ by {case['logit_gap']})")
        assert case["tp2"] == tp_serving[0][name]["tp2"]
        assert case["logit_gap"] <= 1e-5, name
        assert all(len(s) > 0 for s in case["tp2"])
    case = tp_serving[0][name]
    if name.startswith("tier"):
        assert case["demotions"] > 0 and case["restores"] > 0
    if name.startswith("draft"):
        assert case["draft_tp"] == (2 if "sharded" in name else 1)
    if name.startswith("multistep"):
        assert case["steps_multi"]  # some dispatch ran several steps


@pytest.mark.parametrize("name", ["migrate-host", "migrate-device"])
def test_kv_migration_crosses_tp_degrees(tp_serving, name):
    for r, res in enumerate(tp_serving):
        case = res[name]
        for tag in ("tp2_to_tp1", "tp1_to_tp2"):
            assert case[tag]["imported"] == 24, (r, tag)
            assert case[tag]["hit"] == 24, (r, tag)
            assert case[tag]["stream"] == case["reference"], (r, tag)
        assert case == tp_serving[0][name]


def test_tp_engine_refuses_deadlines(tp_serving):
    for res in tp_serving:
        assert "lock step" in res["deadline"]


def test_tp_mesh_validation():
    """The reference's test_tp_mesh_validation (plus the port's
    device= / mesh= exclusivity), on meshes seen from one position."""
    pm = _model("mha", "model")
    kw = dict(registry=telemetry.MetricRegistry(), tracer=telemetry.Tracer())
    with pytest.raises(ValueError, match="make_mesh"):
        ServingEngine(pm, mesh=object(), **kw)
    with pytest.raises(ValueError, match="no 'model' axis"):
        ServingEngine(pm, mesh=Mesh({"dp": 2}, {"dp": 0}, {}), **kw)
    with pytest.raises(ValueError, match="no 'model' axis"):
        ServingEngine(pm, mesh=local_mesh({"dp": 1}), **kw)
    with pytest.raises(ValueError, match="must be 1-D"):
        ServingEngine(pm, mesh=Mesh({"dp": 2, "model": 2},
                                    {"dp": 0, "model": 0}, {}), **kw)
    two = Mesh({"model": 2}, {"model": 0}, {})
    with two:
        tp_model = get_model("transformer_lm", tp_size=2, tp_axis="model",
                             **KW)
    with pytest.raises(ValueError, match="tp_size=1"):
        ServingEngine(tp_model, mesh=two, **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ServingEngine(pm, mesh=two, device="cpu", **kw)
    # a mesh of one position serves unsharded, as the engine without one
    eng = ServingEngine(pm, mesh=local_mesh({"model": 1}), **kw)
    assert eng.stats()["tp"] == 1
