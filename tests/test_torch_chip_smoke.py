"""The parts of ``chip_smoke.py`` that run without a card: reading the
kernels' build facts from nvcc's ``-Xptxas -v`` report and the tensor
instructions from ``cuobjdump -sass``, the analytic FLOP count its
CIFAR phase divides by (``distkeras_torch.bench.cifar_step_flops``),
that phase's witness on the CPU, run here at narrow widths, and phase
9's functions (the parameter-server family) at narrow widths, with the
lock-step witness shown to fail on a fault in a commit rule."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401

_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2ca4sm9010fwd_kernelILi256ELb1ELb0EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16PfNS_5ShapeEii' for 'sm_90a'
ptxas info    : Function properties for _ZN2ca4sm9010fwd_kernelILi256ELb1ELb0EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16PfNS_5ShapeEii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN2ca4sm9010fwd_kernelILi256ELb0ELb1EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16PfNS_5ShapeEii' for 'sm_90a'
ptxas info    : Function properties for _ZN2ca4sm9010fwd_kernelILi256ELb0ELb1EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16PfNS_5ShapeEii
    16 bytes stack frame, 12 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN2ca9dq_kernelILi256ELb1ELb0EEEvPK13__nv_bfloat16' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 236 registers, used 1 barriers
"""


@pytest.mark.parametrize("flags,want", [
    ("ELb1ELb0E", {"registers": 168, "spill_store_bytes": 0,
                   "spill_load_bytes": 0}),
    ("ELb0ELb1E", {"registers": 168, "spill_store_bytes": 12,
                   "spill_load_bytes": 32}),
])
def test_ptxas_facts_reads_each_kernels_own_block(flags, want):
    """Each instantiation's registers and spills come from its own block
    of the report, not from the kernel compiled after it."""
    key = f"sm9010fwd_kernelILi256{flags}"
    assert chip_smoke.ptxas_facts(_LOG, key) == want


def test_ptxas_facts_raises_for_a_kernel_not_in_the_report():
    with pytest.raises(AssertionError, match="no ptxas report"):
        chip_smoke.ptxas_facts(_LOG, "sm9010fwd_kernelILi128ELb1ELb0E")


_SASS = """
	code for sm_90a
		Function : _ZN2ca4sm909dq_kernelILi256EEEv14CUtensorMap_st
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0a40*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;
        /*0a50*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24 ;
        /*0a60*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
		Function : _ZN2ca9dq_kernelILi256ELb1ELb1EEEvPK13__nv_bfloat16
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/                   HMMA.16816.F32.BF16 R20, R8, R14, R20 ;
		Function : _ZN2ca4sm9010dkv_kernelILi256EEEv14CUtensorMap_st
        /*0200*/                   HGMMA.64x32x16.F32.BF16 R24, gdesc[UR4], RZ ;
"""


@pytest.mark.parametrize("key,want", [
    ("sm909dq_kernelILi256E", {"HGMMA": 2, "HMMA": 0,
                               "WARPGROUP_DEPBAR": 1}),
    ("ca9dq_kernelILi256ELb1ELb1E", {"HGMMA": 0, "HMMA": 2,
                                     "WARPGROUP_DEPBAR": 0}),
    ("sm9010dkv_kernelILi256E", {"HGMMA": 1, "HMMA": 0,
                                 "WARPGROUP_DEPBAR": 0}),
])
def test_sass_counts_reads_each_kernels_own_function(key, want):
    """Each kernel's HGMMA / HMMA / WARPGROUP.DEPBAR counts come from its
    own function in the SASS listing."""
    assert chip_smoke.sass_counts(_SASS, key) == want


def test_sass_counts_raises_for_a_kernel_not_in_the_listing():
    with pytest.raises(AssertionError, match="no SASS"):
        chip_smoke.sass_counts(_SASS, "sm909dq_kernelILi64E")


def _bwd_listing():
    """A report and a SASS listing with every backward instantiation of
    both libraries, each with its own register count and HGMMA count, the
    pair's next to the causal ones of the same hd."""
    log, sass, want = [], [], {}
    n = 0
    for row, (_, stem, flags, _) in chip_smoke.BWD_INSTANCES.items():
        for hd in (64, 128, 256):
            n += 1
            name = f"_ZN2ca4{stem}{hd}{flags}EEv14CUtensorMap_st"
            log += [f"ptxas info    : Compiling entry function '{name}' for "
                    f"'sm_90a'",
                    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                    "spill loads",
                    f"ptxas info    : Used {100 + n} registers"]
            sass += [f"\t\tFunction : {name}"] + [
                "        /*0a40*/    HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], "
                "R24 ;"] * n
            want[(row, hd)] = n
    return "\n".join(log), "\n".join(sass), want


@pytest.mark.parametrize("row", sorted(chip_smoke.BWD_INSTANCES))
def test_bwd_instances_pick_their_own_kernel(row):
    """Each backward row's key (mangled stem, hd, <CAUSAL, PAIR> flags)
    finds its own instantiation at every hd, never the causal kernel for
    a pair row, the wedge for the rectangle, or another hd."""
    log, sass, want = _bwd_listing()
    _, stem, flags, _ = chip_smoke.BWD_INSTANCES[row]
    for hd in (64, 128, 256):
        key = f"{stem}{hd}{flags}"
        n = want[(row, hd)]
        assert chip_smoke.ptxas_facts(log, key)["registers"] == 100 + n
        assert chip_smoke.sass_counts(sass, key)["HGMMA"] == n


def test_cifar_step_flops_is_the_hand_count():
    """3x the forward: the six 3x3 convolutions at 32, 32, 16, 16, 8 and 8
    pixels a side, then Dense 4096 -> 256 and 256 -> 10."""
    from distkeras_torch.bench import cifar_step_flops

    convs = [(32, 3, 64), (32, 64, 64), (16, 64, 128), (16, 128, 128),
             (8, 128, 256), (8, 256, 256)]
    fwd = sum(2 * hw * hw * cin * cout * 9 for hw, cin, cout in convs)
    fwd += 2 * 4096 * 256 + 2 * 256 * 10
    assert fwd == 307_631_104  # 307.6 MFLOP a sample
    assert cifar_step_flops() == 3 * fwd
    assert cifar_step_flops(2048) == 3 * fwd * 2048
    small = cifar_step_flops(1, widths=(8, 16, 32))
    assert small == 3 * (sum(2 * hw * hw * cin * cout * 9 for hw, cin, cout
                             in [(32, 3, 8), (32, 8, 8), (16, 8, 16),
                                 (16, 16, 16), (8, 16, 32), (8, 32, 32)])
                         + 2 * 512 * 256 + 2 * 256 * 10)


def _witness(monkeypatch):
    """chip_smoke.cpu_witness with the CPU standing in for the card, on
    the CIFAR CNN at widths 8/16/32."""
    import torch

    from distkeras_torch import bench
    from distkeras_torch.models import get_model
    from distkeras_torch.utils.losses import get_loss, get_optimizer
    from distkeras_torch.workers import make_window_step

    def narrow(name, **kw):
        return get_model(name, widths=(8, 16, 32), **kw)

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    dk = {"bench": bench, "get_model": narrow,
          "get_optimizer": get_optimizer,
          "make_window_step": make_window_step}
    model = narrow("cifar_cnn", device="cpu", seed=0)
    xs, ys = bench.cifar_batches("cpu", chip_smoke.WITNESS_ROWS,
                                 chip_smoke.WITNESS_STEPS)
    return chip_smoke.cpu_witness(torch, dk, model, xs, ys,
                                  get_loss("categorical_crossentropy"))


def test_cpu_witness_at_narrow_widths(monkeypatch):
    """Phase 8a's second witness: the f64 run is the CPU's own, so every
    gap is 0; the bf16 run stays within its tolerances."""
    out = _witness(monkeypatch)
    assert out["float64"] == {"logits": 0.0, "loss": 0.0, "update": 0.0}
    for name in ("bfloat16", "float32"):
        assert set(out[name]) == {"logits", "loss", "update"}


@pytest.mark.parametrize("fault", ["forward", "backward"])
def test_cpu_witness_catches_a_bf16_convolution_fault(monkeypatch, fault):
    """A fault in the bf16 convolutions alone, as one backend's kernels
    could have it, fails the witness: kernels flipped left to right in
    the forward, or the kernels' gradient negated in the backward (the
    forward, and so the logits, unchanged)."""
    import torch

    conv2d = torch.nn.functional.conv2d

    class Negate(torch.autograd.Function):
        @staticmethod
        def forward(ctx, w):
            return w.view_as(w)

        @staticmethod
        def backward(ctx, g):
            return -g

    def faulty(x, w, *args, **kw):
        if x.dtype == torch.bfloat16:
            w = w.flip(-1) if fault == "forward" else Negate.apply(w)
        return conv2d(x, w, *args, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", faulty)
    # the backward's fault shows first in the later steps' losses
    want = "logits" if fault == "forward" else "(loss|update)"
    with pytest.raises(AssertionError, match=f"bfloat16 .*: {want} gap"):
        _witness(monkeypatch)


def _ps_dk():
    from distkeras_torch import bench, evaluators, predictors, trainers
    from distkeras_torch import transformers as stages
    from distkeras_torch.data.dataset import PartitionedDataset
    from distkeras_torch.models import get_model
    from distkeras_torch.parameter_servers import DeltaParameterServer

    def narrow(name, **kw):
        if name == "cifar_cnn":
            kw.setdefault("widths", (4, 8, 8))
        return get_model(name, **kw)

    return {"get_model": narrow, "bench": bench,
            "PartitionedDataset": PartitionedDataset,
            "ModelPredictor": predictors.ModelPredictor,
            "AccuracyEvaluator": evaluators.AccuracyEvaluator,
            "MinMaxTransformer": stages.MinMaxTransformer,
            "ReshapeTransformer": stages.ReshapeTransformer,
            "OneHotTransformer": stages.OneHotTransformer,
            "LabelIndexTransformer": stages.LabelIndexTransformer,
            "DeltaParameterServer": DeltaParameterServer,
            **{n: getattr(trainers, n) for n in chip_smoke.PS_NAMES}}


@pytest.mark.parametrize("fault", [None, "sign", "dropped"])
def test_ps_witness_catches_a_commit_fault(monkeypatch, fault):
    """Phase 9c on the CPU standing in for the card (f64 runs, CIFAR CNN
    at widths 4/8/8, 8 rows): sound, every gap is 0 and phase 9d's round
    trip counts its commit; with the lock-step commit (``rules.
    allreduce_sum_delta``) faulty on the card's run alone — its sign
    flipped, or one worker's delta dropped — the witness fails."""
    import numpy as np
    import torch

    from distkeras_torch.ops import rules

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "PS_WITNESS",
                        dict(chip_smoke.PS_WITNESS, rows=8, batch_size=4))
    monkeypatch.setattr(chip_smoke, "PS_WITNESS_DTYPES", ("float64",))
    dk = _ps_dk()
    model = dk["get_model"]("cifar_cnn", device="cpu", seed=0)
    if fault is None:
        out = chip_smoke.ps_witness(torch, np, dk, model)
        for name in ("DOWNPOUR", "EASGD"):
            assert out[name]["float64"] == {"logits": 0.0, "loss": 0.0,
                                            "center": 0.0, "update": 0.0}
        rt = chip_smoke.ps_roundtrip(torch, dk, model)
        assert rt["commits"] > 0 and rt["bytes"] == 20 * rt["params"]
        return
    reduce = rules.allreduce_sum_delta
    calls = []

    def faulty(deltas, device):
        calls.append(1)
        if len(calls) <= chip_smoke.PS_WITNESS["num_epoch"]:
            return reduce(deltas, device)  # the CPU's reference run
        if fault == "dropped":
            return reduce(deltas[:1], device)
        return rules.tree_scale(reduce(deltas, device), -1.0)

    monkeypatch.setattr(rules, "allreduce_sum_delta", faulty)
    with pytest.raises(AssertionError,
                       match=r"DOWNPOUR\(spmd=True\) float64 .* gap"):
        chip_smoke.ps_witness(torch, np, dk, model)


def test_ps_phases_at_narrow_widths(monkeypatch):
    """Phases 9a and 9b end to end on the CPU at narrow widths and few
    rows (the accuracy floors and epochs lowered to what so few rows
    reach): every history finite, every window committed, the center's
    loss falling."""
    import numpy as np
    import torch

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "PS_CIFAR_MIN_ACCURACY",
                        {"DOWNPOUR": 0.0, "AEASGD": 0.0})
    monkeypatch.setattr(chip_smoke, "PS_CIFAR_TRAIN",
                        dict(chip_smoke.PS_CIFAR_TRAIN, batch_size=16,
                             num_epoch=1))
    monkeypatch.setattr(chip_smoke, "PS_EVAL_ROWS", 256)
    monkeypatch.setattr(chip_smoke, "MNIST_MIN_ACCURACY", 0.0)
    monkeypatch.setattr(chip_smoke, "QUICKSTART",
                        dict(chip_smoke.QUICKSTART, num_epoch=1))
    dk = _ps_dk()
    out = chip_smoke.ps_cifar_phase(torch, np, dk, rows=512,
                                    widths=(4, 8, 8))
    for name, r in out["trainers"].items():
        window = chip_smoke.PS_CIFAR[name]["communication_window"]
        assert r["steps"] == 8 * 4, name  # 64 rows a worker, batch 16
        assert r["commits"] == 8 * -(-4 // window), name
        assert r["center_loss_after"] < r["center_loss_before"]
        assert r["profiled_epoch"]["idle_share"] is None
    quick = chip_smoke.quickstart_phase(torch, np, dk, rows=1024)
    assert quick["commits"] == 4 * 1 and quick["steps"] == 4 * 2


# -- the serving phases (2, 4 and 10) on the CPU ------------------------------


def _standin_kernels(monkeypatch):
    """The serving kernels stood in on the CPU: their gates pass as on a
    card, and each call counts a launch and its route (as the wrappers
    do where they launch) and runs the plain version in f32, as the
    kernels accumulate."""
    import torch

    from distkeras_torch.ops import paged_attention as pa
    from distkeras_torch.ops import splash_prefill as sp

    def counting(plain, kind):
        def f(q, *args):
            f.launches += 1
            route = sp.launch_route(kind, q.dtype == torch.bfloat16, 16, 1)
            f.routes[route] = f.routes.get(route, 0) + 1
            args = [a.float() if torch.is_tensor(a) and a.is_floating_point()
                    else a for a in args]
            return plain(q.float(), *args).to(q.dtype)
        f.launches, f.routes = 0, {}
        return f

    monkeypatch.setattr(pa, "paged_attention",
                        counting(pa.paged_attention_reference, "paged"))
    monkeypatch.setattr(sp, "splash_prefill_attention",
                        counting(sp.splash_prefill_reference, "splash"))
    monkeypatch.setattr(pa, "preferred",
                        lambda hd, bs, device=None: pa.supports(hd, bs))
    monkeypatch.setattr(sp, "preferred",
                        lambda T, hd, L, device=None: sp.supports(T, hd, L))
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    return pa, sp


def _serving_dk():
    from distkeras_torch import bench, bridge, telemetry
    from distkeras_torch.models import get_model
    from distkeras_torch.models.transformer import generate
    from distkeras_torch.serving import ServingEngine

    return {"telemetry": telemetry, "get_model": get_model,
            "bridge": bridge, "generate": generate,
            "ServingEngine": ServingEngine,
            "serving_requests": bench.serving_requests}


_NARROW_EXACT = dict(vocab_size=64, d_model=128, num_heads=2,
                     num_kv_heads=1, num_layers=2, max_len=256,
                     pos_emb="rope", cache_dtype="int8")


def _narrow_exact(monkeypatch):
    """Phase 4 at a narrow width, its requests cut to 8-20 new tokens."""
    monkeypatch.setattr(chip_smoke, "EXACT", _NARROW_EXACT)
    monkeypatch.setattr(chip_smoke, "EXACT_DRAFT",
                        dict(_NARROW_EXACT, num_layers=1,
                             num_kv_heads=None))
    full = chip_smoke.exact_requests
    monkeypatch.setattr(chip_smoke, "exact_requests", lambda np, V: [
        (p, dict(c, max_new_tokens=c["max_new_tokens"] - 16))
        for p, c in full(np, V)])


def test_phase2_times_the_new_shapes(monkeypatch):
    """Phase 2 at narrow shapes: the paged cases at every T of the main
    path (decode, chunk, verify, monolithic) and the splash cases at the
    verify window, a whole prompt from position 0 and hd 128, each held
    and timed beside its bound."""
    import torch
    import torch.nn.functional as F

    pa, sp = _standin_kernels(monkeypatch)
    monkeypatch.setattr(chip_smoke, "PAGED", dict(
        S=3, H=4, Hk=2, hd=64, bs=16, MB=8, T=(1, 16, 5, 100)))
    monkeypatch.setattr(chip_smoke, "SPLASH", dict(S=3, T=16, H=4, Hk=2,
                                                   hd=64, L=128))
    monkeypatch.setattr(chip_smoke, "SPLASH_MORE", (
        (5, 64, 4, "depth"), (100, 64, 4, "zero"), (16, 128, 2, "depth")))
    paged = chip_smoke.paged_cases(torch, F, pa)
    timed = {c["T"] for c in paged if "ms" in c}
    assert timed == {1, 16, 5, 100}
    splash = chip_smoke.splash_cases(torch, F, sp)
    shapes = {(c["T"], c["hd"], c["starts"]) for c in splash if "ms" in c}
    assert shapes == {(16, 64, "depth"), (5, 64, "depth"),
                      (100, 64, "zero"), (16, 128, "depth")}
    for c in paged + splash:
        assert c["max_abs_err"] <= c["tol"]
        if "ms" in c:
            assert c["bound_ms"] > 0 and c["bound_by"] in ("bytes",
                                                           "operations")


def test_phase4_holds_every_mode_at_narrow_width(monkeypatch):
    """Phase 4 end to end on the CPU (a narrow f32 model, the serving
    kernels stood in by their plain versions): every mode on both
    layouts, the host tier, the weight swap, KV migration and beam
    search all hold."""
    import numpy as np
    import torch

    pa, sp = _standin_kernels(monkeypatch)
    _narrow_exact(monkeypatch)
    res = chip_smoke.exact_phase(torch, np, _serving_dk(), pa, sp)
    for layout in ("paged", "slot"):
        assert set(res[layout]) == {n for n, _ in chip_smoke.EXACT_MODES}
        for mode in res[layout].values():
            assert mode["greedy_equal"] and mode["kernel_launches"] > 0
    assert res["host_tier"]["restores"] > 0
    assert res["swap"]["streams_equal"] and res["swap"]["version"] == 2
    assert res["migrate_device"]["tokens"] > 0
    assert res["migrate_host"]["tokens"] > 0
    assert res["beam_search"]["beams_equal"]


@pytest.mark.parametrize("fault", ["dropped_rejection", "restore_skipped"])
def test_phase4_fails_on_an_injected_fault(monkeypatch, fault):
    """Phase 4 catches a speculative engine that accepts every draft (a
    dropped rejection) and a restore whose copy never lands before the
    tick that reads the block."""
    import numpy as np
    import torch

    from distkeras_torch.serving import ServingEngine
    from distkeras_torch.serving import engine as eng_mod

    pa, sp = _standin_kernels(monkeypatch)
    _narrow_exact(monkeypatch)
    dk = _serving_dk()
    model = dk["get_model"]("transformer_lm", dtype=torch.float32,
                            device="cpu", seed=3, **chip_smoke.EXACT)
    if fault == "restore_skipped":
        monkeypatch.setattr(ServingEngine, "_upload_blocks",
                            lambda self, dsts, entries: None)
        with pytest.raises(AssertionError, match="host tier"):
            chip_smoke.exact_tier(torch, np, dk, pa, model)
        return

    def accept_all(cfgs, k, onehot_q, full, gens, valid, n_forced,
                   sample_mask, draft_toks, q_probs):
        S = full.shape[0]
        acc = (valid.long() - n_forced.long()).clamp(min=0)
        z_logits = full[torch.arange(S), n_forced.long() + acc]
        d = draft_toks.long()
        dp = torch.cat([d, torch.zeros((S, 1), dtype=d.dtype)], 1)
        pos = torch.arange(k + 1)[None]
        z = torch.argmax(z_logits, dim=-1)[:, None]
        out = torch.where(pos < acc[:, None], dp,
                          torch.where(pos == acc[:, None], z,
                                      torch.zeros_like(dp)))
        return out, acc, z_logits

    monkeypatch.setattr(eng_mod, "_spec_accept", accept_all)
    monkeypatch.setattr(chip_smoke, "EXACT_MODES", (
        ("chunked", {}), ("ngram", dict(draft="ngram", spec_k=4))))
    requests = chip_smoke.exact_requests(np, model.vocab_size)
    refs = [dk["generate"](model, p[None], c["max_new_tokens"],
                           temperature=c.get("temperature", 0.0),
                           seed=c["seed"], top_k=c.get("top_k"))[
        0, len(p):].tolist() for p, c in requests]
    with pytest.raises(AssertionError, match="ngram greedy vs generate"):
        chip_smoke.exact_modes(torch, np, dk, pa, sp, model, requests, refs)


def test_phase10_modes_at_narrow_width(monkeypatch):
    """Phase 10's configuration and assertions on the CPU (a narrow bf16
    flagship, its request mix cut to five prompts of 8 new tokens): every
    mode finishes every request with the kernels in every layer of every
    forward its layout runs them (the draft's in every draft layer of
    every catch-up feed), the second host-tier pass restores,
    beam search's prefill runs splash, and the swap moves the version."""
    import numpy as np
    import torch

    pa, sp = _standin_kernels(monkeypatch)
    monkeypatch.setattr(chip_smoke, "FLAGSHIP", dict(
        vocab_size=128, d_model=128, num_heads=2, num_kv_heads=1,
        num_layers=2, max_len=256, pos_emb="rope", cache_dtype="int8"))
    monkeypatch.setattr(chip_smoke, "SYSTEM_PREFIX", 32)
    monkeypatch.setattr(chip_smoke, "PROMPT_LENS", (40, 100, 20, 70, 9))
    monkeypatch.setattr(chip_smoke, "DRAFT", dict(
        vocab_size=128, d_model=128, num_heads=1, num_layers=1,
        max_len=256, pos_emb="rope", cache_dtype="int8"))
    monkeypatch.setattr(chip_smoke, "FLAG_TIER", dict(
        prefixes=4, prefix_len=64, tails=(8, 16), passes=2, requests=8,
        max_new=8, slots=2))
    monkeypatch.setattr(chip_smoke, "FLAG_BEAM",
                        dict(rows=2, prompt=32, beam=2, new=4))
    dk = _serving_dk()
    mix = dk["serving_requests"]
    dk["serving_requests"] = lambda *a: [
        (p, dict(c, max_new_tokens=8)) for p, c in mix(*a)]
    _, _, _, chunked = chip_smoke.serving_phase(torch, np, dk, pa, sp)
    out = chip_smoke.modes_phase(torch, np, dk, pa, sp, chunked)
    for lay in ("paged", "slot"):
        for mode in ("chunked", "monolithic", "pipelined", "multi_step",
                     "ngram"):
            r = out[f"{mode}_{lay}"]
            assert r["tokens"] > 0 and r["launches"]
            assert r["greedy_match_vs_chunked"] is not None
        # phase 10's own sync chunked run repeats phase 3's streams
        assert out[f"chunked_{lay}"]["greedy_match_vs_chunked"] == 1.0
    assert out["multi_step_paged"]["tokens_per_dispatch_p50"] > 1
    assert out["ngram_slot"]["acceptance_rate"] is not None
    d = out["draft_model_paged"]
    assert d["draft_feeds"] > 0
    assert d["draft_splash_launches"] >= d["draft_feeds"]  # x 1 layer
    assert out["host_tier_paged"]["pass_2"]["restores"] > 0
    assert out["beam_search"]["splash_launches"] >= 2
    assert out["update_weights_pipelined"]["version"] == 2


def test_tier_sizes_follow_the_serve_bench_rule():
    """The host-tier run's pools by serve_bench.py's rule at its full
    configuration: 4 prefixes of 32 blocks, worst case 50 blocks a slot
    (512 + 256 + 32 tokens), 2 slots."""
    assert chip_smoke.tier_sizes() == (1 + 2 * 50 + 42, 4 * 32 + 32)


# -- phase 11 (I/O and deployment) on the CPU -----------------------------------


def _io_dk():
    from distkeras_torch import streaming
    from distkeras_torch.checkpoint import Checkpointer
    from distkeras_torch.data import shard_io, text
    from distkeras_torch.job_deployment import Job
    from distkeras_torch.models.wrapper import Model
    from distkeras_torch.ops import rules
    from distkeras_torch import trainers
    from distkeras_torch.trainers import LMTrainer, SingleTrainer
    from distkeras_torch.utils.keras_import import from_keras_config
    from distkeras_torch.utils.losses import get_optimizer

    dk = _ps_dk()
    dk.update({"write_shards": shard_io.write_shards,
               "ShardedDataset": shard_io.ShardedDataset,
               "native_dataio_active": shard_io.native_dataio_active,
               "text": text, "Checkpointer": Checkpointer, "Model": Model,
               "StreamingPredictor": streaming.StreamingPredictor,
               "RecordProducer": streaming.RecordProducer,
               "socket_source": streaming.socket_source,
               "from_keras_config": from_keras_config, "Job": Job,
               "rules": rules, "LMTrainer": LMTrainer,
               "DataParallelTrainer": trainers.DataParallelTrainer,
               "SingleTrainer": SingleTrainer,
               "get_optimizer": get_optimizer})
    return dk


def _narrow_io(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "STREAM_CIFAR_ROWS", 384)
    monkeypatch.setattr(chip_smoke, "STREAM_ROWS_PER_SHARD", 80)
    monkeypatch.setattr(chip_smoke, "STREAM_CIFAR_TRAIN", dict(
        chip_smoke.STREAM_CIFAR_TRAIN, batch_size=32))
    monkeypatch.setattr(chip_smoke, "TRAIN", dict(
        vocab_size=256, d_model=32, num_heads=2, num_layers=2, max_len=32))
    monkeypatch.setattr(chip_smoke, "LM_STREAM", dict(
        chip_smoke.LM_STREAM, seqs=16, batch_size=4))
    monkeypatch.setattr(chip_smoke, "CKPT_LAYERS", 1)
    monkeypatch.setattr(chip_smoke, "STREAM_RECORDS", 100)
    monkeypatch.setattr(chip_smoke, "STREAM_BATCH", 32)
    monkeypatch.setattr(chip_smoke, "KERAS_CNN", dict(
        chip_smoke.KERAS_CNN, widths=(4, 8, 8), dense=16))
    monkeypatch.setattr(chip_smoke, "KERAS_TEXT", dict(
        vocab=256, embed=8, units=16, T=8))
    monkeypatch.setattr(chip_smoke, "KERAS_ROWS", 4)
    monkeypatch.setattr(chip_smoke, "KERAS_TRAIN_ROWS", 128)
    monkeypatch.setattr(chip_smoke, "KERAS_TRAIN", dict(
        chip_smoke.KERAS_TRAIN, batch_size=32))
    monkeypatch.setattr(chip_smoke, "JOB_WIDTHS", (4, 8, 8))


def test_phase11_at_narrow_width(monkeypatch, tmp_path):
    """Phase 11's functions and checks on the CPU at narrow widths and few
    rows: 11a's streamed run equals the in-memory one bit for bit and the
    pipeline's accuracy from shards equals memory's; 11b streams the
    repository's text with the in-memory trajectory; 11c resumes exactly;
    11d streams over a socket; 11e imports the three configs within 1e-4
    of f64; 11f runs as a Job of two gloo processes (forced: no card
    here) whose ranks end bit-identical, and prints its skip on one."""
    import numpy as np
    import torch

    from distkeras_torch.ops import pallas_attention as fa
    from distkeras_torch.ops import pallas_pair as pp

    _narrow_io(monkeypatch)
    dk = _io_dk()
    here = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    dp, cnn, sds, x = chip_smoke.dp_stream_phase(torch, np, dk,
                                                 str(tmp_path))
    assert dp["steps"] == 2 * (384 // 32) and dp["history_equal"]
    assert sds.num_shards == 5 and dp["streamed_epoch"]["idle_share"] is None
    lm, corpus = chip_smoke.lm_stream_phase(torch, np, dk, fa, pp,
                                            str(tmp_path), here)
    assert lm["steps"] == 8 and corpus.num_shards == 4
    assert lm["launches"] == {n: 0 for n in chip_smoke.CAUSAL_NAMES}
    resume = chip_smoke.resume_phase(torch, np, dk, str(tmp_path), corpus)
    assert resume["losses_equal"] and len(resume["epoch2_losses"]) == 4
    stream = chip_smoke.streaming_phase(torch, np, dk, cnn, x)
    assert stream["flushes"] >= 4 and stream["max_abs_gap_vs_model_"
                                             "predictor"] <= 1e-2
    keras = chip_smoke.keras_phase(torch, np, dk)
    assert keras["functional_add_skip"]["module"] == "KerasImportedGraph"
    assert keras["single_trainer"]["steps"] == 4
    assert chip_smoke.job_phase(torch, np, dk, sds.directory, here,
                                cards=1) == {"phase": "11f",
                                             "skipped": "one card"}
    job = chip_smoke.job_phase(torch, np, dk, sds.directory, here, cards=2)
    assert job["bit_identical"] and job["backend"] == "gloo"
    # 5 shards of 76-77 rows: strides of 3 and 2 shards, capped at 4
    assert job["batches_per_rank"] == 2 * 4


def test_phase11_resume_check_catches_a_lost_first_moment(monkeypatch,
                                                         tmp_path):
    """11c on the CPU with the optimizer's resume fault put back (the bf16
    first moment left as ``torch.optim`` casts it, f32): the resumed run
    leaves the uninterrupted trajectory and the check fails."""
    import numpy as np
    import torch

    from distkeras_torch.utils import losses

    _narrow_io(monkeypatch)
    dk = _io_dk()
    toks = np.random.default_rng(0).integers(0, 256, size=(16, 32))
    sds = dk["ShardedDataset"](dk["write_shards"](
        dk["PartitionedDataset"].from_arrays({"tokens": toks}),
        str(tmp_path / "c"), 4))
    monkeypatch.setattr(losses.Adam, "load_state_dict",
                        torch.optim.Optimizer.load_state_dict)
    with pytest.raises(AssertionError, match="11c"):
        chip_smoke.resume_phase(torch, np, dk, str(tmp_path), sds)
