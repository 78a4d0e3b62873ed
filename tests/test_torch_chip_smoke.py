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
    card, and each call counts a launch and its route (the split plan a
    132-SM card would take) and notes a first launch of its shape and of
    the wrapper's own configuration key (as the wrappers do where they
    launch) and runs the plain version in f32, as the kernels
    accumulate."""
    import torch

    from distkeras_torch.kernels import build
    from distkeras_torch.ops import paged_attention as pa
    from distkeras_torch.ops import splash_prefill as sp

    def counting(plain, kind):
        def f(q, *args):
            f.launches += 1
            bf16 = q.dtype == torch.bfloat16
            B, T, H, hd = q.shape
            if kind == "paged":  # (k_pages, v_pages, tables, ...)
                Hk, nkeys = args[0].shape[2], args[2].shape[1] * 16
            else:  # (keys, vals, starts)
                Hk, nkeys = args[0].shape[2], args[0].shape[1]
            bm, splits, _ = sp.split_plan(B, Hk, T * (H // Hk), nkeys, 132)
            route = sp.launch_route(kind, bf16, bm, splits)
            f.routes[route] = f.routes.get(route, 0) + 1
            build.note_launch(f"standin_{kind}", (str(q.dtype),
                                                  tuple(q.shape[1:])))
            build.note_launch(f"standin_{kind}_plan",
                              (bf16, len(args) > 4 and args[4] is not None,
                               hd, bm, splits > 1))
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


def test_phase2_times_one_tp_ranks_heads(monkeypatch):
    """Phase 2's paged and splash cases at one tp=2 rank's heads (half
    the query heads over half the KV heads), every timed shape held and
    timed beside its bound in each pool and dtype, the splash values at
    std 0.5."""
    import torch
    import torch.nn.functional as F

    pa, sp = _standin_kernels(monkeypatch)
    monkeypatch.setattr(chip_smoke, "PAGED", dict(
        S=3, H=4, Hk=2, hd=64, bs=16, MB=8, T=(1, 16)))
    monkeypatch.setattr(chip_smoke, "SPLASH", dict(S=3, T=16, H=4, Hk=2,
                                                   hd=64, L=128))
    over = dict(H=2, Hk=1)
    paged = chip_smoke.paged_cases(torch, F, pa, over)
    splash = chip_smoke.splash_cases(torch, F, sp, over, (), v_std=0.5)
    assert {(c["T"], c["H"], c["Hk"]) for c in paged if "ms" in c} == {
        (1, 2, 1), (16, 2, 1)}
    # every pool and dtype is timed, the f32 ones (the FFMA kernels) too
    assert {c["pool"] for c in paged if "ms" in c} == {
        "bf16", "int8", "f32", "int8-f32"}
    assert [(c["T"], c["H"], c["Hk"], c["dtype"]) for c in splash
            if "ms" in c] == [(16, 2, 1, "bf16"), (16, 2, 1, "f32")]
    for c in paged + splash:
        assert c["max_abs_err"] <= c["tol"]
        if "ms" in c:
            assert c["bound_ms"] > 0


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
    assert res["beam_search"]["method_equal"]
    assert res["beam_search"]["method_splash_launches"] > 0


@pytest.mark.parametrize("fault", ["shifted_token", "plain_prefill"])
def test_phase4_beam_method_fails_on_an_injected_fault(monkeypatch, fault):
    """Phase 4 catches a ``Model.beam_search`` whose beams differ from
    the function's (one token off) and one whose prefill bypasses the
    splash kernel."""
    import numpy as np
    import torch

    from distkeras_torch.models.wrapper import Model

    pa, sp = _standin_kernels(monkeypatch)
    _narrow_exact(monkeypatch)
    dk = _serving_dk()
    model = dk["get_model"]("transformer_lm", dtype=torch.float32,
                            device="cpu", seed=3, **chip_smoke.EXACT)
    real = Model.beam_search

    def faulty(self, prompt, n, **kw):
        if fault == "shifted_token":
            out = real(self, prompt, n, **kw)
            out[0, -1] = (out[0, -1] + 1) % self.module.vocab_size
            return out
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sp, "preferred", lambda *a, **k: False)
            return real(self, prompt, n, **kw)

    monkeypatch.setattr(Model, "beam_search", faulty)
    match = "!= beam_search's" if fault == "shifted_token" else "never"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.exact_beam(torch, np, dk, sp, model)


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


def test_phase14_server_at_narrow_width(monkeypatch):
    """Phase 14 on the CPU (phase 10's narrow bf16 flagship and cut mix,
    phase 4's narrow f32 model, the kernels stood in): 14a serves the mix
    over loopback on both layouts with the launch, route, op and thread
    checks; 14b holds greedy streams over TCP to generate() through a
    mid-stream push and a KV migration, and renders the watchdog's
    postmortem; every stop() joins its threads."""
    import numpy as np
    import torch

    from distkeras_torch.serving import LMServer, ServingClient
    from distkeras_torch.telemetry import report

    pa, sp = _standin_kernels(monkeypatch)
    _narrow_exact(monkeypatch)
    monkeypatch.setattr(chip_smoke, "FLAGSHIP", dict(
        vocab_size=128, d_model=128, num_heads=2, num_kv_heads=1,
        num_layers=2, max_len=256, pos_emb="rope", cache_dtype="int8"))
    monkeypatch.setattr(chip_smoke, "SYSTEM_PREFIX", 32)
    monkeypatch.setattr(chip_smoke, "PROMPT_LENS", (40, 100, 20, 70, 9))
    dk = _serving_dk()
    dk.update(LMServer=LMServer, ServingClient=ServingClient, report=report)
    mix = dk["serving_requests"]
    dk["serving_requests"] = lambda *a: [
        (p, dict(c, max_new_tokens=8)) for p, c in mix(*a)]
    phase3, _, _, direct = chip_smoke.serving_phase(torch, np, dk, pa, sp)
    out, launches = chip_smoke.server_phase(torch, np, dk, pa, sp, phase3,
                                            direct)
    a = out["14a"]
    assert launches["paged_attention"] >= a["paged"]["ticks"] * 2 > 0
    assert launches["splash_prefill"] >= a["slot"]["chunk_ticks"] * 2 > 0
    for lay in ("paged", "slot"):
        r = a[lay]
        assert r["tokens"] == 5 * 8 and r["tok_per_s"] > 0
        assert r["client_ttft_ms"]["p99"] >= r["client_ttft_ms"]["p50"] > 0
        assert r["client_itl_ms"]["p50"] is not None
        assert all(r["ops"].values()) and r["stalls"] == 0
        assert 0.0 <= r["greedy_match_vs_direct"] <= 1.0
        assert r["direct_tok_per_s"] == phase3[lay]["tok_per_s"]
        assert r["recompiles_since_mark"] == {}
        assert phase3[lay]["recompiles_since_mark"] == {}
    assert phase3["recompiles"]["kernel.standin_paged"] >= 1
    assert out["lock_order"]["cycles"] == 0
    assert out["lock_order"]["edges"] >= 1
    b = out["14b"]
    for lay in ("paged", "slot"):
        assert b[lay]["greedy_equal"] and b[lay]["after_push_greedy_equal"]
        assert b[lay]["push"]["version"] == 2 and b[lay]["kernel_launches"]
        assert 1 <= b[lay]["streams_across_push"] <= 6
    assert b["migrate"]["stream_equal"] and b["migrate"]["imported"] > 0
    assert b["watchdog"]["stalls"] == 1 and b["watchdog"]["rendered_lines"]
    assert out["thread_errors"] == 0


@pytest.mark.parametrize("fault", ["thread_raised", "stale_prefix"])
def test_phase14_fails_on_an_injected_fault(monkeypatch, tmp_path, fault):
    """Phase 14 fails when a server thread raised (collected through
    threading.excepthook) although its streams ended, and when a weight
    push keeps the prefix cache computed under the old weights (the
    reference's behaviour, which the port retires)."""
    import threading

    import numpy as np
    import torch

    from distkeras_torch.serving import LMServer, ServingClient, ServingEngine
    from distkeras_torch.telemetry import report

    pa, sp = _standin_kernels(monkeypatch)
    dk = _serving_dk()
    dk.update(LMServer=LMServer, ServingClient=ServingClient, report=report)
    if fault == "thread_raised":
        def flagship(*a):
            t = threading.Thread(target=lambda: 1 / 0, name="handler")
            t.start()
            t.join(10)
            return {}, {}

        monkeypatch.setattr(chip_smoke, "server_flagship", flagship)
        monkeypatch.setattr(chip_smoke, "server_exact", lambda *a: {})
        with pytest.raises(AssertionError, match="threads raised"):
            chip_smoke.server_phase(torch, np, dk, pa, sp, {}, {})
        return
    _narrow_exact(monkeypatch)
    monkeypatch.setattr(ServingEngine, "_retire_prefix_cache",
                        lambda self: None)
    with pytest.raises(AssertionError, match="after a wire push"):
        chip_smoke.server_exact(torch, np, dk, pa, sp, str(tmp_path))


def _fleet_dk():
    from distkeras_torch.serving import (Autoscaler, LMServer, Router,
                                         ServingClient)

    dk = _serving_dk()
    dk.update(LMServer=LMServer, ServingClient=ServingClient, Router=Router,
              Autoscaler=Autoscaler)
    return dk


def _narrow_fleet(monkeypatch):
    """Phase 15 at narrow widths: phase 10's narrow bf16 flagship and cut
    mix (prompts over 32 tokens share the prefix; those of 64 or more go
    through the prefill replica), phase 4's narrow f32 model."""
    _narrow_exact(monkeypatch)
    monkeypatch.setattr(chip_smoke, "FLAGSHIP", dict(
        vocab_size=128, d_model=128, num_heads=2, num_kv_heads=1,
        num_layers=2, max_len=256, pos_emb="rope", cache_dtype="int8"))
    monkeypatch.setattr(chip_smoke, "SYSTEM_PREFIX", 32)
    monkeypatch.setattr(chip_smoke, "PROMPT_LENS", (40, 100, 20, 70, 9))
    monkeypatch.setattr(chip_smoke, "FLEET_DISAGG_TOKENS", 64)
    dk = _fleet_dk()
    mix = dk["serving_requests"]
    dk["serving_requests"] = lambda *a: [
        (p, dict(c, max_new_tokens=8)) for p, c in mix(*a)]
    return dk


def test_phase15_fleet_at_narrow_width(monkeypatch):
    """Phase 15 on the CPU (the kernels stood in): 15a routes the cut mix
    through three replicas (every request accounted for by the router,
    the prefix group on one replica, the paged kernel in every layer of
    every tick) and through a prefill + two decode replicas (each long
    prompt migrated); 15b holds every stream to generate() or a solo
    engine through a failover, a rolling update, a migration and an
    autoscaler whose replay is exact; no thread raised."""
    import numpy as np
    import torch

    pa, sp = _standin_kernels(monkeypatch)
    dk = _narrow_fleet(monkeypatch)
    phase3, _, _, direct = chip_smoke.serving_phase(torch, np, dk, pa, sp)
    out, launches = chip_smoke.fleet_phase(torch, np, dk, pa, sp, phase3,
                                           direct)
    a = out["15a"]
    for name in ("uniform", "disagg"):
        r = a[name]
        assert r["tokens"] == 5 * 8 and r["tok_per_s"] > 0
        assert sum(r["routed"].values()) == 5
        assert launches[name] == r["launches"] >= sum(r["ticks"]) * 2 > 0
        assert r["client_ttft_ms"]["p99"] >= r["client_ttft_ms"]["p50"] > 0
        assert 0.0 <= r["greedy_match_vs_direct"] <= 1.0
    assert a["uniform"]["kv_migrations"] == 0
    assert a["disagg"]["kv_migrations"] == 2  # the 100- and 70-token prompts
    assert a["disagg"]["served"][0] == 2
    assert a["direct_tok_per_s"] == phase3["paged"]["tok_per_s"]
    b = out["15b"]
    assert b["failover"]["streams_equal"]
    assert b["failover"]["failed_over"]["replayed"] >= 1
    assert b["failover"]["failed"] == 0
    assert b["rolling_update"]["version"] == 2
    assert b["rolling_update"]["min_routable"] >= 2
    assert b["disagg"]["migrations"]["ok"] >= 1
    assert b["autoscaler"]["actions"] == ["scale_up", "scale_down"]
    assert b["autoscaler"]["replay_exact"] and b["kernel_launches"] > 0
    assert out["thread_errors"] == 0
    assert out["lock_order"]["cycles"] == 0
    assert out["lock_order"]["edges"] >= 1


@pytest.mark.parametrize("fault", ["replay_resends_tokens", "shared_model"])
def test_phase15_fails_on_an_injected_fault(monkeypatch, fault):
    """Phase 15b fails when the router's failover replay forwards the
    tokens the client already has, and when the replicas share one model
    (a rolling update would land on every replica at its first push)."""
    import numpy as np
    import torch

    from distkeras_torch.serving import router as router_mod

    pa, sp = _standin_kernels(monkeypatch)
    dk = _narrow_fleet(monkeypatch)
    if fault == "replay_resends_tokens":
        submit = router_mod.Router._submit_routed

        def resend(self, entry, exclude):
            submit(self, entry, exclude)
            entry.skip = 0

        monkeypatch.setattr(router_mod.Router, "_submit_routed", resend)
        match = "failover"
    else:
        made, real = {}, dk["get_model"]

        def shared(name, **kw):
            key = (name, kw.get("seed"), kw.get("dtype"))
            if key not in made:
                made[key] = real(name, **kw)
            return made[key]

        dk["get_model"] = shared
        match = "share their model"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.fleet_exact(torch, np, dk, pa, sp)


def test_phase3_fails_when_the_mix_recompiles(monkeypatch):
    """Phase 3's steady-state check: a kernel that counted a first
    launch on every call (a configuration the warm-up did not cover)
    fails the phase after its warm-up."""
    import numpy as np
    import torch

    from distkeras_torch.kernels import build
    from distkeras_torch.telemetry.runtime import recompiles

    pa, sp = _standin_kernels(monkeypatch)
    monkeypatch.setattr(chip_smoke, "FLAGSHIP", dict(
        vocab_size=128, d_model=128, num_heads=2, num_kv_heads=1,
        num_layers=2, max_len=256, pos_emb="rope", cache_dtype="int8"))
    monkeypatch.setattr(chip_smoke, "SYSTEM_PREFIX", 32)
    monkeypatch.setattr(chip_smoke, "PROMPT_LENS", (40, 100, 20))
    monkeypatch.setattr(build, "note_launch",
                        lambda op, cfg: recompiles.note(f"kernel.{op}"))
    dk = _serving_dk()
    mix = dk["serving_requests"]
    dk["serving_requests"] = lambda *a: [
        (p, dict(c, max_new_tokens=4)) for p, c in mix(*a)]
    with pytest.raises(AssertionError, match="serving phase .paged.: the "
                       "mix after the warm-up"):
        chip_smoke.serving_phase(torch, np, dk, pa, sp)


def test_lock_order_result_fails_on_a_cycle():
    """Phases 14 and 15 fail on a lock-order cycle: two locks taken in
    both orders (allocated here, so the detector is pointed at this
    file's directory too)."""
    import threading

    det = chip_smoke.lock_order()
    det._markers += (os.sep + "tests" + os.sep,)
    with det:
        a, b = threading.Lock(), threading.Lock()
        with a, b:
            pass
        with b, a:
            pass
    with pytest.raises(AssertionError, match="server phase: lock-order"):
        chip_smoke.lock_order_result("server phase", det)
    clean = chip_smoke.lock_order()
    assert chip_smoke.lock_order_result("fleet phase", clean) == {
        "edges": 0, "cycles": 0}


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


# -- phase 12 (tensor parallelism) on the CPU -----------------------------------


_NARROW_TP_EXACT = dict(vocab_size=64, d_model=64, num_heads=4,
                        num_kv_heads=2, num_layers=2, max_len=256,
                        pos_emb="rope", cache_dtype="int8")


def _narrow_tp(monkeypatch):
    """Phase 12 at narrow widths on two gloo CPU ranks: the flagship and
    the training model cut to 2 layers of width 64 / 32 (4 heads over 2
    KV heads: one a rank), phase 4's requests to 4-20 new tokens, three
    of the witness modes."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "TRAIN", dict(
        vocab_size=128, d_model=32, num_heads=4, num_layers=2, max_len=32))
    monkeypatch.setattr(chip_smoke, "TP_TRAIN_B", {"cards": 4,
                                                   "one_card": 2})
    monkeypatch.setattr(chip_smoke, "TP_WITNESS", dict(
        chip_smoke.TP_WITNESS, T=16))
    monkeypatch.setattr(chip_smoke, "EXACT", _NARROW_TP_EXACT)
    monkeypatch.setattr(chip_smoke, "EXACT_TIER", dict(
        prefixes=3, prefix_len=32, tail=4, reps=2, max_new=4))
    monkeypatch.setattr(chip_smoke, "TP_MODES", ("chunked", "multi_step",
                                                 "ngram"))
    full = chip_smoke.exact_requests
    monkeypatch.setattr(chip_smoke, "exact_requests", lambda np, V: [
        (p[:40], dict(c, max_new_tokens=c["max_new_tokens"] - 20))
        for p, c in full(np, V)])
    monkeypatch.setattr(chip_smoke, "FLAGSHIP", dict(_NARROW_TP_EXACT,
                                                     d_model=32))
    monkeypatch.setattr(chip_smoke, "SYSTEM_PREFIX", 16)
    monkeypatch.setattr(chip_smoke, "PROMPT_LENS", (20, 40, 12, 30))


def _phase3_narrow():
    """Phase 3's results at the narrow flagship on the CPU (its tp=1
    streams; no kernel launches on CPU tensors)."""
    import numpy as np
    import torch

    dk = _serving_dk()
    model = dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                            device="cpu", seed=0, **chip_smoke.FLAGSHIP)
    requests = dk["serving_requests"](model.vocab_size,
                                      chip_smoke.SYSTEM_PREFIX,
                                      chip_smoke.PROMPT_LENS)
    streams = {}
    for paged in (True, False):
        _, s, _ = chip_smoke.serve(torch, np, dk, model, requests,
                                   paged=paged, block_size=16)
        streams["paged" if paged else "slot"] = s
    zero = {"paged_attention": 0, "splash_prefill": 0}
    return {"streams": streams, "launches": {"paged": zero, "slot": zero}}


def test_phase12_at_narrow_width(monkeypatch):
    """Phase 12 end to end on two gloo CPU ranks at narrow widths: the f32
    witness of 12a, three tp=2 steps within 5e-2 of tp=1 with the
    replicated weights bit-identical across the ranks, the f32 serving
    witness (modes on both layouts, the host tier, migration both ways)
    equal to tp=1, and the flagship's streams bit-identical across the
    ranks with phase 3's launch counts."""
    import numpy as np
    import torch

    _narrow_tp(monkeypatch)
    here = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    res = chip_smoke.tp_phase(torch, np, here, _phase3_narrow())
    a, b = res["12a"], res["12b"]
    assert a["backend"] == "gloo" and a["processes"] == 2
    assert a["witness"]["param_gap"] <= 1e-5
    assert a["max_loss_gap_vs_tp1"] <= chip_smoke.TRAIN_LOSS_TOL
    assert a["kernel_shape"] == [4, 32, 2, 8]
    assert set(b["witness_modes"]) == {f"{layout}_{m}"
                                       for layout in ("paged", "slot")
                                       for m in chip_smoke.TP_MODES}
    assert b["witness_tier"]["restores"] > 0
    assert {m["mode"] for m in b["witness_migrate"].values()} == {
        "device", "host"}
    for layout in ("paged", "slot"):
        assert b[layout]["tp"] == 2 and b[layout]["cache_kv_heads"] == 1
        assert b[layout]["streams_bit_identical_across_ranks"]
        assert 0.0 <= b[layout]["greedy_match_vs_tp1"] <= 1.0


_FAULT_LAUNCHER = '''
import runpy
import sys

import torch
import torch.distributed as dist

import distkeras_torch.parallel.spmd as spmd

real = spmd.make_lm_train_step


def faulty(model, optimizer, mesh=None, tp_axis=None, **kw):
    """The step with replicated gradients all-reduced over tp as well:
    summed tp times."""
    if tp_axis is not None:
        if not isinstance(optimizer, torch.optim.Optimizer):
            optimizer = optimizer(model.parameters())
        inner, group = optimizer.step, mesh.group(tp_axis)

        def step(*a, **k):
            for n, p in model.named_parameters():
                if spmd.tp_dim(n) is None and p.grad is not None:
                    dist.all_reduce(p.grad, group=group)
            return inner(*a, **k)

        optimizer.step = step
    return real(model, optimizer, mesh=mesh, tp_axis=tp_axis, **kw)


spmd.make_lm_train_step = faulty
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
'''


def test_phase12_catches_replicated_grads_summed_over_tp(monkeypatch,
                                                         tmp_path):
    """With the replicated parameters' gradients all-reduced over tp as
    well (so summed tp times), 12a's f32 witness leaves the tp=1 step and
    the phase fails, naming 12a."""
    import numpy as np
    import torch

    _narrow_tp(monkeypatch)
    here = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    launcher = tmp_path / "faulty_launch.py"
    launcher.write_text(_FAULT_LAUNCHER)
    with pytest.raises(AssertionError, match="12a: the f32 witness"):
        chip_smoke.tp_phase(torch, np, here, _phase3_narrow(),
                            python=[sys.executable, str(launcher)])


# -- phase 16 (a tensor-parallel engine behind LMServer) on the CPU -------------


def _p16_dk():
    from distkeras_torch.serving import (DrainingError, LMServer, Router,
                                         ServingClient, serialize_weights)

    dk = _serving_dk()
    dk.update(LMServer=LMServer, ServingClient=ServingClient, Router=Router,
              DrainingError=DrainingError, serialize_weights=serialize_weights)
    return dk


def _narrow_p16(monkeypatch):
    """Phase 16 at phase 12's narrow widths, phase 4's requests cut to
    40-token prompts (at least the first migrates through 16b's
    router)."""
    _narrow_tp(monkeypatch)
    monkeypatch.setattr(chip_smoke, "TP_SERVER_DISAGG_TOKENS", 40)
    p3 = _phase3_narrow()
    return _p16_dk(), {"phase3_streams": p3["streams"], "phase3": None,
                       "12b": None, "14a": None}


def test_phase16_at_narrow_width(monkeypatch):
    """Phase 16 end to end on two gloo CPU ranks at narrow widths: 16a
    serves the cut mix through the tp=2 server from four clients on both
    layouts (the follower's streams and ticks equal the leader's, every
    op answers, a push of the same weights lands on both ranks); 16b
    holds phase 4's requests, greedy and sampled, to tp=1 servers on
    both layouts, and on the paged one through a push, a reconfigure and
    a drain, and migrations both ways (the router's tp=2 -> tp=1, an
    export tp=1 -> tp=2)."""
    import numpy as np
    import torch

    dk, yard = _narrow_p16(monkeypatch)
    here = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    res = chip_smoke.tp_server_phase(torch, np, dk, here, yard)
    assert res["backend"] == "gloo" and res["processes"] == 2
    a, b = res["16a"], res["16b"]
    for lay in ("paged", "slot"):
        r = a[lay]
        assert r["streams_bit_identical_across_ranks"]
        assert r["tokens"] > 0 and r["tok_per_s"] > 0
        assert r["client_ttft_ms"]["p99"] >= r["client_ttft_ms"]["p50"] > 0
        assert r["control_records"] > 0 and r["control_record_ms"] >= 0
        assert all(v for k, v in r["ops"].items() if k != "alerts")
        # no kernel on CPU tensors: every rank's count stays 0
        assert r["launches_per_rank"] == [
            {"paged_attention": 0, "splash_prefill": 0}] * 2
        assert r["yardstick_tok_per_s"] == {"phase3": None, "12b": None,
                                            "14a": None}
        assert b[lay]["streams_equal"] and b[lay]["follower_streams_kept"]
    assert b["paged"]["drain_refused"]
    assert b["paged"]["push"]["version"] == 2
    assert b["paged"]["role"] == "prefill"
    marks = res["rank_timeline_s"]
    assert marks["imports"] <= marks["world"] <= marks["done"]
    push = a["paged"]["push"]
    assert push["ack"]["version"] == 2 and push["bytes"] > 0
    assert push["rank0"]["bytes"] == push["rank1"]["bytes"] == push["bytes"]
    m = b["paged"]["migrate"]
    assert m["tp2_to_tp1"]["ok"] >= 1 and m["tp1_to_tp2"]["hit"] > 0
    assert m["routed"] == 2


_P16_FAULT_LAUNCHER = '''
import runpy
import sys

from distkeras_torch.serving import scheduler

real = scheduler.FIFOScheduler.submit
seen = [0]


def dropping(self, req):
    """Rank 1 skips the fifth request its step records admit."""
    seen[0] += 1
    if sys.argv[-1] == "1" and seen[0] == 5:
        return req
    return real(self, req)


scheduler.FIFOScheduler.submit = dropping
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
'''


def test_phase16_fails_on_an_injected_fault(monkeypatch, tmp_path):
    """A follower that skips one staged admission falls out of lock step:
    phase 16 fails with the follower's own check, which names it."""
    import numpy as np
    import torch

    dk, yard = _narrow_p16(monkeypatch)
    here = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    launcher = tmp_path / "faulty_launch.py"
    launcher.write_text(_P16_FAULT_LAUNCHER)
    with pytest.raises(AssertionError,
                       match=r"(?s)16: rank .*tp rank 1 fell out of lock "
                             r"step"):
        chip_smoke.tp_server_phase(torch, np, dk, here, yard,
                                   python=[sys.executable, str(launcher)])


# -- phase 17: serve_bench's engine modes ---------------------------------------

# every mode at a narrow width that keeps the kernels' gates open: 64-wide
# heads, 16-token pages, slot caches of whole 16-key tiles
_NARROW_P17 = {
    "bench": dict(V=64, D=64, H=1, L=1, slots=2, n_requests=4),
    "bench_shared_prefix": dict(V=64, D=64, H=1, L=1, slots=2,
                                n_requests=6, prefix_len=32, tail_len=4,
                                max_new=4, block_size=16),
    "bench_host_tier": dict(V=64, D=64, H=1, L=1, slots=2, n_groups=6,
                            reps=3, prefix_len=32, tail_len=4, max_new=12,
                            block_size=16),
    "bench_long_prompt_interference": dict(
        V=64, D=64, H=1, L=1, slots=3, n_short=6, short_prompt=8,
        short_new=8, n_long=2, long_prompt=120, long_new=2, long_every=2,
        prefill_chunk=16),
    "bench_speculative": dict(V=64, D=64, H=1, L=1, slots=2, n_requests=3,
                              max_new=16, train_steps=80),
    "bench_pipeline": dict(V=64, D=64, H=1, L=1, slots=2, n_requests=4,
                           prompt_len=8, max_new=8, prefill_chunk=8),
    "bench_multistep": dict(V=64, D=64, H=1, L=1, slots=2, n_requests=4,
                            prompt_len=8, max_new=8, prefill_chunk=8,
                            k_list=(1, 2)),
}


def test_phase17_at_narrow_width(monkeypatch, capsys):
    """Phase 17 on the CPU, every mode narrowed (hd 64, 16-token pages)
    with the kernels stood in as f32 kernels: each mode launches the
    kernel its layout uses, every route is the f32 kernel's, every exact
    check holds, and each mode prints its line."""
    import json

    import torch

    from distkeras_torch import serve_bench

    pa, sp = _standin_kernels(monkeypatch)
    monkeypatch.setattr(chip_smoke, "SERVE_BENCH_MODES", _NARROW_P17)
    out = chip_smoke.serve_bench_phase(torch, pa, sp, serve_bench)
    lines = [json.loads(ln)["serve_bench_mode"]
             for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"serve_bench_mode"')]
    assert [ln["mode"] for ln in lines] == list(_NARROW_P17)
    for name in _NARROW_P17:
        r = out[name]
        assert r["ok"] and all(r["exact"].values()), (name, r)
        for kern in chip_smoke.SERVE_BENCH_KERNELS[name]:
            assert r["launches"][kern] > 0, (name, kern)
        assert all(chip_smoke.F32_ROUTE.fullmatch(route)
                   for seen in r["routes"].values() for route in seen)
        assert r["seconds"] > 0 and "timing" in r
    assert out["launches"]["paged_attention"] == sum(
        out[m]["launches"]["paged_attention"] for m in _NARROW_P17)
    assert out["bench_speculative"]["headline"]["acceptance_rate"] > 0.5


def test_phase17_fails_on_an_injected_fault(monkeypatch):
    """A paged stand-in that runs the plain version but never counts its
    launch fails phase 17, naming the mode whose layout needed it."""
    import torch

    from distkeras_torch import serve_bench

    pa, sp = _standin_kernels(monkeypatch)
    monkeypatch.setattr(pa, "paged_attention",
                        lambda q, *a: pa.paged_attention_reference(q, *a))
    pa.paged_attention.launches, pa.paged_attention.routes = 0, {}
    monkeypatch.setattr(chip_smoke, "SERVE_BENCH_MODES", {
        "bench_shared_prefix": _NARROW_P17["bench_shared_prefix"]})
    with pytest.raises(AssertionError,
                       match="bench_shared_prefix.*paged_attention never "
                             "launched"):
        chip_smoke.serve_bench_phase(torch, pa, sp, serve_bench)


# -- phase 18: the examples ---------------------------------------------------


def _standin_training_kernels(monkeypatch):
    """The causal training kernels stood in on the CPU: the model's gate
    passes for any device at any T (the dense cut-off lowered), and each
    kernel runs its plain version and counts a launch, the autograd
    backward going through the dq and dk/dv wrappers as on a card."""
    import torch

    from distkeras_torch.models.transformer import TransformerLM
    from distkeras_torch.ops import pallas_attention as fa

    def counting(name, plain):
        def f(*args):
            getattr(fa, name).launches += 1
            return plain(*args[:6])
        return f

    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq = fa.causal_attention_dq(q, k, v, out, lse, do, ctx.block)
        dk, dv = fa.causal_attention_dkv(q, k, v, out, lse, do, ctx.block)
        return dq, dk, dv, None

    monkeypatch.setattr(TransformerLM, "_DENSE_MAX_T", 0)
    monkeypatch.setattr(fa, "preferred", lambda T, hd, dtype=None,
                        device=None, block=None: fa.supports(T, hd, dtype))
    monkeypatch.setattr(fa, "_on_card", lambda *a: True)
    monkeypatch.setattr(fa, "_fwd_kernel", counting(
        "causal_attention_fwd", lambda q, k, v: tuple(
            t.to(q.dtype) if i == 0 else t for i, t in enumerate(
                fa.causal_attention_reference(q, k, v)))))
    monkeypatch.setattr(fa, "_dq_kernel", counting(
        "causal_attention_dq", lambda *a: fa.causal_attention_dq_reference(
            *a).to(a[0].dtype)))
    monkeypatch.setattr(fa, "_dkv_kernel", counting(
        "causal_attention_dkv", lambda *a: tuple(
            t.to(a[1].dtype) for t in fa.causal_attention_dkv_reference(
                *a))))
    monkeypatch.setattr(fa._PallasCausalAttention, "backward",
                        staticmethod(backward))
    return fa


def _narrow_p18(monkeypatch):
    """Phase 18 at narrow widths: 18a and 18b at d128 (2 heads of 64, 1
    KV head), 2 layers, vocab 64, T=64, 4 rows a step; the dist-keras
    examples at ``tests/test_examples.py``'s sizes; the serving modes at
    the reference's own sizes (they are narrow)."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "LM18", [
        "--d-model", "128", "--heads", "2", "--kv-heads", "1", "--layers",
        "2", "--vocab", "64", "--seq-len", "64", "--rope", "--batch-size",
        "4", "--lr", "3e-3"])
    monkeypatch.setattr(chip_smoke, "LM18_SAMPLE", 8)
    monkeypatch.setattr(chip_smoke, "EXAMPLES18", {
        "mnist_workflow": ["--trainers", "single,adag,dataparallel",
                           "--workers", "2", "--epochs", "1", "--n", "1024",
                           "--batch-size", "64", "--model", "mlp"],
        "cifar10_training": ["--epochs", "1", "--n", "256", "--batch-size",
                             "32", "--workers", "2", "--small"],
        "streaming_inference": ["--n", "256", "--batch-size", "64"],
        "bigdata_pipeline": ["--n", "1024", "--rows-per-shard", "256",
                             "--batch-size", "32", "--epochs", "2"]})


def test_phase18_at_narrow_width(monkeypatch, capsys):
    """Phase 18 on the CPU with the causal kernels stood in (their gates
    open at the narrow width): 18a's loss falls and each kernel launches
    once a layer a step; 18b's two gloo ranks end bit-identical; 18c's
    bars hold; every 18d mode's streams equal ``generate()``, each on
    the plain route."""
    import json

    import numpy as np
    import torch

    from distkeras_torch.ops import pallas_pair as pp

    _narrow_p18(monkeypatch)
    pa, sp = _standin_kernels(monkeypatch)
    fa = _standin_training_kernels(monkeypatch)
    here = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    res = chip_smoke.examples_phase(torch, np, fa, pp, pa, sp, here)
    keys = [next(iter(json.loads(ln))) for ln in
            capsys.readouterr().out.splitlines() if ln.startswith('{"ex')]
    assert keys == ["examples_lm", "examples_lm_sp2", "examples_dist_keras",
                    "examples_lm_serving", "examples_phase"]
    a = res["18a"]
    assert a["launches"]["causal_attention_fwd"] == 2 * 8
    assert a["losses"][-1] < a["losses"][0]
    assert a["sample"]["route"] == "plain" or a["sample"]["launches"]
    b = res["18b"]
    assert b["processes"] == 2 and b["backend"] == "gloo"
    assert b["params_bit_identical"] and len(b["losses"]) == 2
    c = res["18c"]
    assert c["bigdata_pipeline"]["accuracy"] == c["bigdata_pipeline"][
        "accuracy_in_memory"]
    assert set(c["mnist_workflow"]["trainers"]) == {"single", "adag",
                                                    "dataparallel"}
    d = res["18d"]
    assert list(d) == list(chip_smoke.SERVING18)
    for name, r in d.items():
        assert r["route"] == "plain" and r["tok_s"] > 0, name


def test_phase18_fails_when_an_engine_drops_a_token(monkeypatch):
    """An engine whose streams each lose a token fails 18d on the
    example's own check of every stream against ``generate()``."""
    import torch

    from distkeras_torch import examples as ex
    from distkeras_torch.examples import lm_serving  # noqa: F401
    from distkeras_torch.serving import scheduler

    _narrow_p18(monkeypatch)
    pa, sp = _standin_kernels(monkeypatch)
    real = scheduler.TokenStream._put

    def dropping(self, tok):
        self.n_put = getattr(self, "n_put", 0) + 1
        if self.n_put != 3:
            real(self, tok)

    monkeypatch.setattr(scheduler.TokenStream, "_put", dropping)
    monkeypatch.setattr(chip_smoke, "SERVING18", {"paged": ["--paged"]})
    with pytest.raises(AssertionError):
        chip_smoke.examples_serving_phase(torch, pa, sp, ex)


# -- phase 8c: the data-parallel step on the CPU ------------------------------


def _dp_step_dk():
    from distkeras_torch.models import get_model
    from distkeras_torch.parallel import default_mesh
    from distkeras_torch.parallel.spmd import make_dp_train_step
    from distkeras_torch.utils.losses import get_loss, get_optimizer
    from distkeras_torch.workers import make_train_step

    return {"get_model": get_model, "default_mesh": default_mesh,
            "make_dp_train_step": make_dp_train_step,
            "make_train_step": make_train_step, "get_loss": get_loss,
            "get_optimizer": get_optimizer}


@pytest.mark.parametrize("fault", [None, "half_batch"])
def test_phase8c_dp_step_at_narrow_batch(monkeypatch, fault):
    """Phase 8c on the CPU at 16 rows: the dp step over default_mesh()
    equals make_train_step bit for bit and reports a time a step of
    each beside the card line it is handed; a dp step that trains on
    half the rows (a wrong split) fails it."""
    import numpy as np
    import torch

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "DP_STEP",
                        dict(chip_smoke.DP_STEP, rows=16))
    dk = _dp_step_dk()
    if fault:
        real = dk["make_dp_train_step"]

        def halved(*a, **kw):
            step = real(*a, **kw)
            return lambda x, y: step(x[:len(x) // 2], y[:len(y) // 2])

        dk["make_dp_train_step"] = halved
        with pytest.raises(AssertionError, match="8c: make_dp_train_step"):
            chip_smoke.dp_step_phase(torch, np, dk, "card line")
        return
    res = chip_smoke.dp_step_phase(torch, np, dk, "card line")
    assert res["equal_bit_for_bit"] and res["mesh"] == {"dp": 1}
    assert len(res["losses"]) == len(res["ms_per_step"]) == 3
    assert len(res["make_train_step_ms_per_step"]) == 3
    assert res["nvidia_smi"] == "card line"
