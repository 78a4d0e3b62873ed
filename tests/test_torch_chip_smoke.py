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
