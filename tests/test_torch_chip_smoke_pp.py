"""Phase 13 of ``chip_smoke.py`` (pipeline, expert and sequence
parallelism over two ranks) rehearsed on the CPU at narrow widths: the
one-process MoE flagship (13b at ep=1), then the two gloo ranks — the
three f32 witnesses (ep=2 and sp=2 also under ``remat='block'``), pp=2
with M=8 microbatches, the MoE step at ep=2 and the ring at sp=2
through the bucketed gradient reduce — with every check of the phase; and a fault test: with the expert banks' gradients
summed over ep as well (different experts added together), 13b's
witness leaves dp=2 x ep=1 and the phase fails naming it. The yardsticks
(phase 6's and 6b's losses) come from the port's own steps here."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401


def _narrow_p13(monkeypatch):
    """Phase 13 at narrow widths: the flagship cut to 2 layers of width
    32 (4 heads of 8), T=32, 8 rows; the witnesses at 2 layers of width
    64, T=16."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "TRAIN", dict(
        vocab_size=128, d_model=32, num_heads=4, num_layers=2, max_len=32))
    monkeypatch.setattr(chip_smoke, "TRAIN_W", chip_smoke.P13_STEPS)
    monkeypatch.setattr(chip_smoke, "P13_WITNESS", dict(
        chip_smoke.P13_WITNESS, T=16))
    monkeypatch.setattr(chip_smoke, "EXACT", dict(
        vocab_size=64, d_model=64, num_heads=4, num_layers=2, max_len=32,
        pos_emb="rope", num_kv_heads=2))


def _yardsticks():
    """Phases 6 and 6b's first losses at the narrow width: the port's
    step (and its ring at sp=1) on phase 6's batches from seed 0."""
    import numpy as np
    import torch

    from distkeras_torch.models import get_model
    from distkeras_torch.parallel.mesh import make_mesh
    from distkeras_torch.parallel.spmd import make_lm_train_step
    from distkeras_torch.utils.losses import get_optimizer

    tokens = chip_smoke.train_tokens(torch, np)
    out = {}
    for key, attention, mesh in (("losses6", "standard", None),
                                 ("losses6b", "ring",
                                  make_mesh({"dp": 1, "sp": 1}))):
        model = get_model("transformer_lm", dtype=torch.bfloat16,
                          device="cpu", seed=0, attention=attention,
                          **chip_smoke.TRAIN)
        step = make_lm_train_step(model, get_optimizer(
            "adamw", chip_smoke.TRAIN_LR, mu_dtype=torch.bfloat16),
            mesh=mesh)
        out[key] = [step(t).item() for t in tokens]
    return out


def test_phase13_at_narrow_width(monkeypatch):
    import numpy as np
    import torch

    from distkeras_torch.models import get_model
    from distkeras_torch.ops import pallas_attention as fa
    from distkeras_torch.ops import pallas_pair as pp
    from distkeras_torch.parallel.spmd import make_moe_lm_train_step
    from distkeras_torch.utils.losses import get_optimizer

    _narrow_p13(monkeypatch)
    dk = {"get_model": get_model, "get_optimizer": get_optimizer,
          "make_moe_lm_train_step": make_moe_lm_train_step}
    moe = chip_smoke.moe_phase(torch, np, dk, fa, pp)
    assert len(moe["losses"]) == chip_smoke.P13_STEPS
    assert len(moe["dropped_share_per_layer"]) == 2
    assert all(0.0 <= d < 1.0 for d in moe["dropped_share_per_layer"])
    assert np.isfinite(moe["aux_loss"])

    here = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    res = chip_smoke.p13_phase(torch, np, here, _yardsticks())
    a, b, c = res["13a"], res["13b_ep2"], res["13c"]
    assert a["backend"] == "gloo" and a["processes"] == 2
    assert a["witness"]["param_gap"] <= chip_smoke.P13_WITNESS["pp_tol"]
    assert a["max_loss_gap_vs_phase6"] <= chip_smoke.TRAIN_LOSS_TOL
    assert a["bubble"] == 1 / 9 and a["kernel_shape"] == [1, 32, 4, 8]
    # each stage keeps its own block of the two while it trains
    assert a["blocks_held_per_rank"] == [[0], [1]]
    assert b["witness"]["param_gap"] <= chip_smoke.P13_WITNESS["ep_tol"]
    # remat='block' at ep=2 and sp=2: the recompute finds the mesh
    assert b["witness"]["remat_param_gap"] <= chip_smoke.P13_WITNESS[
        "ep_tol"]
    assert c["witness"]["remat_param_gap"] <= chip_smoke.P13_WITNESS[
        "sp_tol"]
    assert b["replicated_bit_identical"] and len(b["losses"]) == 2
    assert c["witness"]["param_gap"] <= chip_smoke.P13_WITNESS["sp_tol"]
    assert c["max_loss_gap_vs_phase6b"] <= chip_smoke.TRAIN_LOSS_TOL
    # the narrow model's gradients fit one bucket: one all-reduce a step,
    # where the per-parameter reduce made one a parameter
    assert c["allreduces_per_step"] == 1
    assert c["per_leaf_allreduces_per_step"] == 29
    assert c["pair_per_layer"]["pair_rect_fwd"] == 6


_FAULT_LAUNCHER = '''
import runpy
import sys

import torch
import torch.distributed as dist

import distkeras_torch.parallel.spmd as spmd

real = spmd.make_moe_lm_train_step


def faulty(model, optimizer, mesh=None, ep_axis="ep", **kw):
    """The MoE step with the expert banks' gradients all-reduced over ep
    as well: each rank's experts take the other rank's experts'
    gradients."""
    if not isinstance(optimizer, torch.optim.Optimizer):
        optimizer = optimizer(model.parameters())
    group = mesh.group(ep_axis) if mesh is not None else None
    if group is not None:
        inner = optimizer.step

        def step(*a, **k):
            for n, p in model.named_parameters():
                if spmd.ep_dim(n) is not None:
                    dist.all_reduce(p.grad, group=group)
            return inner(*a, **k)

        optimizer.step = step
    return real(model, optimizer, mesh=mesh, ep_axis=ep_axis, **kw)


spmd.make_moe_lm_train_step = faulty
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
'''


def test_phase13_catches_expert_grads_summed_over_ep(monkeypatch, tmp_path):
    import numpy as np
    import torch

    _narrow_p13(monkeypatch)
    here = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    launcher = tmp_path / "faulty_launch.py"
    launcher.write_text(_FAULT_LAUNCHER)
    with pytest.raises(AssertionError, match="13b: the f32 witness"):
        chip_smoke.p13_phase(torch, np, here, {"losses6": [0.0] * 3,
                                               "losses6b": [0.0] * 3},
                             python=[sys.executable, str(launcher)])
