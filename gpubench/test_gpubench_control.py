"""The control fails the committed limits at the cells' own sizes, on the
card: the reference in fp8 in the program's place. Run on the chip with
``python3 -m pytest -m cuda gpubench/test_gpubench_control.py``."""

import numpy as np
import pytest
import torch

from gpubench import compare, generator
from gpubench.cells import load_cell
from gpubench.kinds import train
from gpubench.reference import lm as ref_lm
from gpubench.reference import precision
from gpubench.runner import Run
from gpubench.weights import lm_specs, make_flat, views

SEED = 2**31 + 77


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lm_flagship.train", "cifar_cnn.train"])
def test_training_control_fails_a_limit(card, name):
    cell = load_cell(name)
    run = Run(cell, SEED, 0.0, False)
    data = tuple(t[:train.check_steps(cell.traffic)]
                 for t in train.batches(cell.config, cell.traffic, SEED,
                                        card))
    rows = slice(0, cell.traffic["batch"])
    ref = train.reference(run, data, card, rows)
    low = train.reference(run, data, card, rows, prec=precision.FP8)
    correct, _ = compare.judge(compare.train_numbers(low, ref), cell.limits)
    assert not correct


@pytest.mark.cuda
@torch.no_grad()
def test_serving_control_fails_the_limit(card):
    cell = load_cell("lm_flagship.serve_long_prompt")
    cfg, mix = cell.config, cell.traffic
    precision.strict()
    specs = lm_specs(cfg)
    w = views(make_flat(specs, SEED, card), specs)
    worst = 0.0
    for i in range(mix["check_requests"]):
        prompt, _ = generator.request(mix, SEED, cfg["vocab_size"], i)
        toks = torch.as_tensor(np.asarray(prompt), device=card).long()[None]
        exact = ref_lm.logits(w, toks, cfg)[0]
        low = ref_lm.logits(w, toks, cfg, precision.FP8)[0]
        worst = max(worst, compare.served_gap(
            exact[:-1], low[:-1].argmax(dim=-1).tolist()))
    assert worst > cell.limits["served_gap"]["limit"]
