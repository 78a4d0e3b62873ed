"""Shared pieces of the benchmark's own tests (``python -m pytest
gpubench``): tiny cells built from the committed mixes, run on the CPU
through the harness with its look for a card skipped."""

from __future__ import annotations

import json

import pytest
import torch

from gpubench.cells import HERE, Cell, load_cell

TINY_LM = dict(model="transformer_lm", reference="lm", vocab_size=64,
               d_model=32, num_heads=4, num_kv_heads=2, num_layers=2,
               mlp_ratio=4, max_len=64, pos_emb="rope", dtype="float32",
               cache_dtype="int8")
TINY_CNN = dict(model="cifar_cnn", reference="cnn", widths=[4, 8],
                dense=256, num_classes=10, input_shape=[8, 8, 3],
                dtype="float32")


def mix(name: str, **over) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        d = json.load(f)
    engine = over.pop("engine", None)
    d.update(over)
    if engine:
        d["engine"] = dict(d["engine"], **engine)
    return d


def tiny_cell(cell: str, config: dict, traffic: dict, like: str = None,
              chips: int = None) -> Cell:
    """The committed cell ``cell`` (its metrics and limits) at tiny
    sizes; or, under the name ``cell``, the committed cell ``like`` on
    another mix and number of cards."""
    real = load_cell(like or cell)
    return Cell(cell, chips or real.chips, real.config_name,
                real.traffic_name, config, traffic, real.limits,
                real.end_to_end, real.per_layer)


def tiny_cells() -> dict:
    return {
        "lm_flagship.train": tiny_cell(
            "lm_flagship.train", TINY_LM,
            mix("lm_train_b8", batch=4, seq=16, window=2)),
        # the data-parallel path (no committed cell yet): lm_flagship.train's
        # metrics and limits on the dp=4 mix
        "lm_flagship.train.dp": tiny_cell(
            "lm_flagship.train.dp", TINY_LM,
            mix("lm_train_dp4", batch=8, seq=16, window=2),
            like="lm_flagship.train", chips=4),
        "cifar_cnn.train": tiny_cell(
            "cifar_cnn.train", TINY_CNN,
            mix("cnn_train_b2048", batch=16, window=2,
                reference_rows_per_block=8)),
        "lm_flagship.serve_long_prompt": tiny_cell(
            "lm_flagship.serve_long_prompt", TINY_LM,
            mix("serve_long_prompt", clients=4, prompt_len=[8, 24],
                new_tokens=[2, 8], block=8, warmup_completed=4,
                check_requests=3, trace_seconds=0.3,
                engine=dict(slots=4, block_size=8, prefill_chunk=8,
                            tick_token_budget=12))),
    }


@pytest.fixture
def card():
    """The card, for the tests marked ``cuda``; skips where there is
    none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)
