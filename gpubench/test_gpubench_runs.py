"""Whole runs of each cell at a tiny size on the CPU, the harness's look
for a card skipped: the last line's keys, and ``correct`` false for
every fault the cell can have, planted under the timed path."""

import json

import pytest

from gpubench import guard
from gpubench.conftest import tiny_cells
from gpubench.run import execute
from gpubench.runner import Run

CELLS = tiny_cells()
FAULTS = {
    "lm_flagship.train": ["unchanged", "half_batch", "stale_feed"],
    "cifar_cnn.train": ["unchanged", "half_batch", "stale_feed"],
    "lm_flagship.train.dp": ["unchanged", "half_batch", "no_allreduce"],
    "lm_flagship.serve_long_prompt": ["alter_token"],
}


def _run(name, fault=None, trace=False, seed=2**31 + 11):
    # the serving window must hold finished requests even on a busy host
    seconds = 2.0 if "serve" in name else 0.4
    return execute(Run(CELLS[name], seed, seconds, trace,
                       device_type="cpu", fault=fault))


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct_and_prints_the_result_line(name):
    line = _run(name)
    assert line["correct"], line["compared"]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    e2e = {m["name"] for m in CELLS[name].end_to_end}
    assert set(line["metrics"]) == e2e
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    assert line["attempted"] > 0 and line["failed"] == 0
    for v in line["compared"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    json.dumps(line)
    assert guard.loaded() == []


@pytest.mark.parametrize("name,fault", [(n, f) for n in sorted(FAULTS)
                                        for f in FAULTS[n]])
def test_planted_fault_is_not_correct(name, fault):
    assert not _run(name, fault)["correct"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_traced_line_carries_per_layer_metrics_and_breakdown(name):
    line = _run(name, trace=True)
    assert line["correct"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # a CPU run has no device work and no peak: only what it can read
    names = {m["name"] for m in CELLS[name].per_layer}
    assert set(line["metrics"]) <= names
