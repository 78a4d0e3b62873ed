"""A configuration, a traffic mix and a per-layer metric are added by
adding their files and BENCHMARK.json entries, editing no file."""

import json
import shutil

from gpubench.cells import HERE, load_cell, metric_reader


def test_new_config_mix_and_metric_by_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "gpubench").rglob("*") if p.is_file()}
    # the new files
    (root / "gpubench/configs/lm_small.json").write_text(json.dumps(dict(
        json.loads((HERE / "configs/lm_flagship.json").read_text()),
        num_layers=2)))
    (root / "gpubench/traffic/lm_train_b2.json").write_text(json.dumps(dict(
        json.loads((HERE / "traffic/lm_train_b8.json").read_text()),
        batch=2, why="two rows")))
    (root / "gpubench/metrics/steps_traced.py").write_text(
        "def read(record):\n    return record.get('steps')\n")
    # the new entries
    bench["configs"].append({"name": "lm_small", "source": "a test",
                             "file": "gpubench/configs/lm_small.json",
                             "reduced": ["num_layers"], "why": "a test"})
    bench["workloads"].append({"name": "lm_small.train", "config": "lm_small",
                               "traffic": "lm_train_b2", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("lm_small.train")
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "train_step_ms",
                               "workloads": ["lm_small.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("lm_small.train", root=root)
    assert cell.config["num_layers"] == 2 and cell.traffic["batch"] == 2
    assert {m["name"] for m in cell.end_to_end} == {"train_step_ms",
                                                    "setup_s"}
    assert "steps_traced" in {m["name"] for m in cell.per_layer}
    assert metric_reader("steps_traced", root=root)({"steps": 5}) == 5
    # the cells already there are found as before
    assert load_cell("lm_flagship.train", root=root).traffic == \
        load_cell("lm_flagship.train").traffic
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "gpubench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())


def test_every_committed_metric_has_a_reader_and_every_cell_its_files():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(metric_reader(m["name"]))
        assert metric_reader(m["name"])({}) is None
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert cell.limits, f"{w['name']} has no limits"
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
