"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``, whose ``kind`` names its module,
``kinds/<kind>.py``); its limits are ``limits/<cell>.json``; each
per-layer metric is read by ``metrics/<metric>.py``. Adding one of them
is adding its file and its ``BENCHMARK.json`` entry.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: Dict[str, dict]
    end_to_end: List[dict]
    per_layer: List[dict]
    # where a run writes (traces, postmortems): inside the checkout
    out_dir: Path = field(default_factory=lambda: ROOT / "build" / "gpubench")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``) with its
    configuration, traffic, limits and metric entries. Raises
    ``KeyError`` for an unknown cell."""
    bench = bench if bench is not None else _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _json(root / configs[w["config"]]["file"])
    here = root / "gpubench"
    traffic = _json(here / "traffic" / f"{w['traffic']}.json")
    lim_path = here / "limits" / f"{name}.json"
    limits = _json(lim_path)["limits"] if lim_path.exists() else {}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)
                 and m["moves"] in e2e_names]
    return Cell(name, int(w["chips"]), w["config"], w["traffic"], cfg,
                traffic, limits, e2e, per_layer)


def kind_module(kind: str):
    """The module that runs a traffic ``kind``."""
    return importlib.import_module(f"gpubench.kinds.{kind}")


def metric_reader(name: str, root: Path = ROOT) -> Callable[[dict], object]:
    """The ``read(record)`` function of per-layer metric ``name``."""
    path = root / "gpubench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
