"""One run of one cell: the pieces every kind module shares.

A kind module's ``run(run)`` measures the cell and fills :class:`Run`'s
result fields; :func:`result_line` turns them into the last line.
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from gpubench import device as devinfo
from gpubench.cells import Cell, metric_reader


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    # "cuda" on the card; "cpu" only in the CPU tests, which skip the
    # harness's look for a card
    device_type: str = "cuda"
    # a fault planted in the program (gpubench.faults), tests only
    fault: Optional[str] = None
    # the process's start on the wall clock (set-up runs from it)
    t0: float = field(default_factory=time.time)
    # filled by the kind module
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = field(default_factory=dict)
    record: Optional[dict] = None
    numbers: Dict[str, float] = field(default_factory=dict)
    extra_ok: bool = True
    memory_peak_bytes: int = 0
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    device_name: str = "cpu"
    count: int = 1
    # the readings that set the limits (gpubench.readings): seeds to
    # read in one process, and those that also read the control
    seeds: List[int] = field(default_factory=list)
    control_seeds: List[int] = field(default_factory=list)
    # the finished requests a serving run compared
    sample: Optional[list] = None

    def device(self, rank: int = 0) -> torch.device:
        if self.device_type == "cuda":
            return torch.device("cuda", rank)
        return torch.device("cpu")

    def sync(self):
        if self.device_type == "cuda":
            torch.cuda.synchronize()

    def trace_path(self, rank: int = 0, kind: str = "full"):
        return self.cell.out_dir / f"trace.{self.cell.name}.{kind}.{rank}.json"


def memory_peak(run: Run, rank: int = 0) -> int:
    if run.device_type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(rank))


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def peaks_of(run: Run) -> Optional[Tuple[float, float]]:
    return devinfo.peaks(run.device_name)


def per_layer(run: Run) -> Dict[str, dict]:
    """The cell's per-layer metrics read from the traced record; a reader
    that finds nothing returns None and its metric is left out."""
    out = {}
    for m in run.cell.per_layer:
        value = metric_reader(m["name"])(run.record or {})
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(run: Run, correct: bool, compared) -> dict:
    if run.trace:
        metrics = per_layer(run)
    else:
        units = {m["name"]: m["unit"] for m in run.cell.end_to_end}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in run.e2e.items() if k in units}
    device = {"platform": "gpu" if run.device_type == "cuda" else "cpu",
              "kind": run.device_name, "count": run.count,
              "memory_peak_bytes": int(run.memory_peak_bytes),
              "power": devinfo.nvidia_smi() if run.device_type == "cuda"
              else "not available"}
    line = {"correct": bool(correct), "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics, "device": device}
    if run.trace:
        device["busy_s"] = run.busy_s
        device["window_s"] = run.window_s
        if run.record and "breakdown" in run.record.get("summary", {}):
            line["breakdown"] = run.record["summary"]["breakdown"]
    line["compared"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in compared}
    return line
