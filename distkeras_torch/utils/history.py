"""Training-history bookkeeping — a copy of
:mod:`distkeras_tpu.utils.history` (stdlib only).

Reference: distkeras/trainers.py · Trainer.get_averaged_history /
get_executor_history + distkeras/workers.py — workers append per-batch
loss/metric scalars to a local list which the Spark application's
main process collects.

Here a history is ``list[dict[str, float]]`` (one dict per step); per-worker
histories are ``list[list[dict]]`` indexed by worker.
"""

from __future__ import annotations

from typing import Dict, List

History = List[Dict[str, float]]


def average_histories(histories: List[History]) -> History:
    """Average per-step metrics across workers, truncating to the shortest
    worker history (workers may have run different step counts under async
    schedules — reference averages what aligns)."""
    if not histories:
        return []
    n_steps = min(len(h) for h in histories)
    out: History = []
    for t in range(n_steps):
        keys = histories[0][t].keys()
        out.append(
            {k: sum(h[t][k] for h in histories) / len(histories) for k in keys}
        )
    return out


def merge_history_arrays(metrics_by_key: Dict[str, "list"]) -> History:
    """Columnar per-step metric arrays → row-shaped history list."""
    if not metrics_by_key:
        return []
    n = min(len(v) for v in metrics_by_key.values())
    return [{k: float(v[t]) for k, v in metrics_by_key.items()} for t in range(n)]
