"""What the per-layer metrics (``metrics/<metric>.py``, each a
``read(record)``) share: the traced run's record by kind, the idle share
and a kernel group's time a step. A reader that finds nothing to read
returns None, and the metric is left out."""

from __future__ import annotations


def train_summary(record):
    return record.get("summary") if record.get("kind") == "train" else None


def serve_summary(record):
    return record.get("summary") if record.get("kind") == "serve" else None


def idle_pct(record):
    """Share of the kernel-only traced window in which no kernel, copy or
    fill ran on the card (rank 0's streams, overlaps counted once), %."""
    busy = record.get("busy")
    if not busy or not busy["window_s"]:
        return None
    return 100.0 * (1.0 - busy["busy_s"] / busy["window_s"])


def group_ms(record, group):
    """Device time of kernel ``group`` (``trace.group``) a training step,
    ms."""
    s = train_summary(record)
    if not s:
        return None
    sec = s["groups"].get(group, 0.0)
    return 1e3 * sec / record["steps"] if sec > 0 else None
