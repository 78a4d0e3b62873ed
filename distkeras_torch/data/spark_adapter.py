"""Spark ingest adapter — keep Spark RDD partitioning for ingest; a copy
of :mod:`distkeras_tpu.data.spark_adapter` (numpy only, pyspark imported
only by :func:`spark_available`).

Reference: the reference's entire data substrate is a Spark DataFrame/RDD
(reference: distkeras/trainers.py · DistributedTrainer.train operates on
``df.rdd``; distkeras/utils.py · to_dense_vector / new_dataframe_row handle
Spark ML Vector columns). The port runs Spark-free by default (pyspark
is not a dependency), so this module is a *thin
boundary*: it converts a Spark DataFrame or RDD into a
:class:`~distkeras_torch.data.dataset.PartitionedDataset`, **preserving the
RDD's partition structure** so that one Spark partition maps to one logical
training partition (and from there to one worker/device slot), exactly the
mapping ``mapPartitionsWithIndex`` gave the reference.

Everything here is duck-typed against the public RDD surface —
``df.rdd`` / ``df.columns``, ``rdd.glom().collect()``,
``rdd.getNumPartitions()`` — so no pyspark import is required: a real
pyspark object works, and the unit tests exercise the same code path with a
lightweight double. Spark ML ``Vector`` columns (anything exposing
``toArray()``) are densified, mirroring the reference's
``to_dense_vector`` convention.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .dataset import PartitionedDataset


def _densify(value: Any) -> Any:
    """Spark ML Vectors (Dense/Sparse) expose ``toArray``; densify them the
    way the reference's DenseTransformer / to_dense_vector did."""
    if hasattr(value, "toArray"):
        return np.asarray(value.toArray())
    return value


def _row_to_dict(row: Any, columns: Optional[Sequence[str]]) -> Dict[str, Any]:
    """Accept pyspark Rows (``asDict``), mappings, or plain tuples paired
    with an explicit column list."""
    if hasattr(row, "asDict"):
        d = row.asDict()
    elif isinstance(row, dict):
        d = row
    elif columns is not None:
        if len(row) != len(columns):
            raise ValueError(
                f"row of length {len(row)} does not match columns {columns}"
            )
        d = dict(zip(columns, row))
    else:
        raise TypeError(
            f"cannot interpret row of type {type(row).__name__} without an "
            "explicit `columns` list"
        )
    return {k: _densify(v) for k, v in d.items()}


def _partition_to_columns(
    rows: List[Any], columns: Optional[Sequence[str]]
) -> Dict[str, np.ndarray]:
    dicts = [_row_to_dict(r, columns) for r in rows]
    names = sorted(dicts[0].keys()) if columns is None else list(columns)
    out = {}
    for name in names:
        out[name] = np.stack([np.asarray(d[name]) for d in dicts], axis=0)
    return out


def dataset_from_spark(
    df_or_rdd: Any,
    columns: Optional[Sequence[str]] = None,
    num_partitions: Optional[int] = None,
) -> PartitionedDataset:
    """Convert a Spark DataFrame or RDD into a :class:`PartitionedDataset`.

    One Spark partition becomes one logical partition (the north-star
    "keep Spark RDD partitioning for ingest"): partition boundaries survive
    the crossing, so a dataset repartitioned to ``num_workers`` in Spark
    feeds ``num_workers`` workers here without a reshuffle. Empty Spark
    partitions (common after filters) are dropped, matching the reference's
    behavior of simply yielding nothing from an empty ``mapPartitions``.

    Args:
      df_or_rdd: a Spark DataFrame (anything with ``.rdd``; ``.columns`` is
        used for tuple rows), or an RDD (anything with ``.glom``).
      columns: optional explicit column names; required when rows are plain
        tuples without ``asDict``.
      num_partitions: if given, calls ``repartition`` on the Spark side
        first (using the RDD's own ``repartition``) so the shuffle happens
        in Spark, where the data lives.

    Returns:
      A :class:`PartitionedDataset` with one partition per (non-empty)
      Spark partition.
    """
    rdd = df_or_rdd
    if hasattr(df_or_rdd, "rdd"):  # DataFrame → RDD
        if columns is None and hasattr(df_or_rdd, "columns"):
            columns = list(df_or_rdd.columns)
        rdd = df_or_rdd.rdd
    if not hasattr(rdd, "glom"):
        raise TypeError(
            f"expected a Spark DataFrame or RDD, got {type(df_or_rdd).__name__}"
        )
    if num_partitions is not None and hasattr(rdd, "repartition"):
        rdd = rdd.repartition(num_partitions)
    # glom() keeps partition structure: one list of rows per partition.
    partition_rows: List[List[Any]] = rdd.glom().collect()
    parts = [
        _partition_to_columns(rows, columns) for rows in partition_rows if rows
    ]
    if not parts:
        raise ValueError("Spark input has no rows")
    return PartitionedDataset(parts)


def dataset_from_spark_session(
    spark: Any,
    path: str,
    format: str = "parquet",
    columns: Optional[Sequence[str]] = None,
    num_partitions: Optional[int] = None,
) -> PartitionedDataset:
    """Read ``path`` with a live SparkSession and convert.

    Convenience wrapper for the common reference workflow
    ``sqlContext.read.parquet(...)`` → trainer (reference: examples MNIST
    workflow notebook reads a parquet dataset before training).
    """
    reader = spark.read.format(format)
    df = reader.load(path)
    return dataset_from_spark(df, columns=columns, num_partitions=num_partitions)


def spark_available() -> bool:
    """True when pyspark is importable in this environment."""
    try:
        import pyspark  # noqa: F401

        return True
    except ImportError:
        return False
