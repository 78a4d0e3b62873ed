"""PartitionedDataset — a partitioned, columnar, host-resident dataset.

A copy of :mod:`distkeras_tpu.data.dataset` (numpy only), the input of
the port's trainers.

Reference: the reference's data substrate is a Spark DataFrame/RDD: named
columns, k partitions, ``repartition``, row-maps appending columns, and a
``features_col``/``label_col`` convention threaded through every trainer,
transformer, predictor, and evaluator (reference: distkeras/trainers.py ·
DistributedTrainer.train repartitions to ``num_workers`` and runs
``mapPartitionsWithIndex``; distkeras/utils.py · new_dataframe_row appends a
column per row).

The TPU-native redesign keeps the *shape* of that contract — named columns,
logical partitions, append-column transforms — but stores each partition as a
dict of contiguous numpy arrays (one entry per column). That makes every
downstream op a batched array op instead of a per-row Python map:
partitions feed devices directly (one partition per mesh-axis slot, stacked
and device-put once), transformers are vectorized, and inference is one
``jit``-compiled apply per batch rather than the reference's per-row
``model.predict`` (a known perf wart, SURVEY.md §3.3).

No Spark dependency. A Spark adapter can construct one of these from an RDD
via ``from_partitions`` without changing anything downstream.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

Partition = Dict[str, np.ndarray]


class PartitionedDataset:
    """k logical partitions of named columns.

    Each partition is ``{column_name: np.ndarray}`` with equal leading
    (row) dimension within the partition. Columns may have any trailing
    shape (vectors, images, tensors).
    """

    def __init__(self, partitions: List[Partition]):
        if not partitions:
            raise ValueError("PartitionedDataset needs at least one partition")
        cols = set(partitions[0].keys())
        for i, p in enumerate(partitions):
            if set(p.keys()) != cols:
                raise ValueError(
                    f"partition {i} columns {sorted(p.keys())} != {sorted(cols)}"
                )
            sizes = {k: len(v) for k, v in p.items()}
            if len(set(sizes.values())) > 1:
                raise ValueError(f"partition {i} has ragged columns: {sizes}")
        self._partitions = partitions

    # -- construction -------------------------------------------------------

    @classmethod
    def from_arrays(
        cls,
        columns: Dict[str, np.ndarray],
        num_partitions: int = 1,
    ) -> "PartitionedDataset":
        """Build from whole-dataset columns, splitting rows into
        ``num_partitions`` roughly equal partitions (Spark ``parallelize``)."""
        n = len(next(iter(columns.values())))
        for k, v in columns.items():
            if len(v) != n:
                raise ValueError(f"column '{k}' has {len(v)} rows, expected {n}")
        bounds = np.linspace(0, n, num_partitions + 1).astype(int)
        parts = [
            {k: np.asarray(v[bounds[i] : bounds[i + 1]]) for k, v in columns.items()}
            for i in range(num_partitions)
        ]
        return cls(parts)

    @classmethod
    def from_partitions(cls, partitions: List[Partition]) -> "PartitionedDataset":
        """Adopt pre-partitioned data (e.g. from a Spark RDD adapter)."""
        return cls([{k: np.asarray(v) for k, v in p.items()} for p in partitions])

    # -- introspection ------------------------------------------------------

    @property
    def num_partitions(self) -> int:
        return len(self._partitions)

    @property
    def columns(self) -> List[str]:
        return sorted(self._partitions[0].keys())

    @property
    def num_rows(self) -> int:
        return sum(len(next(iter(p.values()))) for p in self._partitions)

    def partition(self, i: int) -> Partition:
        return self._partitions[i]

    def partitions(self) -> List[Partition]:
        return list(self._partitions)

    def column(self, name: str) -> np.ndarray:
        """Materialize one column across all partitions (a ``collect``)."""
        if name not in self._partitions[0]:
            raise KeyError(
                f"column '{name}' not in dataset; available: {self.columns}"
            )
        return np.concatenate([p[name] for p in self._partitions], axis=0)

    # -- Spark-shaped operations -------------------------------------------

    def repartition(self, num_partitions: int) -> "PartitionedDataset":
        """Re-split all rows into ``num_partitions`` equal partitions.

        Reference: distkeras/trainers.py · DistributedTrainer.train calls
        ``df.rdd.repartition(num_workers * parallelism_factor)``.
        """
        merged = {c: self.column(c) for c in self.columns}
        return PartitionedDataset.from_arrays(merged, num_partitions)

    def coalesce(self, num_partitions: int = 1) -> "PartitionedDataset":
        """Reference: SingleTrainer coalesces to one partition."""
        return self.repartition(num_partitions)

    def shuffle(self, seed: int = 0) -> "PartitionedDataset":
        """Global row shuffle (reference: distkeras/utils.py · shuffle(df))."""
        rng = np.random.default_rng(seed)
        merged = {c: self.column(c) for c in self.columns}
        n = len(next(iter(merged.values())))
        perm = rng.permutation(n)
        merged = {c: v[perm] for c, v in merged.items()}
        return PartitionedDataset.from_arrays(merged, self.num_partitions)

    def with_column(
        self, name: str, fn: Callable[[Partition], np.ndarray]
    ) -> "PartitionedDataset":
        """Append/replace a column computed per-partition (vectorized
        row-map; reference: distkeras/utils.py · new_dataframe_row, applied
        rowwise — here one call per partition over the whole array)."""
        parts = []
        for p in self._partitions:
            out = np.asarray(fn(p))
            if len(out) != len(next(iter(p.values()))):
                raise ValueError(
                    f"with_column('{name}') returned {len(out)} rows for a "
                    f"{len(next(iter(p.values())))}-row partition"
                )
            q = dict(p)
            q[name] = out
            parts.append(q)
        return PartitionedDataset(parts)

    def select(self, names: Sequence[str]) -> "PartitionedDataset":
        return PartitionedDataset(
            [{n: p[n] for n in names} for p in self._partitions]
        )

    def take(self, n: int, column: Optional[str] = None):
        """First ``n`` rows (of one column, or dict of all columns)."""
        if column is not None:
            return self.column(column)[:n]
        return {c: self.column(c)[:n] for c in self.columns}

    def precache(self) -> "PartitionedDataset":
        """Materialize every column into contiguous host buffers.

        Reference: distkeras/utils.py · precache(df) [UNCERTAIN in fork] —
        ``df.cache()`` + a count action to force materialization into
        executor memory before training, so the first epoch doesn't pay the
        read. Here data is already host-resident; the analogous cost is
        non-contiguous/strided buffers making ``device_put`` DMA slow, so
        precache defragments each column into C-contiguous arrays (a no-op
        copy-free pass when already contiguous).
        """
        parts = [
            {k: np.ascontiguousarray(v) for k, v in p.items()}
            for p in self._partitions
        ]
        return PartitionedDataset(parts)

    def __len__(self) -> int:
        return self.num_rows

    def __repr__(self) -> str:
        return (
            f"PartitionedDataset(rows={self.num_rows}, "
            f"partitions={self.num_partitions}, columns={self.columns})"
        )
