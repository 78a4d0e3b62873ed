"""Preprocessing transformer stages — a copy of
:mod:`distkeras_tpu.transformers` (numpy only).

Reference: distkeras/transformers.py — Spark-ML-style stages, each a
``transform(df) -> df`` appending an output column. Here each is a
vectorized per-partition array op over
:class:`~distkeras_torch.data.dataset.PartitionedDataset`, with the same
input-col/output-col contract as the JAX package's.

Stages:
- :class:`OneHotTransformer`     (reference · OneHotTransformer)
- :class:`MinMaxTransformer`     (reference · MinMaxTransformer)
- :class:`DenseTransformer`      (reference · DenseTransformer)
- :class:`ReshapeTransformer`    (reference · ReshapeTransformer)
- :class:`LabelIndexTransformer` (reference · LabelIndexTransformer)

``transform_sharded`` runs a stage shard by shard over a disk-sharded
dataset (:func:`distkeras_torch.data.shard_io.map_shards`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from distkeras_torch.data.dataset import PartitionedDataset


class Transformer:
    """Base stage: ``transform(dataset) -> dataset`` appending a column."""

    def transform(self, dataset: PartitionedDataset) -> PartitionedDataset:
        raise NotImplementedError

    def transform_sharded(self, dataset, out_directory: str) -> str:
        """Disk-scale transform: apply this stage shard by shard over a
        :class:`~distkeras_torch.data.shard_io.ShardedDataset`, writing a
        new shard directory (the reference's mapPartitions stage at HDFS
        scale, one shard resident at a time). A stage that FITS
        statistics from the data (``MinMaxTransformer`` without
        ``o_min``/``o_max``) must be given them: fitted per shard, each
        shard would be scaled differently, so that raises."""
        from distkeras_torch.data.shard_io import map_shards

        self._check_sharded_safe()

        def stage(shard):
            return self.transform(PartitionedDataset([shard])).partition(0)

        return map_shards(dataset, stage, out_directory)

    def _check_sharded_safe(self):
        """Override to refuse per-shard application of a stage that fits
        global statistics from the data."""


class OneHotTransformer(Transformer):
    """Integer label column → one-hot float vector column.

    Reference: distkeras/transformers.py · OneHotTransformer
    (label → one-hot dense vector for categorical_crossentropy).
    """

    def __init__(self, num_classes: int, input_col: str = "label",
                 output_col: str = "label_encoded"):
        self.num_classes = num_classes
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataset: PartitionedDataset) -> PartitionedDataset:
        def onehot(p):
            labels = p[self.input_col].astype(np.int64).reshape(-1)
            return np.eye(self.num_classes, dtype=np.float32)[labels]

        return dataset.with_column(self.output_col, onehot)


class MinMaxTransformer(Transformer):
    """Scale a feature column to ``[new_min, new_max]`` given the observed
    (or stated) data range.

    Reference: distkeras/transformers.py · MinMaxTransformer — the reference
    takes ``o_min/o_max`` (observed) and ``n_min/n_max`` (target) constructor
    args; we keep those names and add fit-from-data when omitted.
    """

    def __init__(self, o_min: float = None, o_max: float = None,
                 n_min: float = 0.0, n_max: float = 1.0,
                 input_col: str = "features", output_col: str = "features_normalized"):
        self.o_min, self.o_max = o_min, o_max
        self.n_min, self.n_max = n_min, n_max
        self.input_col = input_col
        self.output_col = output_col

    def _check_sharded_safe(self):
        if self.o_min is None or self.o_max is None:
            raise ValueError(
                "MinMaxTransformer without explicit o_min/o_max fits the "
                "range from data; per-shard fitting would scale each shard "
                "differently — pass o_min/o_max for transform_sharded")

    def transform(self, dataset: PartitionedDataset) -> PartitionedDataset:
        o_min = self.o_min
        o_max = self.o_max
        if o_min is None:
            o_min = float(min(p[self.input_col].min() for p in dataset.partitions()))
        if o_max is None:
            o_max = float(max(p[self.input_col].max() for p in dataset.partitions()))
        span = (o_max - o_min) or 1.0

        def scale(p):
            x = p[self.input_col].astype(np.float32)
            return (x - o_min) / span * (self.n_max - self.n_min) + self.n_min

        return dataset.with_column(self.output_col, scale)


class DenseTransformer(Transformer):
    """Sparse (indices, values, size) column triple → dense vector column.

    Reference: distkeras/transformers.py · DenseTransformer (Spark sparse
    Vector → DenseVector). Without Spark, sparse input is represented as two
    object-array columns of per-row index/value arrays plus a fixed size.
    """

    def __init__(self, size: int, indices_col: str = "indices",
                 values_col: str = "values", output_col: str = "features"):
        self.size = size
        self.indices_col = indices_col
        self.values_col = values_col
        self.output_col = output_col

    def transform(self, dataset: PartitionedDataset) -> PartitionedDataset:
        def densify(p):
            idx_rows = p[self.indices_col]
            val_rows = p[self.values_col]
            out = np.zeros((len(idx_rows), self.size), dtype=np.float32)
            for r, (ix, vs) in enumerate(zip(idx_rows, val_rows)):
                out[r, np.asarray(ix, dtype=np.int64)] = vs
            return out

        return dataset.with_column(self.output_col, densify)


class ReshapeTransformer(Transformer):
    """Flat vector column → tensor-shaped column (e.g. 784 → (28, 28, 1)).

    Reference: distkeras/transformers.py · ReshapeTransformer (prepares CNN
    inputs from flat feature vectors).
    """

    def __init__(self, input_col: str, output_col: str, shape: Sequence[int]):
        self.input_col = input_col
        self.output_col = output_col
        self.shape: Tuple[int, ...] = tuple(shape)

    def transform(self, dataset: PartitionedDataset) -> PartitionedDataset:
        return dataset.with_column(
            self.output_col,
            lambda p: p[self.input_col].reshape((-1,) + self.shape),
        )


class LabelIndexTransformer(Transformer):
    """Prediction-vector column → argmax label index column.

    Reference: distkeras/transformers.py · LabelIndexTransformer (turns the
    raw prediction vector into a class index for evaluation).
    """

    def __init__(self, output_dim: int = None, input_col: str = "prediction",
                 output_col: str = "predicted_index"):
        self.output_dim = output_dim  # kept for reference API parity; unused
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataset: PartitionedDataset) -> PartitionedDataset:
        return dataset.with_column(
            self.output_col,
            lambda p: np.argmax(p[self.input_col], axis=-1).astype(np.int64),
        )
