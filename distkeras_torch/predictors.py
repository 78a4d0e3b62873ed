"""Predictors — batch inference as a dataset stage; the port of
:mod:`distkeras_tpu.predictors`.

Reference: distkeras/predictors.py · ModelPredictor — a Spark
mapPartitions stage calling ``model.predict`` per row. Here, as in the
JAX package, each partition goes through the model in fixed-size batches
(the tail zero-padded, its pad sliced off), appending an output column.

The feed is transfer-bound, so it is pipelined: features are narrowed to
the model's compute dtype on the host (the model's first op casts to it
anyway: the same values at half the bytes), each chunk is copied from a
pinned host buffer with ``non_blocking`` copies on the current stream,
and its logits come back the same way, with at most
:attr:`ModelPredictor._MAX_IN_FLIGHT` chunks in flight: chunk ``i + 1``'s
upload and compute are queued before chunk ``i``'s result is read.
:meth:`ModelPredictor.predict_sharded` runs the same feed shard by shard
over a disk-sharded dataset.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from distkeras_torch.data.dataset import PartitionedDataset
from distkeras_torch.models.wrapper import Model


class Predictor:
    """Base stage: ``predict(dataset) -> dataset`` with an output column."""

    def predict(self, dataset: PartitionedDataset) -> PartitionedDataset:
        raise NotImplementedError


class ModelPredictor(Predictor):
    """Append ``output_col`` = model(features), f32 (reference:
    predictors.py · ModelPredictor). ``transfer_dtype``: ``"auto"`` (the
    module's compute dtype), ``None`` (no host-side cast) or a dtype."""

    # chunks in flight at once: enough to overlap upload, compute and
    # download, few enough that queued inputs stay small
    _MAX_IN_FLIGHT = 4

    def __init__(self, model: Model, features_col: str = "features",
                 output_col: str = "prediction", batch_size: int = 512,
                 transfer_dtype="auto"):
        from distkeras_torch.utils.transfer import resolve_transfer_dtype

        self.model = model
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = batch_size
        self.transfer_dtype = resolve_transfer_dtype(model.module,
                                                     transfer_dtype)

    @torch.no_grad()
    def _predict_array(self, x: np.ndarray) -> np.ndarray:
        """Every model call sees exactly ``batch_size`` rows, so any
        partition size, an empty one included (``[0, ...]`` out), takes
        the same shapes."""
        from distkeras_torch.utils.transfer import narrow_cast

        n = len(x)
        B = self.batch_size
        xt = torch.as_tensor(narrow_cast(np.asarray(x), self.transfer_dtype))
        dev = self.model.device
        cuda = dev.type == "cuda"
        pending: deque = deque()  # (start, host out, its copy's event)
        outs = []

        def drain_one():
            s, host, done = pending.popleft()
            if done is not None:
                done.synchronize()
            outs.append(host[:min(B, n - s)].numpy())

        for s in range(0, max(n, 1), B):
            chunk = xt[s:s + B]
            if len(chunk) < B:
                pad = torch.zeros((B - len(chunk),) + tuple(xt.shape[1:]),
                                  dtype=xt.dtype)
                chunk = torch.cat([chunk, pad])
            if cuda:
                chunk = chunk.pin_memory().to(dev, non_blocking=True)
            out = self.model.module(chunk).float()
            if cuda:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host, done = out, None
            pending.append((s, host, done))
            if len(pending) >= self._MAX_IN_FLIGHT:
                drain_one()
        while pending:
            drain_one()
        return np.concatenate(outs, axis=0)[:n]

    def predict(self, dataset) -> PartitionedDataset:
        """Append ``output_col`` to every partition; a
        :class:`~distkeras_torch.data.shard_io.ShardedDataset` is loaded
        first (:meth:`predict_sharded` streams it instead)."""
        from distkeras_torch.data.shard_io import ShardedDataset

        if isinstance(dataset, ShardedDataset):
            dataset = dataset.load()
        return dataset.with_column(
            self.output_col,
            lambda p: self._predict_array(p[self.features_col]))

    def predict_sharded(self, dataset, out_directory: str) -> str:
        """Disk-scale inference: stream a ShardedDataset shard by shard,
        writing ``out_directory`` as a new shard directory with
        ``output_col`` appended — one shard resident at a time (the
        reference's mapPartitions predict at HDFS scale)."""
        from distkeras_torch.data.shard_io import ShardedDataset, map_shards

        if not isinstance(dataset, ShardedDataset):
            raise TypeError("predict_sharded takes a ShardedDataset")

        def stage(shard):
            out = dict(shard)
            out[self.output_col] = self._predict_array(
                shard[self.features_col])
            return out

        return map_shards(dataset, stage, out_directory)
