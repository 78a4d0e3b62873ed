"""Evaluators — metric computation over a dataset; the port of
:mod:`distkeras_tpu.evaluators`.

Reference: distkeras/evaluators.py · AccuracyEvaluator — a Spark stage
comparing a label column with a prediction column. ``AccuracyEvaluator``
is numpy over the partitions (or a ShardedDataset's shards, one at a
time); ``PerplexityEvaluator`` runs the
port's :class:`~distkeras_torch.models.TransformerLM` batch by batch on
its device; ``LossEvaluator`` applies a port loss to two columns.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from distkeras_torch.data.dataset import PartitionedDataset


def _chunks(dataset):
    """A dataset's partitions, or a ShardedDataset's shards read one at a
    time."""
    from distkeras_torch.data.shard_io import ShardedDataset

    if isinstance(dataset, ShardedDataset):
        for i in range(dataset.num_shards):
            yield dataset.read_shard(i)
    else:
        for i in range(dataset.num_partitions):
            yield dataset.partition(i)


class Evaluator:
    """Base: ``evaluate(dataset) -> float``."""

    def evaluate(self, dataset: PartitionedDataset) -> float:
        raise NotImplementedError


class AccuracyEvaluator(Evaluator):
    """Fraction of rows where prediction == label (reference:
    evaluators.py · AccuracyEvaluator). ``prediction_col`` may hold class
    indices (from LabelIndexTransformer) or prediction vectors (argmax
    taken); ``label_col`` may be integer or one-hot."""

    def __init__(self, prediction_col: str = "predicted_index",
                 label_col: str = "label"):
        self.prediction_col = prediction_col
        self.label_col = label_col

    @staticmethod
    def _score(pred: np.ndarray, label: np.ndarray) -> int:
        if pred.ndim > 1:
            pred = pred.argmax(-1)
        if label.ndim > 1:
            label = label.argmax(-1)
        return int(np.sum(pred.astype(np.int64) == label.astype(np.int64)))

    def evaluate(self, dataset) -> float:
        """A PartitionedDataset, or a ShardedDataset streamed shard by
        shard (exact counts, one shard resident)."""
        correct = total = 0
        for part in _chunks(dataset):
            correct += self._score(np.asarray(part[self.prediction_col]),
                                   np.asarray(part[self.label_col]))
            total += len(part[self.label_col])
        return correct / total


class PerplexityEvaluator(Evaluator):
    """Next-token perplexity of a language model over a ``tokens_col`` of
    ``[N, T]`` int token ids: ``exp`` of the token-weighted mean
    cross-entropy over the corpus, partition by partition in batches of
    ``batch_size`` rows (a ragged tail is zero-padded and its pad rows
    masked, so every batch has one shape)."""

    def __init__(self, model, batch_size: int = 8, tokens_col: str = "tokens"):
        self.model = model  # a models.wrapper.Model over a TransformerLM
        self.batch_size = batch_size
        self.tokens_col = tokens_col

    @torch.no_grad()
    def _batch_sums(self, toks: np.ndarray, n_valid: int):
        """(CE sum, token count) over the first ``n_valid`` rows of a full
        ``[B, T]`` batch, the sum left on the device."""
        module = self.model.module
        t = torch.as_tensor(toks, dtype=torch.long, device=self.model.device)
        logits = module(t)[:, :-1].float()
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             t[:, 1:].reshape(-1), reduction="none")
        return ce.reshape(len(toks), -1)[:n_valid].sum(), \
            n_valid * (toks.shape[1] - 1)

    def evaluate(self, dataset) -> float:
        sums, count = [], 0
        B = self.batch_size
        for part in _chunks(dataset):
            toks = np.asarray(part[self.tokens_col])
            if toks.ndim != 2:
                raise ValueError(
                    f"'{self.tokens_col}' must be [N, T] token ids; got "
                    f"shape {toks.shape}")
            for s in range(0, len(toks), B):
                b = toks[s:s + B]
                n_valid = len(b)
                if n_valid < B:
                    b = np.concatenate(
                        [b, np.zeros((B - n_valid,) + b.shape[1:], b.dtype)])
                total, n = self._batch_sums(b, n_valid)
                sums.append(total)
                count += n
        if count == 0:
            raise ValueError("empty dataset")
        return float(np.exp(float(torch.stack(sums).double().sum()) / count))


class LossEvaluator(Evaluator):
    """Mean loss between a prediction column and a label column, with a
    loss of :func:`distkeras_torch.utils.losses.get_loss`."""

    def __init__(self, loss: str = "mse", prediction_col: str = "prediction",
                 label_col: str = "label"):
        from distkeras_torch.utils.losses import get_loss

        self._loss_fn = get_loss(loss)
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, dataset: PartitionedDataset) -> float:
        pred = torch.as_tensor(dataset.column(self.prediction_col))
        label = torch.as_tensor(dataset.column(self.label_col))
        return float(self._loss_fn(pred, label))
