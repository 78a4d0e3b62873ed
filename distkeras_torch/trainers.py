"""Trainers — the port of :mod:`distkeras_tpu.trainers`: the
:class:`Trainer` base (timing, telemetry, JSONL metrics, history) and
:class:`LMTrainer`'s in-memory path over a dp x sp mesh.

``LMTrainer`` trains a :class:`~distkeras_torch.models.TransformerLM`
with :func:`distkeras_torch.parallel.spmd.make_lm_train_step` in windows
of :attr:`LMTrainer.STREAM_GROUP` steps, keeping each window's losses on
the device until the epoch ends; ``axes={"dp": d, "sp": s}`` shards it
over the ``d * s`` processes of the ``torch.distributed`` world (one
process on one device when both are 1). Not ported yet, and raising
with their ROADMAP item: the ``tp``, ``pp`` and ``ep`` axes and pipeline
``microbatches`` (A10), disk-sharded datasets (A9), ``checkpointer=``
(A9) and ``profile_dir=`` (A7); an MoE model (A10) raises where it is
built.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from distkeras_torch.data.dataset import PartitionedDataset
from distkeras_torch.models.wrapper import Model
from distkeras_torch.utils.history import History, average_histories
from distkeras_torch.utils.losses import get_optimizer


class Trainer:
    """Base trainer (reference: trainers.py · Trainer): holds the model,
    the worker-side optimizer configuration, loss/metrics, column
    conventions, and timing/history bookkeeping.

    ``params`` is an optional flax-layout tree of numpy arrays (what the
    reference's trainers take and return); it is loaded into the model
    when training starts. After training, ``self.params`` is the trained
    weights in the same layout."""

    def __init__(
        self,
        model,
        params: Optional[Any] = None,
        worker_optimizer="sgd",
        learning_rate: float = 0.01,
        loss="categorical_crossentropy",
        metrics: Sequence = ("accuracy",),
        features_col: str = "features",
        label_col: str = "label",
        batch_size: int = 32,
        num_epoch: int = 1,
        seed: int = 0,
        checkpointer=None,
        metrics_path: Optional[str] = None,
        profile_dir: Optional[str] = None,
        stage_limit_bytes: int = 1 << 30,
    ):
        if checkpointer is not None:
            raise NotImplementedError(
                "checkpointer= (training checkpoints) is not ported yet "
                "(ROADMAP A9)")
        if profile_dir is not None:
            raise NotImplementedError(
                "profile_dir= (a profiler trace around training) is not "
                "ported yet (ROADMAP A7)")
        self.model = model
        self.params = params
        self.worker_optimizer = worker_optimizer
        self.learning_rate = learning_rate
        self.loss = loss
        self.metrics = tuple(metrics)
        self.features_col = features_col
        self.label_col = label_col
        self.batch_size = batch_size
        self.num_epoch = num_epoch
        self.seed = seed
        # data bigger than this budget is uploaded window by window
        # instead of staged on the device once
        self.stage_limit_bytes = stage_limit_bytes
        self.metrics_path = metrics_path
        self.metrics_writer = None
        self.history: History = []
        self.executor_histories: List[History] = []
        self._t_start = None
        self._t_end = None

    # -- bookkeeping (reference: record_training_start/end etc.) -----------

    def record_training_start(self):
        self._t_start = time.time()
        from distkeras_torch import telemetry

        telemetry.get_registry().counter(
            "train_runs_total", "trainer.train() invocations",
            labelnames=("trainer",),
        ).labels(trainer=type(self).__name__).inc()
        if self.metrics_path is not None:
            from distkeras_torch.utils.metrics import MetricsWriter

            self.metrics_writer = MetricsWriter(self.metrics_path)

    def record_training_end(self):
        self._t_end = time.time()
        from distkeras_torch import telemetry

        telemetry.get_registry().gauge(
            "train_last_run_seconds",
            "wall-clock duration of the most recent train() call",
            labelnames=("trainer",),
        ).labels(trainer=type(self).__name__).set(
            round(self._t_end - self._t_start, 3))
        if self.metrics_writer is not None:
            tp = self.metrics_writer.throughput()
            if tp is not None:
                self.metrics_writer.summary(
                    "throughput", samples_per_sec=round(tp, 2),
                    training_time=round(self.get_training_time(), 4))
            self.metrics_writer.close()

    def train(self, dataset: PartitionedDataset, shuffle: bool = False):
        """Run training (reference: Trainer.train). The timing/metrics
        lifecycle is managed here so a failing run still closes the
        metrics file; subclasses implement :meth:`_train`."""
        try:
            self.record_training_start()
            return self._train(self._coerce_dataset(dataset), shuffle)
        finally:
            self.record_training_end()

    def _coerce_dataset(self, dataset):
        if isinstance(dataset, PartitionedDataset):
            return dataset
        if hasattr(dataset, "read_shard") or hasattr(dataset, "num_shards"):
            raise NotImplementedError(
                "disk-sharded datasets (ShardedDataset streaming) are not "
                "ported yet (ROADMAP A9); load it into a PartitionedDataset")
        raise TypeError(f"train() takes a PartitionedDataset; got "
                        f"{type(dataset).__name__}")

    def get_training_time(self) -> float:
        if self._t_start is None:
            return 0.0
        return (self._t_end or time.time()) - self._t_start

    def get_averaged_history(self) -> History:
        return average_histories(self.executor_histories)

    def get_executor_history(self, index: int) -> History:
        return self.executor_histories[index]

    def serialize(self) -> dict:
        raise NotImplementedError(
            "Trainer.serialize (the msgpack model blob) is not ported yet "
            "(ROADMAP A1)")

    def _train(self, dataset: PartitionedDataset, shuffle: bool = False):
        raise NotImplementedError


class LMTrainer(Trainer):
    """The flagship LM as a Trainer: a :class:`TransformerLM` trained over
    a dp x sp mesh with the LM step, windows of :attr:`STREAM_GROUP`
    steps.

    Data contract: the dataset carries a ``tokens_col`` column of int
    token ids ``[N, T]``; each step consumes a ``[batch_size, T]`` global
    batch, of which each rank trains on its ``[batch_size/dp, T/sp]``
    shard. The loss is the global mean next-token cross-entropy
    (``loss``/``metrics``/``label_col`` are ignored — an LM supervises
    itself).

    ``axes`` names ``dp`` and ``sp`` (default ``{"dp": world size}``);
    their product must be the size of the ``torch.distributed`` world,
    whose ranks each run ``train()`` on the SAME dataset (the process
    form of the reference's single program over the mesh). ``sp > 1``
    needs ``attention='ring'``. The returned :class:`Model` holds the
    standard-attention twin of a ring model, sharing its parameters."""

    # optimizer steps per window (one device-side loop, losses kept on
    # the device)
    STREAM_GROUP = 16

    def __init__(self, model, *args, axes: Optional[dict] = None,
                 tokens_col: str = "tokens",
                 microbatches: Optional[int] = None, **kwargs):
        super().__init__(model, *args, **kwargs)
        if microbatches is not None:
            raise NotImplementedError(
                "microbatches (pipeline-parallel training) is not ported "
                "yet (ROADMAP A10)")
        extra = {k: v for k, v in (axes or {}).items()
                 if k not in ("dp", "sp") and v != 1}
        if extra:
            raise NotImplementedError(
                f"LMTrainer axes {extra}: tensor, pipeline and expert "
                f"parallelism are not ported yet (ROADMAP A10); the mesh "
                f"takes 'dp' and 'sp'")
        self.axes = axes
        self.tokens_col = tokens_col

    def _single_chip_twin(self):
        """A standard-attention twin of the model sharing its parameters
        (the model itself unless it is a ring model): what the returned
        :class:`Model` predicts with, outside any mesh. The reference
        also initializes through it, because its ring traces only inside
        ``shard_map``; here the parameters exist from construction."""
        if self.model.attention != "ring":
            return self.model
        return self.model.clone(attention="standard")

    def _mesh(self, T: int):
        import torch.distributed as dist

        from distkeras_torch.parallel.mesh import make_mesh

        world = (dist.get_world_size() if dist.is_available()
                 and dist.is_initialized() else 1)
        axes = dict(self.axes) if self.axes else {"dp": world}
        dp, sp = axes.get("dp", 1), axes.get("sp", 1)
        if sp > 1 and self.model.attention != "ring":
            raise ValueError("sp > 1 needs the model built with "
                             "attention='ring' (seq_axis='sp')")
        if T % sp:
            raise ValueError(f"sequence length {T} not divisible by "
                             f"sp={sp}")
        if self.batch_size % dp:
            raise ValueError(f"batch_size={self.batch_size} not divisible "
                             f"by dp={dp}")
        return make_mesh({"dp": dp, "sp": sp})

    def _train(self, dataset: PartitionedDataset,
               shuffle: bool = False) -> Model:
        from distkeras_torch import bridge
        from distkeras_torch.parallel.spmd import make_lm_train_step

        if shuffle:
            dataset = dataset.shuffle(seed=self.seed)
        tokens = np.asarray(dataset.column(self.tokens_col))
        if tokens.ndim != 2:
            raise ValueError(
                f"'{self.tokens_col}' must be [N, T] int token ids, got "
                f"shape {tokens.shape}")
        n_rows, T = tokens.shape
        B = self.batch_size
        if n_rows < B:
            raise ValueError(
                f"dataset of {n_rows} rows is smaller than batch_size={B}")
        if self.params is not None:
            bridge.params_from_jax(self.params, self.model)
        optimizer = get_optimizer(self.worker_optimizer, self.learning_rate)
        step = make_lm_train_step(self.model, optimizer, mesh=self._mesh(T),
                                  window=True)
        n = (n_rows // B) * B
        batches = tokens[:n].reshape(-1, B, T).astype(np.int64)
        W = self.STREAM_GROUP
        # stage everything on the device once when it fits the budget
        if batches.nbytes <= self.stage_limit_bytes:
            batches = torch.as_tensor(batches, device=self.model.device)
        feed = [batches[i:i + W] for i in range(0, len(batches), W)]
        # The reference's windowed step DONATES params and optimizer
        # state, so its caller's buffers die; this port updates the
        # module's parameters in place instead. self.params (the tree
        # handed in, or None) is only replaced once training has finished,
        # so it stays valid if a window raises — the module then holds
        # the partly trained weights.
        history: History = []
        for _epoch in range(self.num_epoch):
            # losses stay on the device until the epoch ends (no per-step
            # host sync)
            epoch_losses = [step(fb) for fb in feed]
            for losses in epoch_losses:
                for loss in losses.float().cpu().numpy():
                    row = {"loss": float(loss)}
                    history.append(row)
                    if self.metrics_writer is not None:
                        self.metrics_writer.log(
                            step=len(history), samples=B * T, **row)
        self.params = bridge.params_to_jax(self.model)
        self.history = history
        self.executor_histories = [history]
        return Model(self._single_chip_twin())
