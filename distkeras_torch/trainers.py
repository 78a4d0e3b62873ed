"""Trainers — the port of :mod:`distkeras_tpu.trainers`: the
:class:`Trainer` base (timing, telemetry, JSONL metrics, the profiler
trace, history), the dist-keras trainers of the in-memory path —
:class:`SingleTrainer`, :class:`EnsembleTrainer`,
:class:`AveragingTrainer` and :class:`DataParallelTrainer` — and
:class:`LMTrainer` over a dp x sp mesh.

A PyTorch module holds its own weights, so a trainer trains its model
(or, for the ensemble family, twins of it built from its configuration)
in place; ``params=`` takes the reference's flax-layout numpy tree and
loads it first, and after training ``trainer.params`` is the trained
tree in the same layout. The dist-keras trainers run
:class:`~distkeras_torch.workers.SequentialWorker` epochs (one window of
steps each, read back once); ``DataParallelTrainer`` runs the same worker
on every rank of a ``torch.distributed`` world with the gradients
averaged over it.

``LMTrainer`` trains a :class:`~distkeras_torch.models.TransformerLM`
with :func:`distkeras_torch.parallel.spmd.make_lm_train_step` in windows
of :attr:`LMTrainer.STREAM_GROUP` steps, keeping each window's losses on
the device until the epoch ends; ``axes={"dp": d, "sp": s}`` shards it
over the ``d * s`` processes of the ``torch.distributed`` world (one
process on one device when both are 1).

Not ported yet, and raising with their ROADMAP item: the parameter-server
trainers (A9), ``checkpointer=`` (A9), disk-sharded datasets (A9),
``serialize`` (A1), ``LMTrainer``'s ``tp``, ``pp`` and ``ep`` axes and
pipeline ``microbatches`` (A10); an MoE model (A10) raises where it is
built.
"""

from __future__ import annotations

import time
import warnings
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from distkeras_torch.data.dataset import PartitionedDataset
from distkeras_torch.models.wrapper import Model
from distkeras_torch.utils.history import History, average_histories
from distkeras_torch.utils.losses import get_optimizer
from distkeras_torch.workers import SequentialWorker, batch_partition


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
        # observability: metrics_path= writes per-step JSONL
        # (MetricsWriter); profile_dir= runs train() inside a
        # torch.profiler trace written there
        self.metrics_path = metrics_path
        self.profile_dir = profile_dir
        self.metrics_writer = None
        self._trace_cm = None
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
        if self.profile_dir is not None:
            from distkeras_torch.utils.profiling import trace

            cm = trace(self.profile_dir)
            cm.__enter__()
            # set only after a successful start, so a failed one is never
            # stopped
            self._trace_cm = cm

    def record_training_end(self):
        self._t_end = time.time()
        from distkeras_torch import telemetry

        telemetry.get_registry().gauge(
            "train_last_run_seconds",
            "wall-clock duration of the most recent train() call",
            labelnames=("trainer",),
        ).labels(trainer=type(self).__name__).set(
            round(self._t_end - self._t_start, 3))
        if self._trace_cm is not None:
            self._trace_cm.__exit__(None, None, None)
            self._trace_cm = None
        if self.metrics_writer is not None:
            tp = self.metrics_writer.throughput()
            if tp is not None:
                self.metrics_writer.summary(
                    "throughput", samples_per_sec=round(tp, 2),
                    training_time=round(self.get_training_time(), 4))
            self.metrics_writer.close()

    def train(self, dataset: PartitionedDataset, shuffle: bool = False):
        """Run training (reference: Trainer.train). The timing, trace and
        metrics lifecycle is managed here so a failing run still stops the
        profiler and closes the metrics file; subclasses implement
        :meth:`_train`."""
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

    # -- params ------------------------------------------------------------

    def ensure_params(self) -> dict:
        """The initial weights as a flax-layout numpy tree: ``params=``
        when given, else the model's own (a PyTorch module initializes at
        construction, from its ``seed``; flax needs a data sample)."""
        if self.params is None:
            from distkeras_torch import bridge

            self.params = bridge.params_to_jax(self.model)
        return self.params

    def worker_kwargs(self) -> dict:
        return dict(
            optimizer=self.worker_optimizer,
            learning_rate=self.learning_rate,
            loss=self.loss,
            metrics=self.metrics,
            features_col=self.features_col,
            label_col=self.label_col,
            batch_size=self.batch_size,
            num_epoch=self.num_epoch,
            stage_limit_bytes=self.stage_limit_bytes,
        )

    def _twin(self, seed: int):
        """A fresh module of the model's configuration on its device,
        initialized from ``seed``."""
        return type(self.model)(device=self.model.device, seed=seed,
                                **self.model.config())

    def serialize(self) -> dict:
        raise NotImplementedError(
            "Trainer.serialize (the msgpack model blob) is not ported yet "
            "(ROADMAP A1)")

    def _train(self, dataset: PartitionedDataset, shuffle: bool = False):
        raise NotImplementedError


class SingleTrainer(Trainer):
    """Non-distributed baseline (reference: trainers.py · SingleTrainer):
    coalesce to one partition, run one sequential worker over it. Trains
    the model in place and returns it as a :class:`Model`."""

    def _train(self, dataset: PartitionedDataset,
               shuffle: bool = False) -> Model:
        if shuffle:
            dataset = dataset.shuffle(seed=self.seed)
        dataset = dataset.coalesce(1)
        worker = SequentialWorker(self.model, self.params,
                                  **self.worker_kwargs())
        worker.metrics_writer = self.metrics_writer
        self.params, history = worker.train(0, dataset.partition(0))
        self.executor_histories = [history]
        self.history = history
        return Model(self.model)


class _StackedModelTrainer(Trainer):
    """Shared machinery of EnsembleTrainer / AveragingTrainer: k models
    trained independently on k partitions.

    The reference stacks the k models' parameters on a leading axis and
    vmaps one epoch program over them, sharded over its devices. On one
    card the port trains k twin modules, each with its own optimizer,
    through the same window step, one after another (ROADMAP A7b batches
    them into one program). As in the reference, the models advance in
    lock step: every partition is truncated to the shortest one's batch
    count, with a ``RuntimeWarning`` when that drops batches."""

    def _stacked_train(self, dataset: PartitionedDataset, inits: list,
                       seeds: list, shuffle: bool) -> list:
        """Train twin ``i``, built from ``seeds[i]``, from ``inits[i]`` (a
        flax tree, or None for the twin's own weights) on partition ``i``;
        returns the trained modules."""
        k = len(inits)
        if shuffle:
            dataset = dataset.shuffle(seed=self.seed)
        dataset = dataset.repartition(k)
        xs, ys = [], []
        for i in range(k):
            xb, yb = batch_partition(dataset.partition(i), self.features_col,
                                     self.label_col, self.batch_size)
            xs.append(xb)
            ys.append(yb)
        nb = min(len(x) for x in xs)
        dropped = sum(len(x) - nb for x in xs)
        if dropped:
            warnings.warn(
                f"ensemble lock-step truncated {dropped} trailing "
                f"batch(es) across {k} models (shortest partition has "
                f"{nb}); pick batch_size/partitions that divide evenly "
                "to keep them",
                RuntimeWarning,
            )
        n = nb * self.batch_size
        modules, histories = [], []
        for i, (init, seed) in enumerate(zip(inits, seeds)):
            module = self._twin(seed)
            worker = SequentialWorker(module, init, **self.worker_kwargs())
            worker.metrics_writer = self.metrics_writer
            part = {self.features_col: xs[i][:nb].reshape(
                        (n,) + xs[i].shape[2:]),
                    self.label_col: ys[i][:nb].reshape(
                        (n,) + ys[i].shape[2:])}
            _, history = worker.train(i, part)
            modules.append(module)
            histories.append(history)
        self.executor_histories = histories
        return modules


class EnsembleTrainer(_StackedModelTrainer):
    """Train k independent models on k partitions (reference: trainers.py
    · EnsembleTrainer). Returns a list of :class:`Model`; model ``i``
    starts from a twin initialized with seed ``seed + i``, or from
    ``params[i]`` when ``params=`` is a list of k flax trees."""

    def __init__(self, *args, num_models: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_models = num_models

    def _train(self, dataset: PartitionedDataset,
               shuffle: bool = False) -> List[Model]:
        k = self.num_models
        inits = self.params if isinstance(self.params, list) else [None] * k
        if len(inits) != k:
            raise ValueError(f"params= holds {len(inits)} trees for "
                             f"num_models={k}")
        seeds = [self.seed + i for i in range(k)]
        return [Model(m) for m in self._stacked_train(dataset, inits, seeds,
                                                      shuffle)]


class AveragingTrainer(_StackedModelTrainer):
    """One-shot parameter averaging (reference: trainers.py ·
    AveragingTrainer): k models train from a common init (``params=``, or
    the model's own weights) on k partitions; the model is then loaded
    with their f32 mean and returned."""

    def __init__(self, *args, num_workers: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_workers = num_workers

    def _train(self, dataset: PartitionedDataset,
               shuffle: bool = False) -> Model:
        from distkeras_torch import bridge

        k = self.num_workers
        modules = self._stacked_train(dataset, [self.ensure_params()] * k,
                                      [self.seed] * k, shuffle)
        trained = [dict(m.named_parameters()) for m in modules]
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                mean = torch.stack([t[name].float() for t in trained]
                                   ).mean(dim=0)
                p.copy_(mean.to(p.dtype))
        self.params = bridge.params_to_jax(self.model)
        return Model(self.model)


class DataParallelTrainer(Trainer):
    """Synchronous data parallelism (reference: trainers.py ·
    DataParallelTrainer) over the ``torch.distributed`` world: one process
    per card, every rank calling ``train()`` on the SAME dataset (the
    process form of the reference's one program over its ``dp`` mesh).

    Each step takes a global batch of ``n * batch_size`` rows (``n`` the
    world size), of which rank ``r`` trains on rows ``[r * batch_size,
    (r + 1) * batch_size)`` — the reference's ``P(None, "dp")`` — with
    replicated parameters (rank 0's at the start), gradients averaged
    over the world (one all-reduce a step), and loss and metrics the
    mean over ranks. A world of one (no process group) runs no
    collective. ``num_workers`` defaults to the world size and must
    equal it."""

    def __init__(self, *args, num_workers: Optional[int] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_workers = num_workers

    def _mesh(self):
        import torch.distributed as dist

        from distkeras_torch.parallel.mesh import make_mesh

        world = (dist.get_world_size() if dist.is_available()
                 and dist.is_initialized() else 1)
        n = self.num_workers or world
        if n != world:
            raise ValueError(
                f"num_workers={n} but the torch.distributed world has "
                f"{world} process(es): DataParallelTrainer runs one worker "
                f"per process")
        return make_mesh({"dp": n})

    def _train(self, dataset: PartitionedDataset,
               shuffle: bool = False) -> Model:
        if shuffle:
            dataset = dataset.shuffle(seed=self.seed)
        mesh = self._mesh()
        n, r = mesh.axis_size("dp"), mesh.index("dp")
        B = self.batch_size
        xb, yb = batch_partition(dataset.repartition(1).partition(0),
                                 self.features_col, self.label_col, B * n)
        # this rank's slice of every global batch, in step order
        local = {self.features_col: xb[:, r * B:(r + 1) * B].reshape(
                     (-1,) + xb.shape[2:]),
                 self.label_col: yb[:, r * B:(r + 1) * B].reshape(
                     (-1,) + yb.shape[2:])}
        worker = SequentialWorker(self.model, self.params,
                                  group=mesh.group("dp"),
                                  **self.worker_kwargs())
        self.params, history = worker.train(r, local)
        if self.metrics_writer is not None:
            for t, row in enumerate(history):
                self.metrics_writer.log(step=t + 1, samples=B * n, **row)
        self.history = history
        self.executor_histories = [history]
        return Model(self.model)


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
