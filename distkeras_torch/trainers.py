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

The parameter-server family (:class:`DistributedTrainer`: ``DOWNPOUR``,
``ADAG``, ``DynSGD``, ``AEASGD``, ``EAMSGD``, ``EASGD``) runs one host
thread per worker against a :mod:`~distkeras_torch.parameter_servers`
center on the first of ``devices``, each worker a copy of the model on
``devices[i % n]``; with ``spmd=True`` the lock-step engine
(:func:`_train_lockstep_spmd`) runs every worker in this thread instead,
a window of steps each and then one round over all of them. ``remote_ps=
(host, port)`` trains against a :class:`~distkeras_torch.networking.
ParameterServerService` elsewhere. ``checkpointer=``
(:class:`~distkeras_torch.checkpoint.Checkpointer`) saves and resumes
``SingleTrainer``, ``DataParallelTrainer``, ``LMTrainer`` and the PS
family. Under :func:`distkeras_torch.runtime.initialize` (a multi-process
:class:`~distkeras_torch.job_deployment.Job`) the PS family wires itself:
the coordinator owns and serves the center, the other processes train
against it through a proxy.

A :class:`~distkeras_torch.data.shard_io.ShardedDataset` trains
everywhere a PartitionedDataset does: ``DataParallelTrainer``,
``LMTrainer`` and the PS family stream it from disk shard by shard, the
others load it. ``LMTrainer(checkpointer=)`` saves its parameters and
optimizer state every epoch and resumes from them.

``LMTrainer`` trains over dp x sp x tp, over dp x pp x tp (the GPipe
step, ``microbatches``) and, for an MoE model with ``ep_size > 1``,
over dp x ep.
"""

from __future__ import annotations

import copy
import threading
import time
import warnings
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from distkeras_torch import parameter_servers as ps_mod
from distkeras_torch import workers as workers_mod
from distkeras_torch.data.dataset import PartitionedDataset
from distkeras_torch.data.shard_io import ShardedDataset
from distkeras_torch.models.wrapper import Model
from distkeras_torch.ops import rules
from distkeras_torch.utils.history import History, average_histories
from distkeras_torch.utils.losses import get_optimizer
from distkeras_torch.workers import (SequentialWorker, _rows,
                                     batch_partition, opt_state_to_host)


def _as_partitioned(dataset) -> PartitionedDataset:
    """A PartitionedDataset as it is, a ShardedDataset loaded; anything
    else raises."""
    if isinstance(dataset, ShardedDataset):
        return dataset.load()
    if isinstance(dataset, PartitionedDataset):
        return dataset
    raise TypeError(f"train() takes a PartitionedDataset or a "
                    f"ShardedDataset; got {type(dataset).__name__}")


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
        self.checkpointer = checkpointer
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
        """Accept a :class:`~distkeras_torch.data.shard_io.ShardedDataset`
        anywhere a PartitionedDataset works (reference: Trainer.
        _coerce_dataset). Trainers that stream it (DataParallelTrainer,
        the PS family, LMTrainer) override this to pass it through; the
        rest materialize it."""
        return _as_partitioned(dataset)

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
        """The reference's model blob (:func:`distkeras_torch.utils.serde.
        serialize_model`) of the model and ``self.params``."""
        from distkeras_torch.models.registry import model_spec
        from distkeras_torch.utils.serde import serialize_model

        return serialize_model(model_spec(self.model), self.ensure_params())

    def _epoch_checkpoints(self, worker, rank: int = 0) -> int:
        """Resume ``worker`` (a :class:`SequentialWorker`) from the latest
        checkpoint — weights, optimizer state, the epochs left — and save
        after each epoch it trains (only ``rank`` 0 writes). Returns the
        epoch it resumes at."""
        from distkeras_torch import bridge

        ckpt = self.checkpointer
        if ckpt is None:
            return 0
        step, state = ckpt.restore()
        start = 0
        if state is not None:
            worker.params = state["params"]
            worker.initial_opt_state = state["opt_state"] or None
            start = int(state["extra"].get("epoch", step))
        worker.num_epoch = max(0, self.num_epoch - start)

        def on_epoch(epoch, w):
            done = start + epoch + 1
            if rank == 0:
                ckpt.maybe_save(done, bridge.params_to_jax(w.module),
                                opt_state_to_host(w.opt),
                                extra={"epoch": done},
                                force=done == self.num_epoch)

        worker.epoch_callback = on_epoch
        return start

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
        self._epoch_checkpoints(worker)
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
        from distkeras_torch.parallel.mesh import default_mesh

        try:
            return default_mesh(self.num_workers)
        except ValueError as e:
            raise ValueError(f"{e}; DataParallelTrainer runs one worker "
                             f"per process") from None

    def _coerce_dataset(self, dataset):
        return dataset  # _train streams a ShardedDataset from disk

    # batches per window on the disk-streaming path: one metrics read
    # each, the epoch's windows read back once it ends
    STREAM_GROUP = 16

    def _train(self, dataset, shuffle: bool = False) -> Model:
        mesh = self._mesh()
        n, r = mesh.axis_size("dp"), mesh.index("dp")
        B = self.batch_size
        worker = SequentialWorker(self.model, self.params,
                                  group=mesh.group("dp"),
                                  **self.worker_kwargs())
        start = self._epoch_checkpoints(worker, rank=r)
        if isinstance(dataset, ShardedDataset):
            windows = self._stream_windows(dataset, worker, n, r, shuffle,
                                           start)
            self.params, history = worker.train_stream(r, windows)
        else:
            dataset = _as_partitioned(dataset)
            if shuffle:
                dataset = dataset.shuffle(seed=self.seed)
            xb, yb = batch_partition(dataset.repartition(1).partition(0),
                                     self.features_col, self.label_col,
                                     B * n)
            # this rank's slice of every global batch, in step order
            local = {self.features_col: xb[:, r * B:(r + 1) * B].reshape(
                         (-1,) + xb.shape[2:]),
                     self.label_col: yb[:, r * B:(r + 1) * B].reshape(
                         (-1,) + yb.shape[2:])}
            self.params, history = worker.train(r, local)
        if self.metrics_writer is not None:
            for t, row in enumerate(history):
                self.metrics_writer.log(step=t + 1, samples=B * n, **row)
        self.history = history
        self.executor_histories = [history]
        return Model(self.model)

    def _stream_windows(self, sds: ShardedDataset, worker, n: int, r: int,
                        shuffle: bool, start: int):
        """The disk-streaming feed (reference: DataParallelTrainer._train's
        sharded branch): ``windows(epoch)`` yields lists of up to
        :attr:`STREAM_GROUP` device batches of this rank's rows. Shards
        stream through the epoch without ever merging into one host
        array, reshuffled two-level per epoch when ``shuffle``; the loader
        casts f32 features to a bf16 model's dtype and assembles into
        pinned memory, copied with ``non_blocking``.

        Each of the ``n`` ranks streams the disjoint stride
        ``range(r, num_shards, n)`` of the directory, every stride capped
        at the smallest one's batch count, so every rank enters the
        gradient all-reduce equally often."""
        B = self.batch_size
        shards, cap = None, None
        if n > 1:
            if sds.num_shards < n:
                raise ValueError(
                    f"sharded multi-process training needs >= {n} shards "
                    f"(one per process); directory has {sds.num_shards} — "
                    "rewrite with a smaller rows_per_shard")
            shards = list(range(r, sds.num_shards, n))
            cap = min(sum(sds.shard_rows[s]
                          for s in range(p, sds.num_shards, n)) // B
                      for p in range(n))
            if cap == 0:
                raise ValueError(
                    "some process's shard slice holds fewer rows than one "
                    f"batch (batch_size={self.batch_size}) — use smaller "
                    "batches or rebalance the shard directory")
        dev = worker.device
        cast = ([self.features_col]
                if getattr(self.model, "dtype", None) == torch.bfloat16
                else None)
        pin = dev.type == "cuda"

        def put(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
            return t.to(dev, non_blocking=pin)

        def windows(epoch):
            seed = self.seed + start + epoch if shuffle else None
            xs, ys = [], []
            for i, b in enumerate(sds.batches(B, shuffle_seed=seed,
                                              cast_bf16=cast, shards=shards,
                                              pin_memory=pin)):
                if cap is not None and i >= cap:
                    break
                xs.append(put(b[self.features_col]))
                ys.append(put(b[self.label_col]))
                if len(xs) == self.STREAM_GROUP:
                    yield xs, ys
                    xs, ys = [], []
            if xs:
                yield xs, ys

        return windows


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

    ``axes`` names ``dp``, ``sp`` and ``tp`` (default ``{"dp": world
    size}``); their product must be the size of the ``torch.distributed``
    world, whose ranks each run ``train()`` on the SAME dataset (the
    process form of the reference's single program over the mesh), laid
    out dp-major, tp fastest. ``sp > 1`` needs ``attention='ring'``;
    ``tp > 1`` a model built with ``tp_size = tp`` inside ``with
    make_mesh({"dp": .., "sp": .., "tp": ..}):`` (the same layout), each
    rank holding its slice of the heads and the MLP. The returned
    :class:`Model` holds the standard-attention twin of a ring model,
    sharing its parameters (a tp model runs inside its mesh);
    ``params`` and checkpoints are always the plain, unsharded layout.

    A :class:`~distkeras_torch.data.shard_io.ShardedDataset` whose tokens
    fit ``stage_limit_bytes`` is loaded and staged like an in-memory
    one; a bigger one streams from disk in windows, shard by shard (the
    same trajectory as in memory; ``shuffle=True`` becomes the two-level
    per-epoch reshuffle). In a world of several processes it always
    streams: the ranks of one dp coordinate (a replica group,
    :func:`~distkeras_torch.parallel.mesh.replica_groups`) read the same
    stride of shards, ``batch_size / dp`` rows a step, every stride
    capped at the smallest one's step count.

    ``checkpointer=`` saves the parameters, the optimizer state (AdamW's
    bf16 first moment and its step count included) and ``{"epoch"}``
    after every epoch, and a new trainer over the same directory resumes
    after the last saved epoch: the same trajectory as a run that never
    stopped. Both are saved in the plain layout (a tp model's gathered),
    so a checkpoint resumes at any tp degree.

    Pipeline parallelism: ``axes={"pp": n, "dp": m[, "tp": k]}`` lays the
    world out ``{"dp", "pp", "tp"}`` (dp major, tp fastest) and trains
    the GPipe step (:mod:`distkeras_torch.parallel.pipeline`): each step
    takes ``batch_size`` rows as ``microbatches`` microbatches (default
    ``4 * pp``; ``batch_size`` must divide by it), each rank its stage's
    blocks. Expert parallelism: an MoE model with ``ep_size > 1`` needs
    ``axes={"dp": m, "ep": n}`` and trains the (dp, ep) MoE step
    (:func:`~distkeras_torch.parallel.spmd.make_moe_lm_train_step`).
    sp is refused with either, and tp with ep. Both checkpoint in the
    plain layout too: a pp or ep checkpoint resumes on any mesh."""

    # optimizer steps per window (one device-side loop, losses kept on
    # the device)
    STREAM_GROUP = 16

    def __init__(self, model, *args, axes: Optional[dict] = None,
                 tokens_col: str = "tokens",
                 microbatches: Optional[int] = None, **kwargs):
        super().__init__(model, *args, **kwargs)
        # e.g. {"dp": 4, "sp": 2}, {"dp": 2, "sp": 2, "tp": 2},
        # {"pp": 2, "dp": 4} (GPipe over the layer stack) or {"dp": 2,
        # "ep": 4} (an MoE model's experts)
        self.axes = axes
        self.tokens_col = tokens_col
        # pipeline (pp) only: microbatches per optimizer step (GPipe M);
        # default 4*pp keeps the bubble (pp-1)/(M+pp-1) under ~20%
        self.microbatches = microbatches
        if microbatches is not None and (axes or {}).get("pp", 1) <= 1:
            raise ValueError(
                "microbatches only applies to pipeline training — set "
                "axes={'pp': ..., 'dp': ...} (or drop microbatches)")

    def _coerce_dataset(self, dataset):
        return dataset  # _maybe_materialize decides: load or stream

    @staticmethod
    def _world() -> int:
        import torch.distributed as dist

        return (dist.get_world_size() if dist.is_available()
                and dist.is_initialized() else 1)

    def _maybe_materialize(self, dataset):
        """``(dataset, sharded)``: a sharded corpus that fits the staging
        budget is loaded, so it is staged on the device once; a bigger
        one streams. Several processes always stream (after a load every
        process would feed every row)."""
        if not isinstance(dataset, ShardedDataset):
            return _as_partitioned(dataset), False
        T = self._sharded_seq_len(dataset)
        itemsize = np.dtype(
            dataset.meta["columns"][self.tokens_col]["dtype"]).itemsize
        small = dataset.num_rows * T * itemsize <= self.stage_limit_bytes
        if small and self._world() == 1:
            return dataset.load(), False
        return dataset, True

    def _sharded_seq_len(self, sds: ShardedDataset) -> int:
        """Sequence length from the shard metadata (no reads)."""
        if self.tokens_col not in sds.columns:
            raise ValueError(
                f"shard directory has no '{self.tokens_col}' column; "
                f"available: {sds.columns}")
        _, row_shape = sds._col_info(self.tokens_col)
        if len(row_shape) != 1:
            raise ValueError(
                f"'{self.tokens_col}' must be [N, T] token ids; shard rows "
                f"have shape {row_shape}")
        return row_shape[0]

    def _shard_slice(self, sds: ShardedDataset, rows_per_step: int,
                     group=None):
        """``(shard indices, per-epoch step cap)`` of this process: one
        disjoint stride of shards per replica group (``group=(gid,
        n_groups)``), every stride capped at the smallest stride's step
        count so the collective step cannot fall out of step; a single
        process streams everything, uncapped."""
        if group is None or self._world() <= 1:
            return None, None
        gid, n_strides = group
        if sds.num_shards < n_strides:
            raise ValueError(
                f"sharded multi-process LM training needs >= {n_strides} "
                f"shards (one per feed stride); directory has "
                f"{sds.num_shards}")
        cap = min(sum(sds.shard_rows[s] for s in range(g, sds.num_shards,
                                                       n_strides))
                  // rows_per_step for g in range(n_strides))
        if cap == 0:
            raise ValueError(
                "some stride's shard slice holds fewer rows than one "
                f"step's batch ({rows_per_step}) — use smaller batches or "
                "rebalance the shard directory")
        return list(range(gid, sds.num_shards, n_strides)), cap

    def _stream_steps(self, sds: ShardedDataset, rows_per_step: int,
                      shuffle: bool, epoch: int, my_shards, cap):
        """``[rows_per_step, T]`` int64 token tensors of one epoch, read
        shard by shard (host memory of the order of a shard, not of the
        corpus), reshuffled two-level with a per-epoch seed."""
        seed = self.seed + epoch if shuffle else None
        for n, b in enumerate(sds.batches(rows_per_step, shuffle_seed=seed,
                                          shards=my_shards)):
            if cap is not None and n >= cap:
                break
            yield torch.from_numpy(np.ascontiguousarray(
                b[self.tokens_col], np.int64))

    def _single_chip_twin(self):
        """A standard-attention twin of the model sharing its parameters
        (the model itself unless it is a ring model): what the returned
        :class:`Model` predicts with, outside any mesh. The reference
        also initializes through it, because its ring traces only inside
        ``shard_map``; here the parameters exist from construction."""
        if self.model.attention != "ring":
            return self.model
        return self.model.clone(attention="standard")

    def _optimizer(self, params):
        opt = get_optimizer(self.worker_optimizer, self.learning_rate)
        return opt if isinstance(opt, torch.optim.Optimizer) else opt(params)

    # Each path returns ``(mesh, optimizer, shard, step, plain_state,
    # reshape)``: ``shard`` maps a plain-layout optimizer state onto the
    # optimizer (None: it is already that layout), ``plain_state()`` gives
    # the (params, optimizer state) a checkpoint stores, ``reshape`` turns
    # a window of ``[W, rows, T]`` batches into the step's feed.
    # ``local`` says each dp coordinate streams its own rows.

    def _lm_plan(self, axes: dict, T: int, local: bool):
        """The dp x sp (x tp) path (the reference's ``make_lm_train_step``
        branch)."""
        from distkeras_torch import bridge
        from distkeras_torch.parallel.mesh import make_mesh
        from distkeras_torch.parallel.spmd import (gather_opt_state,
                                                   make_lm_train_step,
                                                   shard_opt_state)

        dp, sp, tp = axes.get("dp", 1), axes.get("sp", 1), axes.get("tp", 1)
        extra = {k: v for k, v in axes.items()
                 if k not in ("dp", "sp", "tp") and v != 1}
        if extra:
            raise ValueError(f"LMTrainer axes {extra}: the mesh takes 'dp', "
                             f"'sp' and 'tp' (with 'pp': pipeline; 'ep': an "
                             f"MoE model with ep_size > 1)")
        if self.model.tp_size != tp:
            raise ValueError(f"model.tp_size={self.model.tp_size} != mesh "
                             f"tp size {tp}")
        if sp > 1 and self.model.attention != "ring":
            raise ValueError("sp > 1 needs the model built with "
                             "attention='ring' (seq_axis='sp')")
        if T % sp:
            raise ValueError(f"sequence length {T} not divisible by "
                             f"sp={sp}")
        if self.batch_size % dp:
            raise ValueError(f"batch_size={self.batch_size} not divisible "
                             f"by dp={dp}")
        mesh = make_mesh({"dp": dp, "sp": sp, "tp": tp} if tp > 1
                         else {"dp": dp, "sp": sp})
        optimizer = self._optimizer(self.model.parameters())
        step = make_lm_train_step(self.model, optimizer, mesh=mesh,
                                  window=True,
                                  tp_axis="tp" if tp > 1 else None,
                                  local_batch=local)

        def plain_state():
            with mesh:
                return (bridge.params_to_jax(self.model),
                        gather_opt_state(optimizer, self.model, mesh))

        shard = ((lambda sd: shard_opt_state(sd, optimizer, self.model))
                 if tp > 1 else None)
        return mesh, optimizer, shard, step, plain_state, lambda b: b

    def _moe_plan(self, axes: dict, T: int, local: bool):
        """The (dp, ep) path of an MoE model with ``ep_size > 1``."""
        from distkeras_torch import bridge
        from distkeras_torch.parallel.mesh import make_mesh
        from distkeras_torch.parallel.spmd import (gather_opt_state,
                                                   make_moe_lm_train_step,
                                                   shard_opt_state)

        if "ep" not in axes:
            raise ValueError("MoE model (ep_size > 1) needs an 'ep' mesh "
                             "axis, e.g. axes={'dp': 2, 'ep': 4}")
        for bad in ("sp", "tp"):
            if axes.pop(bad, 1) > 1:
                raise ValueError(f"MoE training shards (dp, ep) only; drop "
                                 f"{bad}")
        axes.setdefault("dp", 1)
        if self.batch_size % (axes["dp"] * axes["ep"]):
            raise ValueError(f"batch_size={self.batch_size} not divisible "
                             f"by dp x ep={axes['dp'] * axes['ep']}")
        mesh = make_mesh(axes)
        optimizer = self._optimizer(self.model.parameters())
        step = make_moe_lm_train_step(self.model, optimizer, mesh=mesh,
                                      window=True, local_batch=local)

        def plain_state():
            with mesh:
                return (bridge.params_to_jax(self.model),
                        gather_opt_state(optimizer, self.model, mesh))

        return (mesh, optimizer,
                lambda sd: shard_opt_state(sd, optimizer, self.model),
                step, plain_state, lambda b: b)

    def _pp_plan(self, axes: dict, T: int, local: bool):
        """The GPipe path: ``axes={"pp": n, "dp": m[, "tp": k]}``."""
        from distkeras_torch import bridge
        from distkeras_torch.parallel.mesh import make_mesh
        from distkeras_torch.parallel.pipeline import (check_pp_model,
                                                       gather_pp_opt_state,
                                                       make_pp_lm_train_step,
                                                       release_blocks,
                                                       shard_pp_opt_state,
                                                       sync_blocks)

        pp, tp = axes.pop("pp"), axes.pop("tp", 1)
        for bad in ("sp", "ep"):
            if axes.pop(bad, 1) > 1:
                raise ValueError(f"pipeline training shards (pp, dp, tp) "
                                 f"only; drop '{bad}'")
        dp = axes.pop("dp", 1)
        if axes:
            raise ValueError(f"unknown mesh axes with pp: {sorted(axes)}")
        check_pp_model(self.model, pp, tp)
        M = self.microbatches or 4 * pp
        B = self.batch_size
        if B % M:
            raise ValueError(f"batch_size={B} not divisible by "
                             f"microbatches={M}")
        if (B // M) % dp:
            raise ValueError(f"microbatch of {B // M} rows (batch_size/"
                             f"{M}) not divisible by dp={dp}")
        # dp major, tp innermost: the per-matmul all-reduces ride the
        # nearest ranks, the per-tick permute the next ring out
        mesh = make_mesh({"dp": dp, "pp": pp, "tp": tp})
        step = make_pp_lm_train_step(
            self.model, get_optimizer(self.worker_optimizer,
                                      self.learning_rate), mesh,
            tp_axis="tp" if tp > 1 else None, window=True,
            local_batch=local)
        stage, optimizer = step.stage, step.optimizer

        def plain_state():
            # the model is whole only while its state is read
            with mesh:
                sync_blocks(self.model, mesh)
                out = (bridge.params_to_jax(self.model),
                       gather_pp_opt_state(optimizer, stage, self.model,
                                           mesh))
            release_blocks(self.model, stage.layers)
            return out

        def as_micro(b):  # [W, rows, T] -> [W, M, rows / M, T]
            return b.reshape(b.shape[0], M, b.shape[1] // M, b.shape[2])

        return (mesh, optimizer,
                lambda sd: shard_pp_opt_state(sd, optimizer, stage,
                                              self.model),
                step, plain_state, as_micro)

    def _restore_params(self):
        """Load the latest checkpoint's parameters into the model, before
        a plan shards the optimizer or frees blocks; returns ``(the epoch
        it resumes at, its plain-layout optimizer state or None)``."""
        from distkeras_torch import bridge

        if self.checkpointer is None:
            return 0, None
        step, state = self.checkpointer.restore()
        if state is None:
            return 0, None
        bridge.params_from_jax(state["params"], self.model)
        return (int(state["extra"].get("epoch", step)),
                state["opt_state"] or None)

    def _train(self, dataset, shuffle: bool = False) -> Model:
        from distkeras_torch import bridge
        from distkeras_torch.parallel.mesh import replica_groups
        from distkeras_torch.parallel.pipeline import sync_blocks

        dataset, sharded = self._maybe_materialize(dataset)
        if sharded:
            T, n_rows = self._sharded_seq_len(dataset), dataset.num_rows
        else:
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
        axes = dict(self.axes) if self.axes else {"dp": self._world()}
        pp = axes.get("pp", 1) > 1
        plan = (self._pp_plan if pp else self._moe_plan
                if getattr(self.model, "ep_size", 1) > 1 else self._lm_plan)
        # every rank loads the same checkpoint, so the replicas the step
        # broadcasts at its start stay equal
        start, opt_state = self._restore_params()
        # several processes stream: each replica group (dp coordinate)
        # reads its own stride of shards
        local = sharded and self._world() > 1
        mesh, optimizer, shard, step, plain_state, reshape = plan(axes, T,
                                                                  local)
        if opt_state is not None:
            optimizer.load_state_dict(opt_state if shard is None
                                      else shard(opt_state))
        groups = replica_groups(mesh, "dp") if self._world() > 1 else None
        first = all(c == 0 for c in mesh.coords.values())
        # ranks that must join the collective gathers of a checkpoint
        collective_save = mesh.group() is not None
        W = self.STREAM_GROUP
        dev = self.model.device
        if sharded:
            rows = B // groups[1] if groups is not None else B
            my_shards, cap = self._shard_slice(dataset, rows, group=groups)

            def feed(epoch):
                window = []
                for tb in self._stream_steps(dataset, rows, shuffle, epoch,
                                             my_shards, cap):
                    window.append(tb)
                    if len(window) == W:
                        yield reshape(torch.stack(window))
                        window = []
                if window:
                    yield reshape(torch.stack(window))
        else:
            n = (n_rows // B) * B
            batches = tokens[:n].reshape(-1, B, T).astype(np.int64)
            # stage everything on the device once when it fits the budget
            if batches.nbytes <= self.stage_limit_bytes:
                batches = torch.as_tensor(batches, device=dev)
            else:
                batches = torch.from_numpy(batches)
            windows = [reshape(batches[i:i + W])
                       for i in range(0, len(batches), W)]

            def feed(epoch):
                return windows
        pin = dev.type == "cuda"
        # The reference's windowed step DONATES params and optimizer
        # state, so its caller's buffers die; this port updates the
        # module's parameters in place instead. self.params (the tree
        # handed in, or None) is only replaced once training has finished,
        # so it stays valid if a window raises — the module then holds
        # the partly trained weights.
        history: History = []
        for epoch in range(start, self.num_epoch):
            # losses stay on the device until the epoch ends (no per-step
            # host sync)
            epoch_losses = []
            for fb in feed(epoch):
                if isinstance(fb, torch.Tensor) and fb.device != dev:
                    fb = (fb.pin_memory() if pin else fb).to(
                        dev, non_blocking=pin)
                epoch_losses.append(step(fb))
            for losses in epoch_losses:
                for loss in losses.float().cpu().numpy():
                    row = {"loss": float(loss)}
                    history.append(row)
                    if self.metrics_writer is not None:
                        self.metrics_writer.log(
                            step=len(history), samples=B * T, **row)
            if self.checkpointer is not None and (first or collective_save):
                params, opt_state = plain_state()
                if first:
                    self.checkpointer.maybe_save(
                        epoch + 1, params, opt_state,
                        extra={"epoch": epoch + 1},
                        force=epoch + 1 == self.num_epoch)
        with mesh:
            if pp:
                sync_blocks(self.model, mesh)
            self.params = bridge.params_to_jax(self.model)
        self.history = history
        self.executor_histories = [history]
        return Model(self._single_chip_twin())


# -- the parameter-server family ---------------------------------------------


class DistributedTrainer(Trainer):
    """Parameter-server orchestration base (reference: trainers.py ·
    DistributedTrainer): start the PS -> repartition -> one worker per
    partition -> join -> stop the PS -> the center is the trained model.

    Workers are host threads, one per partition, each training its own
    copy of the model on ``devices[i % len(devices)]`` (default: every
    visible card when the model is on one, else the model's device) on
    that device's default stream; the center lives on ``devices[0]``. On
    one card the threads interleave there, which keeps the algorithms'
    staleness exactly. ``max_retries`` restarts a crashed worker from the
    current center (a fresh pull and optimizer, the same id and device),
    so no update is counted twice. ``remote_ps=(host, port)`` makes this
    process a client of a :class:`~distkeras_torch.networking.
    ParameterServerService` instead of the center's owner. After
    training the model holds the center and ``params`` is its flax tree.
    """

    WORKER_CLS = None  # set by subclasses

    def __init__(self, *args, num_workers: int = 2,
                 communication_window: int = 5,
                 remote_ps: Optional[tuple] = None,
                 devices: Optional[Sequence] = None,
                 max_retries: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_workers = num_workers
        self.communication_window = communication_window
        self.max_retries = max_retries
        self.worker_restarts = 0
        self.remote_ps = remote_ps
        self.devices = devices
        self.staleness: Optional[dict] = None
        self.parameter_server = None
        self.workers: List[workers_mod.WindowedWorker] = []

    def _devices(self) -> List[torch.device]:
        if self.devices is not None:
            return [torch.device(d) for d in self.devices]
        dev = self.model.device
        if dev.type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [dev]

    def _center_params(self) -> dict:
        """The initial center as a flax tree under ``params``."""
        p = self.ensure_params()
        return p if "params" in p else {"params": p}

    def _center_tree(self, params=None) -> rules.Tree:
        """``params`` (default: the initial center) as a flat dict of host
        tensors in the model's master dtype: f32, or f64 for a model cast
        to it."""
        dtype = next(self.model.parameters()).dtype
        return rules.to_tensors(params or self._center_params(), "cpu",
                                dtype=dtype)

    # reference: allocate_parameter_server / allocate_worker
    def allocate_parameter_server(self):
        raise NotImplementedError

    def allocate_worker(self, index: int) -> workers_mod.WindowedWorker:
        kwargs = self.worker_kwargs()
        kwargs.update(communication_window=self.communication_window)
        kwargs.update(self.extra_worker_kwargs())
        devices = self._devices()
        # a copy of the model (its per-layer dtypes and master dtype
        # included) on the worker's device; the first pull sets its weights
        module = copy.deepcopy(self.model).to(devices[index % len(devices)])
        return self.WORKER_CLS(module, None, **kwargs)

    def extra_worker_kwargs(self) -> dict:
        return {}

    @property
    def parallelism_factor(self) -> int:
        return 1

    def _restore(self, n_parts: int):
        """The latest checkpoint's center (into ``self.params``), its step,
        and the workers' optimizer states when it holds ``n_parts`` of
        them (else None: a center-only resume)."""
        if self.checkpointer is None or self.checkpointer.latest_step is None:
            return 0, None
        step, state = self.checkpointer.restore()
        self.params = state["params"]
        saved = (state["opt_state"] or {}).get("workers")
        if int(state["extra"].get("n_workers", -1)) != n_parts:
            saved = None
        return step, saved

    def _coerce_dataset(self, dataset):
        return dataset  # _partitions streams a ShardedDataset per worker

    def _partitions(self, dataset, n_parts: int, shuffle: bool):
        """``get_partition(i)``: worker ``i``'s rows. A ShardedDataset is
        read inside the worker's thread (native reads without the
        interpreter lock, so the workers read in parallel): worker ``i``
        takes every ``n_parts``-th shard of the (shuffled) shard order,
        its rows shuffled when ``shuffle``; a restarted worker reads its
        shards again, so host memory holds one partition per live
        worker."""
        if not isinstance(dataset, ShardedDataset):
            dataset = _as_partitioned(dataset)
            if shuffle:
                dataset = dataset.shuffle(seed=self.seed)
            return dataset.repartition(n_parts).partition
        if dataset.num_shards < n_parts:
            raise ValueError(
                f"{dataset.num_shards} shards cannot feed {n_parts} workers "
                "— re-write with more shards (write_shards "
                "rows_per_shard=...)")
        order = (np.random.default_rng(self.seed).permutation(
            dataset.num_shards) if shuffle else np.arange(dataset.num_shards))

        def get_partition(i):
            shards = [dataset.read_shard(int(s)) for s in order[i::n_parts]]
            part = {c: np.concatenate([sh[c] for sh in shards])
                    for c in dataset.columns}
            if shuffle:
                perm = np.random.default_rng(self.seed + 1 + i).permutation(
                    len(next(iter(part.values()))))
                part = {c: v[perm] for c, v in part.items()}
            return part

        return get_partition

    def _train(self, dataset, shuffle: bool = False) -> Model:
        from distkeras_torch import bridge, runtime

        self.worker_restarts = 0  # per run (trainers are reusable)
        n_parts = self.num_workers * self.parallelism_factor
        get_partition = self._partitions(dataset, n_parts, shuffle)
        self.params = self._center_params()
        # single process (owns the center), an explicit remote_ps client,
        # or wired by the runtime: the coordinator owns the center and
        # serves it, every other process proxies to it
        ctx = runtime.current()
        multi = ctx is not None and ctx.num_processes > 1
        is_owner = self.remote_ps is None and (not multi
                                               or ctx.is_coordinator)
        worker_offset = ctx.process_id * n_parts if multi else 0
        if self.checkpointer is not None and not is_owner:
            raise ValueError(
                "checkpointer must live with the process that owns the "
                "center (the coordinator / ParameterServerService host), "
                "not a remote client — pass it there instead")
        restored_step, restored_opt = self._restore(n_parts)
        service = None
        if self.remote_ps is not None:
            from distkeras_torch.networking import RemoteParameterServer

            ps = RemoteParameterServer(*self.remote_ps)
        elif not is_owner:
            from distkeras_torch.networking import RemoteParameterServer

            ps = RemoteParameterServer(*ctx.ps_hostport, secret=ctx.secret)
        else:
            if multi:
                # PS math over the worker population (ADAG's mean, the
                # EASGD barrier) counts every process's workers; set for
                # this allocation only
                self._ps_num_workers = self.num_workers * ctx.num_processes
            try:
                ps = self.allocate_parameter_server()
            finally:
                self.__dict__.pop("_ps_num_workers", None)
            ps.checkpointer = self.checkpointer
            ps.step_offset = restored_step
            if multi:
                from distkeras_torch.networking import ParameterServerService

                host, port = ctx.ps_hostport
                bind = host if host in ("127.0.0.1", "localhost") \
                    else "0.0.0.0"
                service = ParameterServerService(ps, host=bind, port=port,
                                                 secret=ctx.secret)
                service.start()
        self.parameter_server = ps
        ps.start()

        results: List[Optional[History]] = [None] * n_parts
        errors: List[BaseException] = []
        workers = [self.allocate_worker(i) for i in range(n_parts)]
        self.workers = workers
        for i, w in enumerate(workers):
            w.metrics_writer = self.metrics_writer
            if restored_opt is not None:
                w.initial_opt_state = restored_opt[i]
        if self.checkpointer is not None:
            def _worker_states():
                return ({"workers": [_opt_snapshot(w) for w in workers]},
                        {"n_workers": n_parts})

            ps.extra_state_fn = _worker_states
        restart_lock = threading.Lock()

        def run(i: int):
            gi = worker_offset + i  # a worker id unique over the processes
            attempts = 0
            try:
                while True:
                    try:
                        _, history = workers[i].train(gi, get_partition(i),
                                                      ps)
                        results[i] = history
                        return
                    except (KeyboardInterrupt, SystemExit):
                        raise
                    except BaseException as e:
                        if attempts >= self.max_retries:
                            errors.append(e)
                            return
                        attempts += 1
                        # a fresh worker (clean optimizer) on the same
                        # device and id: its first act is a pull of the
                        # current center, so nothing is replayed
                        with restart_lock:
                            self.worker_restarts += 1
                        replacement = self.allocate_worker(i)
                        replacement.metrics_writer = self.metrics_writer
                        workers[i] = replacement
            finally:
                # shrink a synchronous barrier so survivors never deadlock
                ps.leave(gi)

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(n_parts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if is_owner:
            if service is not None and not errors:
                # the other processes still train against this center:
                # wait until each has read its final center
                if not service.wait_for_remote_done(ctx.num_processes - 1):
                    warnings.warn(
                        "timed out waiting for remote processes to read the "
                        "final center — a peer likely died; the returned "
                        "model reflects all commits received so far",
                        RuntimeWarning)
            final = ps.get_model()
        elif errors:
            # no further calls from this process (the leave with a
            # negative id is the process-done sentinel)
            ps.leave(-1 - worker_offset)
            final = None
        else:
            final = ps.get_model()
            ps.leave(-1 - worker_offset)
        ps.stop()
        if service is not None:
            service.stop()
        if self.checkpointer is not None:
            opt_state, extra = ps.extra_state_fn()
            self.checkpointer.maybe_save(
                ps.step_offset + ps.num_updates, final,
                opt_state=opt_state, extra=extra, force=True)
            self.checkpointer.wait()
            ps.extra_state_fn = None
        from distkeras_torch.utils.metrics import staleness_histogram

        log = getattr(ps, "staleness_log", None) or []
        self.staleness = staleness_histogram(log)
        if self.metrics_writer is not None and log:
            self.metrics_writer.summary(
                "staleness", histogram=self.staleness,
                num_updates=ps.num_updates)
        if self.metrics_writer is not None and self.worker_restarts:
            self.metrics_writer.summary(
                "failures", worker_restarts=self.worker_restarts)
        if errors:
            raise errors[0]
        self.executor_histories = [h for h in results if h is not None]
        self.history = (self.executor_histories[0]
                        if self.executor_histories else [])
        self.params = final
        bridge.params_from_jax(final, self.model)
        return Model(self.model)


def _opt_snapshot(worker):
    """A worker's optimizer state on the host for a checkpoint (None before
    it has one). Read racily from the checkpointing thread, as the
    reference does; a dict resized under the read is read again."""
    for _ in range(3):
        try:
            return (opt_state_to_host(worker.opt)
                    if worker.opt is not None else None)
        except RuntimeError:
            continue
    return None


class AsynchronousDistributedTrainer(DistributedTrainer):
    """Async base (reference: trainers.py · AsynchronousDistributedTrainer):
    adds the partition-oversubscription knob."""

    def __init__(self, *args, parallelism_factor: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self._parallelism_factor = parallelism_factor

    @property
    def parallelism_factor(self) -> int:
        return self._parallelism_factor


class _DeltaFamilySpmdMixin:
    """``spmd=True`` engine of the windowed delta-commit algorithms: W
    local steps per worker, then one lock-step commit of every worker's
    delta — DOWNPOUR sums them (:func:`rules.allreduce_sum_delta`), ADAG
    means them (:func:`rules.allreduce_mean_delta`) — and every worker
    re-pulls the new center. Equal to the PS classes driven on the
    pull-all / commit-all schedule."""

    SPMD_ENGINE = ""  # subclass sets, e.g. 'downpour-spmd'

    def __init__(self, *args, spmd: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.spmd = spmd

    def _spmd_round(self, workers, center):
        dev = next(iter(center.values())).device
        deltas = [rules.tree_sub(w, {k: c.to(w[k].device)
                                     for k, c in center.items()})
                  for w in workers]
        center = rules.tree_add(center, self._spmd_reduce(deltas, dev))
        return [center] * len(workers), center

    def _train(self, dataset, shuffle: bool = False) -> Model:
        if self.spmd:
            return _train_lockstep_spmd(self, dataset, shuffle,
                                        engine=self.SPMD_ENGINE,
                                        round_fn=self._spmd_round)
        return super()._train(dataset, shuffle)


class DOWNPOUR(_DeltaFamilySpmdMixin, AsynchronousDistributedTrainer):
    """Dean et al. 2012 (reference: trainers.py · DOWNPOUR)."""

    WORKER_CLS = workers_mod.DOWNPOURWorker
    SPMD_ENGINE = "downpour-spmd"

    def _spmd_reduce(self, deltas, device):
        return rules.allreduce_sum_delta(deltas, device)

    def allocate_parameter_server(self):
        return ps_mod.DeltaParameterServer(self._center_tree(),
                                           device=self._devices()[0])


class ADAG(_DeltaFamilySpmdMixin, AsynchronousDistributedTrainer):
    """Asynchronous distributed adaptive gradients — the reference's
    recommended default (reference: trainers.py · ADAG)."""

    WORKER_CLS = workers_mod.ADAGWorker
    SPMD_ENGINE = "adag-spmd"

    def _spmd_reduce(self, deltas, device):
        return rules.allreduce_mean_delta(deltas, device)

    def allocate_parameter_server(self):
        return ps_mod.ADAGParameterServer(self._center_tree(),
                                          getattr(self, "_ps_num_workers",
                                                  self.num_workers),
                                          device=self._devices()[0])


class DynSGD(AsynchronousDistributedTrainer):
    """Staleness-damped async SGD (reference: trainers.py · DynSGD).
    ``spmd=True`` runs the lock-step engine with per-worker clocks:
    commits land in worker order inside a round, worker ``i`` damped by
    ``1/(1+i)`` (:func:`rules.allreduce_dynsgd_round`)."""

    WORKER_CLS = workers_mod.DynSGDWorker
    SPMD_ENGINE = "dynsgd-spmd"

    def __init__(self, *args, spmd: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.spmd = spmd

    def allocate_parameter_server(self):
        return ps_mod.DynSGDParameterServer(self._center_tree(),
                                            device=self._devices()[0])

    def _train(self, dataset, shuffle: bool = False) -> Model:
        if self.spmd:
            return _train_lockstep_spmd(self, dataset, shuffle,
                                        engine=self.SPMD_ENGINE,
                                        round_fn=rules.allreduce_dynsgd_round)
        return super()._train(dataset, shuffle)


class AEASGD(AsynchronousDistributedTrainer):
    """Async elastic averaging (reference: trainers.py · AEASGD).
    ``spmd=True`` runs the lock-step engine, each round the elastic
    exchange (:func:`rules.allreduce_easgd_round`): in lock step the
    async elastic commit lands as the synchronous round does."""

    WORKER_CLS = workers_mod.AEASGDWorker
    SPMD_ENGINE = "aeasgd-spmd"

    def __init__(self, *args, rho: float = 5.0, elastic_lr: float = 0.01,
                 spmd: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.rho = rho
        self.elastic_lr = elastic_lr
        self.spmd = spmd

    def extra_worker_kwargs(self):
        return dict(rho=self.rho, elastic_lr=self.elastic_lr)

    def allocate_parameter_server(self):
        return ps_mod.DeltaParameterServer(self._center_tree(),
                                           device=self._devices()[0])

    def _train(self, dataset, shuffle: bool = False) -> Model:
        if self.spmd:
            alpha = self.elastic_lr * self.rho
            return _train_lockstep_spmd(
                self, dataset, shuffle, engine=self.SPMD_ENGINE,
                round_fn=lambda w, c: rules.allreduce_easgd_round(w, c,
                                                                  alpha))
        return super()._train(dataset, shuffle)


class EAMSGD(AEASGD):
    """AEASGD + Nesterov momentum on the workers (reference: trainers.py ·
    EAMSGD); the ``momentum`` knob sets the Nesterov optimizer it builds."""

    WORKER_CLS = workers_mod.EAMSGDWorker
    SPMD_ENGINE = "eamsgd-spmd"

    def __init__(self, *args, momentum: float = 0.9, **kwargs):
        if kwargs.get("worker_optimizer", "sgd") != "sgd":
            raise ValueError(
                "EAMSGD defines its own worker optimizer (Nesterov SGD with "
                "the `momentum` knob); a custom worker_optimizer would be "
                "silently ignored — use AEASGD if you need one")
        super().__init__(*args, **kwargs)
        self.momentum = momentum
        self.worker_optimizer = get_optimizer(
            "nesterov", self.learning_rate, momentum=self.momentum)


class SynchronousDistributedTrainer(DistributedTrainer):
    """Sync base (reference: trainers.py · SynchronousDistributedTrainer)."""


class EASGD(SynchronousDistributedTrainer):
    """Synchronous elastic averaging (reference: trainers.py · EASGD):
    every round is a barrier over the workers. Default engine: worker
    threads and the barrier server (:class:`~distkeras_torch.
    parameter_servers.EASGDParameterServer`), which tolerates unequal
    partitions and restarts; ``spmd=True``: the lock-step engine, each
    round :func:`rules.allreduce_easgd_round` over every worker."""

    WORKER_CLS = workers_mod.EASGDWorker
    SPMD_ENGINE = "easgd-spmd"

    def __init__(self, *args, rho: float = 5.0, elastic_lr: float = 0.01,
                 spmd: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.rho = rho
        self.elastic_lr = elastic_lr
        self.spmd = spmd

    def extra_worker_kwargs(self):
        return dict(rho=self.rho, elastic_lr=self.elastic_lr)

    def allocate_parameter_server(self):
        return ps_mod.EASGDParameterServer(
            self._center_tree(),
            getattr(self, "_ps_num_workers", self.num_workers), rho=self.rho,
            elastic_lr=self.elastic_lr, device=self._devices()[0])

    def _train(self, dataset, shuffle: bool = False) -> Model:
        if self.spmd:
            alpha = self.elastic_lr * self.rho
            return _train_lockstep_spmd(
                self, dataset, shuffle, engine=self.SPMD_ENGINE,
                round_fn=lambda w, c: rules.allreduce_easgd_round(w, c,
                                                                  alpha))
        return super()._train(dataset, shuffle)


# the lock-step checkpoint's engine stamp (0: unstamped, accepted with a
# warning)
_SPMD_ENGINE_IDS = {"easgd-spmd": 1, "downpour-spmd": 2, "adag-spmd": 3,
                    "aeasgd-spmd": 4, "eamsgd-spmd": 5, "dynsgd-spmd": 6}


def _train_lockstep_spmd(self, dataset: PartitionedDataset, shuffle: bool,
                         engine: str, round_fn) -> Model:
    """The lock-step engine of the PS algorithms (``spmd=True``; reference:
    trainers.py · _train_lockstep_spmd). One process drives every worker:
    worker ``i`` is a copy of the model on ``devices[i % n]`` with its
    own optimizer, and each window is W steps of every worker (its window
    step, issued worker after worker — on several cards they overlap),
    then one ``round_fn(workers, center) -> (workers, center)`` over all
    of their parameters with the reductions summed onto the center's
    device (:func:`rules.allreduce_sum_delta` and the others). Metrics
    stay on the devices until the epoch ends.

    Partitions of unequal batch counts: a worker whose batches have run
    out skips its steps (the reference's masked no-op batches) but joins
    every round, so every row is trained on exactly once. Checkpoints
    (per epoch) carry the center, every worker's parameters and
    optimizer state, and the engine stamp and worker count, so a resume
    is exact and a resume under another engine or worker count raises.

    ``self`` is the trainer."""
    import torch.distributed as dist

    from distkeras_torch import bridge

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"{engine} is single-process (every worker in one process); "
            "multi-process runs use the threaded PS engine (spmd=False) "
            "with remote_ps=")
    dataset = _as_partitioned(dataset)  # a ShardedDataset loads
    if shuffle:
        dataset = dataset.shuffle(seed=self.seed)
    n = self.num_workers
    devices = self._devices()
    center = rules.to_tensors(self._center_tree(), devices[0])
    parts = dataset.repartition(n)
    per_worker = [batch_partition(parts.partition(i), self.features_col,
                                  self.label_col, self.batch_size)
                  for i in range(n)]
    lens = [len(xb) for xb, _ in per_worker]
    n_b = max(lens)
    if len(set(lens)) > 1:
        warnings.warn(
            f"{engine}: partitions are unequal ({min(lens)}–{n_b} "
            f"batches across {n} workers); exhausted workers idle "
            "through masked no-op steps but still join every commit — "
            "no rows are dropped",
            RuntimeWarning,
        )
    workers = [self.allocate_worker(i) for i in range(n)]
    self.workers = workers
    start_epoch, restored = 0, None
    if self.checkpointer is not None:
        ck_step, state = self.checkpointer.restore()
        if state is not None:
            extra = state["extra"]
            saved_id = int(extra.get("engine_id", 0))
            saved_workers = int(extra.get("workers", 0))
            if not saved_id:
                warnings.warn(
                    "restoring an unstamped lockstep checkpoint into the "
                    f"'{engine}' spmd engine; if it was written by a "
                    "different algorithm the layouts differ silently — "
                    "verify the source trainer matches")
            if saved_id and saved_id != _SPMD_ENGINE_IDS[engine]:
                names = {v: k for k, v in _SPMD_ENGINE_IDS.items()}
                raise ValueError(
                    "checkpoint was written by engine "
                    f"'{names.get(saved_id, saved_id)}' but this trainer "
                    f"runs '{engine}' — their state layouts are "
                    "incompatible; resume with the matching trainer/spmd "
                    "flag or point at a fresh directory")
            if saved_workers and saved_workers != n:
                raise ValueError(
                    f"checkpoint carries {saved_workers} workers but this "
                    f"run has {n} — per-worker state cannot be re-sliced; "
                    f"resume with num_workers={saved_workers} or start "
                    "fresh")
            center = rules.to_tensors(self._center_tree(state["params"]),
                                      devices[0])
            start_epoch = int(extra.get("epoch", ck_step))
            restored = state["opt_state"] or None
    feeds = []
    for i, w in enumerate(workers):
        if restored is not None:
            w.initial_opt_state = restored["opt"][i]
        w.prepare()
        w.index = i
        rules.tree_copy_(w.local(), center if restored is None
                         else rules.flatten(restored["worker"][i]))
        feeds.append(w._stage(*per_worker[i]))
    W = self.communication_window
    groups = [(s, min(s + W, n_b)) for s in range(0, n_b, W)]
    histories: List[History] = [[] for _ in range(n)]
    for epoch in range(start_epoch, self.num_epoch):
        epoch_ms = []
        for s, e in groups:
            ms = []
            for i, w in enumerate(workers):
                stop = min(e, lens[i])
                if stop <= s:
                    ms.append(None)  # this worker's batches have run out
                    continue
                xs, ys, staged = feeds[i]
                xw, yw = xs[s:stop], ys[s:stop]
                if not staged:
                    xw, yw = w._put(xw), w._put(yw)
                ms.append(w.window_step(xw, yw))
            local = [w.local() for w in workers]
            new_workers, center = round_fn(local, center)
            for dst, src in zip(local, new_workers):
                rules.tree_copy_(dst, src)
            epoch_ms.append(ms)
        for ms in epoch_ms:
            for i, m in enumerate(ms):
                if m is None:
                    continue
                rows = _rows(m)
                if self.metrics_writer is not None:
                    base = len(histories[i])
                    for t, r in enumerate(rows):
                        self.metrics_writer.log(step=base + t + 1, worker=i,
                                                samples=self.batch_size, **r)
                histories[i].extend(rows)
        if self.checkpointer is not None:
            self.checkpointer.maybe_save(
                epoch + 1, rules.to_numpy(center),
                {"worker": [rules.to_numpy(w.local()) for w in workers],
                 "opt": [opt_state_to_host(w.opt) for w in workers]},
                extra={"epoch": epoch + 1,
                       "engine_id": _SPMD_ENGINE_IDS[engine],
                       "workers": n},
                force=(epoch + 1 == self.num_epoch))
    self.params = rules.to_numpy(center)
    bridge.params_from_jax(self.params, self.model)
    self.executor_histories = histories
    self.history = histories[0]
    return Model(self.model)
