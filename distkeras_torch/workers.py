"""Workers — per-device training step loops; the port of
:mod:`distkeras_tpu.workers` (the single-step and window builders, the
batching of a partition, :class:`Worker` and :class:`SequentialWorker`).

The reference jits one step (forward, loss, backward, optax update) and
scans it over a window of W batches in one dispatch. Here the module
holds its parameters and the optimizer updates them in place, so a step
is ``step(x, y) -> metrics`` and a window is a Python loop of steps whose
per-step loss and metrics stay on the device as one stacked tensor: the
host reads them once a window (no ``.item()`` inside a step).

With a process ``group`` (the data-parallel trainer's ``dp`` axis), each
step of :func:`make_window_step` averages the gradients over the group —
ONE all-reduce of the flattened gradients, then a division by the group
size, the reference's ``psum``-by-transpose followed by ``1 / n`` — and
a window's metrics are averaged over the group once, after its last
step.

The parameter-server workers (:class:`WindowedWorker` and its six
subclasses) each train their own module twin with their own optimizer:
a window is one :func:`make_window_step` call read back once, then
``on_round(ps)`` exchanges with the center. A pull is copied into the
module's parameters in place, so the optimizer's state survives it (the
reference's Keras ``set_weights`` kept the optimizer too).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from distkeras_torch import telemetry
from distkeras_torch.ops import rules
from distkeras_torch.parallel.collectives import group_size
from distkeras_torch.utils.history import History
from distkeras_torch.utils.losses import get_loss, get_optimizer, resolve_metrics

_TRAIN_STEPS = telemetry.get_registry().counter(
    "train_steps_total", "optimizer steps completed across all workers",
)
_TRAIN_SAMPLES = telemetry.get_registry().counter(
    "train_samples_total", "training samples consumed across all workers",
)


def _bind(module, optimizer, group):
    """The optimizer over ``module``'s parameters (a factory from
    :func:`get_optimizer` is bound here), with every replica of a
    ``group`` starting from its rank 0's parameters."""
    if not isinstance(optimizer, torch.optim.Optimizer):
        optimizer = optimizer(module.parameters())
    if group is not None:
        with torch.no_grad():
            for p in module.parameters():
                dist.broadcast(p, dist.get_global_rank(group, 0), group=group)
    return optimizer


def _mean_grads(params, group, n: int):
    """Average the gradients over ``group``: one all-reduce (sum) of all of
    them flattened into one buffer, then ``/ n``."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= n
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _step_fn(module, loss_fn, optimizer, metrics, group):
    """One step as a ``[1 + len(metrics)]`` device tensor: loss, then the
    metrics of this batch's logits (taken before the update). The
    forward with the loss and the backward are phase spans
    (``train.forward``, ``train.backward``) on the global tracer; the
    optimizer keeps torch's own ``Optimizer.step`` range."""
    params = [p for p in module.parameters() if p.requires_grad]
    n = group_size(group)
    tracer = telemetry.get_tracer()

    def step(x, y):
        optimizer.zero_grad(set_to_none=True)
        with tracer.phase("train.forward"):
            logits = module(x)
            loss = loss_fn(logits, y)
        with tracer.phase("train.backward"):
            loss.backward()
        if n > 1:
            _mean_grads(params, group, n)
        optimizer.step()
        with torch.no_grad():
            return torch.stack([loss.detach().float()] + [
                fn(logits.detach(), y).float() for _, fn in metrics])

    return step


def _names(metrics):
    return ["loss"] + [name for name, _ in metrics]


def make_train_step(module, loss_fn, optimizer, metrics=()):
    """The single-batch training step (reference: workers.py ·
    make_train_step, Worker.train's ``model.train_on_batch``).

    ``optimizer`` is a ``torch.optim.Optimizer`` over ``module``'s
    parameters or a :func:`get_optimizer` factory; ``metrics`` is
    ``[(name, fn), ...]`` (:func:`resolve_metrics`). Returns ``step(x, y)
    -> {"loss": t, <metric>: t, ...}`` of 0-dim device tensors; the step
    updates ``module`` in place."""
    optimizer = _bind(module, optimizer, None)
    core = _step_fn(module, loss_fn, optimizer, metrics, None)

    def step(x, y):
        return dict(zip(_names(metrics), core(x, y)))

    return step


def make_window_step(module, loss_fn, optimizer, metrics=(), group=None):
    """A whole communication window of steps (reference: workers.py ·
    make_window_step). ``window(xs, ys)`` takes stacked batches ``[W, B,
    ...]`` and returns ``{"loss": [W], <metric>: [W], ...}`` on the
    device, read by the caller once a window. Arguments as
    :func:`make_train_step`; ``group``: see the module docstring."""
    optimizer = _bind(module, optimizer, group)
    core = _step_fn(module, loss_fn, optimizer, metrics, group)
    n = group_size(group)

    def window(xs, ys):
        out = torch.stack([core(x, y) for x, y in zip(xs, ys)])
        if n > 1:
            dist.all_reduce(out, group=group)
            out /= n
        return dict(zip(_names(metrics), out.t()))

    return window


def batch_partition(partition: Dict[str, np.ndarray], features_col: str,
                    label_col: str, batch_size: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Partition columns -> stacked full batches ``[N_batches, B, ...]``;
    the trailing partial batch is dropped (one batch shape for the whole
    run). A copy of the reference's."""
    missing = [c for c in (features_col, label_col) if c not in partition]
    if missing:
        raise KeyError(
            f"column(s) {missing} not in partition; available: "
            f"{sorted(partition)} — check features_col/label_col"
        )
    x = partition[features_col]
    y = partition[label_col]
    n = (len(x) // batch_size) * batch_size
    if n == 0:
        raise ValueError(
            f"partition with {len(x)} rows is smaller than batch_size={batch_size}"
        )
    xb = x[:n].reshape((-1, batch_size) + x.shape[1:])
    yb = y[:n].reshape((-1, batch_size) + y.shape[1:])
    return xb, yb


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) \
        else a.nbytes


def _rows(ms: Dict[str, torch.Tensor]) -> History:
    """A window's ``{name: [W]}`` device metrics -> history rows, with ONE
    device-to-host copy."""
    names = list(ms)
    table = torch.stack([ms[k] for k in names], dim=1).cpu().numpy()
    return [{k: float(v) for k, v in zip(names, row)} for row in table]


class Worker:
    """Shared per-worker machinery (reference: workers.py · Worker): the
    module, the resolved loss, metrics and optimizer, and the batching
    and staging configuration; subclasses implement ``train``.

    ``params`` is an optional flax-layout tree of numpy arrays loaded
    into ``module`` when training starts (None: the module's own
    weights). ``group``: see the module docstring."""

    def __init__(
        self,
        module,
        params=None,
        optimizer="sgd",
        learning_rate: float = 0.01,
        loss="categorical_crossentropy",
        metrics: Sequence[str] = ("accuracy",),
        features_col: str = "features",
        label_col: str = "label",
        batch_size: int = 32,
        num_epoch: int = 1,
        stage_limit_bytes: int = 1 << 30,
        group=None,
    ):
        self.module = module
        self.params = params
        self.optimizer = get_optimizer(optimizer, learning_rate)
        self.loss_fn = get_loss(loss)
        self.metrics = resolve_metrics(metrics)
        self.features_col = features_col
        self.label_col = label_col
        self.batch_size = batch_size
        self.num_epoch = num_epoch
        # partitions no bigger than this are uploaded to the device once
        # and kept resident; bigger ones are uploaded epoch by epoch
        self.stage_limit_bytes = stage_limit_bytes
        self.group = group
        # optional MetricsWriter installed by the trainer
        self.metrics_writer = None
        # optional optimizer state_dict to resume from (checkpoints)
        self.initial_opt_state = None
        self.opt = None
        self.index = 0
        self._step_count = 0

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def _log_steps(self, records: Sequence[Dict[str, float]]):
        if records:
            _TRAIN_STEPS.inc(len(records))
            _TRAIN_SAMPLES.inc(len(records) * self.batch_size)
        w = self.metrics_writer
        if w is not None:
            for r in records:
                self._step_count += 1
                w.log(step=self._step_count, samples=self.batch_size,
                      worker=self.index, **r)
        else:
            self._step_count += len(records)

    def _put(self, a):
        return torch.as_tensor(a).to(self.device)

    def _stage(self, xb: np.ndarray, yb: np.ndarray):
        """Features narrowed to the module's compute dtype on the host
        (the module casts to it first anyway: same values, fewer bytes),
        then uploaded once when both fit the staging budget: ``(x, y,
        staged)``; else returned host-side for per-epoch uploads."""
        from distkeras_torch.utils.transfer import narrow_cast

        xb = narrow_cast(xb, getattr(self.module, "dtype", None))
        if _nbytes(xb) + _nbytes(yb) <= self.stage_limit_bytes:
            return self._put(xb), self._put(yb), True
        return xb, yb, False

    def prepare(self):
        """Load ``params`` (when given), bind the optimizer (restoring
        ``initial_opt_state`` when set) and build the window step
        (reference: Worker.prepare_model)."""
        if self.params is not None:
            from distkeras_torch import bridge

            bridge.params_from_jax(self.params, self.module)
        self.opt = _bind(self.module, self.optimizer, None)
        if self.initial_opt_state is not None:
            self.opt.load_state_dict(self.initial_opt_state)
        self.window_step = make_window_step(
            self.module, self.loss_fn, self.opt, self.metrics,
            group=self.group)

    def batches(self, partition) -> Tuple[np.ndarray, np.ndarray]:
        return batch_partition(partition, self.features_col, self.label_col,
                               self.batch_size)


class SequentialWorker(Worker):
    """Plain local training loop over one partition (reference:
    workers.py · SequentialWorker, used by SingleTrainer,
    EnsembleTrainer, AveragingTrainer and here DataParallelTrainer): each
    epoch is one window over all its full batches, read back once.
    ``epoch_callback(epoch, worker)``, when set, runs after each epoch
    (the checkpoints of ``SingleTrainer``)."""

    def train(self, index: int, partition) -> Tuple[dict, History]:
        """Train ``self.module`` in place; returns its trained weights as a
        flax-layout numpy tree and the per-step history."""
        from distkeras_torch import bridge

        self.prepare()
        self.index = index
        xb, yb = self.batches(partition)
        xs, ys, staged = self._stage(xb, yb)
        history: History = []
        callback = getattr(self, "epoch_callback", None)
        for epoch in range(self.num_epoch):
            if staged:
                ms = self.window_step(xs, ys)
            else:
                ms = self.window_step(self._put(xs), self._put(ys))
            rows = _rows(ms)
            history.extend(rows)
            self._log_steps(rows)
            if callback is not None:
                callback(epoch, self)
        self.params = bridge.params_to_jax(self.module)
        return self.params, history

    def train_stream(self, index: int, windows) -> Tuple[dict, History]:
        """:meth:`train` over a streamed feed: ``windows(epoch)`` yields
        ``(xs, ys)`` lists of device batches, one window step each. The
        epoch's metrics stay on the device until it ends, then are read
        back together."""
        from distkeras_torch import bridge

        self.prepare()
        self.index = index
        history: History = []
        callback = getattr(self, "epoch_callback", None)
        for epoch in range(self.num_epoch):
            pending = [self.window_step(xs, ys) for xs, ys in windows(epoch)]
            rows = [row for ms in pending for row in _rows(ms)]
            history.extend(rows)
            self._log_steps(rows)
            if callback is not None:
                callback(epoch, self)
        self.params = bridge.params_to_jax(self.module)
        return self.params, history


def opt_state_to_host(opt) -> dict:
    """An optimizer's ``state_dict`` with every tensor copied to the host
    (what a checkpoint stores; the live one aliases the device state)."""
    def host(v):
        if isinstance(v, torch.Tensor):
            return v.detach().to("cpu", copy=True)
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        if isinstance(v, list):
            return [host(x) for x in v]
        return v

    return host(opt.state_dict())


class WindowedWorker(Worker):
    """Base of the parameter-server workers (reference: workers.py ·
    WindowedWorker): ``communication_window`` local steps a round, then
    :meth:`on_round` with the parameter server.

    The center's trees are flat dicts keyed by the flax path
    (:func:`distkeras_torch.bridge.flax_key`); :meth:`local` is this
    worker's parameters in that form (live views of the module's), and
    ``last_pulled`` the last center it pulled (a copy of its own)."""

    def __init__(self, *args, communication_window: int = 5, **kwargs):
        super().__init__(*args, **kwargs)
        self.communication_window = communication_window
        self.last_pulled = None
        self.worker_clock = 0

    def local(self) -> rules.Tree:
        from distkeras_torch.bridge import flax_key

        return {flax_key(n): p.detach()
                for n, p in self.module.named_parameters()}

    def _pull(self, ps) -> rules.Tree:
        """A copy of the center on this worker's device (every server, the
        remote proxy included, takes ``device=``)."""
        return ps.pull(device=self.device)

    def _load(self, pulled: rules.Tree):
        """Copy a pulled center into the module (in place: the optimizer
        keeps its state) and remember it as ``last_pulled``."""
        rules.tree_copy_(self.local(), pulled)
        self.last_pulled = pulled

    def on_start(self, index: int, ps):
        """The first pull (reference: NetworkWorker's connect + pull)."""
        self._load(self._pull(ps))

    def on_round(self, index: int, ps):
        raise NotImplementedError

    def train(self, index: int, partition, ps) -> Tuple[rules.Tree, History]:
        """Train on ``partition`` against ``ps``; returns :meth:`local` and
        the per-step history. A window of W batches is one window step,
        read back once; a shorter tail window (a partition whose batch
        count W does not divide) runs its steps the same way, then
        exchanges like any other."""
        self.prepare()
        self.index = index
        self.on_start(index, ps)
        xb, yb = self.batches(partition)
        xs, ys, staged = self._stage(xb, yb)
        n, W = len(xb), self.communication_window
        history: History = []
        for _epoch in range(self.num_epoch):
            for start in range(0, n, W):
                xw, yw = xs[start:start + W], ys[start:start + W]
                if not staged:
                    xw, yw = self._put(xw), self._put(yw)
                rows = _rows(self.window_step(xw, yw))
                history.extend(rows)
                self._log_steps(rows)
                self.on_round(index, ps)
        return self.local(), history


class DOWNPOURWorker(WindowedWorker):
    """Push the window's weight delta, then pull the fresh center
    (reference: workers.py · DOWNPOURWorker). The optimizer state
    persists across pulls."""

    def on_round(self, index: int, ps):
        delta = rules.downpour_delta(self.local(), self.last_pulled)
        ps.commit(delta, worker=index, worker_clock=self.worker_clock)
        self.worker_clock += 1
        self._load(self._pull(ps))


class ADAGWorker(DOWNPOURWorker):
    """DOWNPOUR's client; the ADAG server normalizes (reference: workers.py
    · ADAGWorker)."""


class DynSGDWorker(WindowedWorker):
    """A delta push tagged with the server clock of the worker's last pull
    (reference: workers.py · DynSGDWorker)."""

    def _pull_with_clock(self, ps):
        params, clock = ps.pull_with_clock(device=self.device)
        return params, int(clock)

    def on_start(self, index: int, ps):
        pulled, self.worker_clock = self._pull_with_clock(ps)
        self._load(pulled)

    def on_round(self, index: int, ps):
        delta = rules.downpour_delta(self.local(), self.last_pulled)
        ps.commit(delta, worker=index, worker_clock=self.worker_clock)
        pulled, self.worker_clock = self._pull_with_clock(ps)
        self._load(pulled)


class AEASGDWorker(WindowedWorker):
    """Asynchronous elastic averaging: pull the center, move toward it by
    the elastic force and push the same force (reference: workers.py ·
    AEASGDWorker). ``alpha = elastic_lr * rho``."""

    def __init__(self, *args, rho: float = 5.0, elastic_lr: float = 0.01,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.rho = rho
        self.alpha = elastic_lr * rho

    def on_round(self, index: int, ps):
        center = self._pull(ps)
        local = self.local()
        diff = rules.elastic_difference(self.alpha, local, center)
        rules.tree_sub_(local, diff)
        ps.commit(diff, worker=index, worker_clock=self.worker_clock)
        self.worker_clock += 1


class EAMSGDWorker(AEASGDWorker):
    """AEASGD with Nesterov momentum on the local steps (reference:
    workers.py · EAMSGDWorker): the momentum lives in the worker's
    optimizer; the exchange is AEASGD's."""


class EASGDWorker(WindowedWorker):
    """Synchronous EASGD round: contribute the local weights, wait for the
    round's barrier, then move toward the round's center by the elastic
    force (reference: workers.py · EASGDWorker). The contributed tensors
    are the live parameters: the worker blocks until the round has been
    issued, so none of its later steps can reach them first."""

    def __init__(self, *args, rho: float = 5.0, elastic_lr: float = 0.01,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.rho = rho
        self.alpha = elastic_lr * rho

    def on_round(self, index: int, ps):
        local = self.local()
        center = ps.commit_and_wait(local, worker=index, device=self.device)
        rules.tree_sub_(local, rules.elastic_difference(self.alpha, local,
                                                        center))
