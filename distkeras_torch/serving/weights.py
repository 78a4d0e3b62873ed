"""Live weight updates — the port of :mod:`distkeras_tpu.serving.weights`:
payload serialization, structural validation, and the two standard
feeders (checkpoint directory, parameter server).

- :func:`serialize_weights` / :func:`deserialize_weights` — the wire
  payload: one msgpack blob of the full variables tree in flax's codec
  (:mod:`distkeras_torch.utils.serde`, no flax), so a payload a client
  of either package sends decodes on a server of either package;
  :func:`chunk_payload` splits it across bounded frames.
- :func:`validate_like` — the admission gate for a pushed tree:
  structure, shape and dtype must match the serving engine's current
  weights exactly; the first mismatched leaf (in the current tree's
  flatten order) is named in a typed :class:`WeightPushError`, so a bad
  checkpoint is refused at the boundary instead of surfacing as a shape
  error inside a tick.
- :class:`CheckpointWatcher` — polls a
  :class:`~distkeras_torch.checkpoint.Checkpointer` directory and pushes
  every new step's params to a serving endpoint.
- :class:`ParameterServerFeed` — follows a running parameter server
  (local, or a :class:`~distkeras_torch.networking.RemoteParameterServer`)
  and pushes the committed center whenever it has advanced by
  ``min_updates`` commits.

Trees are the reference's layout: nested dicts keyed by the flax path
(``{"params": {"Block_0": {...}}}``), leaves anything with ``shape`` and
``dtype`` (numpy arrays, torch tensors); the port's parameters are f32
masters, so a pushed tree is f32. Both feeders push through any object
with a ``push_weights`` method (a
:class:`~distkeras_torch.serving.ServingClient`); they are duck-typed on
purpose: this module must not import the server (the server imports
it).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Tuple

from distkeras_torch.utils import serde


class WeightPushError(RuntimeError):
    """A pushed weight tree was refused before any swap happened: its
    structure, a leaf's shape, or a leaf's dtype does not match the
    serving engine's current weights. Always names the first offending
    leaf (in the current tree's flatten order); ``leaf`` carries its key
    path. Travels the wire as the typed ``weight_push`` error code."""

    def __init__(self, msg: str, leaf: Optional[str] = None):
        super().__init__(msg)
        self.leaf = leaf


# -- payload codec -----------------------------------------------------------


def serialize_weights(variables: Any) -> bytes:
    """Variables tree -> one msgpack blob (tensor leaves are fetched to
    the host as numpy). The caller chunks the blob across frames; the
    receiving server joins and :func:`deserialize_weights` it."""
    return serde.packb(variables)


def deserialize_weights(payload: bytes) -> Any:
    """Inverse of :func:`serialize_weights`: nested dicts of (read-only)
    numpy leaves."""
    return serde.unpackb(payload)


def chunk_payload(payload: bytes, chunk_bytes: int) -> List[bytes]:
    """Split one serialized weight blob into wire-frame-sized chunks
    (at least one, even for an empty payload)."""
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1; got {chunk_bytes}")
    out = [payload[i:i + chunk_bytes]
           for i in range(0, len(payload), chunk_bytes)]
    return out or [b""]


# -- validation --------------------------------------------------------------


def _leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key-path string, leaf) pairs in flatten order (sorted keys, as
    jax flattens a dict), the path spelled as jax's ``keystr``."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key in sorted(tree):
        out += _leaf_paths(tree[key], f"{prefix}[{key!r}]")
    return out


def _shape(leaf) -> tuple:
    return tuple(int(n) for n in leaf.shape)


def _dtype(leaf) -> str:
    """A leaf's dtype by name (``float32``), numpy or torch alike."""
    return str(leaf.dtype).replace("torch.", "")


def validate_like(current: Any, new: Any):
    """Raise :class:`WeightPushError` naming the first leaf (in the
    current tree's flatten order) whose presence, shape, or dtype
    differs between ``current`` (the engine's live weights) and ``new``
    (the pushed tree); return silently when the trees match. Values are
    never compared — a weight update is *supposed* to change them."""
    cur = _leaf_paths(current)
    new_map = dict(_leaf_paths(new))
    cur_keys = {p for p, _ in cur}
    for path, leaf in cur:
        got = new_map.get(path)
        if got is None:
            raise WeightPushError(
                f"pushed weights are missing leaf {path}: expected "
                f"shape {_shape(leaf)} dtype {_dtype(leaf)}",
                leaf=path,
            )
        if _shape(got) != _shape(leaf):
            raise WeightPushError(
                f"pushed weights mismatch at leaf {path}: shape "
                f"{_shape(got)} != expected {_shape(leaf)}",
                leaf=path,
            )
        if _dtype(got) != _dtype(leaf):
            raise WeightPushError(
                f"pushed weights mismatch at leaf {path}: dtype "
                f"{_dtype(got)} != expected {_dtype(leaf)}",
                leaf=path,
            )
    for path in sorted(new_map):
        if path not in cur_keys:
            raise WeightPushError(
                f"pushed weights carry unknown leaf {path} (not in "
                f"the serving model's tree)",
                leaf=path,
            )


# -- feeders -----------------------------------------------------------------


def _as_variables(params):
    if isinstance(params, dict) and "params" in params:
        return params
    return {"params": params}


class CheckpointWatcher:
    """Poll a checkpoint directory and push every new step's params.

    ``directory`` uses the :class:`~distkeras_torch.checkpoint.Checkpointer`
    layout (``step_<n>.pt``, listed afresh on every read, so a trainer
    in another process advancing it is seen at the next poll);
    ``target`` is anything with a ``push_weights(params, version=)``
    method — a :class:`~distkeras_torch.serving.ServingClient` against
    one LM server. The checkpoint step is forwarded as the pushed
    ``version``, so weight versions are attributable to training steps.
    ``like`` checks the restored state leaf by leaf
    (:meth:`Checkpointer.restore`). ``transform`` maps the restored
    ``state["params"]`` onto the variables tree the serving engine
    expects (default: wrap as ``{"params": ...}`` when not already a
    variables dict).

    A push refused by validation (:class:`WeightPushError` — the
    checkpoint does not fit the serving model) is recorded in
    ``errors`` and does NOT stop the watcher: the next checkpoint may be
    fine, and a bad artifact must not kill the deploy loop. ``journal``
    (an :class:`~distkeras_torch.telemetry.EventJournal`) records each
    push attempt as a ``weight_push`` event by outcome.
    """

    def __init__(self, directory: str, target: Any,
                 interval_s: float = 1.0, like: Optional[dict] = None,
                 transform: Optional[Callable[[Any], Any]] = None,
                 journal: Optional[Any] = None):
        self.directory = directory
        self.target = target
        self.interval_s = interval_s
        self.like = like
        self.transform = transform
        self.journal = journal
        self.last_step: Optional[int] = None
        self.pushed = 0
        self.errors: List[Tuple[int, str]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ckpt = None

    def _checkpointer(self):
        if self._ckpt is None:
            from distkeras_torch.checkpoint import Checkpointer

            self._ckpt = Checkpointer(self.directory)
        return self._ckpt

    def poll_once(self) -> bool:
        """One poll: push the latest step if it is new. Returns True
        when a push happened. Separated from the thread loop so tests
        (and cron-style callers) can drive it deterministically."""
        ckpt = self._checkpointer()
        step = ckpt.latest_step
        if step is None or step == self.last_step:
            return False
        _, state = ckpt.restore(step, like=self.like)
        params = state["params"]
        variables = (self.transform(params) if self.transform is not None
                     else _as_variables(params))
        self.last_step = step
        try:
            self.target.push_weights(variables, version=step)
        except WeightPushError as e:
            self.errors.append((step, str(e)))
            if self.journal is not None:
                self.journal.append("weight_push",
                                    actor="ckpt_watcher",
                                    version=step, outcome="refused",
                                    reason=str(e))
            return False
        self.pushed += 1
        if self.journal is not None:
            self.journal.append("weight_push", actor="ckpt_watcher",
                                version=step, outcome="ok")
        return True

    def start(self) -> "CheckpointWatcher":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.poll_once()
                except WeightPushError:
                    pass  # recorded by poll_once
                except Exception as e:  # transport blip: retry next poll
                    self.errors.append((-1, f"{type(e).__name__}: {e}"))

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if self._ckpt is not None:
            self._ckpt.close()
            self._ckpt = None


class ParameterServerFeed:
    """Subscribe a serving endpoint to a running parameter server: the
    continuous-deployment loop where the server follows the trainer.

    ``ps`` is anything with ``num_updates`` and ``get_model()`` (the
    center as nested numpy in the flax layout) — a local
    :class:`~distkeras_torch.parameter_servers.ParameterServer` or a
    :class:`~distkeras_torch.networking.RemoteParameterServer` proxy.
    Every poll compares the server's commit count against the last
    pushed one; once it has advanced by at least ``min_updates``, the
    committed center is pulled and pushed to ``target``
    (``push_weights``), with the commit count as the weight version.
    ``transform`` adapts the center tree to the serving variables dict
    (default: wrap as ``{"params": center}`` unless already one)."""

    def __init__(self, ps: Any, target: Any, min_updates: int = 1,
                 interval_s: float = 0.5,
                 transform: Optional[Callable[[Any], Any]] = None,
                 journal: Optional[Any] = None):
        if min_updates < 1:
            raise ValueError(
                f"min_updates must be >= 1; got {min_updates}"
            )
        self.ps = ps
        self.target = target
        self.min_updates = min_updates
        self.interval_s = interval_s
        self.transform = transform
        self.journal = journal
        self.last_pushed_updates = 0
        self.pushed = 0
        self.errors: List[str] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _center(self):
        tree = self.ps.get_model()
        if self.transform is not None:
            return self.transform(tree)
        return _as_variables(tree)

    def poll_once(self) -> bool:
        """Push the center iff commits advanced by ``min_updates``
        since the last push. Returns True when a push happened."""
        n = int(self.ps.num_updates)
        if n - self.last_pushed_updates < self.min_updates:
            return False
        variables = self._center()
        self.last_pushed_updates = n
        self.target.push_weights(variables, version=n)
        self.pushed += 1
        if self.journal is not None:
            self.journal.append("weight_push", actor="ps_feed",
                                version=n, outcome="ok")
        return True

    def start(self) -> "ParameterServerFeed":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.poll_once()
                except Exception as e:  # refused push / transport blip:
                    # record, keep following the trainer
                    self.errors.append(f"{type(e).__name__}: {e}")

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None


__all__ = [
    "WeightPushError",
    "serialize_weights",
    "deserialize_weights",
    "validate_like",
    "chunk_payload",
    "CheckpointWatcher",
    "ParameterServerFeed",
]
