"""Control-plane event journal: every mutating fleet action, as data.

The metric plane (:mod:`~distkeras_torch.telemetry.timeseries`) records
*what changed*; this journal records *why* — the Dapper half of the
Monarch/Dapper split. Every actuator in the fleet appends a typed
:class:`FleetEvent` when it mutates control state:

====================  ====================================================
action                emitted by
====================  ====================================================
``scale_up``          the autoscaler, after actuating a new replica
``scale_down``        the autoscaler, after draining + retiring one
``rebalance``         the autoscaler's drain → reconfigure → undrain flip
``drain``             engine ``begin_drain`` via the ``drain`` op; the
                      router's orchestrated ``drain_replica``
``undrain``           the reopening half of the same ops
``reconfigure``       a role flip landing on the engine thread
``weight_push``       an applied ``push_weights`` swap (version stamped)
``rollback``          the router's SLO-burn auto-rollback
``kv_migrate``        a router-orchestrated KV export/import, by outcome
``replica_up``        ``Router.add_replica`` extending the fleet
``replica_down``      health-loop down transitions and ``remove_replica``
====================  ====================================================

Each event carries wall time, the acting component, the action, its
target (a replica name, a rule, a version), and free-form references
(``trace``/``version``/``reason``) that join it back to the trace
archive and the metric series. Journals are bounded rings (the
flight-recorder discipline: O(1) append under one lock, a ``dropped``
counter); both the engine-side and router-side journals serve the
``events`` wire op and HTTP ``/events``, and
:func:`merge_event_journals` folds a fleet of them into one
timestamp-ordered story for ``report --timeline``.

Stdlib-only, like the rest of the package.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# the taxonomy above, for renderers and docs; append() accepts any
# action string so new actuators never need a telemetry release
KNOWN_ACTIONS = frozenset({
    "scale_up", "scale_down", "rebalance", "drain", "undrain",
    "reconfigure", "weight_push", "rollback", "kv_migrate",
    "replica_up", "replica_down",
})


@dataclass(frozen=True)
class FleetEvent:
    """One mutating control-plane action.

    ``t`` is wall-clock epoch seconds (events from different processes
    must order on one axis — the same reason spans carry a wall
    anchor). ``detail`` holds the joining references: ``trace`` (a
    trace id), ``version`` (a weight version), ``reason``, counts —
    plain msgpack/JSON data only."""

    t: float
    actor: str
    action: str
    target: Optional[str] = None
    detail: Dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        out = {"t": self.t, "actor": self.actor, "action": self.action,
               "target": self.target}
        out.update(self.detail)
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "FleetEvent":
        detail = {k: v for k, v in d.items()
                  if k not in ("t", "actor", "action", "target")}
        return cls(t=float(d["t"]), actor=str(d["actor"]),
                   action=str(d["action"]), target=d.get("target"),
                   detail=detail)


class EventJournal:
    """Bounded ring of control-plane events (one per process side:
    the engine keeps its own, the router keeps the fleet view)."""

    def __init__(self, capacity: int = 512, actor: str = "engine"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = capacity
        self.actor = actor
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self.dropped = 0

    def append(self, action: str, target: Optional[str] = None,
               actor: Optional[str] = None, t: Optional[float] = None,
               **detail) -> dict:
        """Record one event; returns its plain-dict wire form.
        ``actor`` defaults to the journal's owning component; ``t``
        (epoch seconds) is injectable for deterministic tests."""
        ev = FleetEvent(
            t=time.time() if t is None else float(t),
            actor=self.actor if actor is None else str(actor),
            action=str(action), target=target, detail=detail,
        ).to_dict()
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(ev)
        return ev

    def events(self, last: Optional[int] = None) -> List[dict]:
        """The journal, oldest first; ``last`` keeps the most recent
        n. Returned dicts are copies — callers may annotate them."""
        with self._lock:
            evs = [dict(e) for e in self._ring]
        return evs[-last:] if last else evs

    def meta(self) -> dict:
        """Ring state in ONE lock hold."""
        with self._lock:
            return {"recorded": len(self._ring), "dropped": self.dropped,
                    "capacity": self.capacity, "actor": self.actor}


def merge_event_journals(events_by_source: Dict[str, List[dict]],
                         ) -> List[dict]:
    """Fold per-source journals into one timestamp-ordered list, each
    event tagged with its ``source`` (a replica name, ``"router"``).
    Ties order by source name so the merge is deterministic."""
    merged = []
    for source, events in events_by_source.items():
        for e in events:
            tagged = dict(e)
            tagged.setdefault("source", source)
            merged.append(tagged)
    merged.sort(key=lambda e: (e.get("t", 0.0), e.get("source", "")))
    return merged
