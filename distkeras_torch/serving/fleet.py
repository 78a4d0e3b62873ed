"""Replica management for the multi-replica serving fabric.

The reference system's soul is a coordinator distributing work to
workers over sockets; this module is that shape grafted onto serving:
the :class:`Router` (:mod:`distkeras_torch.serving.router`) is the
coordinator, and each worker is one :class:`~distkeras_torch.serving.LMServer`
replica reachable over the framed-msgpack wire protocol. What lives
here is everything the router needs to *know about* its fleet without
caring how requests are routed:

- :class:`Replica` — one backend: a persistent
  :class:`~distkeras_torch.serving.ServingClient` connection, a health
  state (``healthy``/``suspect``/``down``/``draining``), the last
  polled ``stats()`` snapshot (the router's load signal for spill
  decisions), and reconnect bookkeeping.
- :class:`ReplicaManager` — the probe loop: polls every replica's
  ``stats`` op on an interval (one round trip doubles as health probe
  and load sample), marks replicas suspect→down after consecutive
  failures, reconnects downed replicas under exponential backoff, and
  flips replicas to ``draining`` when their engine reports it. Publishes
  per-replica gauges (``router_replica_up``/``_queue_depth``/
  ``_active_slots``/``_blocks_in_use``) into the router's registry and
  fires an ``on_down`` callback exactly once per connection death so
  the router can trigger failover.
- fleet aggregation — :meth:`ReplicaManager.aggregate_stats` (fleet
  sums + per-replica snapshots), :meth:`~ReplicaManager.aggregate_metrics`
  (per-replica :meth:`MetricRegistry.collect` snapshots merged by
  :func:`merge_metric_snapshots`),
  :meth:`~ReplicaManager.aggregate_alerts`, and the
  :meth:`~ReplicaManager.collect_timeseries` /
  :meth:`~ReplicaManager.collect_events` fan-outs — the payloads of
  the router's ``stats``/``metrics``/``alerts``/``timeseries``/
  ``events`` ops.

Everything is stdlib-only, like the rest of the serving transport.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from distkeras_torch import telemetry
from distkeras_torch.serving.server import ServingClient

# replica health states
HEALTHY = "healthy"      # probed OK; eligible for routing
SUSPECT = "suspect"      # one probe failed; still routed, watched
DOWN = "down"            # consecutive probes failed / connection dead
DRAINING = "draining"    # engine reports draining: no new routes

# stats() keys summed into the fleet view (present-only: slot engines
# have no block keys, non-speculative engines no draft keys)
_SUM_KEYS = (
    "ticks", "requests_completed", "tokens_generated", "queue_depth",
    "active_slots", "prompt_tokens", "prefix_hit_tokens",
    "blocks_in_use", "blocks_free", "blocks_reclaimable",
    "draft_tokens", "accepted_tokens", "decode_stalls",
    "kv_blocks_exported", "kv_blocks_imported", "weight_swaps",
)

# stats() keys merged by MAX: versions, where a fleet sum is nonsense
# (three replicas serving weight_version 7 are not at version 21 — the
# fleet is at the highest version any replica has converged to, and a
# laggard shows up as its per-replica snapshot disagreeing)
_MAX_KEYS = ("weight_version",)

# metric gauge families merged by MAX instead of SUM: versions and 0/1
# flags. Everything else the serving stack exports as a gauge (blocks
# in use, queue depth, occupancy) is an additive resource quantity
# where the fleet sum is the right read.
_GAUGE_MAX_FAMILIES = frozenset({
    "serving_weight_version",  # version, not a quantity
    "slo_alert_active",        # 0/1 flag per rule: any-firing, not count
    "router_replica_up",       # 0/1 flag (labeled per replica, but a
                               # nested router must not sum its parents')
})


class Replica:
    """One backend LM server as the router sees it. Thread-safety: the
    ``client`` reference is swapped only by the manager's probe thread
    (connect/reconnect) and by :meth:`mark_down`; readers snapshot it
    once (``replica.client``) and rely on the client's own terminal
    :data:`~distkeras_torch.serving.DISCONNECTED` frames when it dies
    under them."""

    def __init__(self, host: str, port: int, name: Optional[str] = None,
                 request_timeout: float = 60.0):
        self.host, self.port = host, int(port)
        self.name = name or f"{host}:{port}"
        self.request_timeout = request_timeout
        self.client: Optional[ServingClient] = None
        self.state = DOWN          # until the first successful probe
        self.last_stats: Dict = {}
        self.failures = 0          # consecutive probe failures
        self.next_attempt_t = 0.0  # monotonic gate for backoff
        self.backoff_s = 0.0
        self.generation = 0        # bumps per connection death
        self._lock = threading.Lock()

    def connect(self) -> ServingClient:
        """(Re)establish the backend connection. Socket timeout None:
        a router's backend connection may sit idle between requests and
        must not be torn down by a read deadline — liveness comes from
        request-level timeouts and the probe loop."""
        client = ServingClient(self.host, self.port, timeout=None,
                               request_timeout=self.request_timeout)
        with self._lock:
            self.client = client
        return client

    def mark_down(self, reason: str = ""):
        """Declare the replica dead: close the client (its reader seeds
        terminal DISCONNECTED frames, unblocking every proxied stream so
        failover can replay them) and bump the generation. Idempotent
        per connection."""
        with self._lock:
            client, self.client = self.client, None
            if self.state != DOWN:
                self.generation += 1
            self.state = DOWN
        if client is not None:
            client.close()

    @property
    def role(self) -> str:
        """Advertised replica specialization, from the last polled
        stats: ``prefill`` / ``decode`` / ``mixed`` (the default for
        replicas that predate roles). The router's disaggregation pool
        split keys on this."""
        # analysis: unguarded-ok (monitor read of a probe-thread dict
        # rebind; a stale role only delays a pool reclassification one
        # poll, exactly like every other last_stats consumer)
        return str(self.last_stats.get("role", "mixed"))

    def snapshot(self) -> Dict:
        """Plain-data view for the aggregated stats op. ``state`` and
        ``last_stats`` move under the probe thread's hands; read them
        under the lock so one snapshot is internally consistent."""
        with self._lock:
            state, stats = self.state, self.last_stats
        return {"state": state, "host": self.host, "port": self.port,
                **({"stats": stats} if stats else {})}


def merge_metric_snapshots(snapshots: Sequence[Dict[str, dict]],
                           ) -> Dict[str, dict]:
    """Merge :meth:`MetricRegistry.collect` snapshots from N replicas
    into one fleet view: series with identical labels are merged per
    family policy — counters summed, histograms bucket-by-bucket (plus
    sum and count), gauges summed when they are additive resource
    quantities (blocks in use, queue depth, occupancy) but taken by
    MAX for the version/flag families in :data:`_GAUGE_MAX_FAMILIES`
    (summing ``serving_weight_version`` or ``slo_alert_active`` across
    replicas yields nonsense — a fleet is at the highest version any
    replica serves, and one firing alert must read 1, not N). Families
    whose type/labelnames disagree across replicas are kept from the
    first snapshot only (a version-skewed replica must not corrupt the
    fleet view)."""
    out: Dict[str, dict] = {}
    for snap in snapshots:
        for name, fam in snap.items():
            cur = out.get(name)
            if cur is None:
                # deep-enough copy: we mutate series values below
                out[name] = {
                    "type": fam.get("type"), "help": fam.get("help"),
                    "labelnames": list(fam.get("labelnames", [])),
                    "series": [dict(s) for s in fam.get("series", [])],
                }
                continue
            if (cur.get("type") != fam.get("type")
                    or cur.get("labelnames")
                    != list(fam.get("labelnames", []))):
                continue  # skewed family: first replica wins
            by_key = {tuple(sorted(s.get("labels", {}).items())): s
                      for s in cur["series"]}
            for s in fam.get("series", []):
                key = tuple(sorted(s.get("labels", {}).items()))
                have = by_key.get(key)
                if have is None:
                    s = dict(s)
                    cur["series"].append(s)
                    by_key[key] = s
                elif (cur["type"] == "gauge"
                        and name in _GAUGE_MAX_FAMILIES):
                    have["value"] = max(have.get("value", 0.0),
                                        s.get("value", 0.0))
                elif cur["type"] in ("counter", "gauge"):
                    have["value"] = (have.get("value", 0.0)
                                     + s.get("value", 0.0))
                elif cur["type"] == "histogram":
                    hb, sb = have.get("buckets", {}), s.get("buckets", {})
                    have["buckets"] = {
                        k: hb.get(k, 0) + sb.get(k, 0)
                        for k in set(hb) | set(sb)
                    }
                    have["sum"] = round(
                        have.get("sum", 0.0) + s.get("sum", 0.0), 6)
                    have["count"] = (have.get("count", 0)
                                     + s.get("count", 0))
                    # exemplars: per bucket, keep the worst (highest
                    # value) observation across replicas — the fleet
                    # tail names the trace that actually hurt
                    he, se = (have.get("exemplars"),
                              s.get("exemplars"))
                    if se:
                        he = dict(he) if he else {}
                        for le, ex in se.items():
                            cur_ex = he.get(le)
                            if (cur_ex is None
                                    or ex.get("value", 0.0)
                                    > cur_ex.get("value", 0.0)):
                                he[le] = dict(ex)
                        have["exemplars"] = he
    return out


class ReplicaManager:
    """Health probing, load polling, and fleet aggregation over a set
    of :class:`Replica` backends.

    One ``stats`` round trip per replica per ``poll_interval`` serves
    three masters: it is the liveness probe (a replica that cannot
    answer within ``probe_timeout`` is suspect; ``down_after``
    consecutive failures downs it), the load sample the router's spill
    decision reads (``last_stats``), and the drain detector (an engine
    reporting ``draining`` stops receiving new routes without being
    treated as failed). Downed replicas are reconnected under
    exponential backoff (``backoff_base`` doubling to ``backoff_max``)
    and return to ``healthy`` on the first good probe.

    ``on_down(replica)`` fires exactly once per connection death,
    *after* the replica's client has been closed — by then every stream
    proxied from it has already received its terminal DISCONNECTED
    frame, so the callback (the router's failover hook) races nothing.
    """

    def __init__(self, replicas: Sequence[Replica],
                 poll_interval: float = 0.25,
                 probe_timeout: float = 5.0,
                 down_after: int = 2,
                 backoff_base: float = 0.2,
                 backoff_max: float = 5.0,
                 registry: Optional[telemetry.MetricRegistry] = None,
                 on_down: Optional[Callable[[Replica], None]] = None,
                 on_drain: Optional[Callable[[Replica], None]] = None,
                 probe_fault: Optional[Callable[[Replica], bool]] = None):
        if not replicas:
            raise ValueError("ReplicaManager needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique; got {names}")
        self.replicas: List[Replica] = list(replicas)
        self.poll_interval = poll_interval
        self.probe_timeout = probe_timeout
        self.down_after = max(int(down_after), 1)
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.registry = registry or telemetry.get_registry()
        self.on_down = on_down
        # fired once per transition INTO draining (probe-detected or
        # noted via note_drain): the router forgets the replica's
        # affinity placements so traffic stops steering at a replica
        # that refuses it — previously only death forgot them, and a
        # drained replica kept attracting its whole prefix keyspace
        self.on_drain = on_drain
        # fault-injection seam (chaos tests): consulted before each
        # probe round trip; returning True makes that probe fail as if
        # the replica were unreachable — deterministic replica-death
        # injection without touching any socket (the transport-level
        # twin is networking.FaultInjector)
        self.probe_fault = probe_fault
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_up = self.registry.gauge(
            "router_replica_up",
            "1 when the replica answers probes, else 0",
            labelnames=("replica",),
        )
        self._m_depth = self.registry.gauge(
            "router_replica_queue_depth",
            "last polled admission-queue depth per replica",
            labelnames=("replica",),
        )
        self._m_active = self.registry.gauge(
            "router_replica_active_slots",
            "last polled occupied decode slots per replica",
            labelnames=("replica",),
        )
        self._m_blocks = self.registry.gauge(
            "router_replica_blocks_in_use",
            "last polled KV blocks in use per replica (paged engines)",
            labelnames=("replica",),
        )

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ReplicaManager":
        """One synchronous probe pass (so the router starts with a live
        view), then the background loop."""
        self.probe_all()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        for r in self.replicas:
            client = r.client
            if client is not None:
                client.close()

    def _loop(self):
        """Probe each replica on its own phase-offset schedule rather
        than the whole fleet on one synchronized beat: N replicas
        probed back-to-back every ``poll_interval`` is a self-inflicted
        stats stampede (every engine answers a stats op in the same
        instant, and the round-trip burst grows with the fleet). The
        offset is a stable hash of the replica name — deterministic
        across restarts, spread uniformly over the interval — and each
        replica then repeats at ``poll_interval`` cadence, so the
        probes of a large fleet interleave instead of clustering."""
        now = time.monotonic()
        next_t = {r.name: now + self._phase(r.name)
                  for r in self.replicas}
        tick = max(self.poll_interval / 4.0, 0.01)
        while not self._stop.wait(tick):
            now = time.monotonic()
            for r in list(self.replicas):
                due = next_t.get(r.name)
                if due is None:
                    # replica added at runtime: phase it in like the rest
                    due = now + self._phase(r.name)
                    next_t[r.name] = due
                if now >= due:
                    next_t[r.name] = now + self.poll_interval
                    self.probe(r)
                if self._stop.is_set():
                    return
            if len(next_t) != len(self.replicas):
                live = {r.name for r in self.replicas}
                for n in [n for n in next_t if n not in live]:
                    del next_t[n]

    def _phase(self, name: str) -> float:
        """Deterministic per-replica probe phase in ``[0,
        poll_interval)``, from a stable string hash (Python's ``hash``
        is salted per process — two routers would disagree)."""
        h = 0
        for ch in name.encode():
            h = (h * 131 + ch) & 0xFFFFFFFF
        return (h / 0x100000000) * self.poll_interval

    # -- probing ------------------------------------------------------------

    def probe_all(self):
        for r in self.replicas:
            if self._stop.is_set():
                return
            self.probe(r)

    def probe(self, r: Replica):
        """One health/load round trip for one replica (respects the
        reconnect backoff gate for downed replicas)."""
        now = time.monotonic()
        if r.state == DOWN and now < r.next_attempt_t:
            return
        try:
            if self.probe_fault is not None and self.probe_fault(r):
                raise ConnectionError(
                    f"injected probe fault on {r.name}"
                )
            client = r.client
            if client is None or client.closed:
                client = r.connect()
            stats = client._call({"op": "stats"},
                                 timeout=self.probe_timeout)["stats"]
        except Exception:
            with r._lock:
                r.failures += 1
                go_down = (r.state == DOWN
                           or r.failures >= self.down_after)
                if not go_down:
                    r.state = SUSPECT
            if go_down:
                self._down(r)  # takes the replica lock itself
            self._m_up.labels(replica=r.name).set(0)
            return
        with r._lock:
            r.failures = 0
            r.backoff_s = 0.0
            r.last_stats = dict(stats)
            was = r.state
            r.state = DRAINING if stats.get("draining") else HEALTHY
        if r.state == DRAINING and was != DRAINING:
            self.note_drain(r)
        self._m_up.labels(replica=r.name).set(1)
        self._m_depth.labels(replica=r.name).set(
            stats.get("queue_depth", 0))
        self._m_active.labels(replica=r.name).set(
            stats.get("active_slots", 0))
        if "blocks_in_use" in stats:
            self._m_blocks.labels(replica=r.name).set(
                stats["blocks_in_use"])

    def note_failure(self, r: Replica):
        """The router observed a hard failure on this replica (send
        failed, connection refused mid-submit): down it now instead of
        waiting for the next probe round."""
        self._down(r)
        self._m_up.labels(replica=r.name).set(0)

    def note_drain(self, r: Replica):
        """A replica entered draining (probe-detected, or the router
        forwarded an admin drain and flipped the state itself): fire
        the ``on_drain`` hook so placement state stops steering
        traffic at it. Safe to call repeatedly; the probe path already
        deduplicates transitions."""
        if self.on_drain is not None:
            try:
                self.on_drain(r)
            except Exception:
                pass  # a drain-hook bug must not kill the probe loop

    def _down(self, r: Replica):
        was_down = r.state == DOWN
        r.mark_down()
        r.backoff_s = (min(max(r.backoff_s * 2, self.backoff_base),
                           self.backoff_max))
        r.next_attempt_t = time.monotonic() + r.backoff_s
        if not was_down and self.on_down is not None:
            try:
                self.on_down(r)
            except Exception:
                pass  # a failover-hook bug must not kill the probe loop

    # -- membership ---------------------------------------------------------

    def add(self, replica: Replica) -> Replica:
        """Join a replica to the fleet at runtime (the autoscaler's
        scale-up actuator). One synchronous probe runs immediately so
        the new replica enters routing with a live stats view instead
        of waiting out a poll interval; the background loop then picks
        it up on its own phase-offset schedule."""
        if any(r.name == replica.name for r in self.replicas):
            raise ValueError(
                f"replica name {replica.name!r} already in the fleet"
            )
        # rebind-not-mutate: probe loop and routing policies iterate
        # self.replicas lock-free; they see the old or the new list,
        # both internally consistent
        self.replicas = self.replicas + [replica]
        self.probe(replica)
        return replica

    def remove(self, name: str) -> Replica:
        """Retire a replica from the fleet at runtime (the scale-down
        actuator; callers drain it first). The removed replica stops
        being probed and routed immediately; its connection is left to
        the caller to close (the router does, after forgetting its
        affinity placements)."""
        replica = self.get(name)
        if len(self.replicas) <= 1:
            raise ValueError("cannot remove the last replica")
        self.replicas = [r for r in self.replicas if r.name != name]
        self._m_up.labels(replica=name).set(0)
        return replica

    # -- views --------------------------------------------------------------

    def get(self, name: str) -> Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(f"no replica named {name!r}; have "
                       f"{[r.name for r in self.replicas]}")

    def routable(self, roles=None) -> List[Replica]:
        """Replicas eligible for NEW requests: healthy or suspect (a
        single missed probe sheds no traffic), never down or
        draining. ``roles`` optionally restricts to advertised replica
        roles (the disaggregation pool split: ``("prefill",)`` for the
        prefill pool, ``("decode", "mixed")`` for the decode side)."""
        out = [r for r in self.replicas
               if r.state in (HEALTHY, SUSPECT) and r.client is not None]
        if roles is not None:
            out = [r for r in out if r.role in roles]
        return out

    # -- aggregation --------------------------------------------------------

    def aggregate_stats(self) -> Dict:
        """Fleet sums over the last polled per-replica stats, plus the
        per-replica snapshots. Down replicas contribute their last
        known counters (totals stay monotone through a blip) and are
        visible via their ``state``."""
        fleet: Dict = {}
        for r in self.replicas:
            for k in _SUM_KEYS:
                v = r.last_stats.get(k)
                if v is not None:
                    fleet[k] = fleet.get(k, 0) + v
            for k in _MAX_KEYS:
                v = r.last_stats.get(k)
                if v is not None:
                    fleet[k] = max(fleet.get(k, v), v)
        hit, total = (fleet.get("prefix_hit_tokens"),
                      fleet.get("prompt_tokens"))
        if total and hit is not None:
            fleet["prefix_hit_fraction"] = round(hit / total, 4)
        fleet["replicas_total"] = len(self.replicas)
        fleet["replicas_routable"] = len(self.routable())
        return {
            "fleet": fleet,
            "replicas": {r.name: r.snapshot() for r in self.replicas},
        }

    def aggregate_metrics(self) -> Dict[str, dict]:
        """Live ``metrics`` snapshots from every routable replica,
        merged by :func:`merge_metric_snapshots`. A replica that fails
        the fetch is skipped (and will fail its next probe)."""
        snaps = []
        for r in self.routable():
            client = r.client
            if client is None:
                continue
            try:
                snaps.append(client._call(
                    {"op": "metrics"}, timeout=self.probe_timeout
                )["metrics"])
            except Exception:
                continue
        return merge_metric_snapshots(snaps)

    def collect_trace(self, trace: int) -> List[List[dict]]:
        """``trace_dump(trace)`` from every routable replica — the
        fan-out leg of fleet trace collection. One propagated trace id
        names spans on the router AND whichever replicas served (or
        replayed) the request; the router merges these chains with its
        own spans via
        :func:`~distkeras_torch.telemetry.merge_span_chains`. A replica
        that fails the fetch is skipped (its spans may still be in the
        router's :class:`~distkeras_torch.telemetry.TraceArchive`)."""
        out: List[List[dict]] = []
        for r in self.routable():
            client = r.client
            if client is None:
                continue
            try:
                out.append(client.trace_dump(trace=trace))
            except Exception:
                continue
        return out

    def collect_timeseries(self, last: Optional[int] = None,
                           ) -> Dict[str, List[dict]]:
        """Every routable replica's metric-history points, keyed by
        replica name — the fan-out leg of fleet time-series
        collection (the router merges them with its own store via
        :func:`~distkeras_torch.telemetry.merge_timeseries`). A replica
        that fails the fetch, or has its collector disabled, is
        skipped."""
        out: Dict[str, List[dict]] = {}
        for r in self.routable():
            client = r.client
            if client is None:
                continue
            msg: Dict = {"op": "timeseries"}
            if last is not None:
                msg["last"] = int(last)
            try:
                out[r.name] = client._call(
                    msg, timeout=self.probe_timeout
                )["timeseries"]["points"]
            except Exception:
                continue
        return out

    def collect_events(self, last: Optional[int] = None,
                       ) -> Dict[str, List[dict]]:
        """Every routable replica's control-plane journal, keyed by
        replica name — merged with the router's own journal via
        :func:`~distkeras_torch.telemetry.merge_event_journals`. A
        replica that fails the fetch is skipped."""
        out: Dict[str, List[dict]] = {}
        for r in self.routable():
            client = r.client
            if client is None:
                continue
            msg: Dict = {"op": "events"}
            if last is not None:
                msg["last"] = int(last)
            try:
                out[r.name] = client._call(
                    msg, timeout=self.probe_timeout
                )["events"]["events"]
            except Exception:
                continue
        return out

    def aggregate_alerts(self) -> List[dict]:
        """Every routable replica's SLO alerts, tagged with the replica
        name (firing state is per-replica; the router adds no rules of
        its own)."""
        out: List[dict] = []
        for r in self.routable():
            client = r.client
            if client is None:
                continue
            try:
                alerts = client._call(
                    {"op": "alerts"}, timeout=self.probe_timeout
                )["alerts"]
            except Exception:
                continue
            for a in alerts:
                a = dict(a)
                a["replica"] = r.name
                out.append(a)
        return out
