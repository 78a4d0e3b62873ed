"""Prefix-affinity router: one wire-compatible front door for N
`LMServer` replicas.

One continuous-batching engine is one chip's worth of serving; the
fleet story needs a coordinator that looks exactly like a single
server to clients. The :class:`Router` speaks the framed-msgpack
protocol of :mod:`distkeras_torch.serving.server` on the front (a plain
:class:`~distkeras_torch.serving.ServingClient` works against it
unchanged) and holds persistent backend connections to N replicas via
:class:`~distkeras_torch.serving.fleet.ReplicaManager`. Per request it
decides *where*, then proxies the token stream back, re-tagged with a
router-scoped request id.

Routing policy (``policy="affine"``, the default):

1. **Prefix affinity.** A router-side
   :class:`~distkeras_torch.serving.prefix.RadixPrefixIndex` — the same
   radix machinery each paged replica uses over KV blocks, here over
   *synthetic* block ids mapped to replica names — matches the prompt's
   leading ``block_size``-token chunks against previously routed
   prompts. A hit of at least ``min_affinity_blocks`` chunks routes to
   the replica whose radix KV cache already holds that prefix, so the
   per-replica prefix caches keep paying off fleet-wide instead of
   being diluted round-robin.
2. **Consistent hashing** places cold prefixes: the first prompt chunk
   hashes onto a ring of virtual nodes, so placement is deterministic
   across router restarts and only ``1/N`` of keyspace moves when a
   replica joins or dies.
3. **Load-aware spill.** If the chosen replica's last polled stats
   report saturation (queue depth ≥ ``spill_queue_depth``, or a paged
   block pool with ≤ ``spill_min_free_blocks`` free), the request
   spills to the least-loaded routable replica instead — affinity is a
   preference, never a queue. A backend that still answers
   ``overloaded`` triggers the same spill reactively, and only when
   *every* routable replica refuses does the router return the typed
   ``overloaded`` rejection to the client (fleet-level admission
   control).

Robustness:

- **Health/failover.** The manager's probe loop downs replicas that
  stop answering; downing closes the backend connection, which
  delivers a terminal DISCONNECTED frame to every stream proxied from
  it. Each stream's pump then *replays* its request on a surviving
  replica — engines generate deterministically from (prompt, seed), so
  the replay re-derives the identical stream and the pump forwards
  only the tokens the client has not already seen. Not-yet-started
  requests are thereby requeued with zero client-visible artifacts;
  mid-stream requests resume seamlessly. Accepted streams are lost
  only when every replica is gone.
- **Graceful drain.** ``drain`` against the router closes router
  admissions (in-flight streams finish); ``drain`` with a ``replica``
  field forwards to that replica and stops routing to it — the
  rolling-deploy primitive.

Telemetry: ``router_*`` counters (routed per replica, spilled,
failed-over, replayed tokens, failed, overload rejections) and
per-replica health/load gauges live in the router's registry; the
``stats`` op answers fleet sums + per-replica snapshots + the router
section, ``metrics`` merges every replica's registry snapshot with the
router's own, and ``alerts`` concatenates per-replica SLO alerts
tagged by replica. The ``timeseries`` op merges every replica's
metric-history ring with the router's own per time bucket, and the
``events`` op interleaves the fleet's control-plane journals
(autoscaling, drains, weight pushes, rollbacks, migrations, replica
up/down) into one timestamp-ordered story.

Distributed tracing: the router mints ONE fleet-unique trace id per
request (or honors one the client propagated) and forwards it on every
backend submit — the replica's ``queued → prefill → decode → finish``
spans join the router's ``router.route``/``router.stream`` spans under
the same id, across processes, including failover replays (the replay
keeps the original id; ``router.failover`` is the link span). The
``trace_dump`` op with a ``trace`` field *fans out* to the replicas and
answers the **merged** chain; at stream end each request's merged chain
is snapshotted into a bounded
:class:`~distkeras_torch.telemetry.TraceArchive`, so chains outlive the
per-process rings. ``chrome_trace`` exports any chain as Chrome
trace-event JSON (pid=process, tid=slot/stream, flow arrows across the
router hop) for ui.perfetto.dev, and the router observes its routing
overhead into the ``serving_request_critical_path_ms{phase="router"}``
histogram the replicas fill their phases into.
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import random
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from distkeras_torch import telemetry
from distkeras_torch.networking import recv_msg, send_msg
from distkeras_torch.telemetry.chrome import to_chrome_trace
from distkeras_torch.telemetry.events import EventJournal, merge_event_journals
from distkeras_torch.telemetry.timeseries import TimeSeriesStore, merge_timeseries
from distkeras_torch.telemetry.trace import merge_span_chains
from distkeras_torch.serving.fleet import (
    _GAUGE_MAX_FAMILIES,
    DOWN,
    DRAINING,
    HEALTHY,
    Replica,
    ReplicaManager,
    merge_metric_snapshots,
)
from distkeras_torch.serving.prefix import RadixPrefixIndex
from distkeras_torch.serving.scheduler import DrainingError
from distkeras_torch.serving.server import (
    DISCONNECTED,
    MAX_SERVE_FRAME_BYTES,
    OverloadedError,
    ServingClient,
    ServingConnectionError,
    shutdown_close,
)
from distkeras_torch.serving.weights import WeightPushError


class _HashRing:
    """Consistent hashing over replica names: ``vnodes`` virtual points
    per replica on a 64-bit ring. Lookup walks clockwise from the
    key's point to the first vnode whose replica is in the caller's
    alive set — removing a replica only remaps the keys that pointed
    at it."""

    def __init__(self, names: Sequence[str], vnodes: int = 64):
        points: List[Tuple[int, str]] = sorted(
            (self._hash(f"{name}#{v}".encode()), name)
            for name in names for v in range(vnodes)
        )
        self._hashes = [h for h, _ in points]
        self._names = [n for _, n in points]

    @staticmethod
    def _hash(data: bytes) -> int:
        return int.from_bytes(hashlib.sha1(data).digest()[:8], "big")

    def lookup(self, key: bytes, alive: Set[str]) -> Optional[str]:
        if not self._hashes or not alive:
            return None
        n = len(self._hashes)
        i = bisect.bisect_right(self._hashes, self._hash(key))
        for off in range(n):
            name = self._names[(i + off) % n]
            if name in alive:
                return name
        return None


class _AllZero:
    """Refcount view where every block is unreferenced — the router's
    affinity index has no live pins; eviction order is pure LRU."""

    def __getitem__(self, _):
        return 0


class _OwnerRef:
    """Refcount view that pins every block except one owner's: feeding
    this to ``evict_lru`` repeatedly strips exactly that owner's
    reachable (leaf-first) nodes from the index."""

    def __init__(self, owner_of: Dict[int, str], owner: str):
        self._owner_of, self._owner = owner_of, owner

    def __getitem__(self, b):
        return 0 if self._owner_of.get(b) == self._owner else 1


class PrefixAffinityIndex:
    """Prompt-prefix → replica map on the
    :class:`~distkeras_torch.serving.prefix.RadixPrefixIndex` machinery.

    Each radix node's "physical block" is a synthetic id mapped to the
    replica that prompt chunk was routed to; a lookup walks the
    prompt's full-chunk matches and reports the deepest chunk's owner
    (the replica holding the *longest* cached prefix wins).
    ``max_nodes`` bounds memory: beyond it, least-recently-matched
    leaves are evicted — exactly the replicas' own cache discipline,
    so the router's view of "who has this prefix" ages out roughly
    when the replica's cache does. Callers synchronize (the router
    holds its route lock); like the engine-side index, this class has
    no locks of its own."""

    def __init__(self, block_size: int = 16, max_nodes: int = 4096):
        self.block_size = block_size
        self.max_nodes = max_nodes
        self._idx = RadixPrefixIndex(block_size)
        self._owner_of: Dict[int, str] = {}
        self._ids = itertools.count(1)

    def __len__(self) -> int:
        return len(self._idx)

    def lookup(self, tokens) -> Tuple[Optional[str], int]:
        """(owner of the deepest fully-matched chunk, matched tokens);
        ``(None, 0)`` when no full chunk matches."""
        m = self._idx.match(tokens)
        for b in reversed(m.blocks):
            owner = self._owner_of.get(b)
            if owner is not None:
                return owner, len(m.blocks) * self.block_size
        return None, 0

    def place(self, tokens, owner: str):
        """Record that this prompt's chunks now live on ``owner``.
        Chunks already present keep their existing owner (affinity
        sticks to first placement — deterministic under concurrent
        same-prefix requests), new chunks get fresh synthetic ids."""
        n_full = len(tokens) // self.block_size
        if n_full == 0:
            return
        ids = [next(self._ids) for _ in range(n_full)]
        for b in self._idx.insert(tokens, ids):
            self._owner_of[b] = owner
        zero = _AllZero()
        while len(self._idx) > self.max_nodes:
            b = self._idx.evict_lru(zero)
            if b is None:
                break
            self._owner_of.pop(b, None)

    def forget(self, owner: str):
        """Drop a dead replica's placements so its prefixes re-place
        on survivors (interior nodes with living children of other
        owners stay; lookups skip them via the health check)."""
        ref = _OwnerRef(self._owner_of, owner)
        while True:
            b = self._idx.evict_lru(ref)
            if b is None:
                break
            self._owner_of.pop(b, None)


class _Entry:
    """One client request in flight through the router."""

    __slots__ = ("rid", "conn", "lock", "params", "trace_id", "replica",
                 "client", "backend_rid", "skip", "n_backend",
                 "delivered", "replays", "aborted", "t0", "route_ms")

    def __init__(self, rid: int, conn, lock, params: dict, trace_id):
        self.rid = rid
        self.conn, self.lock = conn, lock
        self.params = params          # enough to replay verbatim
        self.trace_id = trace_id
        self.replica: Optional[Replica] = None
        self.client: Optional[ServingClient] = None
        self.backend_rid: Optional[int] = None
        self.skip = 0                 # replay: suppress first N tokens
        self.n_backend = 0            # tokens seen from current attempt
        self.delivered = 0            # tokens the client has received
        self.replays = 0
        self.aborted = False          # client connection gone
        self.t0 = time.monotonic()
        self.route_ms = 0.0           # time spent routing (incl replays)


class Router:
    """Front a fleet of :class:`~distkeras_torch.serving.LMServer`
    replicas behind one wire-compatible endpoint (module docstring has
    the full routing/failover story).

    Args:
      replicas: backends as ``(host, port)`` tuples (names default to
        ``host:port``), ``(host, port, name)`` tuples, or prebuilt
        :class:`~distkeras_torch.serving.fleet.Replica` objects. All
        replicas must serve the SAME model weights: failover replays
        requests on survivors and relies on seeded decoding being
        deterministic across replicas.
      host/port: front-door bind (loopback by default, port 0 =
        ephemeral; read ``router.port`` after construction).
      policy: ``"affine"`` (radix affinity → consistent hash → spill),
        ``"hash"`` (consistent hash only), or ``"random"`` (uniform —
        the bench's control arm showing what affinity buys).
      block_size: affinity granularity in tokens; match the replicas'
        paged ``block_size`` so router chunks align with the blocks
        replicas actually cache.
      min_affinity_blocks: full chunks that must match before affinity
        overrides the hash placement (default 1).
      spill_queue_depth / spill_min_free_blocks: saturation thresholds
        on the polled replica stats.
      max_index_nodes: router-side radix size bound (LRU beyond it).
      disagg_prompt_tokens: enable prefill/decode disaggregation —
        prompts of at least this many tokens route through the
        prefill pool when the fleet advertises one (replicas whose
        ``stats()`` report ``role="prefill"`` / ``"decode"``): the
        prompt runs on a prefill replica, its KV blocks migrate to a
        decode replica over the ``export_kv``/``import_kv`` ops, and
        the request decodes there off a prefix-cache hit. Any failure
        along the way (empty export after losing the race with
        eviction, an unavailable pool, a refused import) falls back to
        the ordinary route — seeded decoding recomputes the identical
        stream, so migration is an optimization, never a correctness
        dependency. ``None`` (default) disables. With roles present,
        prefill-pool replicas are excluded from ordinary routing
        whenever a non-prefill replica is routable.
      max_replays: failover replays attempted per request before its
        stream is failed with reason ``"error"``.
      poll_interval / probe_timeout / down_after / backoff_base /
        backoff_max: forwarded to the
        :class:`~distkeras_torch.serving.fleet.ReplicaManager` probe loop.
      backend_request_timeout: per-reply wait on backend connections
        (acks and inter-token gaps).
      registry / tracer: router-side telemetry sinks (defaults:
        process-global).
      archive_traces / archive_capacity: snapshot each completed
        request's fleet-merged span chain into a bounded
        :class:`~distkeras_torch.telemetry.TraceArchive` (one backend
        ``trace_dump`` round trip per completed request, off the
        stream's critical path; ``archive_traces=False`` disables —
        ``trace_dump`` then answers only from live rings).
      rollback_guard_window_s: arm SLO-burn auto-rollback after every
        completed rolling weight update (:meth:`rolling_update` and
        the ``push_weights`` wire op): for this many seconds the
        router watches the fleet's SLO alerts, and the first firing
        rule triggers an automatic re-push of the *previous* weight
        version (``router_weight_rollbacks_total`` counts them).
        ``None`` (default) disables the guard unless a per-call
        ``guard_window_s`` is given.
      rollback_monitor: alert source for the guard — any object with
        an ``alerts()`` method (an
        :class:`~distkeras_torch.telemetry.SloMonitor` over router-side
        metrics); default ``None`` polls the per-replica SLO monitors
        through ``manager.aggregate_alerts()``.
    """

    def __init__(self, replicas: Sequence, host: str = "127.0.0.1",
                 port: int = 0, policy: str = "affine",
                 block_size: int = 16, min_affinity_blocks: int = 1,
                 spill_queue_depth: int = 8,
                 spill_min_free_blocks: int = 0,
                 max_index_nodes: int = 4096,
                 disagg_prompt_tokens: Optional[int] = None,
                 max_replays: int = 3,
                 poll_interval: float = 0.25, probe_timeout: float = 5.0,
                 down_after: int = 2, backoff_base: float = 0.2,
                 backoff_max: float = 5.0,
                 backend_request_timeout: float = 60.0,
                 max_frame_bytes: int = MAX_SERVE_FRAME_BYTES,
                 registry: Optional[telemetry.MetricRegistry] = None,
                 tracer: Optional[telemetry.Tracer] = None,
                 archive_traces: bool = True,
                 archive_capacity: int = 512,
                 rollback_guard_window_s: Optional[float] = None,
                 rollback_monitor=None,
                 seed: int = 0):
        if policy not in ("affine", "hash", "random"):
            raise ValueError(
                f"unknown policy {policy!r}: want 'affine', 'hash', or "
                f"'random'"
            )
        self.policy = policy
        self.registry = registry or telemetry.get_registry()
        self.tracer = tracer or telemetry.get_tracer()
        # control-plane journal (autoscaling, replica up/down, drains,
        # rollbacks, KV migrations) + router-side metric history; the
        # `events`/`timeseries` ops merge these with every replica's
        self.journal = EventJournal(actor="router")
        self.timeseries = TimeSeriesStore(registry=self.registry)
        built: List[Replica] = []
        for spec in replicas:
            if isinstance(spec, Replica):
                built.append(spec)
            else:
                built.append(Replica(
                    *spec, request_timeout=backend_request_timeout))
        self.manager = ReplicaManager(
            built, poll_interval=poll_interval,
            probe_timeout=probe_timeout, down_after=down_after,
            backoff_base=backoff_base, backoff_max=backoff_max,
            registry=self.registry, on_down=self._on_replica_down,
            on_drain=self._on_replica_drain,
        )
        self.index = PrefixAffinityIndex(block_size=block_size,
                                         max_nodes=max_index_nodes)
        self.ring = _HashRing([r.name for r in built])
        self.min_affinity_blocks = max(int(min_affinity_blocks), 1)
        self.disagg_prompt_tokens = disagg_prompt_tokens
        self.spill_queue_depth = spill_queue_depth
        self.spill_min_free_blocks = spill_min_free_blocks
        self.max_replays = max_replays
        self.max_frame_bytes = max_frame_bytes
        self.backend_request_timeout = backend_request_timeout
        self._rng = random.Random(seed)
        self._route_lock = threading.Lock()   # index + ring + rng
        self._rid_counter = itertools.count(1)
        self.draining = False
        self._inflight: Dict[int, _Entry] = {}
        self._inflight_lock = threading.Lock()
        # front door
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._conns_lock = threading.Lock()
        # router telemetry
        self._m_routed = self.registry.counter(
            "router_requests_routed_total",
            "requests routed, by replica and decision",
            labelnames=("replica", "decision"),
        )
        self._m_spilled = self.registry.counter(
            "router_requests_spilled_total",
            "requests diverted off their preferred replica by load",
        )
        self._m_failed_over = self.registry.counter(
            "router_requests_failed_over_total",
            "requests moved off a dead replica, by whether tokens had "
            "already streamed",
            labelnames=("kind",),  # requeued | replayed
        )
        self._m_failovers = self.registry.counter(
            "router_replica_failovers_total",
            "replica-down events that triggered failover handling",
        )
        self._m_failed = self.registry.counter(
            "router_requests_failed_total",
            "accepted requests whose stream could not be completed",
        )
        self._m_overloaded = self.registry.counter(
            "router_overload_rejections_total",
            "submits rejected because every routable replica refused",
        )
        self._m_inflight = self.registry.gauge(
            "router_inflight_requests",
            "requests currently proxied through the router",
        )
        # prefill/decode disaggregation: migration attempts by outcome
        # (ok / export_empty when the prefill replica lost the race
        # with its own eviction / import_empty / prefill_failed), the
        # end-to-end migration latency, and the KV payload size
        self._m_migrations = self.registry.counter(
            "serving_kv_migrations_total",
            "prefill->decode KV-block migrations attempted, by outcome",
            labelnames=("outcome",),
        )
        self._m_migration_ms = self.registry.histogram(
            "serving_kv_migration_ms",
            "end-to-end KV migration latency: prefill submit through "
            "import ack (ms)",
        )
        self._m_migrated_bytes = self.registry.histogram(
            "serving_kv_migrated_bytes",
            "KV payload bytes per successful block migration",
            buckets=(1 << 10, 1 << 14, 1 << 17, 1 << 20, 1 << 23,
                     1 << 26, 1 << 30),
        )
        # fleet tracing: completed chains archived per request, and the
        # router's own critical-path phase (routing overhead) in the
        # same family the replica engines fill
        self.archive = (telemetry.TraceArchive(archive_capacity)
                        if archive_traces else None)
        self._archive_lock = threading.Lock()
        self._archived = 0
        self._archive_errors = 0
        self._archive_ns = 0
        self._m_archived = self.registry.counter(
            "router_traces_archived_total",
            "completed request chains snapshotted into the trace archive",
        )
        self._m_critical = self.registry.histogram(
            "serving_request_critical_path_ms",
            "per-request time attribution by critical-path phase (ms)",
            labelnames=("phase",),
        )
        self._m_cp_router = self._m_critical.labels(phase="router")
        # live weight updates (rolling deploys): one rolling update at
        # a time (_update_serial); the version/payload history and all
        # counters live in ONE dict rebound atomically per update
        # (readers snapshot self._weights — the rebind-not-mutate
        # discipline, no lock on any read path). rollback_guard_window_s
        # arms the SLO-burn auto-rollback after every completed fleet
        # update: if the fleet's burn-rate rules fire within the
        # window, the previous version is re-pushed automatically.
        # rollback_monitor overrides the alert source (default: the
        # per-replica SLO monitors via manager.aggregate_alerts).
        self._update_serial = threading.Lock()
        self.rollback_guard_window_s = rollback_guard_window_s
        self.rollback_monitor = rollback_monitor
        self._weights: Dict = {
            "version": 0, "current": None, "prev": None,
            "updates": 0, "rollbacks": 0, "guard_deadline": None,
            "last": None,
        }
        self._m_weight_updates = self.registry.counter(
            "router_weight_updates_total",
            "fleet rolling weight updates, by outcome",
            labelnames=("outcome",),
        )
        self._m_weight_rollbacks = self.registry.counter(
            "router_weight_rollbacks_total",
            "automatic re-pushes of the previous weight version after "
            "an SLO burn inside the post-update guard window",
        )

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Router":
        self.manager.start()
        self.timeseries.start()
        self._sock.listen(128)
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        self.timeseries.stop()
        # shutdown-first: a bare close() would leave the accept loop
        # blocked in accept() until the join timeout
        shutdown_close(self._sock)
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            shutdown_close(c)
        self.manager.stop()
        for t in self._threads:
            t.join(timeout)

    # -- fleet events -------------------------------------------------------

    def _on_replica_down(self, replica: Replica):
        """Probe loop / note_failure downed a replica: the connection
        close has already delivered DISCONNECTED to every proxied
        stream (each pump replays itself); here we only retire the
        dead replica's affinity placements so new same-prefix requests
        re-place on survivors."""
        self._m_failovers.inc()
        with self._route_lock:
            self.index.forget(replica.name)
        self.tracer.record(None, "router.replica_down", time.monotonic(),
                           0.0, replica=replica.name)
        self.journal.append("replica_down", target=replica.name,
                            reason="probe_failure")

    def _on_replica_drain(self, replica: Replica):
        """A replica entered draining (probe-detected or admin drain):
        forget its affinity placements so same-prefix traffic re-places
        on replicas that will actually accept it. Before this hook only
        death forgot placements — a *drained* replica kept owning its
        prefix keyspace, and every affine request aimed at it just to
        bounce off the draining refusal."""
        with self._route_lock:
            self.index.forget(replica.name)
        self.tracer.record(None, "router.replica_drain",
                           time.monotonic(), 0.0, replica=replica.name)

    # -- routing ------------------------------------------------------------

    def _saturated(self, r: Replica) -> bool:
        s = r.last_stats
        if s.get("queue_depth", 0) >= self.spill_queue_depth:
            return True
        # block-pool saturation = nothing obtainable: free blocks plus
        # cached-unreferenced (evictable) ones. Falls back to the bare
        # free count against older replicas that don't report it.
        free = s.get("blocks_reclaimable", s.get("blocks_free"))
        if free is None:
            return False
        # tiered replicas: a demoted prefix block is one swap-in away
        # from a hit — spilling an affine request off a replica whose
        # device pool is merely churning (but whose host tier holds
        # the prefixes) would destroy the locality the tier exists to
        # preserve, so host-cached capacity counts before the pool is
        # declared saturated
        free += s.get("host_blocks_cached", 0)
        return free <= self.spill_min_free_blocks

    def _choose(self, prompt, exclude: Set[str],
                ) -> Tuple[Replica, str]:
        """Pick a target replica for one submit attempt. Returns
        (replica, decision) with decision one of affine/hash/random/
        spill. Raises ServingConnectionError when nothing is
        routable."""
        cands = [r for r in self.manager.routable()
                 if r.name not in exclude]
        # replicas advertising role="prefill" serve the prefill pool
        # (long prompts via migration), not ordinary traffic — unless
        # they are all that is left, when serving beats refusing
        nonpre = [r for r in cands if r.role != "prefill"]
        if nonpre:
            cands = nonpre
        if not cands:
            raise ServingConnectionError(
                f"no routable replica (fleet of "
                f"{len(self.manager.replicas)}; excluded={sorted(exclude)})"
            )
        by_name = {r.name: r for r in cands}
        with self._route_lock:
            if self.policy == "random":
                return self._rng.choice(cands), "random"
            preferred, decision = None, "hash"
            if self.policy == "affine":
                owner, hit = self.index.lookup(prompt)
                if (owner in by_name and hit
                        >= self.min_affinity_blocks
                        * self.index.block_size):
                    preferred, decision = by_name[owner], "affine"
            if preferred is None:
                key = bytes(bytearray().join(
                    int(t).to_bytes(4, "big", signed=False)
                    for t in list(prompt)[: self.index.block_size]
                ))
                name = self.ring.lookup(key, set(by_name))
                preferred = by_name[name] if name else cands[0]
        if self._saturated(preferred):
            relief = [r for r in cands
                      if r is not preferred and not self._saturated(r)]
            if relief:
                target = min(relief, key=lambda r: (
                    r.last_stats.get("queue_depth", 0),
                    r.last_stats.get("active_slots", 0),
                ))
                return target, "spill"
        return preferred, decision

    def _try_disagg(self, entry: _Entry, exclude: Set[str]) -> bool:
        """Prefill/decode disaggregation for one submit attempt: run a
        long prompt through the prefill pool, migrate its KV blocks to
        a decode replica (``export_kv`` → ``import_kv``), and submit
        the real request there — the decode replica's prefix cache hits
        the migrated span, so it prefills only the tail and its decode
        streams never feel the prompt. Returns True when the request
        was submitted this way; False falls through to the ordinary
        route (the seeded-replay fallback: a fresh prefill recomputes
        the identical stream, so losing the migration race with
        eviction — or an empty pool — costs latency, never
        correctness)."""
        if self.disagg_prompt_tokens is None:
            return False
        prompt = entry.params["prompt"]
        if len(prompt) < self.disagg_prompt_tokens:
            return False
        pre = [r for r in self.manager.routable(roles=("prefill",))
               if r.name not in exclude and r.client is not None]
        dec = [r for r in self.manager.routable(roles=("decode", "mixed"))
               if r.name not in exclude and r.client is not None]
        if not pre or not dec:
            return False
        with self._route_lock:
            owner, hit = self.index.lookup(prompt)
        if (owner is not None and any(r.name == owner for r in dec)
                and hit >= len(prompt) - 2 * self.index.block_size):
            # a decode replica already holds (nearly) this whole
            # prefix: the ordinary affine route IS the cache hit, and
            # a migration would only re-ship resident blocks
            return False
        src = min(pre, key=lambda r: (
            r.last_stats.get("active_slots", 0),
            r.last_stats.get("queue_depth", 0),
        ))
        relief = [r for r in dec if not self._saturated(r)] or dec
        dst = min(relief, key=lambda r: (
            r.last_stats.get("queue_depth", 0),
            r.last_stats.get("active_slots", 0),
        ))
        t0 = time.perf_counter()
        outcome = "prefill_failed"
        nbytes = 0
        ok = False
        try:
            sclient, dclient = src.client, dst.client
            if sclient is None or dclient is None:
                return False
            # a 1-token run forces the prompt through the prefill
            # replica's compute-optimized path and registers its
            # blocks in the radix index at finish; the token itself is
            # discarded (greedy, so no sampling state is consumed)
            rid = sclient.generate(prompt, 1, temperature=0.0,
                                   seed=int(entry.params.get("seed", 0)),
                                   trace=entry.trace_id,
                                   parent_span="router.migrate")
            for kind, _val in sclient.frames(rid):
                if kind == "end":
                    break
            exp = sclient.export_kv(prompt)
            if exp["tokens"] <= 0 or not exp["blocks"]:
                # lost the race with the prefill replica's own
                # eviction: nothing to ship — seeded-replay fallback
                outcome = "export_empty"
                return False
            outcome = "import_failed"
            imp = dclient.import_kv(prompt, exp["blocks"])
            if imp["imported"] <= 0:
                return False
            nbytes = sum(int(getattr(a, "nbytes", 0) or 0)
                         for blk in exp["blocks"] for a in blk)
            outcome = "submit_failed"
            entry.backend_rid = dclient.generate(
                prompt, entry.params["max_new_tokens"],
                trace=entry.trace_id, parent_span="router.route",
                **{k: v for k, v in entry.params.items()
                   if k not in ("prompt", "max_new_tokens")},
            )
            outcome, ok = "ok", True
        except (OverloadedError, DrainingError, ServingConnectionError,
                TimeoutError):
            return False
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            self._m_migrations.labels(outcome=outcome).inc()
            self._m_migration_ms.observe(ms)
            if nbytes:
                self._m_migrated_bytes.observe(nbytes)
            self.tracer.record(
                entry.trace_id, "router.migrate", time.monotonic(),
                0.0, outcome=outcome, prefill_replica=src.name,
                decode_replica=dst.name, bytes=nbytes,
                migration_ms=round(ms, 3),
            )
            # "from_replica", not "source": merge_event_journals tags
            # each event with its originating journal under "source"
            self.journal.append("kv_migrate", target=dst.name,
                                outcome=outcome, from_replica=src.name,
                                trace=entry.trace_id, bytes=nbytes)
        entry.replica, entry.client = dst, dclient
        entry.n_backend = 0
        if self.policy == "affine":
            with self._route_lock:
                self.index.place(prompt, dst.name)
        self._m_routed.labels(replica=dst.name, decision="disagg").inc()
        self.tracer.record(entry.trace_id, "router.route",
                           time.monotonic(), 0.0, replica=dst.name,
                           decision="disagg", replay=entry.replays)
        return ok

    def _submit_routed(self, entry: _Entry, exclude: Set[str]):
        """Route-and-submit with retries across the fleet. Long
        prompts try the disaggregated prefill→decode migration path
        first (:meth:`_try_disagg`); every failure there falls through
        to the ordinary route below. Typed backend refusals
        (overloaded / draining / dead connection) move to the next
        candidate; request-level errors (bad params) propagate to the
        caller untouched. Raises OverloadedError when every routable
        replica refused for load — the router's admission-control
        boundary."""
        if self._try_disagg(entry, exclude):
            return
        overloaded: Optional[OverloadedError] = None
        last_exc: Optional[Exception] = None
        for _ in range(len(self.manager.replicas)):
            try:
                replica, decision = self._choose(entry.params["prompt"],
                                                 exclude)
            except ServingConnectionError as e:
                last_exc = last_exc or e
                break
            client = replica.client
            if client is None:
                exclude.add(replica.name)
                continue
            try:
                # the router's trace id rides the wire: the replica's
                # span chain joins this request's fleet-wide trace
                # (failover replays keep the original id too)
                backend_rid = client.generate(
                    entry.params["prompt"],
                    entry.params["max_new_tokens"],
                    trace=entry.trace_id, parent_span="router.route",
                    **{k: v for k, v in entry.params.items()
                       if k not in ("prompt", "max_new_tokens")},
                )
            except OverloadedError as e:
                overloaded = e
                exclude.add(replica.name)
                continue
            except DrainingError:
                exclude.add(replica.name)
                continue
            except (ServingConnectionError, TimeoutError) as e:
                self.manager.note_failure(replica)
                last_exc = e
                exclude.add(replica.name)
                continue
            entry.replica, entry.client = replica, client
            entry.backend_rid = backend_rid
            entry.n_backend = 0
            if self.policy == "affine":
                with self._route_lock:
                    self.index.place(entry.params["prompt"], replica.name)
            self._m_routed.labels(replica=replica.name,
                                  decision=decision).inc()
            if decision == "spill":
                self._m_spilled.inc()
            self.tracer.record(entry.trace_id, "router.route",
                               time.monotonic(), 0.0,
                               replica=replica.name, decision=decision,
                               replay=entry.replays)
            return
        if overloaded is not None:
            self._m_overloaded.inc()
            raise overloaded
        raise last_exc or ServingConnectionError(
            "no routable replica accepted the request"
        )

    # -- stream proxy -------------------------------------------------------

    @staticmethod
    def _send(conn, lock, msg: dict):
        with lock:
            send_msg(conn, msg)

    def _send_entry(self, entry: _Entry, msg: dict):
        if entry.aborted:
            return
        try:
            self._send(entry.conn, entry.lock, msg)
        except (ConnectionError, OSError):
            # client went away: keep draining backend frames silently
            # (mirrors LMServer._pump), just stop forwarding
            entry.aborted = True

    def _pump(self, entry: _Entry):
        """Forward one request's backend stream to the client,
        replaying onto survivors when the backend dies mid-stream.
        Replay skips the tokens the client already holds — seeded
        decoding makes the replayed stream identical, so the client
        sees one seamless stream regardless of how many replicas died
        under it."""
        reason: Optional[str] = None
        while True:
            client = entry.client
            try:
                for kind, val in client.frames(entry.backend_rid):
                    if kind == "end":
                        reason = val
                        break
                    entry.n_backend += 1
                    if entry.n_backend > entry.skip:
                        self._send_entry(
                            entry, {"id": entry.rid, "t": int(val)})
                        entry.delivered += 1
            except TimeoutError:
                # stalled backend: treat like a dead one
                if entry.replica is not None:
                    self.manager.note_failure(entry.replica)
                reason = DISCONNECTED
            if reason != DISCONNECTED:
                break
            # backend died mid-stream: fail over
            dead = entry.replica
            if dead is not None and dead.state != DOWN:
                self.manager.note_failure(dead)
            if entry.replays >= self.max_replays:
                reason = "error"
                self._m_failed.inc()
                break
            entry.replays += 1
            self._m_failed_over.labels(
                kind="replayed" if entry.delivered else "requeued"
            ).inc()
            self.tracer.record(entry.trace_id, "router.failover",
                               time.monotonic(), 0.0,
                               from_replica=(dead.name if dead else "?"),
                               delivered=entry.delivered)
            entry.skip = entry.delivered
            try:
                t_route = time.perf_counter()
                self._submit_routed(
                    entry,
                    exclude={dead.name} if dead is not None else set(),
                )
                entry.route_ms += (time.perf_counter() - t_route) * 1e3
            except Exception:
                reason = "error"
                self._m_failed.inc()
                break
            reason = None
        # span before the done frame (same discipline as LMServer's
        # pump): a client that saw "done" can immediately trace_dump
        # the merged chain and find router.stream in it
        self.tracer.record(
            entry.trace_id, "router.stream", entry.t0,
            (time.monotonic() - entry.t0) * 1e3,
            tokens=entry.delivered, reason=reason,
            replays=entry.replays,
        )
        self._m_cp_router.observe(entry.route_ms)
        self._send_entry(entry, {
            "id": entry.rid, "done": 1, "reason": reason,
            "n": entry.delivered,
        })
        with self._inflight_lock:
            self._inflight.pop(entry.rid, None)
            self._m_inflight.set(len(self._inflight))
        self._archive_chain(entry)

    def _archive_chain(self, entry: _Entry):
        """Snapshot a completed request's fleet-merged span chain into
        the bounded archive: the router's own spans plus the serving
        replica's (one ``trace_dump`` round trip on this pump thread,
        after the client already has its done frame — never on the
        stream's critical path). Chains thereby outlive the
        per-process rings that fed them."""
        if self.archive is None:
            return
        t0 = time.perf_counter_ns()
        ok = True
        chains = [self.tracer.dump(trace=entry.trace_id)]
        client = entry.client
        if client is not None and not client.closed:
            try:
                chains.append(client.trace_dump(trace=entry.trace_id))
            except Exception:
                ok = False  # replica died post-stream: archive partial
        prior = self.archive.get(entry.trace_id)
        if prior:
            chains.append(prior)
        self.archive.put(entry.trace_id, merge_span_chains(*chains))
        self._m_archived.inc()
        with self._archive_lock:
            self._archived += 1
            if not ok:
                self._archive_errors += 1
            self._archive_ns += time.perf_counter_ns() - t0

    # -- live weight updates (rolling deploy + SLO-burn rollback) -----------

    def rolling_update(self, params=None, *, payload: Optional[bytes] = None,
                       version: Optional[int] = None, drain: bool = True,
                       retry_timeout_s: float = 60.0,
                       guard_window_s: Optional[float] = None,
                       monitor=None, _rollback: bool = False) -> dict:
        """Push one weight set across the whole fleet, one replica at
        a time: drain (stop routing new requests at it) → push the
        chunked payload → undrain, so at every instant at least N-1
        replicas stay routable and in-flight streams are never
        touched (a pushed replica's engine swaps at its own tick
        boundary; mid-stream requests continue uninterrupted).

        ``params`` is the variables dict (serialized here);
        ``payload`` passes already-serialized bytes (the wire arm and
        the rollback re-push use this). A replica that dies mid-push
        is retried through the manager's existing exponential-backoff
        reconnect machinery until ``retry_timeout_s`` — the update
        converges when it reconnects; replicas still unreachable at
        the deadline are reported in ``failed`` (and the fleet is
        version-skewed until a later push). A *validation* refusal
        (typed :class:`~distkeras_torch.serving.WeightPushError`) is
        fleet-fatal and re-raised immediately: the same payload would
        be refused everywhere, and a partly-updated fleet of
        *accepted* weights is recoverable while a half-pushed refusal
        is just noise.

        ``guard_window_s`` (default: the constructor's
        ``rollback_guard_window_s``) arms the SLO-burn auto-rollback
        after a fully-converged update: a guard thread polls the
        fleet's alerts (``monitor.alerts()`` when given, else every
        replica's SLO monitor via ``manager.aggregate_alerts``) for
        the window, and the first firing rule re-pushes the previous
        version (``router_weight_rollbacks_total``). Serialized: one
        rolling update at a time.

        Returns ``{"version", "updated", "failed", "events",
        "swap_ms", "rollback_armed"}`` — ``events`` carries one
        ``{replica, drain_t, pushed_t, undrain_t, swap_ms}`` record
        per successful push, in order (the rolling-update ordering
        tests assert the intervals never overlap)."""
        if payload is None:
            from distkeras_torch.serving.weights import serialize_weights

            payload = serialize_weights(params)
        with self._update_serial:
            report = self._rolling_update_locked(
                payload, version, drain, retry_timeout_s, _rollback)
        window = (guard_window_s if guard_window_s is not None
                  else self.rollback_guard_window_s)
        armed = (window is not None and not _rollback
                 and not report["failed"])
        if armed:
            self._arm_guard(report["version"], float(window),
                            monitor or self.rollback_monitor)
        report["rollback_armed"] = bool(armed)
        return report

    def _rolling_update_locked(self, payload: bytes,
                               version: Optional[int], drain: bool,
                               retry_timeout_s: float,
                               is_rollback: bool) -> dict:
        w = self._weights
        version = (int(version) if version is not None
                   and int(version) > w["version"]
                   else w["version"] + 1)
        t0 = time.perf_counter()
        names = [r.name for r in self.manager.replicas]
        pending = list(names)
        updated: List[str] = []
        events: List[dict] = []
        swap_ms = 0.0
        deadline = time.monotonic() + retry_timeout_s
        while pending and time.monotonic() < deadline:
            name = pending.pop(0)
            replica = self.manager.get(name)
            client = replica.client
            # never reduce the routable set below N-1: taking this
            # replica out is only allowed while every OTHER replica
            # is routable (a concurrently-dead peer pauses the
            # rollout instead of stacking outages)
            others = [r for r in self.manager.routable()
                      if r.name != name]
            if client is None or replica.state == DOWN \
                    or len(others) < len(names) - 1:
                pending.append(name)
                time.sleep(self.manager.poll_interval)
                continue
            ev: dict = {"replica": name}
            drained_here = False
            try:
                if drain:
                    ev["drain_t"] = time.monotonic()
                    client.drain()
                    replica.state = DRAINING
                    self.manager.note_drain(replica)
                    drained_here = True
                res = client.push_weights(payload=payload,
                                          version=version)
                ev["pushed_t"] = time.monotonic()
                ev["swap_ms"] = res.get("swap_ms")
                swap_ms = max(swap_ms, float(res.get("swap_ms") or 0.0))
                if drain:
                    client.undrain()
                    replica.state = HEALTHY
                    ev["undrain_t"] = time.monotonic()
            except WeightPushError:
                # fleet-fatal: the payload itself is bad — reopen the
                # replica and surface the typed refusal untouched
                if drained_here:
                    try:
                        client.undrain()
                        replica.state = HEALTHY
                    except Exception:
                        pass
                self._m_weight_updates.labels(outcome="refused").inc()
                raise
            except (ServingConnectionError, TimeoutError,
                    ConnectionError, OSError):
                # died mid-push: down it now; the probe loop's backoff
                # reconnect brings it back and this loop retries — the
                # update converges when the replica does
                self.manager.note_failure(replica)
                pending.append(name)
                continue
            updated.append(name)
            events.append(ev)
        outcome = ("rollback" if is_rollback
                   else ("partial" if pending else "ok"))
        self._m_weight_updates.labels(outcome=outcome).inc()
        if not pending:
            self._weights = {
                **w, "version": version,
                "prev": (w["current"] if not is_rollback
                         else w["prev"]),
                "current": (version, payload),
                "updates": w["updates"] + 1,
                "last": outcome,
            }
        else:
            self._weights = {**w, "last": outcome}
        total_ms = (time.perf_counter() - t0) * 1e3
        self.tracer.record(
            0, "router.rolling_update", time.monotonic(), 0.0,
            version=version, updated=len(updated),
            failed=len(pending), rollback=int(is_rollback),
            total_ms=round(total_ms, 3),
        )
        self.journal.append("weight_push", version=version,
                            updated=len(updated), failed=len(pending),
                            outcome=outcome)
        return {"version": version, "updated": updated,
                "failed": pending, "events": events,
                "swap_ms": round(swap_ms, 3),
                "total_ms": round(total_ms, 3)}

    def _arm_guard(self, version: int, window_s: float, monitor):
        """Watch the fleet's SLO alerts for ``window_s`` after update
        ``version``; the first firing rule triggers the rollback.
        One daemon thread per armed update; a newer update (or
        rollback) supersedes the watch."""
        deadline = time.monotonic() + window_s
        self._weights = {**self._weights, "guard_deadline": deadline}

        def guard():
            while (not self._stop.is_set()
                   and time.monotonic() < deadline):
                if self._weights["version"] != version:
                    return  # superseded by a newer update
                try:
                    alerts = (monitor.alerts() if monitor is not None
                              else self.manager.aggregate_alerts())
                except Exception:
                    alerts = []
                firing = [a.get("rule") for a in alerts
                          if a.get("firing")]
                if firing:
                    self._auto_rollback(version, firing)
                    return
                time.sleep(self.manager.poll_interval)

        t = threading.Thread(target=guard, daemon=True)
        t.start()
        self._threads.append(t)

    def _auto_rollback(self, burned_version: int, rules: List):
        """The guard fired inside the window: re-push the previous
        weight version fleet-wide (no guard on the re-push — rolling
        back a rollback is an operator decision, not an automatic
        one). Without a recorded previous version (the burn hit the
        first ever update) the rollback is recorded as unavailable
        and the fleet keeps the burned weights — alerting is already
        firing, and guessing at weights would be worse."""
        prev = self._weights["prev"]
        self._m_weight_rollbacks.inc()
        self.tracer.record(
            0, "router.rollback", time.monotonic(), 0.0,
            version=burned_version,
            rules=",".join(str(r) for r in rules),
            available=int(prev is not None),
        )
        self.journal.append("rollback", version=burned_version,
                            rules=[str(r) for r in rules],
                            available=int(prev is not None))
        if prev is None:
            self._weights = {**self._weights,
                             "rollbacks":
                                 self._weights["rollbacks"] + 1,
                             "last": "rollback_unavailable"}
            return
        self._weights = {**self._weights,
                         "rollbacks": self._weights["rollbacks"] + 1}
        try:
            self.rolling_update(payload=prev[1], guard_window_s=None,
                                _rollback=True)
        except Exception:
            self._weights = {**self._weights,
                             "last": "rollback_failed"}

    # -- front-door protocol ------------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _handle(self, conn: socket.socket):
        lock = threading.Lock()
        pumps: List[threading.Thread] = []
        # push_weights chunk reassembly, per connection (same
        # discipline as LMServer's)
        push_buf: dict = {}
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_msg(conn, max_bytes=self.max_frame_bytes)
                except Exception:
                    return
                if msg is None or not isinstance(msg, dict):
                    return
                op = msg.get("op")
                try:
                    if op == "generate":
                        t = self._op_generate(conn, lock, msg)
                        if t is not None:
                            pumps.append(t)
                    elif op == "stats":
                        self._send(conn, lock,
                                   {"ok": 1, "stats": self.stats()})
                    elif op == "metrics":
                        self._send(conn, lock,
                                   {"ok": 1, "metrics": self.metrics()})
                    elif op == "alerts":
                        self._send(conn, lock, {
                            "ok": 1,
                            "alerts": self.manager.aggregate_alerts(),
                        })
                    elif op == "trace_dump":
                        # one trace id -> the FLEET-merged chain (fan
                        # out to replicas by the propagated id, merge
                        # with router spans + archive); no id -> the
                        # router's own recent spans, as before
                        trace = (None if msg.get("trace") is None
                                 else int(msg["trace"]))
                        limit = (None if msg.get("limit") is None
                                 else int(msg["limit"]))
                        if trace is not None:
                            spans = self.merged_trace(trace)
                            if limit is not None and limit >= 0:
                                spans = spans[-limit:]
                        else:
                            spans = self.tracer.dump(limit=limit)
                        self._send(conn, lock, {"ok": 1, "spans": spans})
                    elif op == "chrome_trace":
                        trace = (None if msg.get("trace") is None
                                 else int(msg["trace"]))
                        limit = (None if msg.get("limit") is None
                                 else int(msg["limit"]))
                        spans = (self.merged_trace(trace)
                                 if trace is not None
                                 else self.tracer.dump(limit=limit))
                        self._send(conn, lock, {
                            "ok": 1, "chrome": to_chrome_trace(spans),
                        })
                    elif op == "drain":
                        self._op_drain(conn, lock, msg)
                    elif op == "reconfigure":
                        self._op_reconfigure(conn, lock, msg)
                    elif op == "push_weights":
                        # the fleet half of live weight updates: the
                        # reassembled payload rolls across every
                        # replica (drain → push → undrain, one at a
                        # time), and the final ack arrives only after
                        # the fleet converged
                        self._op_push_weights(conn, lock, msg,
                                              push_buf)
                    elif op == "timeseries":
                        last = (None if msg.get("last") is None
                                else int(msg["last"]))
                        self._send(conn, lock, {
                            "ok": 1,
                            "timeseries": self.fleet_timeseries(
                                last=last),
                        })
                    elif op == "events":
                        last = (None if msg.get("last") is None
                                else int(msg["last"]))
                        self._send(conn, lock, {
                            "ok": 1,
                            "events": self.fleet_events(last=last),
                        })
                    elif op == "flight":
                        self._send(conn, lock, {
                            "ok": 0,
                            "error": "flight recorder lives per replica"
                                     " — scrape replicas directly",
                        })
                    elif op == "export_kv":
                        self._send(conn, lock, {
                            "ok": 0,
                            "error": "kv migration is orchestrated by "
                                     "the router (disagg_prompt_tokens)"
                                     " — point export_kv at a replica "
                                     "directly",
                        })
                    elif op == "import_kv":
                        self._send(conn, lock, {
                            "ok": 0,
                            "error": "kv migration is orchestrated by "
                                     "the router (disagg_prompt_tokens)"
                                     " — point import_kv at a replica "
                                     "directly",
                        })
                    else:
                        # typed terminal arm, mirroring LMServer: the
                        # proxied op set is closed and the wire-contract
                        # pass can hold it equal to the server's
                        self._send(conn, lock, {
                            "ok": 0, "error": "unknown_op",
                            "op": str(op),
                        })
                except OverloadedError as e:
                    self._send(conn, lock, {
                        "ok": 0, "error": "overloaded",
                        **({"queue_depth": e.queue_depth}
                           if e.queue_depth is not None else {}),
                    })
                except DrainingError:
                    self._send(conn, lock, {"ok": 0, "error": "draining"})
                except ServingConnectionError as e:
                    # a BACKEND connection problem is a reply to the
                    # client, not a reason to drop the client's own
                    # connection (which the next clause handles)
                    self._send(conn, lock, {
                        "ok": 0, "error": f"unavailable: {e}",
                    })
                except (ConnectionError, OSError):
                    raise
                except Exception as e:
                    self._send(conn, lock, {
                        "ok": 0, "error": f"{type(e).__name__}: {e}",
                    })
        except (ConnectionError, OSError):
            return
        finally:
            for t in pumps:
                t.join(timeout=5.0)
            conn.close()
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _op_generate(self, conn, lock, msg: dict,
                     ) -> Optional[threading.Thread]:
        if self.draining:
            raise DrainingError("router is draining: admissions closed")
        params = dict(
            prompt=[int(t) for t in msg["prompt"]],
            max_new_tokens=int(msg["max_new_tokens"]),
            temperature=float(msg.get("temperature", 0.0)),
            seed=int(msg.get("seed", 0)),
        )
        for k, cast in (("eos_id", int), ("top_k", int),
                        ("top_p", float), ("deadline_s", float),
                        ("tier", str)):
            if msg.get(k) is not None:
                params[k] = cast(msg[k])
        entry = _Entry(
            rid=next(self._rid_counter), conn=conn, lock=lock,
            params=params,
            # honor a client-propagated trace id (a tracing frontend
            # upstream of the router); mint the fleet-wide id otherwise
            trace_id=(int(msg["trace"]) if msg.get("trace") is not None
                      else self.tracer.new_trace_id()),
        )
        t_route = time.perf_counter()
        self._submit_routed(entry, exclude=set())
        entry.route_ms += (time.perf_counter() - t_route) * 1e3
        with self._inflight_lock:
            self._inflight[entry.rid] = entry
            self._m_inflight.set(len(self._inflight))
        # ack before the pump starts, so the acceptance frame always
        # precedes the first token frame (same ordering as LMServer)
        self._send(conn, lock, {"ok": 1, "id": entry.rid,
                                "trace": entry.trace_id})
        t = threading.Thread(target=self._pump, args=(entry,),
                             daemon=True)
        t.start()
        return t

    def _op_drain(self, conn, lock, msg: dict):
        name = msg.get("replica")
        undrain = bool(msg.get("undrain"))
        if name is None:
            if undrain:
                # reopen ROUTER admissions (rolling-deploy symmetry)
                self.draining = False
                self._send(conn, lock, {"ok": 1, "draining": 0,
                                        "active": 0, "queued": 0})
                return
            # drain the ROUTER: no new admissions; in-flight streams
            # finish; stats reports drained once the table empties
            self.draining = True
            with self._inflight_lock:
                active = len(self._inflight)
            self._send(conn, lock, {"ok": 1, "draining": 1,
                                    "active": active, "queued": 0})
            return
        replica = self.manager.get(str(name))
        client = replica.client
        if client is None:
            self._send(conn, lock, {
                "ok": 0, "error": f"replica {name!r} is not connected",
            })
            return
        if undrain:
            reply = client.undrain()
            replica.state = HEALTHY  # routable again immediately
            self.journal.append("undrain", target=replica.name,
                                reason="admin")
            self._send(conn, lock, {"ok": 1, "draining": 0,
                                    "replica": replica.name, **reply})
            return
        reply = client.drain()
        replica.state = DRAINING  # stop routing now, not at next poll
        # forget its affinity placements now too — the probe loop only
        # fires on_drain for transitions IT observes, and this state
        # was just set under its feet
        self.manager.note_drain(replica)
        self.journal.append("drain", target=replica.name,
                            reason="admin")
        self._send(conn, lock, {"ok": 1, "draining": 1,
                                "replica": replica.name, **reply})

    def _op_reconfigure(self, conn, lock, msg: dict):
        """Forward a role flip to one named backend replica (the
        router itself has no role — ``replica=`` is required here,
        unlike a direct LMServer). The replica's cached routing view
        updates immediately: the next :meth:`_choose` sees the new
        role without waiting for a probe cycle."""
        name = msg.get("replica")
        if name is None:
            self._send(conn, lock, {
                "ok": 0,
                "error": "reconfigure through a router needs "
                         "replica=<name> (the router has no role)",
            })
            return
        replica = self.manager.get(str(name))
        client = replica.client
        if client is None:
            self._send(conn, lock, {
                "ok": 0, "error": f"replica {name!r} is not connected",
            })
            return
        role = client.reconfigure(str(msg["role"]))
        # refresh the cached stats the routing policy classifies on
        # (stale role = wrong pool until the next probe)
        if replica.last_stats:
            replica.last_stats["role"] = role
        self.journal.append("reconfigure", target=replica.name,
                            role=role)
        self._send(conn, lock, {"ok": 1, "role": role,
                                "replica": replica.name})

    def add_replica(self, spec) -> "Replica":
        """Grow the fleet at runtime (the autoscaler's scale-up
        actuator): ``spec`` is a started replica's ``(host, port[,
        name])`` — or a built :class:`Replica` — which joins probing,
        the hash ring, and the routing pools immediately. The affinity
        index is untouched: existing placements stay valid, and the
        rebuilt ring only redirects the hash-policy share of keys that
        now map to the new replica."""
        if isinstance(spec, Replica):
            replica = spec
        else:
            replica = Replica(
                *spec, request_timeout=self.backend_request_timeout)
        self.manager.add(replica)
        with self._route_lock:
            self.ring = _HashRing([r.name for r in self.manager.replicas])
        self.journal.append("replica_up", target=replica.name,
                            fleet=len(self.manager.replicas))
        return replica

    def remove_replica(self, name: str) -> dict:
        """Shrink the fleet at runtime (the autoscaler's scale-down
        actuator). The caller is responsible for draining first —
        removal is immediate: the replica leaves the ring and the
        probe set, its affinity placements are forgotten, and its
        router-held connection closes. Returns the removed replica's
        last cached stats (the controller logs them with the
        decision)."""
        replica = self.manager.remove(name)
        with self._route_lock:
            self.ring = _HashRing([r.name for r in self.manager.replicas])
            self.index.forget(replica.name)
        last = dict(replica.last_stats)
        replica.mark_down("removed from fleet")
        self.journal.append("replica_down", target=name,
                            reason="removed",
                            fleet=len(self.manager.replicas))
        return last

    def _op_push_weights(self, conn, lock, msg: dict, buf: dict):
        """One push_weights chunk at the fleet level: reassembly is
        identical to LMServer's; the final chunk triggers
        :meth:`rolling_update` with the raw payload (the router never
        deserializes weights — validation is each replica's job), and
        the ack carries the fleet outcome. A typed refusal from any
        replica (bad payload) or an incomplete rollout answers the
        ``weight_push`` error code."""
        seq = int(msg["seq"])
        n = int(msg["n"])
        if seq == 0:
            buf.clear()
            buf["chunks"] = []
        chunks = buf.get("chunks")
        if chunks is None or len(chunks) != seq or seq >= n:
            have = len(chunks) if chunks is not None else None
            buf.clear()
            self._send(conn, lock, {
                "ok": 0, "error": "weight_push",
                "detail": f"out-of-order push chunk seq={seq} of "
                          f"n={n} (have {have})",
            })
            return
        chunks.append(bytes(msg["chunk"]))
        if seq < n - 1:
            self._send(conn, lock, {"ok": 1, "received": seq})
            return
        payload = b"".join(chunks)
        buf.clear()
        version = (None if msg.get("version") is None
                   else int(msg["version"]))
        try:
            report = self.rolling_update(payload=payload,
                                         version=version)
        except WeightPushError as e:
            self._send(conn, lock, {
                "ok": 0, "error": "weight_push", "detail": str(e),
            })
            return
        if report["failed"]:
            self._send(conn, lock, {
                "ok": 0, "error": "weight_push",
                "detail": f"rolling update incomplete: "
                          f"updated={report['updated']} "
                          f"failed={report['failed']}",
            })
            return
        self._send(conn, lock, {
            "ok": 1, "applied": 1, "version": report["version"],
            "swap_ms": report["swap_ms"],
            "updated": report["updated"],
        })

    # -- aggregated views ---------------------------------------------------

    def merged_trace(self, trace: int) -> List[dict]:
        """One request's spans merged across the fleet: the router's
        own ring, the archive snapshot (chains of completed requests
        outlive the live rings), and a ``trace_dump`` fan-out to every
        routable replica — deduped and wall-clock ordered into ONE
        chain by :func:`~distkeras_torch.telemetry.merge_span_chains`."""
        chains = [self.tracer.dump(trace=trace)]
        if self.archive is not None:
            archived = self.archive.get(trace)
            if archived:
                chains.append(archived)
        chains.extend(self.manager.collect_trace(trace))
        return merge_span_chains(*chains)

    def stats(self) -> dict:
        """Fleet sums at the top level (a client written against one
        LMServer keeps finding ``requests_completed`` etc.), plus the
        per-replica snapshots and the router's own section."""
        agg = self.manager.aggregate_stats()
        with self._inflight_lock:
            inflight = len(self._inflight)
            per_replica_inflight: Dict[str, int] = {}
            for e in self._inflight.values():
                if e.replica is not None:
                    per_replica_inflight[e.replica.name] = (
                        per_replica_inflight.get(e.replica.name, 0) + 1)
        router = {
            "policy": self.policy,
            "inflight": inflight,
            "inflight_by_replica": per_replica_inflight,
            "draining": self.draining,
            "drained": self.draining and inflight == 0,
            "affinity_index_nodes": len(self.index),
            "routed": self._counter_total("router_requests_routed_total"),
            "spilled": self.registry.counter(
                "router_requests_spilled_total").value,
            "failed_over": self._counter_total(
                "router_requests_failed_over_total"),
            "failovers": self.registry.counter(
                "router_replica_failovers_total").value,
            "failed": self.registry.counter(
                "router_requests_failed_total").value,
            "overload_rejections": self.registry.counter(
                "router_overload_rejections_total").value,
            # prefill/decode disaggregation: None = disabled; the
            # outcome-labeled counter total and the migration latency
            # percentiles come from the router-side registry series
            "disagg_prompt_tokens": self.disagg_prompt_tokens,
            "kv_migrations": self._counter_total(
                "serving_kv_migrations_total"),
            "kv_migration_ms": {
                "p50": self._m_migration_ms.percentile(50),
                "p99": self._m_migration_ms.percentile(99),
            },
            "critical_path_ms": {
                "router": {
                    "p50": self._m_critical.percentile(
                        50, phase="router"),
                    "p99": self._m_critical.percentile(
                        99, phase="router"),
                },
            },
        }
        # live weight updates: one atomic snapshot of the rolling-
        # update state (the dict is rebound, never mutated)
        wsnap = self._weights
        router["weights"] = {
            "version": wsnap["version"],
            "updates": wsnap["updates"],
            "rollbacks": wsnap["rollbacks"],
            "rollback_available": wsnap["prev"] is not None,
            "guard_active": (
                wsnap["guard_deadline"] is not None
                and time.monotonic() < wsnap["guard_deadline"]),
            "last_outcome": wsnap["last"],
        }
        with self._archive_lock:
            archived = self._archived
            errors = self._archive_errors
            archive_ms = self._archive_ns / 1e6
        router["trace_archive"] = {
            "enabled": self.archive is not None,
            "archived": archived,
            "errors": errors,
            "ms_total": round(archive_ms, 3),
            "chains": (len(self.archive)
                       if self.archive is not None else 0),
        }
        return {**agg["fleet"], "replicas": agg["replicas"],
                "router": router}

    def _counter_total(self, name: str) -> float:
        fam = self.registry.get(name)
        if fam is None:
            return 0.0
        return sum(s.get("value", 0.0)
                   for s in fam.snapshot()["series"])

    def metrics(self) -> Dict[str, dict]:
        """Every replica's registry snapshot merged with the router's
        own (router_* families live only here, serving_* families sum
        across replicas)."""
        return merge_metric_snapshots(
            [self.registry.collect()]
            + [self.manager.aggregate_metrics()]
        )

    def fleet_timeseries(self, last: Optional[int] = None) -> dict:
        """The fleet's metric history: every replica's ring plus the
        router's own, merged per time bucket by
        :func:`~distkeras_torch.telemetry.merge_timeseries` (rates and
        counts summed, windowed percentiles by MAX, gauges summed
        except the version/flag families) — the ``timeseries`` op's
        payload."""
        per = self.manager.collect_timeseries(last=last)
        per["router"] = self.timeseries.points(last=last)
        meta = self.timeseries.meta()
        meta["sources"] = sorted(per)
        return {
            "meta": meta,
            "points": merge_timeseries(
                per, bucket_s=self.timeseries.interval_s,
                max_families=_GAUGE_MAX_FAMILIES),
        }

    def fleet_events(self, last: Optional[int] = None) -> dict:
        """The fleet's control-plane journal: router-side events
        (autoscaling, replica up/down, rollbacks, migrations)
        interleaved with every replica's own (drains, role flips,
        weight swaps), each tagged with its ``source`` and
        timestamp-ordered — the ``events`` op's payload."""
        per = self.manager.collect_events(last=last)
        per["router"] = self.journal.events(last=last)
        meta = self.journal.meta()
        meta["sources"] = sorted(per)
        return {"meta": meta,
                "events": merge_event_journals(per)}

    # -- admin conveniences (host-side; the ops above are the wire API) -----

    def drain_replica(self, name: str) -> dict:
        """Drain one replica (rolling deploy): forward the drain op and
        stop routing to it immediately."""
        replica = self.manager.get(name)
        client = replica.client
        if client is None:
            raise ServingConnectionError(
                f"replica {name!r} is not connected"
            )
        reply = client.drain()
        replica.state = DRAINING
        self.manager.note_drain(replica)  # placement forget, immediate
        return reply
