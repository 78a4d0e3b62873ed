"""Request admission for the continuous-batching engine.

The engine (:mod:`distkeras_torch.serving.engine`) owns a fixed pool of
decode slots; this module owns everything that happens *before* a request
reaches one: a FIFO queue with a hard depth bound (backpressure — a
caller that outruns the engine gets :class:`QueueFullError` immediately
instead of growing an unbounded backlog), per-request deadlines (a
request whose deadline passes while it is still queued is expired, never
prefilled — the slot budget is spent on requests that can still meet
their SLO), and the Sarathi-style **per-tick token budget**
(``tick_token_budget``): each engine tick may process at most that many
*useful* tokens — one is reserved per decoding slot first, and the
remainder is handed to prefilling slots as prompt chunks
(:meth:`FIFOScheduler.plan_prefill`) — so a burst of long prompts is
metered through the ticks instead of stalling every live decode stream
behind a wall of prefill work.

``max_prefills_per_tick`` (the pre-chunking prefill/decode interleave
cap — at most N whole-prompt prefill dispatches per tick) is deprecated:
passing it maps onto an equivalent token budget (N default-sized chunks
per tick) with a :class:`DeprecationWarning`, and still bounds
admissions per pop for engines running the legacy monolithic prefill.

Requests carry a **QoS tier** (``Request.tier``, one of :data:`QOS_TIERS`:
``"interactive"`` then ``"batch"``). The scheduler keeps one FIFO queue
per tier and serves them in strict priority order — batch requests are
admitted only when no interactive request is waiting, and under
``tick_token_budget`` pressure :meth:`FIFOScheduler.plan_prefill` deals
prompt chunks to interactive slots first, so overload starves the batch
tier's prefill progress before it costs an interactive request anything.
Within a tier nothing changes: FIFO order, no queue jumping past a head
that is merely waiting for blocks. A fleet running only the default
``interactive`` tier behaves exactly as the single-queue scheduler did.
"""

from __future__ import annotations

import itertools
import queue as _queue
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from distkeras_torch import telemetry

# the chunk size one deprecated max_prefills_per_tick unit maps onto
# (also ServingEngine's default prefill_chunk — one legacy "prefill per
# tick" becomes one default-sized chunk of prefill tokens per tick)
DEFAULT_PREFILL_CHUNK = 64

# QoS tiers in strict priority order: the admission queue and the
# per-tick prefill budget both serve earlier tiers first, so overload
# degrades the cheap tier before it touches the expensive one
QOS_TIERS = ("interactive", "batch")


class QueueFullError(RuntimeError):
    """Admission queue is at ``max_queue_depth`` — the engine is not
    keeping up with arrivals. Callers should shed load or retry later;
    the TCP front-end maps this to a structured ``overloaded`` reply
    (spill-worthy backpressure, not a hard failure)."""


class DrainingError(RuntimeError):
    """The engine has closed admissions (:meth:`ServingEngine.begin_drain`):
    in-flight and already-queued requests finish, new submits are
    refused. The TCP front-end maps this to a structured ``draining``
    reply so routers route around the replica during a clean deploy."""


class TokenStream:
    """Per-request consumer handle: iterate tokens as the engine emits
    them. The engine pushes from its loop thread; any consumer thread
    iterates (or calls :meth:`tokens` to drain). After the stream ends,
    ``finish_reason`` is one of ``"eos"`` (the request sampled its stop
    token), ``"length"`` (``max_new_tokens`` reached), ``"expired"``
    (deadline passed while queued), or ``"error"``."""

    def __init__(self):
        self._q: _queue.Queue = _queue.Queue()
        self.finish_reason: Optional[str] = None

    # engine side -----------------------------------------------------------

    def _put(self, tok: int):
        self._q.put(("tok", tok))

    def _finish(self, reason: str):
        self._q.put(("end", reason))

    # consumer side ---------------------------------------------------------

    def __iter__(self):
        while True:
            kind, val = self._q.get()
            if kind == "end":
                self.finish_reason = val
                return
            yield val

    def tokens(self, timeout: Optional[float] = 60.0) -> List[int]:
        """Drain the stream to completion (bounded wait per token so a
        dead engine raises ``queue.Empty`` instead of hanging)."""
        out: List[int] = []
        while True:
            kind, val = self._q.get(timeout=timeout)
            if kind == "end":
                self.finish_reason = val
                return out
            out.append(val)


_rid_counter = itertools.count()


@dataclass
class Request:
    """One generation request. ``prompt`` is a 1-D int32 token array;
    sampling fields mirror :func:`~distkeras_torch.models.transformer.generate`
    exactly (same seed + params → the engine's per-slot stream is
    token-identical to a solo ``generate`` call). ``deadline_s`` is a
    relative first-token deadline: if the request is still queued when it
    elapses, it is expired instead of admitted."""

    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    eos_id: Optional[int] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    deadline_s: Optional[float] = None
    # QoS class (one of QOS_TIERS): interactive requests are admitted
    # and dealt prefill budget before batch ones; per-tier latency
    # histograms and SLO rules key off this
    tier: str = "interactive"
    rid: int = field(default_factory=lambda: next(_rid_counter))
    stream: TokenStream = field(default_factory=TokenStream)
    # telemetry: allocated by FIFOScheduler.submit UNLESS the caller
    # propagated one (the TCP front-end forwards the wire `trace`
    # field, so a request routed client -> router -> replica keeps ONE
    # id end-to-end; TCP acks return it so clients can query
    # trace_dump). `parent_span` names the upstream span that submitted
    # this request (e.g. "router.route") and is stamped on the queued
    # span as the cross-process link.
    trace_id: Optional[int] = None
    parent_span: Optional[str] = None
    # engine bookkeeping (monotonic timestamps)
    submit_t: Optional[float] = None
    admit_t: Optional[float] = None  # queue exit / slot entry
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None  # previous emit (ITL histogram)
    done_t: Optional[float] = None
    prefill_done_t: Optional[float] = None
    n_emitted: int = 0
    # device compute attributed to this request (per-tick share of
    # device_ms across the slots active that tick) — the critical-path
    # "device" phase and the decode span's device_ms attr
    device_ms_accum: float = 0.0


class FIFOScheduler:
    """FIFO admission with bounded depth, queued-deadline expiry, and a
    Sarathi-style per-tick token budget. Thread-safe: the TCP front-end
    submits from handler threads while the engine pops from its loop
    thread.

    Args:
      max_queue_depth: hard bound on queued requests (backpressure).
      tick_token_budget: useful tokens one engine tick may process —
        decoding slots reserve one each, prefilling slots split the
        remainder as prompt chunks (:meth:`plan_prefill`). Defaults to
        256.
      max_prefills_per_tick: DEPRECATED (pre-chunking interleave cap).
        Still accepted: maps onto ``tick_token_budget = N *
        DEFAULT_PREFILL_CHUNK`` (one legacy whole-prompt prefill ≈ one
        default chunk of prefill tokens per tick) and keeps bounding
        admissions per :meth:`pop_admissible` for engines running the
        legacy monolithic prefill.
      restore_budget: host-tier KV blocks the engine may upload back
        to the device per tick (:meth:`plan_restore`). Restores ride
        the plan/dispatch boundary and overlap device compute, but the
        host side of each upload still costs tick time — the cap keeps
        a burst of RESTORING admissions from starving the live decode
        streams, the same role ``tick_token_budget`` plays for prompt
        chunks. Defaults to 4 blocks/tick.
    """

    def __init__(self, max_queue_depth: int = 256,
                 tick_token_budget: Optional[int] = None,
                 tracer: Optional["telemetry.Tracer"] = None,
                 registry: Optional["telemetry.MetricRegistry"] = None,
                 max_prefills_per_tick: Optional[int] = None,
                 restore_budget: int = 4):
        if max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1; got {max_queue_depth}"
            )
        if max_prefills_per_tick is not None:
            if max_prefills_per_tick < 1:
                raise ValueError(
                    f"max_prefills_per_tick must be >= 1; "
                    f"got {max_prefills_per_tick}"
                )
            warnings.warn(
                "FIFOScheduler(max_prefills_per_tick=...) is deprecated: "
                "prefill is chunked and metered by tick_token_budget now. "
                f"Mapping {max_prefills_per_tick} prefills/tick onto "
                f"tick_token_budget={max_prefills_per_tick} * "
                f"{DEFAULT_PREFILL_CHUNK}.",
                DeprecationWarning, stacklevel=2,
            )
            if tick_token_budget is None:
                tick_token_budget = (max_prefills_per_tick
                                     * DEFAULT_PREFILL_CHUNK)
        if tick_token_budget is None:
            tick_token_budget = 256
        if tick_token_budget < 1:
            raise ValueError(
                f"tick_token_budget must be >= 1; got {tick_token_budget}"
            )
        if restore_budget < 1:
            raise ValueError(
                f"restore_budget must be >= 1; got {restore_budget}"
            )
        self.max_queue_depth = max_queue_depth
        self.tick_token_budget = tick_token_budget
        self.restore_budget = restore_budget
        # legacy admissions-per-pop cap; None = free slots only
        self.max_prefills_per_tick = max_prefills_per_tick
        # one FIFO per QoS tier, served in QOS_TIERS priority order
        self._qs = {t: deque() for t in QOS_TIERS}
        self._lock = threading.Lock()
        # incremental head bookkeeping: the head request's submit time
        # is cached at every queue mutation so oldest_age_s never
        # touches the deque, and a head that failed the engine's
        # admissible() gate on consecutive pops is short-circuited
        # (the gate re-runs radix matching + pool arithmetic — pure
        # waste while nothing was freed). _cap_epoch invalidates the
        # short-circuit: the engine bumps it whenever capacity is
        # released (note_capacity_change).
        self._head_submit_t: Optional[float] = None
        self._cap_epoch = 0
        # (head request, consecutive inadmissible pops, epoch observed)
        self._blocked: Optional[tuple] = None
        self.head_blocked_skips = 0  # pops answered by the short-circuit
        self.tracer = tracer or telemetry.get_tracer()
        self.registry = registry or telemetry.get_registry()
        self._wire_metrics()

    def _wire_metrics(self):
        """(Re)resolve metric handles from the current registry — the
        engine calls this after adopting an externally-built scheduler
        into its own registry."""
        self._m_depth = self.registry.gauge(
            "serving_queue_depth", "requests waiting for a decode slot"
        )
        self._m_submitted = self.registry.counter(
            "serving_requests_submitted_total",
            "requests accepted into the admission queue",
        )
        self._m_rejected = self.registry.counter(
            "serving_requests_rejected_total",
            "submissions refused by queue backpressure",
        )
        # shared with the engine's finish-reason counter (get-or-create)
        # so queued-deadline expiries land in the same series
        self._m_finished = self.registry.counter(
            "serving_requests_total",
            "requests finished, by finish reason", labelnames=("reason",),
        )
        self._m_qos_depth = self.registry.gauge(
            "serving_qos_queue_depth",
            "queued requests by QoS tier", labelnames=("tier",),
        )
        self._m_qos_preempted = self.registry.counter(
            "serving_qos_preempted_total",
            "prefill chunks starved or truncated by tick-budget "
            "pressure, by tier", labelnames=("tier",),
        )
        for t in QOS_TIERS:
            self._m_qos_depth.labels(tier=t).set(0)

    def submit(self, req: Request) -> Request:
        """Enqueue or raise :class:`QueueFullError` (backpressure).
        Allocates the request's trace id — admission is where a request
        enters the system, so the whole span chain shares this id —
        UNLESS one was propagated from upstream (a router or remote
        client already minted the fleet-wide id; spans recorded here
        join that chain)."""
        if req.tier not in QOS_TIERS:
            raise ValueError(
                f"unknown QoS tier {req.tier!r}; expected one of "
                f"{QOS_TIERS}"
            )
        if req.trace_id is None:
            req.trace_id = self.tracer.new_trace_id()
        with self._lock:
            if self._depth_locked() >= self.max_queue_depth:
                self._m_rejected.inc()
                raise QueueFullError(
                    f"admission queue full "
                    f"(max_queue_depth={self.max_queue_depth})"
                )
            req.submit_t = time.monotonic()
            self._qs[req.tier].append(req)
            depth = self._depth_locked()
            tier_depth = len(self._qs[req.tier])
            self._refresh_head_locked()
        self._m_submitted.inc()
        self._m_depth.set(depth)
        self._m_qos_depth.labels(tier=req.tier).set(tier_depth)
        return req

    def _depth_locked(self) -> int:
        return sum(len(q) for q in self._qs.values())

    def _peek_head_locked(self) -> Optional[Tuple[str, Request]]:
        """The next request :meth:`pop_admissible` would consider: head
        of the highest-priority non-empty tier queue."""
        for tier in QOS_TIERS:
            if self._qs[tier]:
                return tier, self._qs[tier][0]
        return None

    def _refresh_head_locked(self):
        """Recompute the oldest-head timestamp across tiers (each tier
        is FIFO, so its head is its oldest — the fleet-wide oldest wait
        is the min over tier heads, which keeps a starving batch
        request visible in the admission-latency signal even while
        interactive traffic jumps ahead of it)."""
        heads = [q[0].submit_t for q in self._qs.values() if q]
        self._head_submit_t = min(heads) if heads else None

    def depth(self) -> int:
        with self._lock:
            return self._depth_locked()

    def depth_by_tier(self) -> dict:
        """Queued requests per QoS tier (engine stats / flight
        snapshots)."""
        with self._lock:
            return {t: len(q) for t, q in self._qs.items()}

    def oldest_age_s(self) -> float:
        """Seconds the head (oldest queued) request has been waiting;
        0.0 when the queue is empty. The admission-latency SLO signal:
        queue *depth* looks fine while one stuck head request starves —
        its age does not. The engine publishes this per tick as the
        ``serving_queue_oldest_wait_s`` gauge and in flight snapshots.
        Reads the incrementally maintained head timestamp — no deque
        access on the per-tick path."""
        with self._lock:
            head_t = self._head_submit_t
        if head_t is None:
            return 0.0
        return max(time.monotonic() - head_t, 0.0)

    def note_capacity_change(self):
        """Engine hook: a slot was freed, blocks were released, or a
        prefix was registered — anything that could turn yesterday's
        inadmissible head request admissible. Invalidates
        :meth:`pop_admissible`'s head-of-line short-circuit so the
        resource gate is re-evaluated on the next pop."""
        with self._lock:
            self._cap_epoch += 1

    def pop_admissible(
        self, free_slots: int,
        admissible: Optional[Callable[[Request], bool]] = None,
    ) -> Tuple[List[Request], List[Request]]:
        """Pop up to ``free_slots`` requests in FIFO order, expiring
        deadline-passed ones along the way (chunked engines meter the
        admitted prompts through :meth:`plan_prefill`, so admission
        itself costs no prefill dispatch; a deprecated
        ``max_prefills_per_tick`` still caps the pop for legacy
        monolithic-prefill engines). Tier queues are served in strict
        :data:`QOS_TIERS` priority order — every waiting interactive
        request is considered before any batch one. ``admissible`` is
        an optional
        resource gate (the paged engine's free-block check): when the
        HEAD request fails it, popping stops — priority-then-FIFO order
        is preserved (no queue-jumping past a request that is merely
        waiting for blocks, not even by a lower tier: batch work must
        not steal the blocks the interactive head waits for), and the
        head retries next step. A head that failed
        the gate on each of the last TWO pops with no intervening
        :meth:`note_capacity_change` is short-circuited: the gate
        (radix matching + pool arithmetic on the paged engine) is not
        re-run, because nothing that could change its answer has
        happened — deadline expiry still runs, so a stuck head can
        never outlive its deadline silently. Returns ``(admitted,
        expired)``; expired requests are already finished here — span
        chain (``queued`` → ``finish`` with ``reason="expired"``),
        finish-reason counter, and the stream's end sentinel — so they
        show up in trace dumps even if the caller drops them."""
        admitted: List[Request] = []
        expired: List[Request] = []
        budget = free_slots
        if self.max_prefills_per_tick is not None:
            budget = min(budget, self.max_prefills_per_tick)
        now = time.monotonic()
        with self._lock:
            # expiry sweep first: the short-circuit must never keep a
            # deadline-passed head queued (every tier head is swept —
            # a batch head can expire while interactive traffic keeps
            # jumping ahead of it)
            for q in self._qs.values():
                while q:
                    req = q[0]
                    if (req.deadline_s is not None
                            and now - req.submit_t > req.deadline_s):
                        expired.append(q.popleft())
                        continue
                    break
            head = self._peek_head_locked()
            blocked = self._blocked
            if blocked is not None and (
                    head is None or blocked[0] is not head[1]):
                # the blocked head moved on (admitted elsewhere is
                # impossible FIFO, but it can expire — or a higher-tier
                # arrival displaced it as the priority head) — drop the
                # state
                self._blocked = blocked = None
            if (admissible is not None and blocked is not None
                    and blocked[1] >= 2
                    and blocked[2] == self._cap_epoch):
                # head inadmissible two pops running and no capacity
                # released since: same inputs, same "no" — skip the scan
                self.head_blocked_skips += 1
            else:
                while len(admitted) < budget:
                    head = self._peek_head_locked()
                    if head is None:
                        break
                    tier, req = head
                    q = self._qs[tier]
                    if (req.deadline_s is not None
                            and now - req.submit_t > req.deadline_s):
                        expired.append(q.popleft())
                        continue
                    if admissible is not None and not admissible(req):
                        streak = (blocked[1] + 1 if blocked is not None
                                  and blocked[0] is req else 1)
                        self._blocked = (req, streak, self._cap_epoch)
                        break
                    admitted.append(q.popleft())
                    if blocked is not None and blocked[0] is req:
                        self._blocked = blocked = None
            depth = self._depth_locked()
            qos_depths = {t: len(q) for t, q in self._qs.items()}
            self._refresh_head_locked()
        for req in expired:
            self._expire(req)
        if admitted or expired:
            self._m_depth.set(depth)
            for t, d in qos_depths.items():
                self._m_qos_depth.labels(tier=t).set(d)
        return admitted, expired

    def plan_prefill(self, n_decoding: int, pending_lens: Sequence[int],
                     chunk: int,
                     tiers: Optional[Sequence[str]] = None) -> List[int]:
        """Sarathi-style budget split for ONE mixed tick: every decoding
        slot reserves one budget token first (decode never stalls behind
        prefill), then the remainder is dealt to prefilling slots in
        admission order — each gets ``min(chunk, its remaining prompt,
        budget left)`` tokens, possibly 0 (that slot simply makes no
        prefill progress this tick and retries next tick; starvation is
        bounded because decoding slots drain at max_new_tokens and free
        their reservations). Returns one token count per entry of
        ``pending_lens``.

        ``tiers`` (one QoS tier per entry, parallel to
        ``pending_lens``) makes the deal tier-aware: interactive slots
        are dealt their chunks first (admission order within a tier),
        batch slots get only what is left — under budget pressure the
        batch tier's prefill stalls before an interactive chunk
        shrinks. Slots whose chunk was truncated or zeroed by budget
        pressure increment ``serving_qos_preempted_total{tier}``.
        Without ``tiers`` the deal is tier-blind and byte-identical to
        the pre-QoS scheduler."""
        remain = max(self.tick_token_budget - n_decoding, 0)
        out = [0] * len(pending_lens)
        if tiers is None:
            order = list(range(len(pending_lens)))
        else:
            if len(tiers) != len(pending_lens):
                raise ValueError(
                    f"tiers/pending_lens length mismatch: "
                    f"{len(tiers)} vs {len(pending_lens)}"
                )
            order = [i for t in QOS_TIERS
                     for i, ti in enumerate(tiers) if ti == t]
            order += [i for i, ti in enumerate(tiers)
                      if ti not in QOS_TIERS]
        for i in order:
            n = int(pending_lens[i])
            take = min(chunk, n, remain)
            out[i] = take
            remain -= take
            if tiers is not None and take < min(chunk, n):
                self._m_qos_preempted.labels(
                    tier=tiers[i] if tiers[i] in QOS_TIERS
                    else QOS_TIERS[-1]).inc()
        return out

    def plan_spec(self, n_decoding: int, pending_lens: Sequence[int],
                  chunk: int, want_widths: Sequence[int],
                  tiers: Optional[Sequence[str]] = None,
                  ) -> Tuple[List[int], List[int]]:
        """Budget split for one SPECULATIVE mixed tick: verify-window
        tokens are charged against the same ``tick_token_budget`` as
        prompt chunks, so chunked prefill and speculation coexist
        without starving either. Order of claims:

        1. every decoding slot reserves ONE token (the committed token
           a verify tick emits at minimum — decode never stalls);
        2. prefilling slots are dealt their prompt chunks from the
           remainder, exactly as :meth:`plan_prefill`;
        3. only budget left after prefill widens the speculative
           windows (draft positions in the verify dispatch), dealt in
           slot order up to each slot's requested width.

        Prefill pressure therefore shrinks verify windows toward plain
        1-token decode instead of the other way around. Returns
        ``(prefill_takes, granted_widths)`` — one entry per
        ``pending_lens`` / ``want_widths`` element respectively.
        ``tiers`` is forwarded to :meth:`plan_prefill` (QoS-aware
        chunk dealing)."""
        takes = self.plan_prefill(n_decoding, pending_lens, chunk,
                                  tiers=tiers)
        remain = max(
            self.tick_token_budget - n_decoding - sum(takes), 0
        )
        widths: List[int] = []
        for w in want_widths:
            grant = min(int(w), remain)
            widths.append(grant)
            remain -= grant
        return takes, widths

    def plan_multi_step(self, n_decoding: int, k: int) -> int:
        """Window width for one device-resident multi-step decode
        dispatch: a k-step window runs every decoding slot k steps, so
        it charges ``n_decoding * k`` tokens against the SAME
        ``tick_token_budget`` prompt chunks and verify windows spend —
        one dispatch's worth of work stays one budget's worth of
        tokens, whatever shape it takes. Returns the widest width the
        budget covers, ``min(k, tick_token_budget // n_decoding)``,
        floored at 1 (decode never stalls; 1 means the engine falls
        back to the ordinary tick). There is no prefill claim to
        interleave — the engine only asks for a window in all-decode
        steady state, where no chunk is dealt by definition."""
        if n_decoding < 1:
            return 1
        return max(1, min(int(k), self.tick_token_budget // n_decoding))

    def plan_restore(self, pending: int) -> int:
        """How many queued host-tier block restores one tick may issue:
        ``min(pending, restore_budget)``. Restores are host→device
        transfers, not budget tokens — they overlap in-flight device
        compute — but issuing them still spends host plan time, so the
        per-tick cap bounds what a burst of RESTORING admissions can
        steal from live decode streams (a row waiting on blocks waits a
        few more ticks; a decode stream never stalls)."""
        return min(int(pending), self.restore_budget)

    def _expire(self, req: Request):
        """Finish a queued request whose deadline passed before a slot
        freed: full telemetry (the request must not vanish from trace
        dumps just because it never reached the engine) and the stream
        end sentinel consumers are blocked on."""
        req.done_t = time.monotonic()
        queued_ms = (req.done_t - req.submit_t) * 1e3
        self.tracer.record(req.trace_id, "queued", req.submit_t,
                           queued_ms, parent=req.parent_span)
        self.tracer.record(req.trace_id, "finish", req.done_t, 0.0,
                           reason="expired", tokens=0)
        self._m_finished.labels(reason="expired").inc()
        req.stream._finish("expired")
