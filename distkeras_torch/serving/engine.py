"""Continuous-batching serving engine — the port of
:mod:`distkeras_tpu.serving.engine` (the synchronous chunked engine, on
both cache layouts).

Iteration-level scheduling (Orca/vLLM-style) for
:class:`~distkeras_torch.models.transformer.TransformerLM`:

- **Slot pool.** One preallocated per-layer KV cache of batch ``S``
  (``slots``) with per-row cursors: each batch row is an independent
  sequence at its own depth.
- **Paged mode** (``paged=True``): the per-slot slabs become one pool of
  fixed-size KV blocks (:mod:`distkeras_torch.serving.kvpool`) addressed
  through per-row block tables, with radix-tree prompt-prefix sharing
  (:mod:`distkeras_torch.serving.prefix`) and copy-on-write at
  mid-block divergence. Admission is free-block-aware, so live
  sequences are never evicted mid-decode.
- **Chunked prefill fused into the tick** (Sarathi-Serve-style): a
  joining prompt streams into its slot ``prefill_chunk`` tokens per
  tick, coalesced with the decoding rows into ONE ``[S, C]`` mixed step
  — each row at its own valid length, K/V written at absolute per-row
  positions, logits taken at each row's last valid token. The
  scheduler's ``tick_token_budget`` meters the prompt tokens a tick
  carries (decodes first). With no chunk dealt the step is ``[S, 1]``.
- **Per-slot sampling.** Each slot samples on its own ``[1, vocab]``
  logits slice with its own ``torch.Generator``, seeded from the
  request's ``seed`` and advanced only on ticks it sampled — the
  function and draws of a solo B=1
  :func:`~distkeras_torch.models.transformer.generate`, so streams are
  token-identical to it.

On the card the mixed step's attention runs the hand-written Hopper
kernels: the paged-attention kernel on the paged layout (every layer,
every tick), the splash chunked-prefill kernel on the slot layout (every
layer of every tick that carries a prompt chunk). There is no jit and
no buffer donation: the tick bodies are plain methods that update the
KV cache in place. Host-side control arrays (block tables, seq lens,
fed tokens, valid lens, sample mask) ride ONE packed int32 upload per
tick, built fresh each tick and copied to the device, never mutated
after — the torch form of the reference's host-buffer aliasing rule.

Observability is the reference's: a span chain per request, live
counters/gauges/histograms in a
:class:`~distkeras_torch.telemetry.MetricRegistry`, per-tick
:class:`~distkeras_torch.telemetry.FlightRecorder` snapshots dumped to
a postmortem JSONL on crash, and per-request JSONL records through
:class:`~distkeras_torch.utils.metrics.MetricsWriter`.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): monolithic prefill (``prefill_chunk=None``), ``host_blocks``,
``draft``, ``pipeline=True``, ``multi_step_k > 1``, ``export_blocks`` /
``import_blocks`` and ``update_weights`` (A8); ``mesh`` (A10);
``watchdog`` (A11).
"""

from __future__ import annotations

import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from distkeras_torch import telemetry
from distkeras_torch.models.transformer import sample_tokens
from distkeras_torch.serving.kvpool import BlockPool
from distkeras_torch.serving.prefix import RadixPrefixIndex
from distkeras_torch.serving.scheduler import (
    DEFAULT_PREFILL_CHUNK,
    QOS_TIERS,
    DrainingError,
    FIFOScheduler,
    Request,
)
from distkeras_torch.telemetry.events import EventJournal
from distkeras_torch.telemetry.flight import FlightRecorder
from distkeras_torch.telemetry.runtime import MemoryWatermarks
from distkeras_torch.utils.device import resolve_device
from distkeras_torch.utils.metrics import MetricsWriter


def _pack_i32(*arrs) -> np.ndarray:
    """Flatten a tick's host-side control arguments into ONE fresh int32
    buffer, so every tick pays a single host->device copy. The unpack
    order in the tick body must match (:func:`_unpack_i32`)."""
    return np.concatenate(
        [np.ascontiguousarray(a, np.int32).ravel() for a in arrs]
    )


def _unpack_i32(packed, shapes):
    """Views into a packed control buffer (a device tensor)."""
    out, off = [], 0
    for shp in shapes:
        n = int(np.prod(shp))
        out.append(packed[off:off + n].view(shp))
        off += n
    return out


def _not_ported(feature: str, item: str):
    return NotImplementedError(
        f"{feature} is not ported to the PyTorch engine yet (ROADMAP {item})")


_IDLE_CFG = (0.0, None, None)  # free slots sample greedily into the void


@dataclass
class _SlotState:
    req: Request
    remaining: int
    blocks: Optional[List[int]] = None  # paged: this row's block chain
    cached_tokens: int = 0  # paged: prompt tokens served from the index
    # prompt tokens not yet fed through a mixed tick. A slot is
    # PREFILLING while decoding is False and DECODING after its last
    # chunk landed.
    pending: Optional[np.ndarray] = None
    decoding: bool = True
    admit_seq: int = 0  # admission order: prefill budget is dealt FIFO
    admit_t: float = 0.0  # monotonic admission time (prefill span)


@dataclass
class _InflightTick:
    """One dispatched-but-unread tick: the device-side token tensor plus
    the host plan that produced it. ``packed`` keeps the tick's host
    control buffer alive until the tick is reconciled — it is never
    mutated after its upload."""

    toks: Any                       # device [S] sampled tokens
    # per slot: None (idle at plan) | ("dec", st) | ("pre", st, take,
    # flipped) — flipped marks the prompt's last chunk landing
    rows: List[Optional[tuple]]
    plan_ms: float
    dispatch_ms: float
    n_dec: int
    fed_tokens: int
    chunk: Optional[int]
    packed: Optional[np.ndarray] = None


class ServingEngine:
    """Continuous-batching serving over a fixed slot pool.

    Args:
      model: a TRAINING-mode :class:`TransformerLM` (``decode=False``),
        carrying its weights; decode twins sharing them are cloned
        internally.
      slots: number of concurrent sequences ``S``.
      max_len: serving context length (prompt + generated); defaults to
        ``model.max_len``.
      scheduler: admission policy; defaults to a :class:`FIFOScheduler`.
      metrics: a :class:`MetricsWriter`; an in-memory one by default.
      registry / tracer: the telemetry pair the engine publishes into
        (process-global by default); the scheduler is adopted into it.
      paged: block-pooled KV cache with radix prefix sharing (see the
        module docstring). ``block_size`` tokens per block (``max_len``
        must be a multiple); ``num_blocks`` defaults to worst-case per
        slot plus the trash block; ``prefix_cache=False`` disables
        sharing (every prompt fully prefills, blocks free at finish).
      prefill_chunk: prompt tokens a row may feed per tick (default 64).
      flight / flight_capacity / postmortem_dir: the per-tick black box
        (``True`` = own recorder, a recorder to share one, ``None`` off);
        crash dumps land in ``postmortem_dir`` (default: the system
        temp directory).
      paged_kernel: paged attend — 'auto' (the Hopper paged-attention
        kernel of :mod:`distkeras_torch.ops.paged_attention` on CUDA
        tensors where its gate passes, else the gathered reference),
        'pallas' (force the hand-written kernel; the name is kept from
        the reference, where it meant the Pallas TPU kernel), 'gather'
        (force the reference). Paged mode only.
      prefill_kernel: chunk attend — 'auto' (the Hopper splash-prefill
        kernel of :mod:`distkeras_torch.ops.splash_prefill` on CUDA
        where its gate passes), 'splash' (force the hand-written
        kernel), 'gather' (force the dense reference).
      device: where the engine runs; ``None`` means the CUDA card (and
        raises without one). Must be the model's device.

    Drive it with :meth:`step` or :meth:`drain`; ``submit`` is
    thread-safe, stepping is single-threaded by design (the TCP front
    end that steps it from a loop thread is ROADMAP A11).
    """

    def __init__(self, model, slots: int = 4,
                 max_len: Optional[int] = None,
                 scheduler: Optional[FIFOScheduler] = None,
                 metrics: Optional[MetricsWriter] = None,
                 registry: Optional[telemetry.MetricRegistry] = None,
                 tracer: Optional[telemetry.Tracer] = None,
                 paged: bool = False, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 host_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = DEFAULT_PREFILL_CHUNK,
                 flight=True, flight_capacity: int = 512,
                 postmortem_dir: Optional[str] = None,
                 mesh=None, paged_kernel: str = "auto",
                 prefill_kernel: str = "auto",
                 draft=None, device=None, pipeline: bool = False,
                 multi_step_k: int = 1):
        if slots < 1:
            raise ValueError(f"slots must be >= 1; got {slots}")
        if multi_step_k < 1:
            raise ValueError(
                f"multi_step_k must be >= 1; got {multi_step_k}")
        if prefill_chunk is None:
            raise _not_ported("monolithic prefill (prefill_chunk=None)",
                              "A8")
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1; got {prefill_chunk}")
        if host_blocks is not None:
            raise _not_ported("the host-RAM KV tier (host_blocks)", "A8")
        if draft is not None:
            raise _not_ported("speculative decoding (draft)", "A8")
        if pipeline:
            raise _not_ported("the pipelined loop (pipeline=True)", "A8")
        if multi_step_k > 1:
            raise _not_ported("multi-step decode (multi_step_k > 1)", "A8")
        if mesh is not None:
            raise _not_ported("tensor-parallel serving (mesh)", "A10")
        self._device = resolve_device(device)
        if (model.device.type != self._device.type
                or (self._device.index is not None
                    and model.device.index != self._device.index)):
            raise ValueError(
                f"the model lives on {model.device} but the engine was "
                f"asked to run on {self._device}")
        self._device = model.device
        self.prefill_chunk = prefill_chunk
        self.prefill_kernel = prefill_kernel
        self.paged_kernel = paged_kernel
        self._admit_seq = 0
        self._packed_prev = (None, None)
        if flight is True:
            self.flight: Optional[FlightRecorder] = FlightRecorder(
                capacity=flight_capacity,
                postmortem_dir=postmortem_dir or tempfile.gettempdir())
        else:
            self.flight = flight or None
        self._mem = MemoryWatermarks()
        self._flight_ns = 0  # time spent building/recording snapshots
        self._tick_ns = 0    # total tick wall time (plan+device+stream)
        self.model = (model if max_len is None
                      else model.clone(max_len=max_len))
        self.slots = slots
        self.paged = paged
        self.registry = registry or telemetry.get_registry()
        self.tracer = tracer or telemetry.get_tracer()
        self.journal = EventJournal(actor="engine")
        self.scheduler = scheduler or FIFOScheduler(
            tracer=self.tracer, registry=self.registry
        )
        # adopt an externally-built scheduler into this engine's
        # telemetry so one trace id space covers queue + slots
        self.scheduler.tracer = self.tracer
        self.scheduler.registry = self.registry
        self.scheduler._wire_metrics()
        self._wire_metrics()
        self.metrics = metrics or MetricsWriter()
        if paged:
            if self.model.max_len % block_size != 0:
                raise ValueError(
                    f"max_len={self.model.max_len} must be a multiple of "
                    f"block_size={block_size}: the gathered per-row view "
                    f"must equal the contiguous cache length exactly"
                )
            self.block_size = block_size
            self._max_blocks = self.model.max_len // block_size
            if num_blocks is None:
                # worst case every slot at max_len, plus the trash block
                num_blocks = BlockPool.RESERVED + slots * self._max_blocks
            self.pool = BlockPool(num_blocks, block_size,
                                  registry=self.registry)
            self.prefix = (RadixPrefixIndex(block_size)
                           if prefix_cache else None)
            self._dm = self.model.clone(
                decode=True, paged=True, page_block_size=block_size,
                num_pages=num_blocks, paged_kernel=paged_kernel,
                prefill_kernel=prefill_kernel,
            )
            self._cache = self._dm.init_cache()
            # host-owned per-row state fed to every tick; idle rows
            # point at the reserved trash block at length 0. Rebound,
            # never mutated: a packed upload built from them must not
            # change under a later plan.
            self._block_tables = np.zeros((slots, self._max_blocks),
                                          np.int32)
            self._seq_lens = np.zeros((slots,), np.int32)
        else:
            self.pool = None
            self.prefix = None
            self._dm = self.model.clone(
                decode=True, slot_cursor=True,
                prefill_kernel=prefill_kernel,
            )
            self._cache = self._dm.init_cache(slots)
        self._last_logits = torch.zeros(
            (slots, self.model.vocab_size), dtype=torch.float32,
            device=self._device)
        # one sampling generator per slot, reseeded at admission
        self._gens = [torch.Generator(device=self._device).manual_seed(0)
                      for _ in range(slots)]
        self._slots: List[Optional[_SlotState]] = [None] * slots
        self.draining = False
        self.ticks = 0
        self.requests_completed = 0
        self.tokens_generated = 0
        self.prompt_tokens = 0
        self.prefix_hit_tokens = 0
        self._occ_sum = 0

    def _wire_metrics(self):
        """Register this engine's metric handles (get-or-create: many
        engines on one registry share the series)."""
        reg = self.registry
        self._m_ticks = reg.counter(
            "serving_ticks_total", "decode ticks executed")
        self._m_tokens = reg.counter(
            "serving_tokens_total", "tokens sampled and emitted")
        self._m_requests = reg.counter(
            "serving_requests_total",
            "requests finished, by finish reason", labelnames=("reason",))
        self._m_occupancy = reg.gauge(
            "serving_slot_occupancy", "decode slots holding a request")
        self._m_tick_ms = reg.histogram(
            "serving_token_ms",
            "per-token latency: one decode tick, host-observed (ms)")
        self._m_ttft_ms = reg.histogram(
            "serving_ttft_ms", "submit to first token (ms)")
        self._m_prefill_ms = reg.histogram(
            "serving_prefill_ms", "per-slot prefill (ms)")
        self._m_prefill_frac = reg.histogram(
            "serving_prefill_fraction",
            "per tick: prefill tokens / (prefill + decode tokens)",
            buckets=telemetry.FRACTION_BUCKETS)
        self._m_itl_ms = reg.histogram(
            "serving_itl_ms",
            "inter-token latency: gap between consecutive tokens of one "
            "stream, host-observed (ms)")
        self._m_decode_tps = reg.gauge(
            "serving_decode_tokens_per_sec",
            "tokens emitted by the latest tick over its wall time")
        self._m_device_wait = reg.histogram(
            "serving_device_wait_ms",
            "host time blocked on device readback per tick (ms)")
        self._m_prefix_hit = reg.counter(
            "serving_prefix_hit_tokens_total",
            "prompt tokens served from the radix prefix cache "
            "(prefill skipped)")
        self._m_prompt_tokens = reg.counter(
            "serving_prompt_tokens_total",
            "prompt tokens across admitted requests (hit + prefilled)")
        self._m_rss = reg.gauge(
            "process_rss_bytes", "host resident set size")
        self._m_device_mem = reg.gauge(
            "device_bytes_in_use",
            "device allocator bytes in use (CUDA devices)")
        self._m_device_peak = reg.gauge(
            "device_peak_bytes_in_use",
            "device allocator high-water mark")
        self._m_oldest_wait = reg.gauge(
            "serving_queue_oldest_wait_s",
            "age of the oldest queued request (admission latency SLO)")
        self._m_crashes = reg.counter(
            "serving_engine_crashes_total",
            "exceptions escaping step() (each dumps a flight postmortem)")
        self._m_critical = reg.histogram(
            "serving_request_critical_path_ms",
            "per-request time attribution by critical-path phase (ms)",
            labelnames=("phase",))
        self._m_cp = {ph: self._m_critical.labels(phase=ph)
                      for ph in ("queue", "prefill", "decode", "device")}
        self._m_qos_ttft = reg.histogram(
            "serving_qos_ttft_ms",
            "submit to first token by QoS tier (ms)",
            labelnames=("tier",))
        self._m_qos_itl = reg.histogram(
            "serving_qos_itl_ms",
            "inter-token latency by QoS tier (ms)",
            labelnames=("tier",))
        self._m_qos_critical = reg.histogram(
            "serving_qos_critical_path_ms",
            "per-request critical-path attribution by QoS tier (ms)",
            labelnames=("tier", "phase"))

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               seed: int = 0, eos_id: Optional[int] = None,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               deadline_s: Optional[float] = None,
               tier: str = "interactive",
               trace_id: Optional[int] = None,
               parent_span: Optional[str] = None) -> Request:
        """Queue one request; returns it (consume ``request.stream``).
        Raises :class:`QueueFullError` under backpressure,
        :class:`DrainingError` after :meth:`begin_drain`, and
        ``ValueError`` for requests that can never fit the cache."""
        if self.draining:
            raise DrainingError(
                "engine is draining: admissions are closed, in-flight "
                "streams are finishing"
            )
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1; got {max_new_tokens}"
            )
        if prompt.size + max_new_tokens > self.model.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len={self.model.max_len} "
                f"(the per-slot KV-cache length)"
            )
        if top_k is not None:
            if top_k < 1:
                raise ValueError(f"top_k must be >= 1; got {top_k}")
            top_k = min(top_k, self.model.vocab_size)
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]; got {top_p}")
        if tier not in QOS_TIERS:
            raise ValueError(
                f"unknown QoS tier {tier!r}; expected one of {QOS_TIERS}"
            )
        req = Request(
            prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, seed=seed, eos_id=eos_id,
            top_k=top_k, top_p=top_p, deadline_s=deadline_s,
            tier=tier, trace_id=trace_id, parent_span=parent_span,
        )
        return self.scheduler.submit(req)

    # -- the engine loop ----------------------------------------------------

    def step(self) -> bool:
        """One scheduler iteration: admit into free slots, run one mixed
        tick over the pool, emit tokens, free finished slots, and refill
        them from the queue in the same call. Returns False when there is
        nothing to do. An exception escaping the cycle dumps the flight
        recorder to a postmortem JSONL before re-raising."""
        try:
            return self._step()
        except Exception as e:
            self._m_crashes.inc()
            if self.flight is not None:
                path = self.flight.dump_postmortem(
                    "crash", error=f"{type(e).__name__}: {e}",
                    tick=self.ticks,
                )
                if path:
                    print(
                        f"ServingEngine: step() crashed at tick "
                        f"{self.ticks}; flight postmortem: {path}",
                        file=sys.stderr,
                    )
            raise

    @torch.no_grad()
    def _step(self) -> bool:
        self._admit()
        occupied = any(st is not None for st in self._slots)
        if occupied:
            self._mixed_tick()
            # slots freed while processing the tick's tokens are refilled
            # NOW, so the next tick already serves their replacements
            self._admit()
        return occupied or self.scheduler.depth() > 0

    def drain(self, timeout: float = 120.0):
        """Step until queue and slots are empty (bench/test helper)."""
        deadline = time.monotonic() + timeout
        while self.step():
            if time.monotonic() > deadline:
                raise TimeoutError("engine did not drain in time")

    def begin_drain(self):
        """Close admissions: later :meth:`submit` calls raise
        :class:`DrainingError` while queued and in-flight requests
        finish. Idempotent."""
        if not self.draining:
            self.journal.append("drain", queued=self.scheduler.depth())
        self.draining = True

    def end_drain(self):
        """Reopen admissions after :meth:`begin_drain`. Idempotent."""
        if self.draining:
            self.journal.append("undrain")
        self.draining = False

    @property
    def drained(self) -> bool:
        """True once a draining engine has finished all accepted work."""
        return (self.draining and self.scheduler.depth() == 0
                and all(st is None for st in self._slots))

    def update_weights(self, variables, version=None):
        raise _not_ported("live weight updates (update_weights)", "A8")

    def export_blocks(self, prompt):
        raise _not_ported("KV-block export (export_blocks)", "A8")

    def import_blocks(self, prompt, blocks):
        raise _not_ported("KV-block import (import_blocks)", "A8")

    def watchdog(self, timeout_s: float = 30.0, interval_s=None):
        raise _not_ported("the stall watchdog (telemetry.slo)", "A11")

    # -- admission ------------------------------------------------------------

    def _admit(self) -> int:
        free = [i for i, st in enumerate(self._slots) if st is None]
        if not free:
            return 0
        admissible = None
        if self.paged:
            # free-block-aware admission: a request only enters a slot
            # when its WORST-CASE block need fits in free + evictable
            # blocks; `reserved` accumulates within one pop so a batch
            # of admissions can't jointly overcommit
            reserved = [0]

            def admissible(req: Request) -> bool:
                need, avail = self._paged_headroom(req)
                if avail - reserved[0] < need:
                    return False
                reserved[0] += need
                return True

        admitted, expired = self.scheduler.pop_admissible(
            len(free), admissible=admissible
        )
        for req in expired:
            self.metrics.summary(
                "request", rid=req.rid, reason="expired", tokens=0,
                queued_ms=round((req.done_t - req.submit_t) * 1e3, 3),
            )
        for req in admitted:
            self._prefill_into(free.pop(0), req)
        return len(admitted)

    def _blocks_for(self, req: Request) -> int:
        """Worst-case logical blocks a request can occupy: every prompt
        and generated token position, rounded up to whole blocks."""
        return -(-(int(req.prompt.size) + req.max_new_tokens)
                 // self.block_size)

    def _paged_headroom(self, req: Request):
        """(need, avail) for admission: fresh blocks the request must be
        able to allocate (prefix hits count as savings only while their
        blocks are pinned by live references), and the blocks obtainable
        without touching live data (free + unreferenced cached,
        excluding this request's own hit chain)."""
        total = self._blocks_for(req)
        if self.prefix is None:
            return total, self.pool.free_count()
        m = self.prefix.match(req.prompt)
        hit_live = sum(1 for b in m.blocks if self.pool.ref[b] > 0)
        avail = self.pool.free_count() + self.prefix.evictable_count(
            self.pool.ref, exclude=m.blocks
        )
        return total - hit_live, avail

    def _alloc_blocks(self, n: int, keep=()) -> List[int]:
        """Allocate ``n`` blocks, evicting LRU unreferenced prefix blocks
        as needed (``keep`` protects a hit chain about to be reused)."""
        while self.pool.free_count() < n and self.prefix is not None:
            need = n - self.pool.free_count()
            victims: List[int] = []
            ex = set(keep)
            while len(victims) < need:
                blk = self.prefix.peek_evictable(self.pool.ref, exclude=ex)
                if blk is None:
                    break
                victims.append(blk)
                ex.add(blk)
            if not victims:
                break
            for blk in victims:
                self.prefix.remove_block(blk)
                self.pool.evict(blk)
        return self.pool.alloc(n)

    def _prefill_into(self, slot: int, req: Request):
        now = time.monotonic()
        req.admit_t = now
        self.tracer.record(req.trace_id, "queued", req.submit_t,
                           (now - req.submit_t) * 1e3,
                           parent=req.parent_span)
        self._chunked_enter(slot, req, now)

    def _paged_attach_blocks(self, req: Request):
        """Paged admission bookkeeping: radix-match the prompt, reuse the
        matched prefix blocks (refcount bump, zero prefill),
        copy-on-write a partially-shared block if the prompt diverges
        mid-block, allocate the rest. Returns ``(chain, cached)``."""
        bs = self.block_size
        m = (self.prefix.match(req.prompt) if self.prefix is not None
             else None)
        shared = list(m.blocks) if m else []
        total = self._blocks_for(req)
        fresh = self._alloc_blocks(total - len(shared), keep=shared)
        chain = shared + fresh
        self.pool.incref(chain)
        cached = len(shared) * bs
        if m is not None and m.cow is not None:
            # the prompt shares j tokens of a cached block, then diverges:
            # copy that block into this row's first fresh block — the
            # row's writes land in its own copy, the shared original
            # stays immutable under other tables
            src, j = m.cow
            self._copy_block(src, fresh[0])
            cached += j
        return chain, cached

    def _copy_block(self, src: int, dst: int):
        """Copy-on-write: duplicate physical block ``src`` into ``dst``
        across every paged cache leaf (K, V, int8 scales), in place."""
        for leaf in self._cache.leaves():
            leaf[dst] = leaf[src]

    def _chunked_enter(self, slot: int, req: Request, now: float):
        """Admit one request into a slot without any dispatch: the prompt
        is queued on the slot state (``pending``) and streams through the
        next mixed ticks chunk by chunk under the scheduler's token
        budget. Prefix-cache hits skip the shared span."""
        Tp = int(req.prompt.size)
        cached = 0
        if self.paged:
            chain, cached = self._paged_attach_blocks(req)
            tables = self._block_tables.copy()
            tables[slot, :] = 0
            tables[slot, :len(chain)] = chain
            self._block_tables = tables
            lens = self._seq_lens.copy()
            lens[slot] = cached
            self._seq_lens = lens
        else:
            chain = None
            # park the slot at depth 0: stale K/V beyond the cursor is
            # unreachable (each position is rewritten before any query
            # of the new tenant can attend it)
            self._cache.index[slot] = 0
        self._gens[slot].manual_seed(req.seed)
        self._slots[slot] = _SlotState(
            req=req, remaining=req.max_new_tokens, blocks=chain,
            cached_tokens=cached,
            pending=np.asarray(req.prompt[cached:], np.int32),
            decoding=False, admit_seq=self._admit_seq, admit_t=now,
        )
        self._admit_seq += 1
        self.prompt_tokens += Tp
        self._m_prompt_tokens.inc(Tp)
        if self.paged:
            self.prefix_hit_tokens += cached
            self._m_prefix_hit.inc(cached)

    # -- the mixed tick -------------------------------------------------------

    def _mixed_tick(self):
        """One fused mixed prefill/decode tick: plan and dispatch, then
        reconcile."""
        self._reconcile(self._plan_dispatch_mixed())

    def _upload(self, packed: np.ndarray):
        """One packed control-buffer copy per tick — none when the plan
        is unchanged from the previous tick (the all-decode slot-mode
        steady state reuses the previous device buffer; the tick body
        never writes to it). ``torch.tensor`` always copies, so the
        device buffer never aliases the host array."""
        prev_host, prev_dev = self._packed_prev
        if (prev_host is not None and prev_host.shape == packed.shape
                and np.array_equal(prev_host, packed)):
            return prev_dev
        dev = torch.tensor(packed, dtype=torch.int32, device=self._device)
        self._packed_prev = (packed, dev)
        return dev

    def _plan_dispatch_mixed(self) -> _InflightTick:
        """Plan one mixed tick from host state only — deal the token
        budget (decodes first, then prompt chunks in admission order),
        advance each prefilling row's pending queue and flip rows whose
        last chunk is being fed to DECODING — then run ONE ``[S, C]``
        valid-length step (``[S, 1]`` when no prompt token was dealt)."""
        t_plan0 = time.perf_counter()
        S = self.slots
        cfgs = tuple(
            (st.req.temperature, st.req.top_k, st.req.top_p)
            if st else _IDLE_CFG
            for st in self._slots
        )
        n_dec = sum(1 for st in self._slots if st and st.decoding)
        pre = sorted(
            ((s, st) for s, st in enumerate(self._slots)
             if st and not st.decoding),
            key=lambda p: p[1].admit_seq,
        )
        takes = self.scheduler.plan_prefill(
            n_dec, [len(st.pending) for _, st in pre], self.prefill_chunk,
            tiers=[st.req.tier for _, st in pre],
        )
        fed_tokens = sum(takes)
        C = self.prefill_chunk if fed_tokens else 1
        fed = np.zeros((S, C), np.int32)
        valid = np.zeros((S,), np.int32)
        sample_mask = np.zeros((S,), np.int32)
        rows: List[Optional[tuple]] = [None] * S
        for s, st in enumerate(self._slots):
            if st is None:
                # idle rows tick along like decoders (sampling greedily
                # into the void at their parked cursor)
                valid[s] = 1
                sample_mask[s] = 1
            elif st.decoding:
                valid[s] = 1
                sample_mask[s] = 1
                rows[s] = ("dec", st)
        for (s, st), take in zip(pre, takes):
            flipped = False
            if take > 0:
                fed[s, :take] = st.pending[:take]
                valid[s] = take
                st.pending = st.pending[take:]
                if st.pending.size == 0:
                    # last chunk dealt: this step leaves the prompt-final
                    # logits at the row's last valid token — the NEXT
                    # tick samples its first token
                    st.decoding = True
                    flipped = True
            # take == 0: starved this tick — valid stays 0, the row
            # writes nothing and its cursor holds
            rows[s] = ("pre", st, take, flipped)
        if self.paged:
            # live rows advance by what the step consumes; idle rows stay
            # parked at 0 on the trash block (rebind, never mutate)
            adv = np.zeros((S,), np.int32)
            for s, row in enumerate(rows):
                if row is not None:
                    adv[s] = 1 if row[0] == "dec" else valid[s]
            packed = _pack_i32(self._block_tables, self._seq_lens, fed,
                               valid, sample_mask)
            self._seq_lens = self._seq_lens + adv
        else:
            packed = _pack_i32(fed, valid, sample_mask)
        t0 = time.perf_counter()
        plan_ms = (t0 - t_plan0) * 1e3
        dev = self._upload(packed)
        toks = self._mixed_step(cfgs, C, dev, sample_mask)
        return _InflightTick(
            toks=toks, rows=rows, plan_ms=plan_ms,
            dispatch_ms=(time.perf_counter() - t0) * 1e3,
            n_dec=n_dec, fed_tokens=fed_tokens, chunk=C, packed=packed,
        )

    def _sample(self, cfgs, sample_mask: np.ndarray) -> torch.Tensor:
        """Per-slot sampling from the pooled last-token logits: greedy
        rows (and idle rows) share one argmax; each sampling row draws
        on its own ``[1, vocab]`` slice from its own generator — the
        exact call of a solo B=1 :func:`generate` step. A slot's
        generator only advances on ticks it samples."""
        last = self._last_logits
        toks = torch.argmax(last, dim=-1)
        for s, (temp, top_k, top_p) in enumerate(cfgs):
            if sample_mask[s] and temp != 0.0:
                toks[s] = sample_tokens(last[s:s + 1], self._gens[s], temp,
                                        top_k, top_p)[0]
        return toks

    def _mixed_step(self, cfgs, chunk: int, packed: torch.Tensor,
                    sample_mask: np.ndarray) -> torch.Tensor:
        """The mixed tick body (the reference's ``_mixed_tick_fn`` /
        ``_paged_mixed_tick_fn``, as a plain method): sample each
        decoding row's next token, feed it in column 0 of its row, run
        the model over the ``[S, chunk]`` step — the KV cache is updated
        in place — and keep each row's logits at its last valid token.
        Returns the sampled ``[S]`` tokens (device)."""
        S = self.slots
        if self.paged:
            MB = packed.shape[0] // S - chunk - 3
            tables, lens, fed, valid, smask = _unpack_i32(
                packed, ((S, MB), (S,), (S, chunk), (S,), (S,)))
            paged_kw = {"block_tables": tables, "seq_lens": lens}
        else:
            fed, valid, smask = _unpack_i32(packed, ((S, chunk), (S,), (S,)))
            paged_kw = {}
        sampled = self._sample(cfgs, sample_mask)
        inputs = fed.long()
        inputs[:, 0] = torch.where(smask != 0, sampled, inputs[:, 0])
        logits = self._dm(inputs, cache=self._cache, valid_lens=valid,
                          **paged_kw)
        # row s's next-step logits live at its last valid token; a
        # starved prefill row (valid 0) reads garbage it never uses
        idx = torch.clamp(valid.long() - 1, min=0)
        self._last_logits = logits[torch.arange(S, device=logits.device),
                                   idx].to(torch.float32)
        return sampled

    def _reconcile(self, rec: _InflightTick):
        """Materialize one dispatched tick and settle the host side: read
        its tokens back, stream each planned row's token, complete
        EOS'd/exhausted rows, and record telemetry + the flight
        snapshot."""
        t_wait0 = time.perf_counter()
        toks_host = rec.toks.cpu().numpy()  # waits for the tick
        wait_ms = (time.perf_counter() - t_wait0) * 1e3
        t_stream0 = time.perf_counter()
        self.ticks += 1
        occupancy = sum(st is not None for st in self._slots)
        self._occ_sum += occupancy
        now = time.monotonic()
        device_ms = rec.dispatch_ms + wait_ms
        emitted = 0
        for s, row in enumerate(rec.rows):
            if row is None:
                continue
            st = row[1]
            if row[0] == "pre":
                if row[3]:  # the prompt's last chunk landed this tick
                    req = st.req
                    req.prefill_done_t = now
                    prefill_ms = (now - st.admit_t) * 1e3
                    self.tracer.record(
                        req.trace_id, "prefill", st.admit_t,
                        prefill_ms, slot=s,
                        prompt_tokens=int(req.prompt.size),
                        cached_tokens=st.cached_tokens,
                        chunk=self.prefill_chunk,
                    )
                    self._m_prefill_ms.observe(prefill_ms)
                continue
            e, _ = self._stream_row(s, st, [int(toks_host[s])], now)
            emitted += e
        queue_depth = self.scheduler.depth()
        self._m_ticks.inc()
        self._m_tokens.inc(emitted)
        self._m_occupancy.set(sum(st is not None for st in self._slots))
        self._m_tick_ms.observe(device_ms)
        self._m_device_wait.observe(wait_ms)
        if rec.fed_tokens + rec.n_dec > 0:
            self._m_prefill_frac.observe(
                rec.fed_tokens / (rec.fed_tokens + rec.n_dec))
        if device_ms > 0:
            self._m_decode_tps.set(round(emitted / (device_ms / 1e3), 3))
        self.metrics.log(
            step=self.ticks, occupancy=occupancy, queue_depth=queue_depth,
            token_ms=round(device_ms, 3), prefill_tokens=rec.fed_tokens,
        )
        self._record_tick(
            plan_ms=rec.plan_ms, device_ms=device_ms,
            stream_ms=(time.perf_counter() - t_stream0) * 1e3,
            n_dec=rec.n_dec, prefill_tokens=rec.fed_tokens,
            chunk=rec.chunk, emitted=emitted, occupancy=occupancy,
            queue_depth=queue_depth, device_wait_ms=wait_ms,
            dispatch_ms=rec.dispatch_ms,
        )

    def _stream_row(self, s: int, st: _SlotState, toks_row, now):
        """Emit one row's tick tokens to its consumer stream, stopping at
        EOS or budget exhaustion (which completes the slot)."""
        req = st.req
        take: List[int] = []
        done = False
        reason = None
        for tok in toks_row:
            take.append(tok)
            req.n_emitted += 1
            st.remaining -= 1
            self.tokens_generated += 1
            if req.eos_id is not None and tok == req.eos_id:
                done, reason = True, "eos"
                break
            if st.remaining == 0:
                done, reason = True, "length"
                break
        self._emit_now(req, take, now)
        if done:
            self._complete(s, reason)
        return len(take), done

    def _emit_now(self, req: Request, toks, now):
        for tok in toks:
            if req.first_token_t is None:
                req.first_token_t = now
                ttft_ms = (now - req.submit_t) * 1e3
                self._m_ttft_ms.observe(ttft_ms, exemplar=req.trace_id)
                self._m_qos_ttft.labels(tier=req.tier).observe(ttft_ms)
            else:
                itl_ms = (now - req.last_token_t) * 1e3
                self._m_itl_ms.observe(itl_ms, exemplar=req.trace_id)
                self._m_qos_itl.labels(tier=req.tier).observe(itl_ms)
            req.last_token_t = now
            req.stream._put(tok)

    def _complete(self, slot: int, reason: str):
        """Free a finished slot NOW (blocks released, row parked, the
        scheduler's head-of-line short-circuit invalidated) and notify
        the consumer."""
        st = self._slots[slot]
        req = st.req
        req.done_t = time.monotonic()
        if self.paged:
            self._release_blocks(st)
            # park the freed row on the trash block (rebind, never mutate)
            tables = self._block_tables.copy()
            tables[slot, :] = 0
            self._block_tables = tables
            lens = self._seq_lens.copy()
            lens[slot] = 0
            self._seq_lens = lens
        self._slots[slot] = None
        self.requests_completed += 1
        self.scheduler.note_capacity_change()
        self._notify_finish(req, reason, slot)

    def _notify_finish(self, req: Request, reason: str, slot: int):
        # spans first, then the stream-end sentinel: a client that saw
        # "done" can immediately read the full chain
        decode_t0 = req.prefill_done_t or req.submit_t
        decode_ms = (req.done_t - decode_t0) * 1e3
        device_ms = min(req.device_ms_accum, decode_ms)
        self.tracer.record(
            req.trace_id, "decode", decode_t0, decode_ms,
            slot=slot, tokens=req.n_emitted,
            device_ms=round(device_ms, 3),
        )
        self.tracer.record(
            req.trace_id, "finish", req.done_t, 0.0,
            reason=reason, slot=slot, tokens=req.n_emitted,
            ttft_ms=round((req.first_token_t - req.submit_t) * 1e3, 3),
        )
        admit_t = req.admit_t or req.submit_t
        prefill_done = req.prefill_done_t or admit_t
        phase_ms = (
            ("queue", (admit_t - req.submit_t) * 1e3),
            ("prefill", (prefill_done - admit_t) * 1e3),
            ("device", device_ms),
            ("decode", max(decode_ms - device_ms, 0.0)),
        )
        for ph, ms in phase_ms:
            self._m_cp[ph].observe(ms)
            self._m_qos_critical.labels(tier=req.tier, phase=ph).observe(ms)
        self._m_requests.labels(reason=reason).inc()
        req.stream._finish(reason)
        self.metrics.summary(
            "request", rid=req.rid, reason=reason, tokens=req.n_emitted,
            ttft_ms=round((req.first_token_t - req.submit_t) * 1e3, 3),
            total_ms=round((req.done_t - req.submit_t) * 1e3, 3),
        )

    def _release_blocks(self, st: _SlotState):
        """Finish-time block bookkeeping: register the prompt's full
        blocks in the radix index (future requests hit them), then drop
        this request's references; private blocks go straight back to
        the free list."""
        req = st.req
        if self.prefix is not None:
            n_full = int(req.prompt.size) // self.block_size
            self.prefix.insert(
                req.prompt[:n_full * self.block_size],
                st.blocks[:n_full],
            )
        released = self.pool.decref(st.blocks)
        to_free = [
            b for b in released
            if self.prefix is None or not self.prefix.contains_block(b)
        ]
        if to_free:
            self.pool.free(to_free)

    # -- observability ------------------------------------------------------

    MEM_SAMPLE_EVERY = 32  # ticks between /proc + device-allocator reads

    def _slot_snaps(self) -> list:
        out = []
        for st in self._slots:
            if st is None:
                out.append(None)
            elif st.decoding:
                out.append({"rid": st.req.rid, "state": "decode",
                            "remaining": st.remaining})
            else:
                out.append({"rid": st.req.rid, "state": "prefill",
                            "pending": int(st.pending.size),
                            "remaining": st.remaining})
        return out

    def _sample_memory(self) -> dict:
        """Host RSS + CUDA allocator watermarks into gauges; returns the
        plain-dict summary for the flight snapshot."""
        rss = self._mem.sample_host()
        if rss is not None:
            self._m_rss.set(rss)
        if self._device.type == "cuda":
            self._mem.sample_device({
                "bytes_in_use": torch.cuda.memory_allocated(self._device),
                "peak_bytes_in_use":
                    torch.cuda.max_memory_allocated(self._device),
            })
            self._m_device_mem.set(self._mem.device_bytes)
            self._m_device_peak.set(self._mem.device_peak_bytes)
        return self._mem.summary()

    def _record_tick(self, *, plan_ms: float, device_ms: float,
                     stream_ms: float, n_dec: int, prefill_tokens: int,
                     chunk: Optional[int], emitted: int, occupancy: int,
                     queue_depth: int, device_wait_ms: float,
                     dispatch_ms: float):
        """Post-tick runtime introspection + the flight snapshot, self-
        timed against tick wall time (``stats()["flight"]``)."""
        self._tick_ns += int((plan_ms + device_ms + stream_ms) * 1e6)
        oldest = self.scheduler.oldest_age_s()
        sample_tick = self.ticks % self.MEM_SAMPLE_EVERY == 1
        mem = None
        if sample_tick:
            mem = self._sample_memory()
            self._m_oldest_wait.set(round(oldest, 3))
        # device-compute attribution: this tick's device time split
        # evenly over the rows that were active
        if device_ms > 0.0:
            live = [st for st in self._slots if st is not None]
            if live:
                share = device_ms / len(live)
                for st in live:
                    st.req.device_ms_accum += share
        t0 = time.perf_counter_ns()
        if self.flight is not None:
            snap = {
                "kind": "tick", "tick": self.ticks,
                "t": time.monotonic(),
                "tick_ms": plan_ms + device_ms + stream_ms,
                "plan_ms": plan_ms, "device_ms": device_ms,
                "stream_ms": stream_ms,
                "device_wait_ms": device_wait_ms,
                "dispatch_ms": dispatch_ms,
                "occupancy": occupancy, "queue_depth": queue_depth,
                "queue_oldest_wait_s": oldest,
                "qos_depth": self.scheduler.depth_by_tier(),
                "budget_limit": self.scheduler.tick_token_budget,
                "decode_tokens": n_dec,
                "prefill_tokens": prefill_tokens, "chunk": chunk,
                "emitted": emitted,
                "slots": self._slot_snaps(),
            }
            if mem is not None:
                snap["mem"] = mem
            if self.paged:
                snap["blocks"] = (self.pool.stats() if sample_tick
                                  else {"in_use": self.pool.in_use_count(),
                                        "free": self.pool.free_count()})
                snap["prefix_hit_tokens"] = self.prefix_hit_tokens
            self.flight.record(snap)
        self._flight_ns += time.perf_counter_ns() - t0

    def stats(self) -> dict:
        """Counters + latency percentiles (TTFT and per-token, ms) for
        THIS engine. The process-cumulative view is
        ``self.registry.collect()``."""
        qos_depth = self.scheduler.depth_by_tier()
        out = {
            "device": str(self._device),
            "prefill_kernel": self.prefill_kernel,
            "ticks": self.ticks,
            "requests_completed": self.requests_completed,
            "tokens_generated": self.tokens_generated,
            "queue_depth": self.scheduler.depth(),
            "active_slots": sum(1 for st in self._slots if st is not None),
            "draining": self.draining,
            "drained": self.drained,
            "mean_occupancy": (
                round(self._occ_sum / self.ticks, 3) if self.ticks else 0.0
            ),
            "ttft_ms": self.metrics.percentiles("ttft_ms"),
            "token_ms": self.metrics.percentiles("token_ms"),
            "itl_ms": {
                "p50": self._m_itl_ms.percentile(50),
                "p99": self._m_itl_ms.percentile(99),
                "p99_exemplar": self._m_itl_ms.tail_exemplar(),
            },
            "queue_oldest_wait_s": round(
                self.scheduler.oldest_age_s(), 3),
            "memory": self._mem.summary(),
            "device_wait_ms": {
                "p50": self._m_device_wait.percentile(50),
                "p99": self._m_device_wait.percentile(99),
            },
            "critical_path_ms": {
                ph: {"p50": self._m_critical.percentile(50, phase=ph),
                     "p99": self._m_critical.percentile(99, phase=ph)}
                for ph in ("queue", "prefill", "decode", "device")
            },
            "qos": {
                t: {
                    "queue_depth": qos_depth.get(t, 0),
                    "ttft_p99_ms": self._m_qos_ttft.percentile(
                        99, tier=t),
                    "itl_p50_ms": self._m_qos_itl.percentile(50, tier=t),
                    "itl_p99_ms": self._m_qos_itl.percentile(99, tier=t),
                    "preempted_chunks": (
                        self.scheduler._m_qos_preempted
                        .labels(tier=t).value),
                }
                for t in QOS_TIERS
            },
        }
        if self.flight is not None:
            out["flight"] = {
                "recorded": len(self.flight),
                "dropped": self.flight.dropped,
                "overhead_frac": round(
                    self._flight_ns
                    / max(self._tick_ns + self._flight_ns, 1), 5),
            }
        if self.paged:
            pool = self.pool.stats()
            out.update({
                "paged_kernel": self.paged_kernel,
                "blocks_in_use": self.pool.in_use_count(),
                "blocks_free": self.pool.free_count(),
                "blocks_reclaimable": pool["free"] + pool["cached"],
                "prompt_tokens": self.prompt_tokens,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prefix_hit_fraction": (
                    round(self.prefix_hit_tokens / self.prompt_tokens, 4)
                    if self.prompt_tokens else 0.0
                ),
            })
        return out
