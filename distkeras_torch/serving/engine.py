"""Continuous-batching serving engine — the port of
:mod:`distkeras_tpu.serving.engine` on one device.

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
- **Chunked prefill fused into the tick** (Sarathi-Serve-style, the
  default): a joining prompt streams into its slot ``prefill_chunk``
  tokens per tick, coalesced with the decoding rows into ONE ``[S, C]``
  mixed step — each row at its own valid length, K/V written at
  absolute per-row positions, logits taken at each row's last valid
  token. The scheduler's ``tick_token_budget`` meters the prompt tokens
  a tick carries (decodes first). With no chunk dealt the step is
  ``[S, 1]``. ``prefill_chunk=None`` is the monolithic mode: a whole
  prompt runs as one B=1 prefill at admission (merged into the slot's
  cache row, or written straight into the block pool for its uncached
  suffix), and ticks are plain ``[S, 1]`` decode steps.
- **Per-slot sampling.** Each slot samples on its own ``[1, vocab]``
  logits slice with its own ``torch.Generator``, seeded from the
  request's ``seed`` and advanced only on ticks it sampled — the
  function and draws of a solo B=1
  :func:`~distkeras_torch.models.transformer.generate`, so streams are
  token-identical to it.
- **Pipelined loop** (``pipeline=True``): tick N+1 is planned
  optimistically and dispatched BEFORE tick N's tokens are read back,
  so host planning and token streaming overlap device compute; late
  finishes drop their one overrun token at reconciliation and streams
  stay bit-identical to the sync loop. Every host->device control copy
  goes through a pinned buffer with ``non_blocking=True`` and every
  token readback through a pinned buffer and a CUDA event recorded
  right after its tick, so neither copy waits for the tick queued
  behind it; each buffer stays referenced by its in-flight tick until
  that tick is reconciled.
- **Multi-step decode** (``multi_step_k > 1``): in all-decode steady
  state one dispatch issues up to k decode steps back to back, sampling,
  cache writes and EOS / emission-limit masking on the device, and the
  host reads ``[S, k]`` tokens once.
- **Speculative decoding** (``draft="ngram"`` or a draft model): one
  fused ``[S, spec_k + 1]`` verify step per tick, per-row rejection
  sampling on the device (greedy streams bit-identical to the plain
  engine, sampled streams exact in distribution), rejected suffixes
  rolled back as cursor rewinds.
- **Host-RAM KV tier** (``host_blocks``, paged): evicted prefix blocks
  are demoted to pinned host memory and restored on a prefix hit by a
  non-blocking copy issued before the tick that reads them.

On the card the attention runs the hand-written Hopper kernels: the
paged-attention kernel on the paged layout (every layer of every step:
decode, multi-step, verify at ``spec_k + 1``, monolithic prefill of a
suffix), the splash chunked-prefill kernel on the slot layout (every
layer of every step carrying more than one token: chunks, verify
windows, monolithic prompts, a draft model's catch-up feed). There is
no jit and no buffer donation: the tick bodies are plain methods that
update the KV cache in place. Host-side control arrays (block tables,
seq lens, fed tokens, valid lens, masks) ride ONE packed int32 upload
per tick, built fresh each tick and never mutated after — the torch
form of the reference's host-buffer aliasing rule.

Observability is the reference's: a span chain per request (stamped
with the weight version), live counters/gauges/histograms in a
:class:`~distkeras_torch.telemetry.MetricRegistry`, per-tick
:class:`~distkeras_torch.telemetry.FlightRecorder` snapshots dumped to a
postmortem JSONL on crash, and per-request JSONL records through
:class:`~distkeras_torch.utils.metrics.MetricsWriter`.

Tensor-parallel serving (``mesh=make_mesh({"model": n})``): every rank
is one process that builds the engine from the same ``tp_size=1`` model
and is submitted the same requests in the same order; the engine serves
a tp twin holding this rank's slice of the heads and the MLP
(:meth:`~distkeras_torch.models.transformer.TransformerLM.shard`) over
caches of ``Hk/tp`` KV heads, with one ``all_reduce`` per col -> row
projection pair inside each tick. The logits after the last all-reduce
are identical on every rank and the per-slot generators are seeded the
same, so every rank samples the same tokens and plans the same next
tick: the ranks step in lock step, and no plan decision reads a clock
(deadlines are refused). Host-side KV (the host tier, exported and
imported blocks) is unsharded: gathered over tp on the way out, sliced
on the way in, so a block moves between engines of any tp degree.

A tensor-parallel engine admits at the step boundary: :meth:`submit`
applies the scheduler's refusals at once (the queue depth counting what
is staged) and STAGES an accepted request, which enters the scheduler at
the top of the next step (every rank submitting the same requests in the
same order). Behind a server, :meth:`serve_forever` on a tp engine is
the **lock-step loop**: rank 0 (the leader) sends, at the top of every
iteration (idle ones included), one step record over the mesh's control
group (gloo, CPU tensors, its own timeout) holding the named control ops
it is about to apply (:meth:`control`: a weight push, a KV export or
import, a role flip, a drain), the admissions it is about to submit,
whether it steps or dozes and the stop flag; every other rank (a
follower) receives it, applies the same ops (their tensors broadcast
after the record) and admissions in the same order and runs the same
step, so the ticks' tp collectives meet. Each record also carries the
leader's state (ticks, slots, queue depth, weight version, role, drain
flag, failed ops), which a follower checks against its own: a rank that
falls out of step raises naming itself, and a rank that dies or stalls
makes the others' next broadcast or collective raise after the control
group's timeout. Either way the loop ends with a flight postmortem. A
follower's streams are read by nobody: each keeps its tokens, and the
last :data:`LOCKSTEP_STREAM_RECORDS` finished ones stay in
``lockstep_streams``.

The loop thread: :meth:`ServingEngine.serve_forever` steps the engine
until told to stop (on the engine's card: CUDA's current device is per
thread), and :meth:`ServingEngine.call_in_loop` marshals a control call
(:meth:`~ServingEngine.update_weights`,
:meth:`~ServingEngine.export_blocks`, :meth:`~ServingEngine.import_blocks`,
:meth:`~ServingEngine.set_role`) from another thread onto it, serviced
at the top of the next step — before the pipelined loop plans, so a
tick already in flight completes on the state it was queued with.
:class:`~distkeras_torch.serving.server.LMServer` runs that thread and
:meth:`ServingEngine.watchdog` guards it. Without a loop thread those
calls are made between steps (by every rank of a tp engine, in the same
order: an export gathers over tp).
"""

from __future__ import annotations

import contextlib
import inspect
import sys
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from distkeras_torch import bridge, telemetry
from distkeras_torch.models.transformer import filter_logits, sample_tokens
from distkeras_torch.parallel.collectives import (all_gather_tp,
                                                  broadcast_object,
                                                  broadcast_tensors,
                                                  tensor_specs)
from distkeras_torch.parallel.mesh import Mesh
from distkeras_torch.parallel.spmd import (draft_param_specs, shard_tensor,
                                           tp_dim)
from distkeras_torch.serving.kvpool import BlockPool, HostBlockPool
from distkeras_torch.serving.prefix import RadixPrefixIndex
from distkeras_torch.serving.scheduler import (
    DEFAULT_PREFILL_CHUNK,
    QOS_TIERS,
    DrainingError,
    FIFOScheduler,
    QueueFullError,
    Request,
    TokenStream,
)
from distkeras_torch.serving.weights import validate_like
from distkeras_torch.telemetry.events import EventJournal
from distkeras_torch.telemetry.flight import FlightRecorder
from distkeras_torch.telemetry.runtime import MemoryWatermarks, recompiles
from distkeras_torch.telemetry.slo import StallWatchdog
from distkeras_torch.utils.device import resolve_device
from distkeras_torch.utils.metrics import MetricsWriter

# a draft model's per-slot generator seed: the request's seed moved past
# every emission seed, so the proposal chain never shares draws with the
# emission chain (the reference folds 1 into the request's key)
_DRAFT_SEED_OFFSET = 1 << 32

# the control calls that touch device state, by name (ServingEngine.
# control): a tensor-parallel engine applies each on every rank
CONTROL_OPS = ("update_weights", "export_blocks", "import_blocks",
               "set_role", "begin_drain", "end_drain")
# a follower rank keeps the streams of this many finished requests
LOCKSTEP_STREAM_RECORDS = 1024


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


def _d2h(tensors, device: torch.device):
    """Start reading device tensors back: on the card each is copied into
    a pinned buffer with ``non_blocking=True`` and ONE event is recorded
    right after the copies, so a later wait on it covers exactly this
    work — not the tick the pipelined loop queued behind it. On the CPU
    the copies are plain. Returns ``(host tensors, event or None)``."""
    if device.type != "cuda":
        return [t.clone() for t in tensors], None
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in tensors]
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return hosts, ev


def _merge_drafts(fed, valid, n_forced, draft_toks, k):
    """Scatter each row's draft tokens into its window columns
    ``n_forced .. valid-1`` (on the device: a model drafter's proposals
    never round-trip the host). Forced columns and prefill chunks stay
    as the host built them."""
    cols = torch.arange(fed.shape[1], device=fed.device)[None, :]
    di = cols - n_forced[:, None]
    take = torch.gather(draft_toks, 1, torch.clamp(di, 0, k - 1))
    return torch.where((di >= 0) & (cols < valid[:, None]), take, fed)


def _spec_accept(cfgs, k, onehot_q, full, gens, valid, n_forced,
                 sample_mask, draft_toks, q_probs):
    """Rejection-sampling core of both verify steps (the reference's
    ``_spec_accept``).

    ``full`` [S, W+1, V]: position j is the target's sampling source for
    window token j (j=0 is the pre-window last logits). Per row: accept
    the longest draft prefix where each draft d_i survives ``u <
    min(1, p_i(d_i)/q_i(d_i))`` (greedy: ``d_i == argmax p_i``), then
    draw the extra token z from the residual ``norm(max(p - q, 0))`` at
    the first rejection — or from the full target distribution when
    every draft survived (the bonus token). ``onehot_q`` marks a
    deterministic drafter (the n-gram one): q is one-hot at the
    proposal. A sampling row (``sample_mask``, host-known) draws its
    ``k`` accept uniforms and then z's ``V`` uniforms from its own
    generator; every other row draws nothing.

    Returns ``(out_toks [S, k+1], acc [S], new_last [S, V])``: rows of
    out_toks are [accepted drafts..., z, 0 pad]; new_last is
    ``full[s, n_forced + acc]`` — for prefill rows (acc 0, n_forced =
    valid) the logits at the last valid token, as the mixed tick keeps.
    """
    S, W1, V = full.shape
    dev = full.device
    ar = torch.arange(k, device=dev)
    valid, n_forced = valid.long(), n_forced.long()
    d = draft_toks.long()
    n_draft = valid - n_forced
    j = torch.clamp(n_forced[:, None] + ar[None], max=W1 - 1)  # [S, k]
    pd = torch.gather(full, 1, j[..., None].expand(S, k, V))  # [S, k, V]
    ok = d == torch.argmax(pd, dim=-1)
    sampling = [(s, cfg) for s, cfg in enumerate(cfgs)
                if cfg[0] != 0.0 and sample_mask[s]]
    for s, (temp, top_k, top_p) in sampling:
        p_prob = torch.softmax(filter_logits(pd[s], temp, top_k, top_p),
                               dim=-1)
        p_at_d = torch.gather(p_prob, 1, d[s][:, None])[:, 0]
        if onehot_q:
            ratio = p_at_d
        else:
            q_at_d = torch.gather(q_probs[s], 1, d[s][:, None])[:, 0]
            ratio = p_at_d / torch.clamp(q_at_d, min=1e-30)
        u = torch.rand(k, generator=gens[s], device=dev)
        ok[s] = u < torch.clamp(ratio, max=1.0)
    ok = ok & (ar[None] < n_draft[:, None])
    acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    z_logits = full[torch.arange(S, device=dev), n_forced + acc]  # [S, V]
    z = torch.argmax(z_logits, dim=-1)
    for s, (temp, top_k, top_p) in sampling:
        p_z = torch.softmax(filter_logits(z_logits[s], temp, top_k, top_p),
                            dim=-1)
        a_clip = torch.clamp(acc[s], max=k - 1).view(1)
        if onehot_q:
            q_z = F.one_hot(d[s].index_select(0, a_clip)[0], V).to(p_z.dtype)
        else:
            q_z = q_probs[s].index_select(0, a_clip)[0]
        resid = torch.clamp(p_z - q_z, min=0.0)
        dist = torch.where(acc[s] >= n_draft[s], p_z, resid)
        tot = dist.sum()
        # p == q exactly makes the residual vanish; rejection then had
        # probability 0, so the fallback is never drawn — it only keeps
        # the draw finite
        dist = torch.where(tot > 0, dist / torch.clamp(tot, min=1e-30), p_z)
        z[s] = sample_tokens(torch.log(torch.clamp(dist, min=1e-38))[None],
                             gens[s], 1.0)[0]
    dp = torch.cat([d, torch.zeros((S, 1), dtype=d.dtype, device=dev)], 1)
    pos = torch.arange(k + 1, device=dev)[None]
    out = torch.where(pos < acc[:, None], dp,
                      torch.where(pos == acc[:, None], z[:, None],
                                  torch.zeros_like(dp)))
    return out, acc, z_logits


def _ngram_propose(history: np.ndarray, k: int, max_n: int = 3):
    """Self-speculative n-gram drafter (host-side, no second model):
    match the stream's suffix n-gram (n from ``max_n`` down to 1)
    against its most recent earlier occurrence in ``history`` (prompt +
    emitted tokens) and propose the k tokens that followed it. Overlap
    with the suffix itself is allowed — a stream stuck on one token
    matches at distance 1 and proposes the repeat. Returns ``(proposal
    [k] int32, found)``; found 0 means no match (the row decodes plain
    this tick)."""
    L = int(history.size)
    for n in range(min(max_n, L - 1), 0, -1):
        # candidate starts 0 .. L-n-1: strictly before the suffix, with
        # at least one continuation token inside history
        hay = history[:L - 1]
        if hay.size < n:
            continue
        windows = np.lib.stride_tricks.sliding_window_view(hay, n)
        hits = np.nonzero((windows == history[L - n:]).all(axis=1))[0]
        if hits.size:
            start = int(hits[-1])
            # continuation read from the stream EXTENDED BY THE PROPOSAL
            # itself: past the end of history it lands on an already
            # proposed token — the periodic extension of the matched
            # cycle (a repeat-token stream proposes k repeats)
            ext = history.tolist()
            out = np.empty(k, np.int32)
            for i in range(k):
                t = int(ext[start + n + i])
                out[i] = t
                ext.append(t)
            return out, k
    return np.zeros(k, np.int32), 0


def _host_tensor(a) -> torch.Tensor:
    """A block leaf as a CPU tensor: a tensor as is, a numpy array (read
    off the wire: read-only, bf16 as ``ml_dtypes``) through a copy."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _admission(req: Request) -> dict:
    """A staged request as a step record carries it: every field a
    follower needs to build the same request (the leader's rid, trace id
    and sampling fields)."""
    return {"rid": req.rid, "prompt": req.prompt,
            "max_new_tokens": req.max_new_tokens,
            "temperature": req.temperature, "seed": req.seed,
            "eos_id": req.eos_id, "top_k": req.top_k, "top_p": req.top_p,
            "tier": req.tier, "trace_id": req.trace_id,
            "parent_span": req.parent_span}


_IDLE_CFG = (0.0, None, None)  # free slots sample greedily into the void


@dataclass
class _Ctrl:
    """One control call queued for the loop: a closure ``fn`` (run on
    this rank only) or a named op of :data:`CONTROL_OPS` with its
    arguments (``meta``, picklable) and tensors (every rank of a tp
    engine applies it); the caller waits on ``ev`` for ``box``."""

    fn: Any = None
    op: Optional[str] = None
    meta: Any = None
    tensors: list = field(default_factory=list)
    ev: threading.Event = field(default_factory=threading.Event)
    box: dict = field(default_factory=dict)


class _KeptStream(TokenStream):
    """A follower rank's request stream, which nobody reads: its tokens
    are kept in a list (at most the request's ``max_new_tokens``), and
    at its end ``(rid, tokens, reason)`` joins ``book``, the engine's
    bounded record of finished streams."""

    def __init__(self, rid: int, book: deque):
        super().__init__()
        self.rid, self.kept, self._book = rid, [], book

    def _put(self, tok: int):
        self.kept.append(int(tok))

    def _finish(self, reason: str):
        self.finish_reason = reason
        self._book.append((self.rid, self.kept, reason))


@dataclass
class _SlotState:
    req: Request
    remaining: int
    blocks: Optional[List[int]] = None  # paged: this row's block chain
    cached_tokens: int = 0  # paged: prompt tokens served from the index
    # chunked prefill: prompt tokens not yet fed through a mixed tick
    # (None = monolithic mode, already prefilled). A slot is PREFILLING
    # while decoding is False and DECODING after its last chunk landed.
    pending: Optional[np.ndarray] = None
    decoding: bool = True
    # host tier: (host handle, prompt-token offset) pairs this row still
    # waits on — non-None marks the RESTORING state (the row ticks idle,
    # charging no budget, until the restores land; then PREFILLING)
    restoring: Optional[List[tuple]] = None
    admit_seq: int = 0  # admission order: prefill budget is dealt FIFO
    admit_t: float = 0.0  # monotonic admission time (prefill span)
    # speculative decoding: the row's emitted-but-unfed token (None
    # until the transition tick samples the first one), the
    # prompt+emitted history the n-gram drafter matches against, the
    # queue of true tokens the draft model has not consumed yet, and
    # the draft-cursor overshoot to rewind at its next feed
    pending_tok: Optional[int] = None
    history: Optional[np.ndarray] = None
    draft_queue: Optional[np.ndarray] = None
    draft_rewind: int = 0
    wv: int = 1  # the weight version the row was admitted under


@dataclass
class _InflightTick:
    """One dispatched-but-unread tick: the device-side outputs, their
    pinned host copies and the event after them, plus the host plan
    that produced them. The sync loop reconciles it right after
    dispatch; the pipelined loop holds exactly one while the NEXT tick
    is planned and dispatched. ``rows`` pins the exact
    :class:`_SlotState` each row was planned against — reconciliation
    drops a row's tokens when the slot no longer holds that state (the
    late-finish overrun). ``keep`` holds every pinned host buffer whose
    copy to the card was queued before this tick's kernels (its control
    buffer, restores, prefill uploads): they stay referenced until the
    tick's readback event has passed."""

    toks: Any                       # device [S] ([S, k+1] spec, [S, k] multi)
    # per slot: None (idle at plan) | ("dec", st) | ("pre", st, take,
    # flipped) — flipped marks the prompt's last chunk landing
    rows: List[Optional[tuple]]
    plan_ms: float
    dispatch_ms: float
    n_dec: int
    fed_tokens: int
    chunk: Optional[int]
    # multi-step decode: the window width (None = one-token tick); acc
    # doubles as its device [S] per-row emitted counts
    multi_k: Optional[int] = None
    acc: Any = None                 # device [S] accepted-prefix lengths
    n_forced: Optional[np.ndarray] = None
    granted: Optional[np.ndarray] = None
    spec_set: Optional[set] = None
    host: Optional[list] = None     # pinned host copies of toks (+ acc)
    event: Any = None               # recorded after those copies (card)
    keep: list = field(default_factory=list)


class ServingEngine:
    """Continuous-batching serving over a fixed slot pool.

    Args:
      model: a TRAINING-mode :class:`TransformerLM` (``decode=False``),
        carrying its weights; decode twins sharing them are cloned
        internally. (The reference takes ``params`` beside the module;
        the port's module owns its parameters.)
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
      host_blocks: capacity in KV blocks of the host-RAM spill tier under
        the block pool: evicting a cached unreferenced block demotes its
        contents to pinned host memory (its radix node re-keyed ``device
        -> host``), and a prefix hit on a demoted entry admits the
        request RESTORING — its blocks are copied back by the plan of
        the next ticks (at most the scheduler's ``restore_budget`` a
        tick, each copy queued before the tick that reads the block),
        then it prefills its suffix. Streams stay bit-identical to the
        tier-less engine. Needs ``paged=True``, ``prefix_cache=True``
        and chunked prefill.
      prefill_chunk: prompt tokens a row may feed per tick (default 64);
        ``None`` is the monolithic mode (one B=1 prefill per admission,
        plain decode ticks).
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
      role: advertised replica specialization for disaggregated serving
        — 'mixed' (default), 'prefill' or 'decode'; surfaced in
        :meth:`stats`, flipped by :meth:`set_role`. Engine behavior is
        shaped by the ordinary knobs.
      draft: speculative decoding (chunked mode only): ``"ngram"`` (the
        self-speculative drafter, proposals matched from each stream's
        own prompt + emitted history) or a small TRAINING-mode port
        :class:`TransformerLM` with the flagship's vocab. Like the
        flagship, the draft module carries its own weights: there is no
        ``draft_params`` (the reference's separate variables). It runs
        its own slot cache beside the flagship's, with per-slot
        proposal generators separate from the emission generators. The
        flagship verifies every window in ONE ``[S, spec_k + 1]`` step
        and accepts a per-row prefix by rejection sampling.
      spec_k: draft tokens proposed per row per tick (default 4).
      ngram_max: longest suffix n-gram the ``"ngram"`` drafter matches
        (default 3).
      pipeline: overlap host planning and token streaming with device
        compute — tick N+1 is planned optimistically and dispatched
        before tick N's tokens are read back; a row that had finished in
        tick N drops its tick-N+1 token (an overrun) and its slot is
        refilled on tick N+2. Streams stay bit-identical to the sync
        loop, sampled ones included. Speculative engines run a depth-1
        pipeline (the next plan needs the accepted tokens): emission and
        telemetry are deferred past the next dispatch.
      multi_step_k: in all-decode steady state (every occupied slot
        decoding, no prompt chunk to deal, no host-tier restore pending,
        no speculative window) run up to ``multi_step_k`` decode steps
        per dispatch, issued back to back with sampling, cache writes
        and EOS / emission-limit masking on the device; each slot's
        generator advances exactly as k one-token ticks advance it, so
        streams stay bit-identical to the k=1 engine. Any other state
        falls back to one-token ticks (``multi_step_fallbacks`` counts
        the reasons). Default 1: off.
      mesh / tp_axis: tensor-parallel serving over a 1-D process mesh
        (``make_mesh({"model": n})``, this process one rank of it): heads
        and the MLP sharded over ``tp_axis`` (see the module docstring).
        Pass the ``tp_size=1`` model; the engine runs on its device (one
        card a rank over NCCL, or the CPU over gloo), so ``device=``
        must stay None. A draft whose head counts divide ``n`` is sharded
        like the flagship, any other runs whole on every rank. Building
        one is collective (it makes the mesh's control group).
      device: where the engine runs; ``None`` means the CUDA card (and
        raises without one). Must be the model's (and the draft's)
        device.

    Drive it with :meth:`step` or :meth:`drain`, or from a loop thread
    with :meth:`serve_forever`; ``submit`` is thread-safe, stepping is
    single-threaded by design, and other threads reach the engine's
    state through :meth:`control` (the named control calls) and
    :meth:`call_in_loop` (a closure).
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
                 mesh=None, tp_axis: str = "model",
                 paged_kernel: str = "auto",
                 prefill_kernel: str = "auto",
                 draft=None, spec_k: int = 4, ngram_max: int = 3,
                 device=None, pipeline: bool = False, role: str = "mixed",
                 multi_step_k: int = 1):
        if slots < 1:
            raise ValueError(f"slots must be >= 1; got {slots}")
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(
                f"Unknown role '{role}'. Known: mixed (the default — "
                f"serves everything), prefill (compute-optimized replica "
                f"a router sends long prompts to), decode (memory-"
                f"optimized replica that receives migrated KV blocks)."
            )
        if multi_step_k < 1:
            raise ValueError(
                f"multi_step_k must be >= 1; got {multi_step_k}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 (or None for monolithic "
                f"prefill); got {prefill_chunk}")
        self.mesh, self.tp_axis, self.tp = mesh, tp_axis, 1
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise ValueError(
                    f"mesh= takes a distkeras_torch.parallel.mesh mesh "
                    f"(make_mesh({{'{tp_axis}': n}})); got "
                    f"{type(mesh).__name__}")
            sizes = mesh.shape
            if tp_axis not in sizes:
                raise ValueError(
                    f"mesh axes {mesh.axis_names} have no '{tp_axis}' "
                    f"axis — build the serving mesh as "
                    f"make_mesh({{'{tp_axis}': n}})")
            if any(n > 1 for a, n in sizes.items() if a != tp_axis):
                raise ValueError(
                    f"the serving mesh must be 1-D over '{tp_axis}' "
                    f"(got {sizes}): the engine shards heads only — "
                    f"batch parallelism is the router's job, one engine "
                    f"per replica")
            if getattr(model, "tp_size", 1) != 1:
                raise ValueError(
                    "pass the training-mode (tp_size=1) model; the "
                    "engine clones tensor-parallel decode twins for the "
                    "mesh itself")
            if device is not None:
                raise ValueError(
                    "device= and mesh= are mutually exclusive: a "
                    "tensor-parallel engine spans its mesh's devices; "
                    "per-replica device pinning is for single-chip "
                    "engines")
            self.tp = sizes[tp_axis]
        self._tp_group = mesh.group(tp_axis) if self.tp > 1 else None
        self.tp_rank = mesh.index(tp_axis) if mesh is not None else 0
        # the lock-step loop's channel, made on every rank as the engine
        # is built (collective; cached on the mesh)
        self._ctrl_group = (mesh.control_group(tp_axis) if self.tp > 1
                            else None)
        # a tp engine's accepted requests, waiting for the step boundary
        self._staged_lock = threading.Lock()
        self._staged_admits: List[Request] = []
        self._lockstep_on = False
        self._lockstep_error: Optional[BaseException] = None
        self.lockstep_streams: deque = deque(maxlen=LOCKSTEP_STREAM_RECORDS)
        self._lockstep = {"records": 0, "record_ms": 0.0, "tensor_ms": 0.0,
                          "tensor_bytes": 0, "op_errors": 0, "ops": {},
                          "last_op": None}
        self.role = role
        self.multi_step_k = multi_step_k
        self.multi_step_fallbacks: dict = {}
        # control calls marshalled onto the loop thread (call_in_loop):
        # the pool, radix index, caches and weights are loop-thread-only
        self._ctrl: deque = deque()
        self.dispatches = 0
        self.pipeline = pipeline
        self._pending: deque = deque()
        self.overrun_tokens = 0
        self.spec = draft is not None
        self.spec_k = spec_k
        self.ngram_max = ngram_max
        self.draft_kind = None
        if self.spec:
            if prefill_chunk is None:
                raise ValueError(
                    "speculative decoding rides the fused mixed tick — it "
                    "needs chunked prefill (prefill_chunk is not None)")
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1; got {spec_k}")
            if isinstance(draft, str):
                if draft != "ngram":
                    raise ValueError(
                        f"Unknown draft '{draft}'. Known: 'ngram' (self-"
                        f"speculative n-gram lookup), or a small port "
                        f"TransformerLM carrying its weights")
                self.draft_kind = "ngram"
            else:
                if draft.vocab_size != model.vocab_size:
                    raise ValueError(
                        f"draft vocab_size={draft.vocab_size} != model "
                        f"vocab_size={model.vocab_size}: proposals must "
                        f"live in the flagship's token space")
                self.draft_kind = "model"
        # a tp rank runs where its model lives (its card, or the CPU)
        self._device = (model.device if mesh is not None
                        else resolve_device(device))
        for m in (model,) + ((draft,) if self.draft_kind == "model" else ()):
            if (m.device.type != self._device.type
                    or (self._device.index is not None
                        and m.device.index != self._device.index)):
                raise ValueError(
                    f"a model lives on {m.device} but the engine was "
                    f"asked to run on {self._device}")
        self._device = model.device
        self.prefill_chunk = prefill_chunk
        self.prefill_kernel = prefill_kernel
        self.paged_kernel = paged_kernel
        self._admit_seq = 0
        self._packed_prev = (None, None)
        # pinned buffers of copies queued outside a tick's own upload
        # (prefill inputs, restores): handed to the next dispatched tick
        self._staged: list = []
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
        # the module the ticks run: the model itself, or under a mesh its
        # tp twin holding this rank's slices (the decode twins share it)
        self._served = (self.model if self.tp == 1
                        else self.model.shard(mesh, tp_axis))
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
        self.host: Optional[HostBlockPool] = None
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
            if host_blocks is not None:
                if host_blocks < 1:
                    raise ValueError(
                        f"host_blocks must be >= 1; got {host_blocks}")
                if not prefix_cache:
                    raise ValueError(
                        "the host tier spills the radix prefix cache — "
                        "host_blocks requires prefix_cache=True")
                if prefill_chunk is None:
                    raise ValueError(
                        "host-tier restores ride the chunked mixed tick's "
                        "plans — host_blocks requires chunked prefill "
                        "(prefill_chunk is not None)")
                self.host = HostBlockPool(host_blocks, block_size,
                                          registry=self.registry)
            self.pool = BlockPool(num_blocks, block_size,
                                  registry=self.registry,
                                  host_tier=self.host)
            self.prefix = (RadixPrefixIndex(block_size)
                           if prefix_cache else None)
            self._dm = self._served.clone(
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
            if host_blocks is not None:
                raise ValueError(
                    "the host tier lives under the paged BlockPool — "
                    "host_blocks requires paged=True")
            self.pool = None
            self.prefix = None
            self._dm = self._served.clone(
                decode=True, slot_cursor=True,
                prefill_kernel=prefill_kernel,
            )
            # the monolithic prefill's B=1 twin (scalar cursor)
            self._dm_one = self._served.clone(decode=True,
                                              prefill_kernel=prefill_kernel)
            self._cache = self._dm.init_cache(slots)
        self._dm_draft = None
        if self.draft_kind == "model":
            # the draft's slot cache mirrors the flagship's per-row
            # positions (same max_len, same slot count), so its proposals
            # condition on the identical token history
            self.draft_model = draft.clone(max_len=self.model.max_len)
            # sharded like the flagship when its heads divide tp, else
            # whole on every rank (identical proposals by construction)
            self.draft_tp = draft_param_specs(draft, self.tp, tp_axis)[1]
            if self.draft_tp > 1:
                self.draft_model = self.draft_model.shard(mesh, tp_axis)
            self._dm_draft = self.draft_model.clone(
                decode=True, slot_cursor=True,
                prefill_kernel=prefill_kernel)
            self._draft_cache = self._dm_draft.init_cache(slots)
            self._draft_gens = [
                torch.Generator(device=self._device).manual_seed(0)
                for _ in range(slots)]
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
        self.draft_tokens_proposed = 0
        self.draft_tokens_accepted = 0
        # the draft model's catch-up feeds (one forward of >= 2 tokens each)
        self.draft_feeds = 0
        # host tier: queued (handle, dst block) uploads, and handle ->
        # dst of every queued-or-issued restore (a concurrent admission
        # hitting the same demoted chunk shares the dst)
        self._restore_queue: deque = deque()
        self._inflight_restores: dict = {}
        self.demotions = 0
        self.restores = 0
        self._tick_demoted = 0
        self._tick_restored = 0
        self.kv_blocks_exported = 0
        self.kv_blocks_imported = 0
        self._tick_exported = 0
        self._tick_imported = 0
        self.weight_version = 1
        self.weight_swaps = 0
        self._m_weight_version.set(1)
        self._recompile_mark = recompiles.mark()

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
            "per tick: prefill tokens / (prefill + decode tokens) "
            "(chunked), or prefill dispatches / dispatches (monolithic)",
            buckets=telemetry.FRACTION_BUCKETS)
        self._m_itl_ms = reg.histogram(
            "serving_itl_ms",
            "inter-token latency: gap between consecutive tokens of one "
            "stream, host-observed (ms)")
        self._m_decode_stalls = reg.counter(
            "serving_decode_stalls_total",
            "prefill dispatches that ran while decoding slots sat "
            "waiting (monolithic prefill only)")
        self._m_decode_tps = reg.gauge(
            "serving_decode_tokens_per_sec",
            "tokens emitted by the latest tick over its wall time")
        self._m_device_wait = reg.histogram(
            "serving_device_wait_ms",
            "host time blocked on device readback per tick (ms) — the "
            "overlap headroom sync mode wastes and pipeline=True hides")
        self._m_overrun = reg.counter(
            "serving_overrun_tokens_total",
            "optimistically computed tokens dropped at reconciliation "
            "because their row had finished (pipeline=True late EOS)")
        self._m_prefix_hit = reg.counter(
            "serving_prefix_hit_tokens_total",
            "prompt tokens served from the radix prefix cache "
            "(prefill skipped)")
        self._m_prompt_tokens = reg.counter(
            "serving_prompt_tokens_total",
            "prompt tokens across admitted requests (hit + prefilled)")
        self._m_restore_wait = reg.histogram(
            "serving_restore_wait_ms",
            "RESTORING-row admission to last host-tier block resident "
            "(ms)")
        # recompiles are process-global (kernel builds, library loads
        # and lazily loaded kernel configurations are), so the gauge
        # mirrors the shared counter; the name is the reference's
        self._m_recompiles = reg.gauge(
            "jax_recompiles",
            "process-total kernel builds, kernel library loads and first "
            "launches of each kernel configuration (steady-state growth "
            "is a bug)")
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
        self._m_draft_tokens = reg.counter(
            "serving_draft_tokens_total",
            "speculative draft tokens entering verify windows")
        self._m_accepted_tokens = reg.counter(
            "serving_accepted_tokens_total",
            "draft tokens accepted by rejection sampling")
        self._m_accept_len = reg.histogram(
            "serving_accept_len",
            "accepted draft prefix length per speculating row per tick",
            buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16))
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
        self._m_dispatches = reg.counter(
            "serving_dispatches_total",
            "tick dispatches (a k-step multi window counts once)")
        self._m_tokens_per_dispatch = reg.histogram(
            "serving_tokens_per_dispatch",
            "tokens emitted per tick dispatch (multi-step windows "
            "amortize the host round trip over up to k tokens)",
            buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32))
        self._m_multi_k = reg.gauge(
            "serving_multi_step_k",
            "window width of the latest reconciled dispatch (1 = "
            "ordinary tick: multi-step off or fallen back)")
        self._m_multi_fallbacks = reg.counter(
            "serving_multi_step_fallbacks_total",
            "planned ticks that fell back to k=1, by the "
            "non-steady-state condition that forced it",
            labelnames=("reason",))
        self._m_weight_version = reg.gauge(
            "serving_weight_version",
            "monotonically increasing version of the live weights")
        self._m_weight_swaps = reg.counter(
            "serving_weight_swaps_total",
            "weight hot swaps applied at the tick boundary")
        self._m_weight_swap_ms = reg.histogram(
            "serving_weight_swap_ms",
            "one weight swap: validation, staged host->device copies, "
            "and the parameter rebind (ms)")

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
        if self.tp > 1 and deadline_s is not None:
            raise ValueError(
                "deadline_s expires by each rank's own clock: the ranks of "
                "a tensor-parallel engine would plan different ticks and "
                "fall out of lock step")
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
        if self.tp > 1:
            return self._stage(req)
        return self.scheduler.submit(req)

    def _stage(self, req: Request) -> Request:
        """A tensor-parallel engine's admission: refused now by the
        scheduler's own rule (the queue depth counting the staged
        requests), else staged for the next step boundary, where every
        rank submits it in the same order."""
        if self._lockstep_error is not None:
            raise RuntimeError(
                f"the engine's lock-step loop ended: "
                f"{type(self._lockstep_error).__name__}: "
                f"{self._lockstep_error}")
        sch = self.scheduler
        if req.trace_id is None:
            req.trace_id = self.tracer.new_trace_id()
        with self._staged_lock:
            if (sch.depth() + len(self._staged_admits)
                    >= sch.max_queue_depth):
                sch._m_rejected.inc()
                raise QueueFullError(
                    f"admission queue full "
                    f"(max_queue_depth={sch.max_queue_depth})")
            req.submit_t = time.monotonic()
            self._staged_admits.append(req)
        return req

    def _take_staged(self) -> List[Request]:
        with self._staged_lock:
            out, self._staged_admits = self._staged_admits, []
        return out

    # -- the engine loop ----------------------------------------------------

    @property
    def slot_requests(self) -> List[Optional[int]]:
        """Request id per slot (None = free) — test/observability hook."""
        return [st.req.rid if st else None for st in self._slots]

    def step(self) -> bool:
        """One scheduler iteration: admit into free slots, run one tick
        over the pool (mixed prefill/decode when chunked), emit tokens,
        free finished slots, and refill them from the queue in the same
        call. Returns False when there is nothing to do. An exception
        escaping the cycle dumps the flight recorder to a postmortem
        JSONL before re-raising. A tensor-parallel engine binds its
        mesh around the step (the twins read their tp group from it)."""
        try:
            with (self.mesh if self.mesh is not None
                  else contextlib.nullcontext()):
                return self._step()
        except Exception as e:
            self._crash(e, "step()")
            raise

    def _crash(self, e: BaseException, where: str):
        """Count a crash and dump the flight postmortem (once per
        exception)."""
        if getattr(e, "_dk_postmortem", False):
            return
        self._m_crashes.inc()
        if self.flight is not None:
            path = self.flight.dump_postmortem(
                "crash", error=f"{type(e).__name__}: {e}",
                tick=self.ticks,
            )
            if path:
                print(
                    f"ServingEngine: {where} crashed at tick "
                    f"{self.ticks}; flight postmortem: {path}",
                    file=sys.stderr,
                )
        try:
            e._dk_postmortem = True
        except AttributeError:  # pragma: no cover - slotted exceptions
            pass

    @torch.no_grad()
    def _step(self) -> bool:
        if not self._lockstep_on:
            # driven directly: the boundary is here (the lock-step loop
            # applies both from its step record instead)
            self._drain_ctrl()
            if self.tp > 1:
                for req in self._take_staged():
                    self.scheduler.submit(req)
        if self.pipeline:
            return self._pipelined_step()
        n_prefills = self._admit()
        occupied = any(st is not None for st in self._slots)
        if occupied:
            k = self._multi_gate()
            if k > 1:
                self._reconcile(self._plan_dispatch_multi(k))
            elif self.spec:
                self._spec_tick()
            elif self.prefill_chunk is not None:
                self._mixed_tick()
            else:
                self._decode_tick()
            # slots freed while processing the tick's tokens are refilled
            # NOW, so the next tick already serves their replacements
            n_prefills += self._admit()
            if self.prefill_chunk is None:
                # share of this step's dispatches that were prefills
                self._m_prefill_frac.observe(n_prefills / (n_prefills + 1))
        return occupied or self.scheduler.depth() > 0

    def _pipelined_step(self) -> bool:
        """One pipelined iteration. Non-speculative engines run depth 2:
        admit, plan tick N+1 OPTIMISTICALLY (every planned row assumed
        to continue), dispatch it, and only then reconcile tick N —
        its tokens are read while the card runs N+1; rows that turn out
        to have finished in N drop their N+1 token (overrun) and are
        refilled by the next step's admit. Speculative engines run depth
        1: reconciliation first (the next plan needs the accepted
        tokens), emission deferred past the next dispatch."""
        if self.spec:
            defer: list = []
            while self._pending:
                self._reconcile_spec(self._pending.popleft(), defer)
            self._admit()
            occupied = any(st is not None for st in self._slots)
            if occupied:
                self._multi_gate()  # fallback accounting only ("spec")
                self._pending.append(self._plan_dispatch_spec())
            self._flush_emissions(defer)
            return (occupied or self.scheduler.depth() > 0
                    or bool(self._pending))
        self._admit()
        occupied = any(st is not None for st in self._slots)
        if occupied:
            k = self._multi_gate()
            if k > 1:
                rec = self._plan_dispatch_multi(k)
            elif self.prefill_chunk is not None:
                rec = self._plan_dispatch_mixed()
            else:
                rec = self._plan_dispatch_decode()
            self._pending.append(rec)
        # keep exactly one tick unreconciled while occupied; flush
        # everything once the pool idles so the last streams complete
        keep = 1 if occupied else 0
        while len(self._pending) > keep:
            self._reconcile(self._pending.popleft())
        return (occupied or self.scheduler.depth() > 0
                or bool(self._pending))

    def serve_forever(self, stop: threading.Event,
                      idle_sleep: float = 0.002):
        """Step until ``stop`` is set, dozing briefly when idle: the
        engine's loop thread. It runs on the engine's card (CUDA's
        current device is per thread). A step that raises ends the loop
        with the error, after :meth:`step` wrote its flight
        postmortem. On a tensor-parallel engine this is the lock-step
        loop (see the module docstring): rank 0 leads, watching
        ``stop``; on every other rank ``stop`` is unused and the loop
        ends when the leader's does."""
        with (torch.cuda.device(self._device)
              if self._device.type == "cuda" else contextlib.nullcontext()):
            if self.tp > 1:
                return self._serve_lockstep(stop, idle_sleep)
            while not stop.is_set():
                if not self.step():
                    stop.wait(idle_sleep)

    def _has_work(self) -> bool:
        return (any(st is not None for st in self._slots)
                or self.scheduler.depth() > 0 or bool(self._pending))

    def _take_ctrl(self) -> List[_Ctrl]:
        out = []
        while self._ctrl:
            try:
                out.append(self._ctrl.popleft())
            except IndexError:  # pragma: no cover - single consumer
                break
        return out

    @staticmethod
    def _settle(c: _Ctrl, fn):
        """Run ``fn`` for the caller waiting on ``c``."""
        try:
            c.box["val"] = fn()
        except BaseException as e:
            c.box["err"] = e
        finally:
            c.ev.set()

    def _drain_ctrl(self):
        """Service queued control calls at the top of each step: the
        pool, radix index, caches and weights belong to the loop thread,
        so cross-thread work is marshalled here instead of locked."""
        for c in self._take_ctrl():
            self._settle(c, c.fn if c.op is None else (
                lambda: self._apply_op(c.op, c.meta, c.tensors)))

    def _wait_ctrl(self, c: _Ctrl, timeout: float):
        self._ctrl.append(c)
        if not c.ev.wait(timeout):
            raise TimeoutError(
                f"engine loop did not service the control call within "
                f"{timeout}s (is serve_forever running?)"
            )
        if "err" in c.box:
            raise c.box["err"]
        return c.box.get("val")

    def call_in_loop(self, fn, timeout: float = 60.0):
        """Run ``fn()`` on the engine loop thread between ticks and
        return its result (exceptions propagate). Needs the loop
        (:meth:`serve_forever`), or a caller driving :meth:`step`, to be
        running. On a tensor-parallel engine ``fn`` runs on THIS rank
        only: it must touch no state the ranks share (the caches, the
        pool, the weights, the scheduler) — the named calls of
        :meth:`control` do that on every rank."""
        return self._wait_ctrl(_Ctrl(fn=fn), timeout)

    def control(self, op: str, *args, timeout: float = 60.0, **kw):
        """Apply one of the engine's control calls (:data:`CONTROL_OPS`:
        :meth:`update_weights`, :meth:`export_blocks`,
        :meth:`import_blocks`, :meth:`set_role`, :meth:`begin_drain`,
        :meth:`end_drain`) from any thread, between steps, and return
        this rank's result (exceptions propagate). One engine: through
        :meth:`call_in_loop` (the drain pair, flags only, at once). A
        tensor-parallel engine under its lock-step loop: named in the
        leader's next step record, with its tensors broadcast after it,
        and applied on every rank; what can be checked before that (a
        pushed tree against the live weights) is checked here, so a
        refusal reaches no rank."""
        if op not in CONTROL_OPS:
            raise ValueError(f"unknown control op {op!r}; known: "
                             f"{CONTROL_OPS}")
        if self.tp == 1:
            if op in ("begin_drain", "end_drain"):
                return getattr(self, op)()
            return self.call_in_loop(
                lambda: getattr(self, op)(*args, **kw), timeout)
        meta, tensors = self._prepare_op(op, *args, **kw)
        return self._wait_ctrl(_Ctrl(op=op, meta=meta, tensors=tensors),
                               timeout)

    def _prepare_op(self, op: str, *args, **kw):
        """``(meta, tensors)`` of a named control call: its picklable
        arguments and its CPU tensors, which :meth:`_apply_op` turns back
        into the call on every rank."""
        call = inspect.signature(getattr(self, op)).bind(*args, **kw)
        call.apply_defaults()
        a = call.arguments
        if op == "update_weights":
            variables, version = a["variables"], a["version"]
            if not (isinstance(variables, dict) and "params" in variables):
                variables = {"params": variables}
            validate_like(self._param_tree(),
                          {"params": variables["params"]})
            paths, tensors = [], []
            for name, _ in self.model.named_parameters():
                node = variables
                for key in bridge.flax_key(name).split("/"):
                    node = node[key]
                paths.append(bridge.flax_key(name))
                tensors.append(_host_tensor(node).detach().contiguous())
            return {"version": version, "paths": paths}, tensors
        if "prompt" in a:
            a["prompt"] = np.asarray(a["prompt"], np.int32).reshape(-1)
        if op == "import_blocks":
            rows = [[_host_tensor(x).contiguous() for x in bl]
                    for bl in a.pop("blocks")]
            a["widths"] = [len(r) for r in rows]
            return dict(a), [t for r in rows for t in r]
        return dict(a), []

    def _apply_op(self, op: str, meta, tensors):
        if op == "update_weights":
            tree: dict = {}
            for path, t in zip(meta["paths"], tensors):
                node = tree
                keys = path.split("/")
                for key in keys[:-1]:
                    node = node.setdefault(key, {})
                node[keys[-1]] = t
            return self.update_weights(tree, version=meta["version"])
        if op == "import_blocks":
            rows, i = [], 0
            for w in meta["widths"]:
                rows.append(list(tensors[i:i + w]))
                i += w
            return self.import_blocks(meta["prompt"], rows)
        return getattr(self, op)(**meta)

    # -- the lock-step loop (tensor-parallel engines) -------------------------

    def _lockstep_state(self) -> tuple:
        """What every rank must agree on at a step boundary."""
        return (self.ticks, tuple(self.slot_requests),
                self.scheduler.depth(), self.weight_version, self.role,
                self.draining, self._lockstep["op_errors"])

    def _lockstep_verify(self, theirs: tuple, where: str):
        mine = self._lockstep_state()
        if mine != theirs:
            names = ("ticks", "slot requests", "queue depth",
                     "weight version", "role", "draining",
                     "failed control ops")
            diff = [f"{n} {a!r} (the leader's {b!r})"
                    for n, a, b in zip(names, mine, theirs) if a != b]
            raise RuntimeError(
                f"tp rank {self.tp_rank} fell out of lock step with the "
                f"leader (rank 0) {where}: {', '.join(diff)}")

    def _serve_lockstep(self, stop: threading.Event, idle_sleep: float):
        lead = self.tp_rank == 0
        book = self._lockstep
        taken: List[_Ctrl] = []
        admits: List[Request] = []
        self._lockstep_on = True
        try:
            while True:
                t0 = time.perf_counter()
                if lead:
                    taken, admits = self._take_ctrl(), self._take_staged()
                    rec = {"state": self._lockstep_state(),
                           "ops": [(c.op, c.meta, tensor_specs(c.tensors))
                                   for c in taken if c.op is not None],
                           "admits": [_admission(r) for r in admits],
                           "busy": bool(admits) or self._has_work(),
                           "stop": stop.is_set()}
                    broadcast_object(rec, self._ctrl_group)
                else:
                    rec = broadcast_object(None, self._ctrl_group)
                    self._lockstep_verify(rec["state"], "at the boundary")
                book["records"] += 1
                book["record_ms"] += (time.perf_counter() - t0) * 1e3
                # the ops in the leader's order (its rank-local closures
                # run between them), then the admissions
                if lead:
                    for c in taken:
                        if c.op is None:
                            self._settle(c, c.fn)
                        else:
                            self._lockstep_op(c.op, c.meta, c.tensors, c)
                else:
                    for op, meta, specs in rec["ops"]:
                        self._lockstep_op(op, meta, specs, None)
                    admits = [self._follower_request(a)
                              for a in rec["admits"]]
                taken = []
                for req in admits:
                    self.scheduler.submit(req)
                admits = []
                if not lead:
                    want = rec["state"][2] + len(rec["admits"])
                    if self.scheduler.depth() != want:
                        raise RuntimeError(
                            f"tp rank {self.tp_rank} fell out of lock step "
                            f"with the leader (rank 0) admitting: queue "
                            f"depth {self.scheduler.depth()}, the "
                            f"leader's {want}")
                if rec["stop"]:
                    return
                if rec["busy"]:
                    self.step()
                elif lead:
                    stop.wait(idle_sleep)
        except BaseException as e:
            self._lockstep_error = e
            self._crash(e, f"the lock-step loop (tp rank {self.tp_rank})")
            self._end_streams(taken, admits, e)
            raise
        finally:
            self._lockstep_on = False

    def _lockstep_op(self, op: str, meta, data, entry: Optional[_Ctrl]):
        """Apply one named op of a step record on this rank: broadcast its
        tensors (``data``: the leader's list, else their specs) over the
        control group, then call it. An op that raises counts in the
        step state on every rank (it raises alike everywhere); only the
        leader's caller sees the error."""
        book = self._lockstep
        specs = tensor_specs(data) if entry is not None else data
        t0 = time.perf_counter()
        tensors = (broadcast_tensors(data if entry is not None else None,
                                     specs, self._ctrl_group)
                   if specs else [])
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        bcast_ms = (time.perf_counter() - t0) * 1e3
        book["tensor_ms"] += bcast_ms
        book["tensor_bytes"] += nbytes
        book["ops"][op] = book["ops"].get(op, 0) + 1
        t1 = time.perf_counter()
        try:
            val = self._apply_op(op, meta, tensors)
            if entry is not None:
                entry.box["val"] = val
        except Exception as e:
            book["op_errors"] += 1
            if entry is not None:
                entry.box["err"] = e
            else:
                print(f"ServingEngine: tp rank {self.tp_rank}: control op "
                      f"{op} raised {type(e).__name__}: {e}",
                      file=sys.stderr)
        finally:
            book["last_op"] = {
                "op": op, "bytes": nbytes,
                "broadcast_ms": round(bcast_ms, 3),
                "apply_ms": round((time.perf_counter() - t1) * 1e3, 3)}
            if entry is not None:
                entry.ev.set()

    def _follower_request(self, a: dict) -> Request:
        return Request(stream=_KeptStream(a["rid"], self.lockstep_streams),
                       **a)

    def _end_streams(self, taken: List[_Ctrl], admits: List[Request],
                     err: BaseException):
        """After the lock-step loop failed: every waiting control call
        gets the error, every stream staged, queued or in a slot ends
        ``error``."""
        for c in taken + self._take_ctrl():
            if not c.ev.is_set():
                c.box["err"] = err
                c.ev.set()
        reqs = admits + self._take_staged()
        reqs += self.scheduler.pop_admissible(1 << 30)[0]
        reqs += [st.req for st in self._slots if st is not None]
        for req in reqs:
            if req.stream.finish_reason is None:
                req.stream._finish("error")

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

    def set_role(self, role: str) -> str:
        """Reconfigure the replica's advertised specialization (drain ->
        ``set_role`` -> undrain flips a spare replica between pools).
        Called between steps; the tick bodies are role-independent."""
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(
                f"unknown role {role!r}: expected 'mixed', 'prefill', "
                f"or 'decode'")
        if role != self.role:
            self.journal.append("reconfigure", target=role,
                                previous=self.role)
        self.role = role
        return role

    @property
    def drained(self) -> bool:
        """True once a draining engine has finished all accepted work
        (a tensor-parallel engine's staged admissions included)."""
        return (self.draining and self.queue_depth() == 0
                and all(st is None for st in self._slots))

    def queue_depth(self) -> int:
        """Accepted requests not yet in a slot: the scheduler's queue and
        a tensor-parallel engine's admissions staged for the next step
        boundary."""
        with self._staged_lock:
            return self.scheduler.depth() + len(self._staged_admits)

    def _param_tree(self) -> dict:
        """The live weights' flax-layout tree of shapes and dtypes (leaves
        are zero-stride numpy views: no copy of the weights)."""
        tree: dict = {}
        for name, p in self.model.named_parameters():
            node = tree
            path = bridge.flax_key(name).split("/")
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = np.broadcast_to(
                np.zeros((), np.float32), tuple(p.shape))
        return tree

    @torch.no_grad()
    def update_weights(self, variables, version: Optional[int] = None
                       ) -> dict:
        """Live weight swap, applied at the tick boundary: call it
        between :meth:`step` calls.

        ``variables`` is a flax-layout tree of the flagship's weights
        (``{"params": ...}``, a bare params tree is wrapped; numpy
        arrays or CPU tensors, f32 as the port keeps its masters).
        Structure, shapes and dtypes must match the live weights exactly
        — the first mismatched leaf raises a typed
        :class:`~distkeras_torch.serving.weights.WeightPushError` before
        anything is touched. Every new leaf is then staged on the device
        (pinned, non-blocking copies) while the old weights keep
        serving, and one rebind per parameter makes them live. A tick
        the pipelined loop already dispatched was queued on the old
        parameters and completes on them (stream order); the next
        dispatch reads the new ones. A draft model's weights are not
        updated. ``version`` stamps the new weights; the engine keeps it
        monotonic (a stale or absent version bumps by one). A
        tensor-parallel engine is pushed the FULL tree on every rank and
        stages this rank's slices into its tp twin (the ``tp_size=1``
        model it was built from keeps its weights). Returns
        ``{"version", "swap_ms"}``."""
        t0 = time.perf_counter()
        if not (isinstance(variables, dict) and "params" in variables):
            variables = {"params": variables}
        validate_like(self._param_tree(), {"params": variables["params"]})
        staged = []
        for name, p in self._served.named_parameters():
            node = variables
            for key in bridge.flax_key(name).split("/"):
                node = node[key]
            if self.tp > 1:
                node = shard_tensor(torch.as_tensor(node), tp_dim(name),
                                    self._served.tp_rank, self.tp)
            cuda = self._device.type == "cuda"
            host = torch.empty(p.shape, dtype=p.dtype, pin_memory=cuda)
            if isinstance(node, torch.Tensor):
                host.copy_(node.detach())
            else:
                host.numpy()[...] = node
            staged.append((p, host.to(self._device, non_blocking=True)
                           if cuda else host))
        # the rebind IS the swap: kernels already queued hold the old
        # storage (freed stream-ordered), later ticks read the new
        for p, t in staged:
            p.data = t
        self._retire_prefix_cache()
        if version is not None and int(version) > self.weight_version:
            self.weight_version = int(version)
        else:
            self.weight_version += 1
        self.weight_swaps += 1
        swap_ms = (time.perf_counter() - t0) * 1e3
        self._m_weight_version.set(self.weight_version)
        self._m_weight_swaps.inc()
        self._m_weight_swap_ms.observe(swap_ms)
        self.tracer.record(0, "serving.weight_swap", time.monotonic(),
                           0.0, wv=self.weight_version,
                           swap_ms=round(swap_ms, 3))
        self.journal.append("weight_push", version=self.weight_version,
                            swap_ms=round(swap_ms, 3))
        return {"version": self.weight_version,
                "swap_ms": round(swap_ms, 3)}

    def _retire_prefix_cache(self):
        """After a weight swap no cached prefix may serve a later
        admission: its K/V was computed under the old weights. (The
        reference keeps its radix index across a swap, so a prompt
        admitted after one can reuse stale K/V; the port retires it.)
        The index starts empty; unreferenced cached blocks free now,
        blocks of live rows free at their release (rows admitted under
        an older version never register), host entries not pinned by a
        queued restore are dropped — pinned ones still restore for the
        rows that wait on them."""
        if self.prefix is None:
            return
        old = self.prefix
        self.prefix = RadixPrefixIndex(self.block_size)
        unref = [b for b in old.blocks() if self.pool.ref[b] == 0]
        if unref:
            self.pool.free(unref)
        if self.host is not None:
            for h in old.host_handles():
                if h not in self._inflight_restores:
                    self.host.discard(h)

    def watchdog(self, timeout_s: float = 30.0,
                 interval_s: Optional[float] = None) -> StallWatchdog:
        """A :class:`~distkeras_torch.telemetry.StallWatchdog` wired to
        this engine: when the tick counter stops advancing for
        ``timeout_s`` while work is pending (occupied slots or queued
        requests), it dumps a flight postmortem — a wedged engine
        updates no metric, so threshold alerts cannot see it. The
        caller owns the lifecycle (``.start()`` / ``.stop()``);
        :class:`~distkeras_torch.serving.server.LMServer` does this when
        given ``watchdog_timeout_s``."""
        return StallWatchdog(
            progress=lambda: self.ticks,
            busy=lambda: (any(st is not None for st in self._slots)
                          or self.queue_depth() > 0),
            timeout_s=timeout_s, interval_s=interval_s,
            flight=self.flight, registry=self.registry,
            tracer=self.tracer,
        )

    def mark_steady(self):
        """Declare warm-up over: snapshot the process-global recompile
        counts. Any nonzero :meth:`recompiles_since_mark` afterwards
        means the serving path built or loaded a kernel, or launched a
        kernel configuration for the first time, in steady state — a
        latency spike (``chip_smoke.py`` asserts the dict is empty)."""
        self._recompile_mark = recompiles.mark()

    def recompiles_since_mark(self) -> dict:
        """Per-kind counts (``nvcc.<source>``, ``load.<source>``,
        ``kernel.<op>``) since :meth:`mark_steady` (or engine
        construction). Empty dict = clean steady state."""
        return recompiles.since(self._recompile_mark)

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
        blocks are pinned by live references; a HOST hit saves nothing —
        its restore lands in a fresh block — unless an in-flight restore
        of the same chunk already owns a dst this request shares), and
        the blocks obtainable without touching live data (free +
        unreferenced cached, excluding this request's own hit chain)."""
        total = self._blocks_for(req)
        if self.prefix is None:
            return total, self.pool.free_count()
        m = self.prefix.match(req.prompt)
        hit_live = sum(1 for b in m.blocks if self.pool.ref[b] > 0)
        reused = sum(1 for h in m.host if h in self._inflight_restores)
        avail = self.pool.free_count() + self.prefix.evictable_count(
            self.pool.ref, exclude=m.blocks
        )
        return total - hit_live - reused, avail

    def _alloc_blocks(self, n: int, keep=()) -> List[int]:
        """Allocate ``n`` blocks, evicting LRU unreferenced prefix blocks
        as needed (``keep`` protects a hit chain about to be reused).
        With a host tier the eviction DEMOTES: the victim's contents
        move to host memory and its radix node is re-keyed ``device ->
        host``, so the prefix stays matchable."""
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
            if self.host is not None:
                self._demote_blocks(victims)
            else:
                for blk in victims:
                    self.prefix.remove_block(blk)
            for blk in victims:
                self.pool.evict(blk)
        return self.pool.alloc(n)

    def _gather_blocks(self, blks: List[int]) -> List[list]:
        """Copy physical blocks off the device: for each block its
        per-leaf ``[block_size, ...]`` contents (every leaf of the paged
        cache is block-major: K, V and the int8 scales), into pinned
        host tensors on the card. Every copy is queued before the one
        wait, so a round pays one device round trip. A tensor-parallel
        engine gathers each leaf's blocks over tp first (collective): the
        host copies hold every KV head."""
        leaves = list(self._cache.leaves())
        if self.tp > 1 and blks:
            idx = torch.as_tensor(blks, dtype=torch.long, device=self._device)
            leaves = [all_gather_tp(leaf.index_select(0, idx),
                                    self._tp_group, dim=2)
                      for leaf in leaves]
            blks = range(len(blks))
        cuda = self._device.type == "cuda"
        out = []
        for blk in blks:
            row = []
            for leaf in leaves:
                src = leaf[blk]
                if cuda:
                    h = torch.empty(src.shape, dtype=src.dtype,
                                    pin_memory=True)
                    h.copy_(src, non_blocking=True)
                else:
                    h = src.clone()
                row.append(h)
            out.append(row)
        if cuda and out:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self._device))
            ev.synchronize()
        return out

    def _upload_blocks(self, dsts: List[int], entries: List[list]):
        """Scatter host block contents into physical blocks ``dsts``:
        per leaf ONE staged (pinned) buffer of the stacked blocks, one
        non-blocking copy and one ``index_copy_``, all queued on the
        stream before whatever tick is dispatched next — which reads the
        blocks after they land. The staging buffers ride that tick
        (``_staged``) until it is reconciled. Host contents hold every KV
        head; a tensor-parallel engine uploads its rank's slice."""
        idx = self._to_device(np.asarray(dsts, np.int64))
        for j, leaf in enumerate(self._cache.leaves()):
            stacked = torch.stack([torch.as_tensor(e[j]) for e in entries])
            if self.tp > 1:
                stacked = shard_tensor(stacked, 2, self._served.tp_rank,
                                       self.tp)
            if self._device.type == "cuda":
                stacked = stacked.pin_memory()
                self._staged.append(stacked)
                dev = stacked.to(self._device, non_blocking=True)
            else:
                dev = stacked
            leaf.index_copy_(0, idx, dev.to(leaf.dtype))

    def _demote_blocks(self, blks: List[int]):
        """Demote a round of about-to-be-evicted prefix-cached blocks:
        copy each one's contents to the host pool and re-key the radix
        nodes to the returned handles; the caller then frees the device
        blocks. Off the hot path (admission only). The host pool may
        LRU-evict older entries to make room — their radix subtrees
        unlink — or refuse when everything it holds is pinned by queued
        restores, in which case the demotion degrades to a plain
        eviction."""
        for blk, leaves in zip(blks, self._gather_blocks(blks)):
            handle, lru_evicted = self.host.put(leaves)
            for h in lru_evicted:
                for hh in self.prefix.drop_host(h):
                    self.host.discard(hh)
            if handle is None:
                for hh in self.prefix.remove_block(blk):
                    self.host.discard(hh)
                continue
            self.prefix.demote(blk, handle)
            self.demotions += 1
            self._tick_demoted += 1

    def _prefill_into(self, slot: int, req: Request):
        now = time.monotonic()
        req.admit_t = now
        self.tracer.record(req.trace_id, "queued", req.submit_t,
                           (now - req.submit_t) * 1e3,
                           parent=req.parent_span, wv=self.weight_version)
        if self.prefill_chunk is not None:
            self._chunked_enter(slot, req, now)
            return
        if any(st is not None and st.decoding for st in self._slots):
            # this whole-prompt prefill runs between ticks: every live
            # decode stream waits it out
            self._m_decode_stalls.inc()
        t0 = time.perf_counter()
        Tp = int(req.prompt.size)
        if self.paged:
            chain, cached, _ = self._paged_attach_blocks(req)
            self._paged_prefill(slot, req, chain, cached)
        else:
            chain, cached = None, 0
            self._slot_prefill(slot, req)
        self._gens[slot].manual_seed(req.seed)
        self._slots[slot] = _SlotState(req=req,
                                       remaining=req.max_new_tokens,
                                       blocks=chain, cached_tokens=cached,
                                       wv=self.weight_version)
        self.prompt_tokens += Tp
        self._m_prompt_tokens.inc(Tp)
        if self.paged:
            self.prefix_hit_tokens += cached
            self._m_prefix_hit.inc(cached)
        # dispatch time only — no forced sync; the tick's own readback
        # is the hot path's one synchronization point
        prefill_ms = (time.perf_counter() - t0) * 1e3
        req.prefill_done_t = time.monotonic()
        self.tracer.record(req.trace_id, "prefill", now, prefill_ms,
                           slot=slot, prompt_tokens=Tp,
                           cached_tokens=cached, wv=self.weight_version)
        self._m_prefill_ms.observe(prefill_ms)

    def _slot_prefill(self, slot: int, req: Request):
        """Monolithic slot prefill (the reference's ``_prefill_fn``): run
        the prompt through the B=1 twin into a fresh B=1 cache, then
        merge every leaf's row into row ``slot`` of the pooled cache —
        the WHOLE row, zeros (and unit int8 scales) past the prompt
        included, the bytes of the reference's merge — and set the
        slot's cursor and last logits."""
        prompt = self._to_device(req.prompt.astype(np.int64)[None])
        one = self._dm_one.init_cache(1)
        logits = self._dm_one(prompt, cache=one)
        L = self._cache.length
        for big, small in zip(self._cache.layers, one.layers):
            for name, leaf in big.items():
                leaf[slot * L:(slot + 1) * L] = small[name][:L]
        self._cache.index[slot] = one.index[0]
        self._last_logits[slot] = logits[0, -1].to(torch.float32)

    def _paged_prefill(self, slot: int, req: Request, chain, cached: int):
        """Monolithic paged prefill (the reference's
        ``_paged_prefill_fn``): run the prompt's UNCACHED suffix at B=1
        against the block pool through the row's block table — cached
        prefix positions are attended, not recomputed — and set the
        row's table, cursor and last logits."""
        Tp = int(req.prompt.size)
        table = np.zeros((1, self._max_blocks), np.int32)
        table[0, :len(chain)] = chain
        packed = _pack_i32(req.prompt[cached:], table, [cached])
        dev = self._to_device(packed)
        n = Tp - cached
        suffix, tab, start = _unpack_i32(
            dev, ((1, n), (1, self._max_blocks), (1,)))
        logits = self._dm(suffix.long(), cache=self._cache,
                          block_tables=tab, seq_lens=start)
        self._last_logits[slot] = logits[0, -1].to(torch.float32)
        tables = self._block_tables.copy()
        tables[slot, :] = 0
        tables[slot, :len(chain)] = chain
        self._block_tables = tables
        lens = self._seq_lens.copy()
        lens[slot] = Tp
        self._seq_lens = lens

    def _paged_attach_blocks(self, req: Request):
        """Paged admission bookkeeping: radix-match the prompt, reuse the
        matched device-resident prefix blocks (refcount bump, zero
        prefill), queue restores for the matched HOST-resident chunks
        (each into a fresh block the row owns — or sharing the dst of an
        already queued restore of the same chunk), copy-on-write a
        partially-shared block if the prompt diverges mid-block, allocate
        the rest. Returns ``(chain, cached, restoring)``."""
        bs = self.block_size
        # `is not None`, not truthiness: an index whose entries are all
        # host-resident is falsy (its length counts device nodes)
        m = (self.prefix.match(req.prompt) if self.prefix is not None
             else None)
        shared = list(m.blocks) if m else []
        host_hits = list(m.host) if m else []
        total = self._blocks_for(req)
        # pin the host entries FIRST: the allocation below may demote
        # more blocks, and the host LRU must not evict an entry this
        # admission is about to restore from
        reuse = {}
        for h in host_hits:
            if h in self._inflight_restores:
                reuse[h] = self._inflight_restores[h]
            else:
                self.host.pin(h)
            self.host.touch(h)
        keep = shared + list(reuse.values())
        fresh = self._alloc_blocks(total - len(shared) - len(reuse),
                                   keep=keep)
        fi = 0
        chain = list(shared)
        restoring: List[tuple] = []
        for i, h in enumerate(host_hits):
            dst = reuse.get(h)
            if dst is None:
                dst = fresh[fi]
                fi += 1
                self._inflight_restores[h] = dst
                self._restore_queue.append((h, dst))
            chain.append(dst)
            restoring.append((h, (len(shared) + i) * bs))
        chain += fresh[fi:]
        self.pool.incref(chain)
        cached = (len(shared) + len(host_hits)) * bs
        if m is not None and m.cow is not None:
            # the prompt shares j tokens of a cached block, then
            # diverges: copy that block into this row's first fresh
            # block (COW is offered from a device frontier only, so
            # host_hits is empty and fresh[0] follows the shared chain)
            src, j = m.cow
            self._copy_block(src, fresh[0])
            cached += j
        return chain, cached, restoring

    def _copy_block(self, src: int, dst: int):
        """Copy-on-write: duplicate physical block ``src`` into ``dst``
        across every paged cache leaf (K, V, int8 scales), in place."""
        for leaf in self._cache.leaves():
            leaf[dst] = leaf[src]

    def _chunked_enter(self, slot: int, req: Request, now: float):
        """Admit one request into a slot without any dispatch: the prompt
        is queued on the slot state (``pending``) and streams through the
        next mixed ticks chunk by chunk under the scheduler's token
        budget. Prefix-cache hits skip the shared span (host-tier hits
        first wait RESTORING)."""
        Tp = int(req.prompt.size)
        cached = 0
        restoring: List[tuple] = []
        if self.paged:
            chain, cached, restoring = self._paged_attach_blocks(req)
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
        st = _SlotState(
            req=req, remaining=req.max_new_tokens, blocks=chain,
            cached_tokens=cached,
            pending=np.asarray(req.prompt[cached:], np.int32),
            decoding=False, restoring=restoring or None,
            admit_seq=self._admit_seq, admit_t=now, wv=self.weight_version,
        )
        if self.spec:
            # the drafter conditions on the FULL prompt: a prefix hit
            # skips target prefill, but neither the n-gram history nor
            # the draft model's private cache has seen the shared span
            if self.draft_kind == "ngram":
                st.history = np.asarray(req.prompt, np.int32).copy()
            else:
                st.draft_queue = np.asarray(req.prompt, np.int32).copy()
                self._draft_cache.index[slot] = 0
                self._draft_gens[slot].manual_seed(
                    req.seed + _DRAFT_SEED_OFFSET)
        self._slots[slot] = st
        self._admit_seq += 1
        self.prompt_tokens += Tp
        self._m_prompt_tokens.inc(Tp)
        if self.paged:
            self.prefix_hit_tokens += cached
            self._m_prefix_hit.inc(cached)

    # -- host tier (restores) -------------------------------------------------

    def _issue_restores(self):
        """Copy up to ``restore_budget`` queued host-tier blocks back into
        the device pool, from a plan, BEFORE the tick's dispatch: the
        copies are non-blocking and stream-ordered ahead of every later
        tick, so the tick that reads a block finds it resident, and the
        staging buffers ride that tick until it is reconciled. Rows
        whose last awaited block landed flip RESTORING -> PREFILLING;
        each handle's radix node is promoted back to device residency at
        its destination block. A handle whose host entry vanished falls
        back to seeded replay (:meth:`_restore_fallback`)."""
        n = self.scheduler.plan_restore(len(self._restore_queue))
        if n <= 0:
            return
        done: List[tuple] = []
        entries: List[list] = []
        while self._restore_queue and len(done) < n:
            h, dst = self._restore_queue.popleft()
            leaves = self.host.take(h)
            if leaves is None:
                self._restore_fallback(h)
                continue
            entries.append(leaves)
            done.append((h, dst))
        if not done:
            return
        self._upload_blocks([dst for _, dst in done], entries)
        now = time.monotonic()
        for h, dst in done:
            del self._inflight_restores[h]
            if self.prefix.has_host(h):  # not retired by a weight swap
                self.prefix.promote(h, dst)
        self.restores += len(done)
        self._tick_restored += len(done)
        for st in self._slots:
            if st is None or st.restoring is None:
                continue
            still = [(h, off) for h, off in st.restoring
                     if h in self._inflight_restores]
            if len(still) == len(st.restoring):
                continue
            if still:
                st.restoring = still
                continue
            # every block resident: an ordinary PREFILLING admission now
            st.restoring = None
            self._m_restore_wait.observe((now - st.admit_t) * 1e3)

    def _restore_fallback(self, handle: int):
        """A queued restore's host entry is gone (its radix node is
        already unlinked): seeded replay. Every row waiting on the handle
        is rewound to recompute from that chunk's token offset on — its
        pending queue regrows and the ordinary chunked prefill rewrites
        the SAME chain blocks at the same positions, so the bytes are
        bit-identical either way (deterministic compute). Later chunks
        the row awaited drop from its wait list too: the recompute
        covers them."""
        self._inflight_restores.pop(handle, None)
        lens = None
        for s, st in enumerate(self._slots):
            if st is None or st.restoring is None:
                continue
            offs = [off for h, off in st.restoring if h == handle]
            if not offs:
                continue
            new_cached = offs[0]
            self.prefix_hit_tokens -= st.cached_tokens - new_cached
            st.cached_tokens = new_cached
            st.pending = st.req.prompt[new_cached:]
            st.restoring = [(h, off) for h, off in st.restoring
                            if off < new_cached] or None
            if lens is None:
                lens = self._seq_lens.copy()  # rebind, never mutate
            lens[s] = new_cached
        if lens is not None:
            self._seq_lens = lens

    # -- KV-block migration (disaggregated serving) -------------------------

    @torch.no_grad()
    def export_blocks(self, prompt) -> dict:
        """The cached KV blocks covering ``prompt``'s prefix, for
        migration to another replica (call between steps). The radix
        match yields the device chain plus any host-tier suffix; device
        blocks are copied off the card in one round trip, host chunks
        are served straight from the tier. Returns ``{"tokens": covered,
        "blocks": [[leaf tensors...] per block]}`` (CPU tensors, in the
        cache's leaf order and dtypes) — ``tokens`` is 0 when nothing is
        cached (the caller prefills from scratch)."""
        if not self.paged or self.prefix is None:
            return {"tokens": 0, "blocks": []}
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        m = self.prefix.match(prompt)
        blocks = self._gather_blocks(list(m.blocks))
        for h in m.host:
            leaves = (self.host.peek(h) if self.host is not None
                      else None)
            if leaves is None:
                break  # entry evicted under us: export the prefix we have
            blocks.append([t.clone() for t in leaves])
        n = len(blocks)
        self.kv_blocks_exported += n
        self._tick_exported += n
        return {"tokens": n * self.block_size, "blocks": blocks}

    @torch.no_grad()
    def import_blocks(self, prompt, blocks) -> dict:
        """Install migrated KV blocks for ``prompt``'s prefix (call
        between steps). With a host tier the contents land in the spill
        pool and the chunks register as HOST-resident radix nodes — the
        first hit admits RESTORING and copies them in through the
        ordinary restore path. Without one they are copied straight into
        freshly allocated device blocks and register as cached prefix
        blocks. Either way the next admission of this prompt prefills
        only the tail. Chunks already cached keep their resident copy;
        a device import never evicts live data. Returns ``{"imported":
        k, "tokens": k * block_size, "mode": "host" | "device"}``."""
        if not self.paged or self.prefix is None:
            raise ValueError(
                "KV import needs a paged engine with the prefix cache "
                "(paged=True, prefix_cache=True)")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        bs = self.block_size
        n = min(len(blocks), int(prompt.size) // bs)
        leaves = list(self._cache.leaves())
        # the host layout: every KV head (dim 1 of a block), whatever tp
        want = [(leaf.shape[1], leaf.shape[2] * self.tp)
                + tuple(leaf.shape[3:]) for leaf in leaves]
        for bl in blocks[:n]:
            if (len(bl) != len(want)
                    or any(tuple(np.shape(a)) != w
                           for a, w in zip(bl, want))):
                raise ValueError(
                    f"imported block leaves do not match this engine's "
                    f"paged cache layout (want {len(want)} leaves of "
                    f"shapes {want})")
        if n == 0:
            return {"imported": 0, "tokens": 0, "mode": "none"}
        cuda = self._device.type == "cuda"

        def host_leaves(bl):
            out = []
            for a, leaf in zip(bl, leaves):
                t = _host_tensor(a).to(dtype=leaf.dtype, copy=True)
                out.append(t.pin_memory() if cuda else t)
            return out

        if self.host is not None:
            handles: List[int] = []
            for bl in blocks[:n]:
                h, lru_evicted = self.host.put(host_leaves(bl))
                for he in lru_evicted:
                    for hh in self.prefix.drop_host(he):
                        self.host.discard(hh)
                if h is None:
                    break  # tier full of pinned entries: partial import
                handles.append(h)
            reg = set(self.prefix.insert_host(
                prompt[:len(handles) * bs], handles))
            for h in handles:
                if h not in reg:
                    self.host.discard(h)  # chunk already cached
            k, mode = len(handles), "host"
        else:
            avail = (self.pool.free_count()
                     + self.prefix.evictable_count(self.pool.ref))
            k = min(n, avail)
            if k == 0:
                return {"imported": 0, "tokens": 0, "mode": "device"}
            fresh = self._alloc_blocks(k)
            self._upload_blocks(fresh, [host_leaves(bl)
                                        for bl in blocks[:k]])
            registered = set(self.prefix.insert(prompt[:k * bs], fresh))
            dup = [b for b in fresh if b not in registered]
            if dup:
                # chunks another request cached first: the resident copy
                # wins, the duplicate frees (concurrent-miss rule)
                self.pool.free(dup)
            mode = "device"
        self.kv_blocks_imported += k
        self._tick_imported += k
        return {"imported": k, "tokens": k * bs, "mode": mode}

    # -- uploads, readbacks ---------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a stream synchronization:
        on the card the array is staged in a pinned buffer and copied
        with ``non_blocking=True`` (a pageable copy would wait for every
        kernel already queued), and the buffer joins ``_staged`` — it
        rides the tick dispatched next until that tick is reconciled; on
        the CPU a plain copy (never an alias of the array)."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if self._device.type != "cuda":
            return host.clone()
        pinned = host.pin_memory()
        self._staged.append(pinned)
        return pinned.to(self._device, non_blocking=True)

    def _upload(self, packed: np.ndarray):
        """One packed control-buffer copy per tick — none when the plan
        is unchanged from the previous tick (the all-decode slot-mode
        steady state reuses the previous device buffer; the tick body
        never writes to it), through :meth:`_to_device`."""
        prev_host, prev_dev = self._packed_prev
        if (prev_host is not None and prev_host.shape == packed.shape
                and np.array_equal(prev_host, packed)):
            return prev_dev
        dev = self._to_device(packed)
        self._packed_prev = (packed, dev)
        return dev

    def _dispatched(self, rec: _InflightTick) -> _InflightTick:
        """Queue the tick's readback right behind its kernels and hand it
        every pinned buffer whose copy was queued before them."""
        outs = [rec.toks] + ([rec.acc] if rec.acc is not None else [])
        rec.host, rec.event = _d2h(outs, self._device)
        rec.keep, self._staged = self._staged, []
        return rec

    def _read(self, rec: _InflightTick):
        """Wait for a tick's readback (its event only) and return the
        host arrays: tokens, and the accepted lengths / counts if any."""
        if rec.event is not None:
            rec.event.synchronize()
        out = [h.numpy() for h in rec.host]
        rec.keep = []  # every copy queued before the tick has completed
        return out

    # -- the mixed tick -------------------------------------------------------

    def _cfgs(self):
        return tuple(
            (st.req.temperature, st.req.top_k, st.req.top_p)
            if st else _IDLE_CFG
            for st in self._slots
        )

    def _mixed_tick(self):
        """One fused mixed prefill/decode tick, sync: plan and dispatch,
        then reconcile."""
        self._reconcile(self._plan_dispatch_mixed())

    def _plan_dispatch_mixed(self) -> _InflightTick:
        """Plan one mixed tick from host state only — deal the token
        budget (decodes first, then prompt chunks in admission order),
        advance each prefilling row's pending queue and flip rows whose
        last chunk is being fed to DECODING — then run ONE ``[S, C]``
        valid-length step (``[S, 1]`` when no prompt token was dealt).
        RESTORING rows are planned idle (valid 0, no budget charge,
        generator untouched); their restores are issued first."""
        t_plan0 = time.perf_counter()
        if self.host is not None:
            self._issue_restores()
        S = self.slots
        cfgs = self._cfgs()
        n_dec = sum(1 for st in self._slots if st and st.decoding)
        pre = sorted(
            ((s, st) for s, st in enumerate(self._slots)
             if st and not st.decoding and st.restoring is None),
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
        return self._dispatched(_InflightTick(
            toks=toks, rows=rows, plan_ms=plan_ms,
            dispatch_ms=(time.perf_counter() - t0) * 1e3,
            n_dec=n_dec, fed_tokens=fed_tokens, chunk=C,
        ))

    def _decode_tick(self):
        """One plain decode tick (monolithic-prefill mode), sync."""
        self._reconcile(self._plan_dispatch_decode())

    def _plan_dispatch_decode(self) -> _InflightTick:
        """The reference's ``_tick_fn`` / ``_paged_tick_fn``: every slot
        samples (idle ones greedily) and advances one decode step; paged
        rows advance their host cursors by one. It is the mixed step at
        ``C = 1`` with every row valid and sampling."""
        t_plan0 = time.perf_counter()
        S = self.slots
        cfgs = self._cfgs()
        rows: List[Optional[tuple]] = [
            ("dec", st) if st is not None else None for st in self._slots
        ]
        n_dec = sum(1 for r in rows if r is not None)
        fed = np.zeros((S, 1), np.int32)
        ones = np.ones((S,), np.int32)
        if self.paged:
            packed = _pack_i32(self._block_tables, self._seq_lens, fed,
                               ones, ones)
            alive = np.fromiter((st is not None for st in self._slots),
                                bool, S)
            self._seq_lens = self._seq_lens + alive.astype(np.int32)
        else:
            packed = _pack_i32(fed, ones, ones)
        t0 = time.perf_counter()
        plan_ms = (t0 - t_plan0) * 1e3
        toks = self._mixed_step(cfgs, 1, self._upload(packed), ones)
        return self._dispatched(_InflightTick(
            toks=toks, rows=rows, plan_ms=plan_ms,
            dispatch_ms=(time.perf_counter() - t0) * 1e3,
            n_dec=n_dec, fed_tokens=0, chunk=None,
        ))

    def _sample(self, cfgs, last, active) -> torch.Tensor:
        """Per-slot sampling from pooled last-token logits: greedy rows
        (and idle rows) share one argmax; each sampling row with
        ``active[s]`` draws on its own ``[1, vocab]`` slice from its own
        generator — the exact call of a solo B=1 :func:`generate` step.
        A slot's generator only advances when it samples."""
        toks = torch.argmax(last, dim=-1)
        for s, (temp, top_k, top_p) in enumerate(cfgs):
            if active[s] and temp != 0.0:
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
            tables, lens, fed, valid, smask = _unpack_i32(
                packed, ((S, self._max_blocks), (S,), (S, chunk), (S,),
                         (S,)))
            paged_kw = {"block_tables": tables, "seq_lens": lens}
        else:
            fed, valid, smask = _unpack_i32(packed, ((S, chunk), (S,), (S,)))
            paged_kw = {}
        sampled = self._sample(cfgs, self._last_logits, sample_mask)
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

    # -- multi-step decode ---------------------------------------------------

    def _multi_gate(self) -> int:
        """This step's window width: the granted k (> 1) when the engine
        is in all-decode steady state, else 1 with the blocking condition
        counted as a fallback reason — a speculative engine (its plan
        needs each window's accepted tokens), a staged control call (a
        weight push or KV export lands between dispatches), a host-tier
        restore queued or holding a row, a prompt chunk to deal, or a
        budget the scheduler cannot spare for the window."""
        if self.multi_step_k <= 1:
            return 1
        if self.spec:
            reason = "spec"
        elif self._ctrl and not self._lockstep_on:
            reason = "control"
        elif (self._restore_queue or self._inflight_restores
              or any(st is not None and st.restoring is not None
                     for st in self._slots)):
            reason = "restore"
        elif any(st is not None and not st.decoding for st in self._slots):
            reason = "prefill"
        else:
            n_dec = sum(1 for st in self._slots if st is not None)
            granted = self.scheduler.plan_multi_step(n_dec,
                                                     self.multi_step_k)
            if granted > 1:
                return granted
            reason = "budget"
        self.multi_step_fallbacks[reason] = (
            self.multi_step_fallbacks.get(reason, 0) + 1)
        self._m_multi_fallbacks.labels(reason=reason).inc()
        return 1

    def _plan_dispatch_multi(self, k: int) -> _InflightTick:
        """Plan and dispatch ONE k-step decode window. The packed buffer
        carries each row's EOS id (-1: none) and its emission limit
        ``min(k, remaining)`` (0: idle) — constant in steady state, so
        the upload dedup reuses the previous device buffer. Paged cursors
        advance by the worst case ``lim`` NOW (the next pipelined plan
        must see the window's writes); a row that stops early always
        completes at this window's reconcile (EOS or an emptied budget
        are the only stop reasons), where :meth:`_complete` returns its
        chain and zeroes its cursor."""
        t_plan0 = time.perf_counter()
        S = self.slots
        cfgs = self._cfgs()
        rows: List[Optional[tuple]] = [
            ("dec", st) if st is not None else None for st in self._slots
        ]
        n_dec = sum(1 for r in rows if r is not None)
        eos = np.full((S,), -1, np.int32)
        lim = np.zeros((S,), np.int32)
        for s, st in enumerate(self._slots):
            if st is None:
                continue
            if st.req.eos_id is not None:
                eos[s] = st.req.eos_id
            lim[s] = min(k, st.remaining)
        if self.paged:
            packed = _pack_i32(self._block_tables, self._seq_lens, eos, lim)
            self._seq_lens = self._seq_lens + lim  # rebind, never mutate
        else:
            packed = _pack_i32(eos, lim)
        t0 = time.perf_counter()
        plan_ms = (t0 - t_plan0) * 1e3
        toks, counts = self._multi_step(cfgs, k, lim, self._upload(packed))
        return self._dispatched(_InflightTick(
            toks=toks, rows=rows, plan_ms=plan_ms,
            dispatch_ms=(time.perf_counter() - t0) * 1e3,
            n_dec=n_dec, fed_tokens=0, chunk=None, multi_k=k, acc=counts,
        ))

    def _multi_step(self, cfgs, k: int, lim_host: np.ndarray,
                    packed: torch.Tensor):
        """The k-step window body (the reference's ``_multi_tick_fn`` /
        ``_paged_multi_tick_fn``): k decode steps issued back to back. A
        row is ALIVE while it has neither sampled its EOS nor emitted
        ``lim`` tokens (both tested on the device); alive rows advance
        exactly as k one-token ticks would, stopped rows run valid-0
        padding (no write, no cursor advance, logits frozen). A sampling
        row draws on every step below its (host-known) ``lim`` — one
        draw per token, as one-token ticks draw; draws after its EOS are
        unobservable (the EOS completes the request at reconcile and the
        next admission reseeds the slot). Returns ``[S, k]`` tokens
        (garbage past each row's count, never read) and the per-row
        counts ``[S]``."""
        S = self.slots
        if self.paged:
            tables, lens, eos, lim = _unpack_i32(
                packed, ((S, self._max_blocks), (S,), (S,), (S,)))
        else:
            eos, lim = _unpack_i32(packed, ((S,), (S,)))
        dev = self._last_logits.device
        last = self._last_logits
        stopped = torch.zeros((S,), dtype=torch.bool, device=dev)
        emitted = torch.zeros((S,), dtype=torch.int32, device=dev)
        cols = []
        for j in range(k):
            alive = ~stopped & (emitted < lim)
            tok = self._sample(cfgs, last, lim_host > j)
            valid = alive.to(torch.int32)
            kw = ({"block_tables": tables, "seq_lens": lens + emitted}
                  if self.paged else {})
            logits = self._dm(tok[:, None], cache=self._cache,
                              valid_lens=valid, **kw)
            last = torch.where(alive[:, None], logits[:, -1].float(), last)
            stopped = stopped | (alive & (eos >= 0) & (tok == eos))
            emitted = emitted + valid
            cols.append(tok)
        self._last_logits = last
        return torch.stack(cols, dim=1), emitted

    # -- reconcile -------------------------------------------------------------

    def _reconcile(self, rec: _InflightTick):
        """Materialize one dispatched tick and settle the host side: wait
        for its readback (in pipelined mode the card is already running
        the NEXT tick, so this wait shrinks by whatever the overlap
        hid), stream each planned row's tokens, complete EOS'd /
        exhausted rows, drop overrun tokens whose row finished in an
        earlier reconcile, and record telemetry + the flight snapshot."""
        t_wait0 = time.perf_counter()
        host = self._read(rec)
        toks_host = host[0]
        counts_host = host[1] if rec.multi_k is not None else None
        wait_ms = (time.perf_counter() - t_wait0) * 1e3
        t_stream0 = time.perf_counter()
        self.ticks += 1
        occupancy = sum(st is not None for st in self._slots)
        self._occ_sum += occupancy
        now = time.monotonic()
        device_ms = rec.dispatch_ms + wait_ms
        k = rec.multi_k or 1
        # a window's k tokens per row were produced one step apart:
        # spread their timestamps over its device span
        step_s = (device_ms / 1e3) / k
        window_t0 = now - (k - 1) * step_s
        emitted = 0
        overrun = 0
        for s, row in enumerate(rec.rows):
            if row is None:
                continue
            st = row[1]
            if self._slots[s] is not st:
                # late finish: the request completed while this tick was
                # in flight — its optimistic token is an overrun, dropped
                # before any consumer sees it
                if row[0] == "dec":
                    overrun += (1 if counts_host is None
                                else int(counts_host[s]))
                continue
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
                        chunk=self.prefill_chunk, wv=self.weight_version,
                    )
                    self._m_prefill_ms.observe(prefill_ms)
                continue
            if counts_host is None:
                e, _ = self._stream_row(s, st, [int(toks_host[s])], now)
            else:
                # the device froze the row at its EOS (or at lim); a
                # pipelined window planned against a stale `remaining`
                # can carry more tokens than the row has budget left —
                # _stream_row trims them and they count as overrun
                n = int(counts_host[s])
                times = [window_t0 + i * step_s for i in range(n)]
                e, _ = self._stream_row(
                    s, st, toks_host[s, :n].tolist(), now, times=times)
                overrun += n - e
            emitted += e
        if overrun:
            self.overrun_tokens += overrun
            self._m_overrun.inc(overrun)
        queue_depth = self.scheduler.depth()
        self._m_ticks.inc()
        self._m_tokens.inc(emitted)
        self._m_occupancy.set(sum(st is not None for st in self._slots))
        self._m_tick_ms.observe(device_ms / k)
        self._m_device_wait.observe(wait_ms)
        self.dispatches += 1
        self._m_dispatches.inc()
        self._m_tokens_per_dispatch.observe(emitted)
        self._m_multi_k.set(k)
        if rec.chunk is not None and rec.fed_tokens + rec.n_dec > 0:
            self._m_prefill_frac.observe(
                rec.fed_tokens / (rec.fed_tokens + rec.n_dec))
        if device_ms > 0:
            self._m_decode_tps.set(round(emitted / (device_ms / 1e3), 3))
        log_kw = ({"prefill_tokens": rec.fed_tokens}
                  if rec.chunk is not None else {})
        self.metrics.log(
            step=self.ticks, occupancy=occupancy, queue_depth=queue_depth,
            token_ms=round(device_ms / k, 3), **log_kw,
        )
        self._record_tick(
            plan_ms=rec.plan_ms, device_ms=device_ms,
            stream_ms=(time.perf_counter() - t_stream0) * 1e3,
            n_dec=rec.n_dec, prefill_tokens=rec.fed_tokens,
            chunk=rec.chunk, emitted=emitted, occupancy=occupancy,
            queue_depth=queue_depth, device_wait_ms=wait_ms,
            dispatch_ms=rec.dispatch_ms, overrun=overrun,
            multi_k=rec.multi_k,
        )

    def _stream_row(self, s: int, st: _SlotState, toks_row, now,
                    defer: Optional[list] = None, times=None):
        """Emit one row's tick tokens to its consumer stream, stopping at
        EOS or budget exhaustion (which completes the slot). ``defer``
        (pipelined spec mode): the bookkeeping happens now — the next
        plan needs it — while the consumer-visible emission is queued
        for :meth:`_flush_emissions`. ``times`` carries one timestamp
        per token (multi-step windows)."""
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
        if defer is None:
            self._emit_now(req, take, now, times)
        else:
            defer.append(("toks", req, take))
        if done:
            self._complete(s, reason, defer=defer)
        return len(take), done

    def _emit_now(self, req: Request, toks, now, times=None):
        for i, tok in enumerate(toks):
            t = now if times is None else times[i]
            if req.last_token_t is not None and t < req.last_token_t:
                # interpolated window timestamps never run backwards
                # across a reconcile boundary
                t = req.last_token_t
            if req.first_token_t is None:
                req.first_token_t = t
                ttft_ms = (t - req.submit_t) * 1e3
                self._m_ttft_ms.observe(ttft_ms, exemplar=req.trace_id)
                self._m_qos_ttft.labels(tier=req.tier).observe(ttft_ms)
            else:
                itl_ms = (t - req.last_token_t) * 1e3
                self._m_itl_ms.observe(itl_ms, exemplar=req.trace_id)
                self._m_qos_itl.labels(tier=req.tier).observe(itl_ms)
            req.last_token_t = t
            req.stream._put(tok)

    def _flush_emissions(self, defer: list):
        """Deliver deferred token puts and finish sentinels (pipelined
        spec mode) in the order bookkeeping produced them."""
        if not defer:
            return
        now = time.monotonic()
        for item in defer:
            if item[0] == "toks":
                self._emit_now(item[1], item[2], now)
            else:
                self._notify_finish(item[1], item[2], item[3])

    # -- speculative decoding -------------------------------------------------

    def _spec_tick(self):
        """One speculative tick, sync: plan+dispatch, then reconcile."""
        self._reconcile_spec(self._plan_dispatch_spec(), None)

    def _plan_dispatch_spec(self) -> _InflightTick:
        """Plan one speculative verify tick: per-row verify windows
        (pending token + granted draft width) and prompt chunks under the
        shared token budget, run the drafter (the draft model's steps or
        the host-side n-gram lookup), and dispatch the fused ``[S, W]``
        verify with per-row rejection sampling and rollback. Restores
        are issued first; RESTORING rows are planned idle."""
        t_plan0 = time.perf_counter()
        if self.host is not None:
            self._issue_restores()
        S, k = self.slots, self.spec_k
        cfgs = self._cfgs()
        pre = sorted(
            ((s, st) for s, st in enumerate(self._slots)
             if st and not st.decoding and st.restoring is None),
            key=lambda p: p[1].admit_seq,
        )
        dec = [(s, st) for s, st in enumerate(self._slots)
               if st and st.decoding]
        # rows eligible to speculate: a host-known pending token, room
        # for at least one draft, and a drafter able to propose
        spec_rows, want = [], []
        ngram_toks = {}
        for s, st in dec:
            if st.pending_tok is None:
                continue  # transition row: samples its first token
            w = min(k, st.remaining - 1)
            if self.draft_kind == "ngram":
                toks, found = _ngram_propose(st.history, k, self.ngram_max)
                ngram_toks[s] = toks
                w = min(w, found)
            elif st.draft_queue is not None and st.draft_queue.size > 2:
                w = 0  # the draft is still consuming the prompt
            if w > 0:
                spec_rows.append((s, st))
                want.append(w)
        spec_set = {s for s, _ in spec_rows}
        takes, widths = self.scheduler.plan_spec(
            len(dec), [len(st.pending) for _, st in pre],
            self.prefill_chunk, want,
            tiers=[st.req.tier for _, st in pre],
        )
        fed_tokens = sum(takes)
        W = max(self.prefill_chunk, k + 1) if fed_tokens else k + 1
        fed = np.zeros((S, W), np.int32)
        valid = np.zeros((S,), np.int32)
        n_forced = np.zeros((S,), np.int32)
        sample_mask = np.zeros((S,), np.int32)
        draft_np = np.zeros((S, k), np.int32)
        granted = np.zeros((S,), np.int32)
        rows: List[Optional[tuple]] = [None] * S
        for s, st in dec:
            sample_mask[s] = 1
            rows[s] = ("dec", st)
            if st.pending_tok is not None:
                fed[s, 0] = st.pending_tok
                n_forced[s] = 1
                valid[s] = 1
        for (s, st), w in zip(spec_rows, widths):
            valid[s] = 1 + w
            granted[s] = w
            if self.draft_kind == "ngram":
                draft_np[s] = ngram_toks[s]
        for (s, st), take in zip(pre, takes):
            flipped = False
            if take > 0:
                fed[s, :take] = st.pending[:take]
                valid[s] = take
                n_forced[s] = take
                st.pending = st.pending[take:]
                if st.pending.size == 0:
                    # last chunk dealt: the next tick is this row's
                    # transition tick (samples its first token)
                    st.decoding = True
                    flipped = True
            rows[s] = ("pre", st, take, flipped)
        t0 = time.perf_counter()
        plan_ms = (t0 - t_plan0) * 1e3
        q_probs = draft_dev = None
        if self.draft_kind == "model":
            q_probs, draft_dev = self._run_draft(cfgs, spec_rows)
        if self.paged:
            packed = _pack_i32(self._block_tables, self._seq_lens, fed,
                               valid, n_forced, sample_mask, draft_np)
        else:
            packed = _pack_i32(fed, valid, n_forced, sample_mask, draft_np)
        toks, acc = self._spec_verify(cfgs, W, self._upload(packed),
                                      sample_mask, draft_dev, q_probs)
        return self._dispatched(_InflightTick(
            toks=toks, rows=rows, plan_ms=plan_ms,
            dispatch_ms=(time.perf_counter() - t0) * 1e3,
            n_dec=len(dec), fed_tokens=fed_tokens, chunk=W,
            acc=acc, n_forced=n_forced, granted=granted,
            spec_set=spec_set,
        ))

    def _spec_verify(self, cfgs, W: int, packed, sample_mask, draft_dev,
                     q_probs):
        """The verify step body (the reference's ``_spec_verify_fn`` /
        ``_paged_spec_verify_fn``): one ``[S, W]`` valid-length step
        writes every row's window K/V at its absolute positions and
        scores every window position, then per-row rejection sampling
        (:func:`_spec_accept`). Slot cursors are rewound past the
        rejected suffixes here; paged cursors are host-owned and advance
        at reconcile by ``n_forced + acc``. Returns ``(out_toks [S,
        k+1], acc [S])`` on the device."""
        S, k = self.slots, self.spec_k
        if self.paged:
            tables, lens, fed, valid, n_forced, _, draft_h = _unpack_i32(
                packed, ((S, self._max_blocks), (S,), (S, W), (S,), (S,),
                         (S,), (S, k)))
            paged_kw = {"block_tables": tables, "seq_lens": lens}
        else:
            fed, valid, n_forced, _, draft_h = _unpack_i32(
                packed, ((S, W), (S,), (S,), (S,), (S, k)))
            paged_kw = {}
        draft = (draft_h if draft_dev is None else draft_dev).long()
        merged = _merge_drafts(fed.long(), valid.long(), n_forced.long(),
                               draft, k)
        logits = self._dm(merged, cache=self._cache, valid_lens=valid,
                          **paged_kw)
        full = torch.cat([self._last_logits[:, None],
                          logits.to(torch.float32)], dim=1)
        out, acc, new_last = _spec_accept(
            cfgs, k, self.draft_kind == "ngram" or q_probs is None, full,
            self._gens, valid, n_forced, sample_mask, draft, q_probs)
        if not self.paged:
            self._cache.index -= valid.long() - (n_forced.long() + acc)
        self._last_logits = new_last
        return out, acc

    def _run_draft(self, cfgs, spec_rows):
        """Draft-model pass for one speculative tick: ONE catch-up feed
        (each row's queue of true tokens the draft has not consumed —
        prompt chunks after admission, the 1-2 tokens emitted since the
        last window in steady state — with its rejected-proposal cursor
        overshoot rewound first), then ``spec_k`` proposal steps, each
        sampling one draft token per speculating row and feeding it (the
        k-th is sample-only). Returns ``(q_probs [S, k, V], draft_toks
        [S, k])`` on the device, or ``(None, None)`` with no speculating
        row — the proposals never round-trip the host."""
        S, k = self.slots, self.spec_k
        feed_rows = [
            (s, st) for s, st in enumerate(self._slots)
            if st is not None and st.draft_queue is not None
            and (st.draft_queue.size > 0 or st.draft_rewind > 0)
        ]
        if not feed_rows and not spec_rows:
            return None, None
        logits = None
        if feed_rows:
            # steady state feeds at most 2 lag tokens per row; only the
            # prompt catch-up widens the feed to the chunk
            need = max(int(st.draft_queue.size) for _, st in feed_rows)
            Wd = 2 if need <= 2 else max(self.prefill_chunk, 2)
            dfed = np.zeros((S, Wd), np.int32)
            dvalid = np.zeros((S,), np.int32)
            rewind = np.zeros((S,), np.int32)
            for s, st in feed_rows:
                take = min(Wd, int(st.draft_queue.size))
                dfed[s, :take] = st.draft_queue[:take]
                dvalid[s] = take
                rewind[s] = st.draft_rewind
                st.draft_queue = st.draft_queue[take:]
                st.draft_rewind = 0
            dev = self._to_device(_pack_i32(dfed, dvalid, rewind))
            dfed_d, dvalid_d, rewind_d = _unpack_i32(
                dev, ((S, Wd), (S,), (S,)))
            self._draft_cache.index -= rewind_d.long()
            out = self._dm_draft(dfed_d.long(), cache=self._draft_cache,
                                 valid_lens=dvalid_d)
            self.draft_feeds += 1
            idx = torch.clamp(dvalid_d.long() - 1, min=0)
            logits = out[torch.arange(S, device=out.device), idx].to(
                torch.float32)
        if not spec_rows:
            return None, None
        spec_mask = np.zeros((S,), bool)
        for s, _ in spec_rows:
            spec_mask[s] = True
        V = self.model.vocab_size
        feed_on = self._to_device(spec_mask.astype(np.int32))
        toks_l, qs_l = [], []
        for i in range(k):
            tok = torch.argmax(logits, dim=-1)
            # greedy q is a formality (the greedy accept never reads it)
            q = F.one_hot(tok, V).to(torch.float32)
            for s, (temp, top_k, top_p) in enumerate(cfgs):
                if temp == 0.0 or not spec_mask[s]:
                    continue
                tok[s] = sample_tokens(logits[s:s + 1], self._draft_gens[s],
                                       temp, top_k, top_p)[0]
                q[s] = torch.softmax(
                    filter_logits(logits[s], temp, top_k, top_p), dim=-1)
            toks_l.append(tok)
            qs_l.append(q)
            if i < k - 1:
                # feed the proposal (spec rows only); the k-th is never
                # fed, so its step is skipped
                out = self._dm_draft(tok[:, None], cache=self._draft_cache,
                                     valid_lens=feed_on)
                logits = out[:, 0].to(torch.float32)
        return torch.stack(qs_l, dim=1), torch.stack(toks_l, dim=1)

    def _reconcile_spec(self, rec: _InflightTick, defer: Optional[list]):
        """Materialize one verify tick and settle the host side: read
        back tokens AND accepted-prefix lengths (the next plan depends on
        both), advance the paged cursors by ``n_forced + acc`` (the
        rejected-suffix rollback), emit each row's accepted prefix plus
        its extra token, and do the draft lag bookkeeping. With ``defer``
        (pipelined) the emission is queued for after the next
        dispatch."""
        k = self.spec_k
        t_wait0 = time.perf_counter()
        toks_host, acc_host = self._read(rec)
        wait_ms = (time.perf_counter() - t_wait0) * 1e3
        if self.paged:
            # rebind, never mutate: each row keeps its forced tokens
            # plus the accepted prefix
            self._seq_lens = self._seq_lens + (
                rec.n_forced + acc_host).astype(np.int32)
        t_stream0 = time.perf_counter()
        self.ticks += 1
        occupancy = sum(st is not None for st in self._slots)
        self._occ_sum += occupancy
        now = time.monotonic()
        emitted = 0
        proposed = int(rec.granted.sum())
        accepted = 0
        for s, row in enumerate(rec.rows):
            if row is None:
                continue
            st = row[1]
            if self._slots[s] is not st:
                continue  # late finish (cannot happen at depth 1)
            if row[0] == "pre":
                if row[3]:
                    req = st.req
                    req.prefill_done_t = now
                    prefill_ms = (now - st.admit_t) * 1e3
                    self.tracer.record(
                        req.trace_id, "prefill", st.admit_t,
                        prefill_ms, slot=s,
                        prompt_tokens=int(req.prompt.size),
                        cached_tokens=st.cached_tokens,
                        chunk=self.prefill_chunk, wv=self.weight_version,
                    )
                    self._m_prefill_ms.observe(prefill_ms)
                continue
            a = int(acc_host[s])
            if rec.granted[s] > 0:
                accepted += a
                self._m_accept_len.observe(a)
            toks_row = [int(t) for t in toks_host[s, :a + 1]]
            e, done = self._stream_row(s, st, toks_row, now, defer)
            emitted += e
            if done:
                continue
            st.pending_tok = toks_row[-1]
            if st.history is not None:
                st.history = np.concatenate(
                    [st.history, np.asarray(toks_row, np.int32)])
            if self.draft_kind == "model":
                lag = []
                if s in rec.spec_set and a == k:
                    # every proposal survived: the k-th was accepted but
                    # never fed to the draft — it precedes the extra token
                    lag.append(int(toks_host[s, k - 1]))
                lag.append(st.pending_tok)
                lag_np = np.asarray(lag, np.int32)
                st.draft_queue = (
                    np.concatenate([st.draft_queue, lag_np])
                    if st.draft_queue.size else lag_np)
                if s in rec.spec_set:
                    st.draft_rewind = max(k - 1 - a, 0)
        self.draft_tokens_proposed += proposed
        self.draft_tokens_accepted += accepted
        self._m_draft_tokens.inc(proposed)
        self._m_accepted_tokens.inc(accepted)
        queue_depth = self.scheduler.depth()
        device_ms = rec.dispatch_ms + wait_ms
        self._m_ticks.inc()
        self._m_tokens.inc(emitted)
        self._m_occupancy.set(sum(st is not None for st in self._slots))
        self._m_tick_ms.observe(device_ms)
        self._m_device_wait.observe(wait_ms)
        self.dispatches += 1
        self._m_dispatches.inc()
        self._m_tokens_per_dispatch.observe(emitted)
        if rec.fed_tokens + rec.n_dec > 0:
            self._m_prefill_frac.observe(
                rec.fed_tokens / (rec.fed_tokens + rec.n_dec))
        if device_ms > 0:
            self._m_decode_tps.set(round(emitted / (device_ms / 1e3), 3))
        self.metrics.log(
            step=self.ticks, occupancy=occupancy, queue_depth=queue_depth,
            token_ms=round(device_ms, 3), prefill_tokens=rec.fed_tokens,
            draft_tokens=proposed, accepted_tokens=accepted,
        )
        self._record_tick(
            plan_ms=rec.plan_ms, device_ms=device_ms,
            stream_ms=(time.perf_counter() - t_stream0) * 1e3,
            n_dec=rec.n_dec, prefill_tokens=rec.fed_tokens,
            chunk=rec.chunk, emitted=emitted, occupancy=occupancy,
            queue_depth=queue_depth, draft_tokens=proposed,
            accepted_tokens=accepted, device_wait_ms=wait_ms,
            dispatch_ms=rec.dispatch_ms,
        )

    # -- completion -------------------------------------------------------------

    def _complete(self, slot: int, reason: str,
                  defer: Optional[list] = None):
        """Free a finished slot NOW (blocks released, row parked, the
        scheduler's head-of-line short-circuit invalidated) and notify
        the consumer — immediately, or queued behind the row's deferred
        tokens in the pipelined spec loop."""
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
        if defer is None:
            self._notify_finish(req, reason, slot)
        else:
            defer.append(("finish", req, reason, slot))

    def _notify_finish(self, req: Request, reason: str, slot: int):
        # spans first, then the stream-end sentinel: a client that saw
        # "done" can immediately read the full chain
        decode_t0 = req.prefill_done_t or req.submit_t
        decode_ms = (req.done_t - decode_t0) * 1e3
        device_ms = min(req.device_ms_accum, decode_ms)
        self.tracer.record(
            req.trace_id, "decode", decode_t0, decode_ms,
            slot=slot, tokens=req.n_emitted,
            device_ms=round(device_ms, 3), wv=self.weight_version,
        )
        self.tracer.record(
            req.trace_id, "finish", req.done_t, 0.0,
            reason=reason, slot=slot, tokens=req.n_emitted,
            ttft_ms=round((req.first_token_t - req.submit_t) * 1e3, 3),
            wv=self.weight_version,
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
        if self.prefix is not None and st.wv == self.weight_version:
            # a row admitted before a weight swap holds K/V of the old
            # weights: it never registers (its blocks free below)
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
            elif st.restoring is not None:
                out.append({"rid": st.req.rid, "state": "restore",
                            "pending": len(st.restoring),
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
                     dispatch_ms: float,
                     draft_tokens: Optional[int] = None,
                     accepted_tokens: Optional[int] = None,
                     overrun: int = 0, multi_k: Optional[int] = None):
        """Post-tick runtime introspection + the flight snapshot, self-
        timed against tick wall time (``stats()["flight"]``)."""
        self._tick_ns += int((plan_ms + device_ms + stream_ms) * 1e6)
        rec_total = recompiles.total()
        oldest = self.scheduler.oldest_age_s()
        sample_tick = self.ticks % self.MEM_SAMPLE_EVERY == 1
        mem = None
        if sample_tick:
            mem = self._sample_memory()
            self._m_recompiles.set(rec_total)
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
                "recompiles": rec_total,
                "weight_version": self.weight_version,
            }
            if multi_k is not None:
                snap["multi_k"] = multi_k
            if self.pipeline:
                snap["pipeline_depth"] = len(self._pending)
                snap["overrun_tokens"] = overrun
            if draft_tokens is not None:
                snap["draft_tokens"] = draft_tokens
                snap["accepted_tokens"] = accepted_tokens
            if mem is not None:
                snap["mem"] = mem
            if self.paged:
                snap["blocks"] = (self.pool.stats() if sample_tick
                                  else {"in_use": self.pool.in_use_count(),
                                        "free": self.pool.free_count()})
                snap["prefix_hit_tokens"] = self.prefix_hit_tokens
                if self.host is not None:
                    snap["demoted"] = self._tick_demoted
                    snap["restored"] = self._tick_restored
                    snap["host_blocks"] = self.host.count()
                if self._tick_exported or self._tick_imported:
                    snap["kv_exported"] = self._tick_exported
                    snap["kv_imported"] = self._tick_imported
            self.flight.record(snap)
        self._flight_ns += time.perf_counter_ns() - t0
        self._tick_demoted = 0
        self._tick_restored = 0
        self._tick_exported = 0
        self._tick_imported = 0

    def stats(self) -> dict:
        """Counters + latency percentiles (TTFT and per-token, ms) for
        THIS engine. The process-cumulative view is
        ``self.registry.collect()``."""
        qos_depth = self.scheduler.depth_by_tier()
        out = {
            "device": str(self._device),
            "tp": self.tp,
            "role": self.role,
            "prefill_kernel": self.prefill_kernel,
            "ticks": self.ticks,
            "requests_completed": self.requests_completed,
            "tokens_generated": self.tokens_generated,
            "queue_depth": self.queue_depth(),
            "active_slots": sum(1 for st in self._slots if st is not None),
            "draining": self.draining,
            "drained": self.drained,
            "weight_version": self.weight_version,
            "weight_swaps": self.weight_swaps,
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
            "decode_stalls": self._m_decode_stalls.value,
            "multi_step_k": self.multi_step_k,
            "multi_step_fallbacks": dict(self.multi_step_fallbacks),
            "dispatches": self.dispatches,
            "tokens_per_dispatch": {
                "p50": self._m_tokens_per_dispatch.percentile(50),
                "p99": self._m_tokens_per_dispatch.percentile(99),
            },
            "queue_oldest_wait_s": round(
                self.scheduler.oldest_age_s(), 3),
            # process-global kernel builds, loads and first launches per
            # configuration, and the delta since mark_steady() —
            # nonempty in steady state is a bug
            "recompiles": recompiles.counts(),
            "recompiles_since_mark": self.recompiles_since_mark(),
            "memory": self._mem.summary(),
            "pipeline": self.pipeline,
            "device_wait_ms": {
                "p50": self._m_device_wait.percentile(50),
                "p99": self._m_device_wait.percentile(99),
            },
            "overrun_tokens": self.overrun_tokens,
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
        if self.tp > 1:
            book = self._lockstep
            out["lockstep"] = {
                "rank": self.tp_rank, "records": book["records"],
                "record_ms_mean": (round(book["record_ms"] / book["records"],
                                         4) if book["records"] else None),
                "tensor_bytes": book["tensor_bytes"],
                "tensor_ms": round(book["tensor_ms"], 3),
                "ops": dict(book["ops"]), "op_errors": book["op_errors"],
                "last_op": book["last_op"],
            }
        if self.spec:
            out.update({
                "draft": self.draft_kind,
                "spec_k": self.spec_k,
                "draft_tokens": self.draft_tokens_proposed,
                "accepted_tokens": self.draft_tokens_accepted,
                "acceptance_rate": (
                    round(self.draft_tokens_accepted
                          / self.draft_tokens_proposed, 4)
                    if self.draft_tokens_proposed else 0.0
                ),
            })
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
                "kv_blocks_exported": self.kv_blocks_exported,
                "kv_blocks_imported": self.kv_blocks_imported,
            })
            if self.host is not None:
                hs = self.host.stats()
                out.update({
                    "host_blocks_cached": hs["blocks"],
                    "host_bytes": hs["bytes"],
                    "block_demotions": self.demotions,
                    "block_restores": self.restores,
                    "restore_wait_ms": {
                        "p50": self._m_restore_wait.percentile(50),
                        "p99": self._m_restore_wait.percentile(99),
                    },
                })
        return out
