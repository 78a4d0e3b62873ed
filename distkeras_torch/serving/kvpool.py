"""Block pool for the paged KV cache (PagedAttention-style memory
management, Kwon et al., SOSP 2023) plus the host-RAM spill tier
(CachedAttention-style KV offload) — the port of
:mod:`distkeras_tpu.serving.kvpool`.

The slot engine reserves one contiguous ``[S, max_len, ...]`` KV slab
per layer — worst-case length for every slot, whether a request uses 20
tokens or 2000. Paged mode carves each layer's cache into fixed-size
token **blocks** (``[num_blocks, block_size, Hk, hd]``) and gives each
sequence a *block table*: the list of physical blocks its logical
positions map onto. Memory is then committed block-by-block as a
sequence grows, and identical prompt prefixes can point their tables at
the *same* physical blocks (:mod:`distkeras_torch.serving.prefix`).

This module is the host-side accountant for those physical blocks:

- **Reserved trash block.** Block 0 is never allocated: idle decode rows
  still scatter one K/V write per tick (static shapes — the tick always
  writes all rows), and their tables point every logical block at
  block 0 so the garbage lands where no live sequence reads.
- **Ref-counted sharing.** A block referenced by ``r`` live requests has
  ``ref == r``; prefix-shared blocks are incref'd per admission and
  decref'd at finish. A block is only writable by the single sequence
  that owns its tail (``ref == 1`` and not prefix-registered), which is
  what makes copy-on-write safe.
- **Free vs cached.** ``decref`` to zero does NOT free a block that the
  radix index still registers — it becomes *cached*: evictable the
  moment an allocation needs room, a prefix hit until then. Unregistered
  blocks go straight back to the free list.
- **Host tier.** With a :class:`HostBlockPool` attached, an evicted
  cached block's contents are *demoted* to pinned host memory instead of
  discarded (the radix node is re-keyed ``device -> host``), and a later
  prefix hit copies them back asynchronously. The tier itself is plain
  bookkeeping: a bounded LRU dict of per-block leaf tensors (pinned CPU
  tensors when the cache lives on a card), with pinning so an entry a
  RESTORING row still needs can never be evicted under it.

Eviction policy lives with the structure that knows reuse odds: the
radix index picks the LRU unreferenced victim
(:meth:`RadixPrefixIndex.peek_evictable`); the engine demotes or drops
it and frees the device block through :meth:`BlockPool.evict` — which
returns the freed block id (the evicted contents' handle), so the
demotion bookkeeping is pinned to exactly the block released. The pool
itself is policy-free bookkeeping.

Allocation and refcounts are engine-thread-only; the internal lock
exists for the *observers* — ``stats()`` may be called from other
threads mid-tick and must see a coherent live/cached decomposition.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict, deque
from typing import List, Optional, Tuple

import numpy as np

from distkeras_torch import telemetry


class OutOfBlocksError(RuntimeError):
    """Allocation needed more physical blocks than free + evictable.
    The free-block-aware admission check exists to make this unreachable
    for admitted requests; seeing it means a caller bypassed admission."""


class HostBlockPool:
    """Bounded LRU pool of demoted KV blocks in host memory.

    Each entry holds one device block's contents: the per-leaf
    ``[block_size, ...]`` CPU tensors the engine copied out at demotion
    (K, V and, under an int8 cache, their f32 scales; pinned when the
    cache lives on a card, so the copy back is asynchronous). Entries
    are keyed by an opaque monotonically increasing ``handle`` that is
    never reused, so a stale reference can only miss, never alias.

    - :meth:`put` stores an entry, LRU-evicting unpinned entries to stay
      within ``capacity`` blocks; returns ``(handle, evicted_handles)``
      — the caller (the engine) unlinks the evicted entries' radix
      nodes. Returns ``(None, [])`` when nothing can be evicted (every
      entry pinned by a queued restore): the caller falls back to plain
      eviction for that block.
    - :meth:`pin` marks an entry needed by a queued restore; pinned
      entries are never LRU-evicted (:meth:`take` drops the pin with the
      entry).
    - :meth:`take` pops an entry for upload (the restore path — counted
      as a restore); :meth:`discard` drops one silently (radix-subtree
      cleanup); :meth:`peek` reads one without removing it (KV export).

    Thread-safety mirrors :class:`BlockPool`: one mutating thread (the
    engine loop), any number of ``stats()`` readers.
    """

    def __init__(self, capacity: int, block_size: int,
                 registry: Optional["telemetry.MetricRegistry"] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = capacity
        self.block_size = block_size
        self._lock = threading.Lock()
        # handle -> [leaves, nbytes, pins]; insertion order IS the LRU
        # order (touch = move_to_end)
        self._entries: "OrderedDict[int, list]" = OrderedDict()
        self._bytes = 0
        self._handles = itertools.count(1)
        self.bytes_demoted_total = 0
        self.bytes_restored_total = 0
        reg = registry or telemetry.get_registry()
        self._m_blocks = reg.gauge(
            "host_blocks_cached",
            "demoted KV blocks resident in the host-RAM tier")
        self._m_bytes = reg.gauge(
            "host_bytes", "bytes held by the host-RAM KV tier")
        self._m_demotions = reg.counter(
            "serving_block_demotions_total",
            "evicted prefix-cached blocks demoted to the host tier "
            "instead of discarded")
        self._m_restores = reg.counter(
            "serving_block_restores_total",
            "host-tier blocks uploaded back into the device pool on a "
            "prefix hit")
        self._m_blocks.set(0)
        self._m_bytes.set(0)

    # -- queries ------------------------------------------------------------

    def count(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "blocks": len(self._entries),
                "bytes": self._bytes,
                "capacity": self.capacity,
            }

    def __contains__(self, handle: int) -> bool:
        with self._lock:
            return handle in self._entries

    # -- demote / restore ---------------------------------------------------

    def put(self, leaves: list) -> Tuple[Optional[int], List[int]]:
        """Store one demoted block's leaf tensors. Evicts LRU unpinned
        entries as needed; refuses (``(None, [])``) when the pool is
        full of pinned entries — the demotion then degrades to a plain
        eviction, never an unbounded host footprint."""
        nbytes = sum(_nbytes(a) for a in leaves)
        evicted: List[int] = []
        with self._lock:
            while len(self._entries) >= self.capacity:
                victim = next(
                    (h for h, e in self._entries.items() if e[2] == 0),
                    None,
                )
                if victim is None:
                    return None, evicted
                _, vb, _ = self._entries.pop(victim)
                self._bytes -= vb
                evicted.append(victim)
            handle = next(self._handles)
            self._entries[handle] = [list(leaves), nbytes, 0]
            self._bytes += nbytes
            self.bytes_demoted_total += nbytes
            n, b = len(self._entries), self._bytes
        self._m_demotions.inc()
        self._m_blocks.set(n)
        self._m_bytes.set(b)
        return handle, evicted

    def take(self, handle: int) -> Optional[list]:
        """Pop an entry for upload back into the device pool (counted as
        a restore, pin discarded with the entry). None when the entry is
        gone — the caller's seeded-replay fallback recomputes the span
        instead. The caller keeps the tensors alive until its copy to
        the card has completed."""
        with self._lock:
            e = self._entries.pop(handle, None)
            if e is not None:
                self._bytes -= e[1]
                self.bytes_restored_total += e[1]
            n, b = len(self._entries), self._bytes
        if e is None:
            return None
        self._m_restores.inc()
        self._m_blocks.set(n)
        self._m_bytes.set(b)
        return e[0]

    def peek(self, handle: int) -> Optional[list]:
        """Read an entry's leaf tensors WITHOUT removing it (KV-block
        export serves host-resident chunks straight from the tier — no
        device copy, no restore accounting). LRU recency is bumped;
        ``None`` when the entry is gone."""
        with self._lock:
            e = self._entries.get(handle)
            if e is None:
                return None
            self._entries.move_to_end(handle)
            return list(e[0])

    def discard(self, handle: int) -> None:
        """Drop an entry without counting a restore (the radix-subtree
        cleanup after an LRU eviction unlinked its ancestors).
        Idempotent — cascaded cleanups may name already-gone handles."""
        with self._lock:
            e = self._entries.pop(handle, None)
            if e is not None:
                self._bytes -= e[1]
            n, b = len(self._entries), self._bytes
        if e is not None:
            self._m_blocks.set(n)
            self._m_bytes.set(b)

    # -- pins / recency -----------------------------------------------------

    def pin(self, handle: int) -> bool:
        """Protect an entry a queued restore will upload; pinned entries
        are skipped by LRU eviction."""
        with self._lock:
            e = self._entries.get(handle)
            if e is None:
                return False
            e[2] += 1
            return True

    def unpin(self, handle: int) -> None:
        with self._lock:
            e = self._entries.get(handle)
            if e is not None and e[2] > 0:
                e[2] -= 1

    def touch(self, handle: int) -> None:
        """LRU recency bump (a prefix match grazed this entry)."""
        with self._lock:
            if handle in self._entries:
                self._entries.move_to_end(handle)


def _nbytes(a) -> int:
    """Bytes of one leaf: a torch tensor or a numpy array."""
    if hasattr(a, "element_size"):
        return a.numel() * a.element_size()
    return int(a.nbytes)


class BlockPool:
    """Ref-counted allocator over ``num_blocks`` fixed-size KV blocks.

    Args:
      num_blocks: physical blocks in the device cache (``>= 2``; block 0
        is the reserved trash block and is never handed out).
      block_size: tokens per block (bookkeeping only — the device layout
        is owned by the model's paged cache variables).
      registry: :class:`~distkeras_torch.telemetry.MetricRegistry` for
        the ``serving_blocks_in_use`` gauge and
        ``serving_block_evictions_total`` counter; defaults to the
        process-global one.
      host_tier: optional :class:`HostBlockPool` the engine demotes
        evicted cached blocks into; referenced here so :meth:`stats`
        reports the full live/cached/host decomposition in one snapshot.
    """

    RESERVED = 1  # block 0: the idle-row scratch target

    def __init__(self, num_blocks: int, block_size: int,
                 registry: Optional["telemetry.MetricRegistry"] = None,
                 host_tier: Optional[HostBlockPool] = None):
        if num_blocks < self.RESERVED + 1:
            raise ValueError(
                f"num_blocks must be >= {self.RESERVED + 1} "
                f"(block 0 is reserved); got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1; got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.host_tier = host_tier
        self._lock = threading.Lock()
        self.ref = np.zeros(num_blocks, np.int32)
        self._free: deque = deque(range(self.RESERVED, num_blocks))
        self._in_free = np.ones(num_blocks, bool)
        self._in_free[:self.RESERVED] = False
        reg = registry or telemetry.get_registry()
        self._m_in_use = reg.gauge(
            "serving_blocks_in_use",
            "physical KV blocks allocated (live + prefix-cached)")
        self._m_evictions = reg.counter(
            "serving_block_evictions_total",
            "prefix-cached blocks reclaimed to satisfy an allocation")
        self._m_in_use.set(0)

    # -- queries ------------------------------------------------------------

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def in_use_count(self) -> int:
        """Allocated blocks: live (ref > 0) plus prefix-cached (ref 0
        but still registered — not yet back on the free list)."""
        with self._lock:
            return self._in_use_locked()

    def _in_use_locked(self) -> int:
        return self.num_blocks - self.RESERVED - len(self._free)

    def stats(self) -> dict:
        """Plain-data snapshot for flight-recorder ticks, the router's
        saturation gate, and debugging: total/free/in-use split, with
        in-use decomposed into live (referenced) vs cached (ref 0,
        awaiting reuse or eviction), plus the host tier's block count.
        The whole decomposition is taken in ONE lock hold so a scrape
        concurrent with an engine tick can never observe a torn
        live/cached pair (live counted before a decref, cached after)."""
        with self._lock:
            in_use = self._in_use_locked()
            live = int(np.count_nonzero(self.ref > 0))
            free = len(self._free)
        host = self.host_tier.count() if self.host_tier is not None else 0
        return {
            "total": self.num_blocks - self.RESERVED,
            "free": free,
            "in_use": in_use,
            "live": live,
            "cached": in_use - live,
            "host": host,
        }

    # -- alloc / free -------------------------------------------------------

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` free blocks (ref starts at 0 — the caller increfs
        the whole chain it builds). Raises :class:`OutOfBlocksError`
        rather than partially allocating; callers evict first."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        with self._lock:
            if n > len(self._free):
                raise OutOfBlocksError(
                    f"need {n} blocks, only {len(self._free)} free "
                    f"(evict prefix-cached blocks first)"
                )
            out = [self._free.popleft() for _ in range(n)]
            for b in out:
                self._in_free[b] = False
            in_use = self._in_use_locked()
        self._m_in_use.set(in_use)
        return out

    def free(self, blocks) -> None:
        """Return blocks to the free list. Only legal at ref 0 — freeing
        a referenced block would hand a live sequence's storage to the
        next allocation."""
        with self._lock:
            self._free_locked(blocks)
            in_use = self._in_use_locked()
        self._m_in_use.set(in_use)

    def _free_locked(self, blocks) -> None:
        for b in blocks:
            self._check(b)
            if self.ref[b] != 0:
                raise ValueError(
                    f"block {b} still has ref={int(self.ref[b])}; "
                    f"decref to zero before freeing"
                )
            if self._in_free[b]:
                raise ValueError(f"block {b} double-freed")
            self._free.append(b)
            self._in_free[b] = True

    def evict(self, block: int) -> int:
        """Free one prefix-cached block reclaimed for an allocation —
        same invariants as :meth:`free`, plus the eviction counter.
        Returns the freed block id: the evicted contents' handle, so a
        demotion (copy the contents to the host tier, re-key the radix
        node) is pinned to exactly the block this call released rather
        than whatever the caller *believed* it was evicting."""
        with self._lock:
            self._free_locked([block])
            in_use = self._in_use_locked()
        self._m_in_use.set(in_use)
        self._m_evictions.inc()
        return block

    # -- refcounts ----------------------------------------------------------

    def incref(self, blocks) -> None:
        with self._lock:
            for b in blocks:
                self._check(b)
                if self._in_free[b]:
                    raise ValueError(
                        f"block {b} is free; alloc before incref")
                self.ref[b] += 1

    def decref(self, blocks) -> List[int]:
        """Drop one reference from each block; returns the blocks whose
        refcount hit zero (the caller decides: registered in the prefix
        index → leave allocated as cached; private → :meth:`free`)."""
        released: List[int] = []
        with self._lock:
            for b in blocks:
                self._check(b)
                if self.ref[b] <= 0:
                    raise ValueError(f"block {b} decref'd below zero")
                self.ref[b] -= 1
                if self.ref[b] == 0:
                    released.append(b)
        return released

    def _check(self, b: int) -> None:
        if not self.RESERVED <= b < self.num_blocks:
            raise ValueError(
                f"block id {b} out of range "
                f"[{self.RESERVED}, {self.num_blocks})"
            )
