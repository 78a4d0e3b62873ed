"""Block pool for the paged KV cache (PagedAttention-style memory
management, Kwon et al., SOSP 2023) — the port of
:mod:`distkeras_tpu.serving.kvpool` without its host-RAM spill tier
(``HostBlockPool`` waits for ROADMAP A8).

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

Eviction policy lives with the structure that knows reuse odds: the
radix index picks the LRU unreferenced victim
(:meth:`RadixPrefixIndex.peek_evictable`); the engine drops it and frees
the device block through :meth:`BlockPool.evict`. The pool itself is
policy-free bookkeeping.

Allocation and refcounts are engine-thread-only; the internal lock
exists for the *observers* — ``stats()`` may be called from other
threads mid-tick and must see a coherent live/cached decomposition.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional

import numpy as np

from distkeras_torch import telemetry


class OutOfBlocksError(RuntimeError):
    """Allocation needed more physical blocks than free + evictable.
    The free-block-aware admission check exists to make this unreachable
    for admitted requests; seeing it means a caller bypassed admission."""



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
    """

    RESERVED = 1  # block 0: the idle-row scratch target

    def __init__(self, num_blocks: int, block_size: int,
                 registry: Optional["telemetry.MetricRegistry"] = None):
        if num_blocks < self.RESERVED + 1:
            raise ValueError(
                f"num_blocks must be >= {self.RESERVED + 1} "
                f"(block 0 is reserved); got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1; got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
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
        awaiting reuse or eviction). The whole decomposition is taken in ONE lock hold so a scrape
        concurrent with an engine tick can never observe a torn
        live/cached pair (live counted before a decref, cached after)."""
        with self._lock:
            in_use = self._in_use_locked()
            live = int(np.count_nonzero(self.ref > 0))
            free = len(self._free)
        return {
            "total": self.num_blocks - self.RESERVED,
            "free": free,
            "in_use": in_use,
            "live": live,
            "cached": in_use - live,
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
        Returns the freed block id."""
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
