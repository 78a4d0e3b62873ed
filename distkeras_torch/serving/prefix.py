"""Radix-tree prefix index for the paged KV cache (RadixAttention-style
prefix sharing, Zheng et al., SGLang 2024) with a two-tier residency
state per node.

Thousands of serving requests open with the same system prompt; the
slot engine re-prefills that prefix for every one of them. With the
cache paged (:mod:`distkeras_torch.serving.kvpool`), a prefix's K/V lives
in ordinary physical blocks — so a new request whose prompt starts with
an already-computed prefix can point its block table at those blocks,
bump their refcounts, and prefill only the uncached suffix.

The index is a radix tree at **block granularity**: each node owns one
physical block and is keyed by the exact ``block_size`` token ids that
block covers, so a path from the root spells out a prefix in
``block_size``-token steps. Rope positions are absolute, which is what
makes a cached block reusable at all: the K/V for tokens ``[i*bs,
(i+1)*bs)`` depends only on the token ids before and inside the block,
never on what comes after.

**Residency.** A node is ``device``-resident (owns a physical device
block, registered in ``_by_block``) or ``host``-resident (its contents
were demoted to the :class:`~distkeras_torch.serving.kvpool.HostBlockPool`
under eviction pressure; it owns an opaque host ``handle``, registered
in ``_by_host``). Demotion is bottom-up (a node only demotes once no
device-resident child remains) and promotion is top-down (a restored
chain re-keys ancestors before descendants), so on every root path the
device nodes form a prefix and the host nodes a suffix — which is what
lets :meth:`match` return one device chain followed by one host chain.

- **match(tokens)** walks exact-key children chunk by chunk; a
  device-resident child extends the zero-cost hit chain, a
  host-resident child extends the *restore* chain (the engine admits
  the request in a RESTORING state and uploads those blocks
  asynchronously). Where the walk stops — and only when it stopped
  among device nodes — it scans the frontier children for the longest
  shared *partial* device prefix, reusable via **copy-on-write**. The
  hit is capped at ``len(tokens) - 1``: the last prompt token is always
  prefilled, because sampling needs its logits.
- **insert(tokens, blocks)** registers a finished request's full prompt
  blocks. Chunks already present are skipped; the walk STOPS at the
  first host-resident chunk (re-registering a device copy under a host
  node would put a device node below a host one and break the
  path-suffix invariant — the host copy stays authoritative and the
  caller's duplicate block is freed at decref, exactly like the
  concurrent-miss dedup).
- **peek_evictable(ref)** picks the least-recently-matched unreferenced
  device node with no device-resident child; the engine demotes it
  (:meth:`demote`) or — without a host tier — unlinks it
  (:meth:`evict_lru`). Referenced nodes are never touched, and an
  ancestor is always at least as recently used and at least as
  referenced as its descendants (every match touches/refs the whole
  path), so bottom-up LRU never strands a child whose prefix context
  is gone. Ties on recency go to the node registered first.

**Victim selection in O(log n).** Candidates — device nodes with no
device-resident child — sit in a lazy min-heap keyed ``(last_access,
seq, block)``, where ``seq`` numbers registrations in ``_by_block``
order, so the heap yields exactly the order a scan of ``_by_block``
for the strict minimum would. An entry is pushed whenever a node
becomes such a leaf or is touched while one; it is never updated in
place. A popped entry whose stamp, registration or device-child count
no longer matches its node is stale and dropped; a live leaf that is
referenced or excluded is set aside and pushed back before the call
returns. Victims handed out stay off the heap until the caller demotes
or removes them, or the next selection pushes them back. The heap is
rebuilt from the registered leaves once it holds more than twice as
many entries as there are registered blocks, so its size stays
O(registered blocks) and the rebuilds cost O(1) a mutation amortized.

Engine-thread only, like the pool: no locks, deterministic behavior.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class PrefixMatch:
    """Result of a lookup: ``blocks`` are fully-shared device-resident
    physical blocks in prefix order; ``host`` are the handles of the
    host-resident chunks that follow them (each covers ``block_size``
    tokens — the engine restores these before the row may run); ``cow``
    is an optional ``(source_block, tokens)`` partial hit at a
    device-resident divergence frontier — reusable only via
    copy-on-write."""

    blocks: List[int] = field(default_factory=list)
    host: List[int] = field(default_factory=list)
    cow: Optional[Tuple[int, int]] = None
    block_size: int = 0

    @property
    def hit_tokens(self) -> int:
        return ((len(self.blocks) + len(self.host)) * self.block_size
                + (self.cow[1] if self.cow else 0))


class _Node:
    __slots__ = ("key", "block", "children", "parent", "last_access",
                 "resident", "handle", "seq", "ndev")

    def __init__(self, key: Tuple[int, ...], block: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_access = 0
        self.resident = "device"
        self.handle: Optional[int] = None
        self.seq = 0   # registration number in _by_block (its dict order)
        self.ndev = 0  # children with resident == "device"


class RadixPrefixIndex:
    """Token-prefix → block-chain index at ``block_size`` granularity."""

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1; got {block_size}")
        self.block_size = block_size
        self._root = _Node((), None, None)
        self._by_block: Dict[int, _Node] = {}
        self._by_host: Dict[int, _Node] = {}
        self._clock = 0  # logical LRU time: bumped per match/insert
        self._seq = 0
        # (last_access, seq, block) of candidate leaves, some stale; and
        # the entries of victims handed out but not yet demoted/removed
        self._heap: List[Tuple[int, int, int]] = []
        self._held: Dict[int, Tuple[int, int, int]] = {}
        self.victims = 0        # victims chosen
        self.victim_probes = 0  # heap entries examined choosing them

    def __len__(self) -> int:
        return len(self._by_block)

    def host_count(self) -> int:
        return len(self._by_host)

    def contains_block(self, block: int) -> bool:
        return block in self._by_block

    def has_host(self, handle: int) -> bool:
        return handle in self._by_host

    def blocks(self) -> List[int]:
        """The device blocks the index registers (a snapshot)."""
        return list(self._by_block)

    def host_handles(self) -> List[int]:
        """The host-tier handles the index registers (a snapshot)."""
        return list(self._by_host)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _register(self, node: _Node, block: int) -> None:
        self._seq += 1
        node.seq = self._seq
        self._by_block[block] = node

    def _push_if_leaf(self, node: _Node) -> None:
        """Queue ``node`` as a victim candidate at its current stamp if
        it is a registered device node with no device-resident child."""
        if (node.block is not None and node.resident == "device"
                and node.ndev == 0):
            heapq.heappush(self._heap,
                           (node.last_access, node.seq, node.block))
            self._maybe_rebuild()

    def _touch(self, node: _Node, now: int) -> None:
        node.last_access = now
        self._push_if_leaf(node)

    def _maybe_rebuild(self) -> None:
        if len(self._heap) > 2 * len(self._by_block):
            self._heap = [(n.last_access, n.seq, b)
                          for b, n in self._by_block.items() if n.ndev == 0]
            heapq.heapify(self._heap)
            self._held.clear()

    # -- lookup -------------------------------------------------------------

    def match(self, tokens) -> PrefixMatch:
        """Longest cached prefix of ``tokens``, capped at
        ``len(tokens) - 1`` so at least one token remains to prefill
        (its logits seed sampling). Touches every node on the matched
        path (LRU recency). The chain is device blocks first, then
        host handles (the residency suffix invariant); a COW partial
        hit is only offered from a device frontier — a host-resident
        divergence is simply not reused (restoring a whole block to
        copy part of it is not worth the transfer)."""
        toks = tuple(int(t) for t in tokens)
        bs = self.block_size
        limit = len(toks) - 1  # the final prompt token is never skipped
        now = self._tick()
        node = self._root
        blocks: List[int] = []
        host: List[int] = []
        h = 0
        while h + bs <= limit:
            child = node.children.get(toks[h:h + bs])
            if child is None:
                break
            if child.resident == "host":
                child.last_access = now
                host.append(child.handle)
            else:
                if host:
                    # a device node below a host node would violate the
                    # residency suffix invariant (demotion is bottom-up,
                    # promotion top-down)
                    raise AssertionError(
                        "device-resident node below a host-resident one"
                    )
                self._touch(child, now)
                blocks.append(child.block)
            node = child
            h += bs
        cow = None
        rest = toks[h:limit]
        if rest and not host:
            best_j, best = 0, None
            for key, child in node.children.items():
                if child.resident != "device":
                    continue
                j = 0
                for a, b in zip(key, rest):
                    if a != b:
                        break
                    j += 1
                if j > best_j:
                    best_j, best = j, child
            if best is not None:
                self._touch(best, now)
                cow = (best.block, best_j)
        return PrefixMatch(blocks=blocks, host=host, cow=cow,
                           block_size=bs)

    # -- registration -------------------------------------------------------

    def insert(self, tokens, blocks) -> List[int]:
        """Register a prompt's full-block chain: chunk ``i`` of
        ``tokens`` (``block_size`` ids) is served by physical block
        ``blocks[i]``. Trailing tokens past the last full block are
        ignored (a partial block is private to its sequence — its tail
        slots will be overwritten by decode writes). Returns the block
        ids actually registered (already-present chunks are skipped —
        their existing node wins, and the caller's duplicate block stays
        unregistered so decref frees it). The walk stops at the first
        host-resident chunk: its demoted copy stays authoritative, and
        the deeper duplicates free at decref like any concurrent-miss
        losers."""
        toks = tuple(int(t) for t in tokens)
        bs = self.block_size
        n_full = min(len(toks) // bs, len(blocks))
        now = self._tick()
        node = self._root
        registered: List[int] = []
        for i in range(n_full):
            key = toks[i * bs:(i + 1) * bs]
            child = node.children.get(key)
            if child is not None and child.resident == "host":
                break
            if child is None:
                b = int(blocks[i])
                if b in self._by_block:
                    self._push_if_leaf(node)
                    raise ValueError(
                        f"block {b} already registered to another prefix"
                    )
                child = _Node(key, b, node)
                node.children[key] = child
                node.ndev += 1
                self._register(child, b)
                registered.append(b)
            child.last_access = now
            node = child
        # every node of the walk but the last has a device child on it
        self._push_if_leaf(node)
        return registered

    def insert_host(self, tokens, handles) -> List[int]:
        """Register a migrated prompt's chunks as HOST-resident nodes
        (KV-block import on an engine with a host tier: the imported
        contents sit in the :class:`HostBlockPool` and swap in through
        the ordinary RESTORING machinery on the first hit). Chunk ``i``
        of ``tokens`` is backed by host entry ``handles[i]``; chunks
        already present — device or host — keep their existing node
        (the resident copy is at least as good as the imported one).
        Returns the handles actually registered; the caller discards
        the rest from the host pool. The residency suffix invariant
        holds by construction: a freshly created node is always a leaf,
        and host nodes may sit below anything."""
        toks = tuple(int(t) for t in tokens)
        bs = self.block_size
        n_full = min(len(toks) // bs, len(handles))
        now = self._tick()
        node = dev = self._root
        registered: List[int] = []
        for i in range(n_full):
            key = toks[i * bs:(i + 1) * bs]
            child = node.children.get(key)
            if child is None:
                h = int(handles[i])
                if h in self._by_host:
                    self._push_if_leaf(dev)
                    raise ValueError(
                        f"host handle {h} already registered"
                    )
                child = _Node(key, None, node)
                child.resident = "host"
                child.handle = h
                node.children[key] = child
                self._by_host[h] = child
                registered.append(h)
            child.last_access = now
            node = child
            if node.resident == "device":
                dev = node
        # the walk's deepest device node is the only one it may leave a
        # leaf: each above it has a device child on the walk
        self._push_if_leaf(dev)
        return registered

    # -- residency transitions ----------------------------------------------

    def demote(self, block: int, handle: int) -> None:
        """Re-key a device-resident node to the host tier: the engine
        gathered the block's contents into the host pool under
        ``handle`` and is about to :meth:`BlockPool.evict` the device
        block. The node — and every prefix it anchors — stays matchable;
        hits on it admit in the RESTORING state."""
        node = self._by_block.pop(block)
        if handle in self._by_host:
            raise ValueError(f"host handle {handle} already registered")
        self._held.pop(block, None)
        node.block = None
        node.resident = "host"
        node.handle = handle
        self._by_host[handle] = node
        node.parent.ndev -= 1
        self._push_if_leaf(node.parent)
        self._maybe_rebuild()

    def promote(self, handle: int, block: int) -> None:
        """Re-key a host-resident node back to the device tier at
        ``block`` (the restore upload's destination — typically a block
        the restoring request already owns live, so the node lands
        registered-and-referenced exactly like a fresh shared hit)."""
        if block in self._by_block:
            raise ValueError(
                f"block {block} already registered to another prefix"
            )
        node = self._by_host.pop(handle)
        node.block = block
        node.resident = "device"
        node.handle = None
        self._register(node, block)
        node.parent.ndev += 1
        self._push_if_leaf(node)

    def drop_host(self, handle: int) -> List[int]:
        """Unlink a host-resident node — the host pool LRU-evicted its
        entry — together with its (necessarily host-resident) subtree,
        whose entries the caller must also discard. Returns every
        handle unlinked, the named one included; unknown handles return
        ``[]`` (the cascade may race a restore that already promoted)."""
        node = self._by_host.get(handle)
        if node is None:
            return []
        return self._unlink(node)

    def _unlink(self, node: _Node) -> List[int]:
        """Unlink ``node`` and its whole subtree from the tree and both
        residency maps; returns every host handle dropped (the caller
        discards their host-pool entries)."""
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        dropped: List[int] = []
        stack = [node]
        while stack:
            n = stack.pop()
            if n.resident == "host":
                if n.handle is not None:
                    self._by_host.pop(n.handle, None)
                    dropped.append(n.handle)
            elif n.block is not None:
                self._by_block.pop(n.block, None)
                self._held.pop(n.block, None)
            stack.extend(n.children.values())
        if node.parent is not None and node.resident == "device":
            node.parent.ndev -= 1
            self._push_if_leaf(node.parent)
        self._maybe_rebuild()
        return dropped

    # -- eviction -----------------------------------------------------------

    def evictable_count(self, ref, exclude=()) -> int:
        """How many registered device blocks an allocator could
        reclaim: unreferenced (``ref[b] == 0``) and not in ``exclude``
        (e.g. the hit chain an admission check is about to reuse).
        Refcounts are monotone down the tree (every match refs its
        whole path), so all of these are reachable by repeated
        bottom-up eviction/demotion."""
        ex = set(exclude)
        return sum(1 for b in self._by_block
                   if ref[b] == 0 and b not in ex)

    def peek_victims(self, ref, n: int, exclude=()) -> List[int]:
        """The blocks ``n`` successive :meth:`peek_evictable` calls would
        return, each call's ``exclude`` adding the blocks before it —
        fewer when fewer are evictable — WITHOUT unlinking them: LRU
        unreferenced device nodes with no device-resident child
        (bottom-up order: demoting/evicting one strands nothing — its
        remaining children, if any, are host-resident and keep their
        own handles). Ties on ``last_access`` go to the node registered
        first."""
        heap = self._heap
        for e in self._held.values():
            heapq.heappush(heap, e)
        self._held.clear()
        ex = set(exclude)
        out: List[int] = []
        aside: List[Tuple[int, int, int]] = []
        last = None
        while heap and len(out) < n:
            e = heapq.heappop(heap)
            self.victim_probes += 1
            if e == last:
                continue  # a duplicate pops next to its twin
            last = e
            stamp, seq, b = e
            node = self._by_block.get(b)
            if (node is None or node.seq != seq
                    or node.last_access != stamp or node.ndev):
                continue  # stale
            if ref[b] != 0 or b in ex:
                aside.append(e)
                continue
            out.append(b)
            self._held[b] = e
        for e in aside:
            heapq.heappush(heap, e)
        self.victims += len(out)
        return out

    def peek_evictable(self, ref, exclude=()) -> Optional[int]:
        """The block :meth:`evict_lru` (or a demotion) would reclaim
        next, WITHOUT unlinking it — the engine reads the block's
        contents for demotion first, then commits via :meth:`demote` +
        :meth:`BlockPool.evict` (or :meth:`remove_block` when the host
        tier refused the entry)."""
        best = self.peek_victims(ref, 1, exclude)
        return best[0] if best else None

    def remove_block(self, block: int) -> List[int]:
        """Unlink a device-resident node without demoting it (plain
        eviction). Any host-resident children go with it — returns
        their handles for the caller to discard from the host pool."""
        return self._unlink(self._by_block[block])

    def evict_lru(self, ref, exclude=()) -> Optional[int]:
        """Unlink and return the least-recently-matched unreferenced
        device leaf's block (caller frees it via
        :meth:`BlockPool.evict`), or None when nothing is evictable.
        The no-host-tier path: engines WITH a tier peek first and
        demote instead."""
        best = self.peek_evictable(ref, exclude)
        if best is None:
            return None
        self.remove_block(best)
        return best
