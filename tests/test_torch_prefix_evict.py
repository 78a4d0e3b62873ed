"""The port's radix prefix index choosing eviction victims from a lazy
heap of candidate leaves (``distkeras_torch/serving/prefix.py``), on the
CPU:

- through seeded random sequences of insert, insert_host, match (COW
  frontiers included), demote, promote, drop_host, remove_block,
  peek_evictable, peek_victims and evict_lru, under random refcounts
  and exclusions, it picks the reference index's victims (a scan of
  every registered block) and keeps the reference's matches, registered
  blocks and host handles after every step;
- filled as unique 512-1536-token prompts at block 16 fill it (about
  4,000 blocks), it examines at most two heap entries a victim and its
  heap stays within twice the registered blocks;
- the router's affinity index past ``max_nodes`` drops the least recent
  placements, as the reference's does;
- a paged engine under eviction pressure exports the probes in its
  registry and ``stats()``, and streams what the same engine without a
  prefix cache streams.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401

from distkeras_tpu.serving.prefix import (  # noqa: E402
    RadixPrefixIndex as RefIndex,
)
from distkeras_tpu.serving.router import (  # noqa: E402
    PrefixAffinityIndex as RefAffinity,
)
from distkeras_torch.serving import RadixPrefixIndex  # noqa: E402
from distkeras_torch.serving.router import PrefixAffinityIndex  # noqa: E402


class _DictRef:
    """A refcount view over a dict: neither an array nor a list."""

    def __init__(self, d):
        self._d = d

    def __getitem__(self, b):
        return self._d.get(b, 0)


def _heap_bounded(idx):
    return len(idx._heap) <= 2 * len(idx)


class _Oracle:
    """One random operation sequence driven through both indices."""

    def __init__(self, seed, bs):
        self.rng = np.random.default_rng(seed)
        self.bs = bs
        self.ref_idx, self.idx = RefIndex(bs), RadixPrefixIndex(bs)
        self.seqs = [[]]
        self.next_block, self.next_handle = 1, 1
        self.blocks_used, self.handles_used = [], []

    # -- drawing --------------------------------------------------------

    def tokens(self):
        """A known sequence's prefix (any length, so walks stop mid
        block and COW frontiers appear) and a short random tail, over a
        vocabulary of 3 so that prompts share prefixes often."""
        r = self.rng
        base = self.seqs[int(r.integers(len(self.seqs)))]
        cut = int(r.integers(len(base) + 1))
        tail = r.integers(0, 3, size=int(r.integers(0, 3 * self.bs + 2)))
        out = list(base[:cut]) + [int(t) for t in tail]
        self.seqs.append(out)
        return out

    def fresh_blocks(self, n):
        out = list(range(self.next_block, self.next_block + n))
        self.next_block += n
        self.blocks_used += out
        return out

    def fresh_handles(self, n):
        out = list(range(self.next_handle, self.next_handle + n))
        self.next_handle += n
        self.handles_used += out
        return out

    def registered(self):
        return [b for b in self.blocks_used if self.ref_idx.contains_block(b)]

    def device_leaves(self):
        return [b for b in self.registered()
                if not any(c.resident == "device" for c in
                           self.ref_idx._by_block[b].children.values())]

    def refs(self):
        """A refcount view: a numpy array, a dict view or all zeros, with
        a random share of the blocks pinned."""
        r = self.rng
        pinned = float(r.choice([0.0, 0.3, 0.7]))
        arr = np.zeros(self.next_block + 1, np.int32)
        hot = r.random(arr.size) < pinned
        arr[hot] = r.integers(1, 4, size=int(hot.sum()))
        kind = int(r.integers(3))
        if kind == 0:
            return arr
        if kind == 1:
            return _DictRef({b: int(v) for b, v in enumerate(arr) if v})
        return _DictRef({})

    def exclude(self):
        r = self.rng
        ex = [b for b in self.registered() if r.random() < 0.2]
        return [tuple, list, set][int(r.integers(3))](ex)

    def pick(self, xs):
        return xs[int(self.rng.integers(len(xs)))] if xs else None

    # -- one step -------------------------------------------------------

    def both(self, name, *args):
        """Call ``name`` on both indices: equal results (a
        ``PrefixMatch`` by its fields), or the same exception type from
        both."""
        got = []
        for idx in (self.ref_idx, self.idx):
            try:
                out = getattr(idx, name)(*args)
            except (ValueError, KeyError) as e:
                got.append(("raise", type(e)))
                continue
            if name == "match":
                out = (out.blocks, out.host, out.cow, out.block_size)
            got.append(("ok", out))
        assert got[0] == got[1], (name, args, got)
        return got[0][1]

    def step(self):
        r, bs = self.rng, self.bs
        op = r.choice(["insert", "insert_host", "match", "demote",
                       "promote", "drop_host", "remove_block", "peek",
                       "peek_victims", "evict_lru", "count"],
                      p=[.2, .05, .2, .1, .07, .04, .05, .1, .07, .08, .04])
        if op == "insert":
            toks = self.tokens()
            n = len(toks) // bs - int(r.integers(0, 2))
            blocks = self.fresh_blocks(max(n, 0))
            reg = self.registered()
            if blocks and reg and r.random() < 0.05:
                blocks[int(r.integers(len(blocks)))] = self.pick(reg)
            self.both("insert", toks, blocks)
        elif op == "insert_host":
            toks = self.tokens()
            handles = self.fresh_handles(len(toks) // bs)
            held = [h for h in self.handles_used
                    if h in self.ref_idx._by_host]
            if handles and held and r.random() < 0.1:
                handles[-1] = self.pick(held)
            self.both("insert_host", toks, handles)
        elif op == "match":
            self.both("match", self.tokens())
        elif op == "demote":
            if r.random() < 0.5:
                blk = self.both("peek_evictable", self.refs(),
                                self.exclude())
            else:
                blk = self.pick(self.device_leaves())
            if blk is not None:
                self.both("demote", blk, self.fresh_handles(1)[0])
        elif op == "promote":
            # top-down: a host node right below a device node or the root
            tops = [h for h, n in self.ref_idx._by_host.items()
                    if n.parent.resident == "device"]
            h = self.pick(tops)
            if h is not None:
                self.both("promote", h, self.fresh_blocks(1)[0])
        elif op == "drop_host":
            held = [h for h in self.handles_used if h in self.ref_idx._by_host]
            h = self.pick(held) if held and r.random() < 0.8 else 10 ** 9
            self.both("drop_host", h)
        elif op == "remove_block":
            pool = (self.device_leaves() if r.random() < 0.8
                    else self.registered())
            blk = self.pick(pool)
            if blk is not None:
                self.both("remove_block", blk)
        elif op == "peek":
            self.both("peek_evictable", self.refs(), self.exclude())
        elif op == "peek_victims":
            ref, ex = self.refs(), self.exclude()
            n = int(r.integers(1, 8))
            want, seen = [], set(ex)
            while len(want) < n:
                b = self.ref_idx.peek_evictable(ref, seen)
                if b is None:
                    break
                want.append(b)
                seen.add(b)
            assert self.idx.peek_victims(ref, n, ex) == want
        elif op == "evict_lru":
            self.both("evict_lru", self.refs(), self.exclude())
        else:
            ref, ex = self.refs(), self.exclude()
            self.both("evictable_count", ref, ex)
        self.check()

    def check(self):
        a, b = self.ref_idx, self.idx
        assert len(a) == len(b) and a.host_count() == b.host_count()
        for blk in self.blocks_used:
            assert a.contains_block(blk) == b.contains_block(blk), blk
        for h in self.handles_used:
            # the reference has no has_host(): its map is read directly
            assert (h in a._by_host) == b.has_host(h), h
        assert _heap_bounded(b)


@pytest.mark.parametrize("bs", [1, 2, 4])
@pytest.mark.parametrize("seed", range(5))
def test_victims_match_reference_scan(seed, bs):
    o = _Oracle(seed, bs)
    for _ in range(500):
        o.step()
    # the sequence reached the paths the heap has to get right
    assert o.idx.victims > 20 and o.idx.host_count() + len(o.idx) > 0


def test_probes_per_victim_under_unique_long_prompts():
    """Unique prompts of 512-1536 tokens at block 16 over a pool of
    4,096 blocks, admitted as the engine admits them (each round's
    victims taken in one call, then removed; the full prompt blocks
    registered at release), then every registered block evicted with an all-zero
    refcount view: at most two heap entries examined a victim, and the
    heap never above twice the registered blocks."""
    bs, pool_blocks = 16, 4096
    rng = np.random.default_rng(0)
    idx = RadixPrefixIndex(bs)
    ref = np.zeros(pool_blocks + 1, np.int32)
    free = list(range(1, pool_blocks + 1))
    for _ in range(200):
        prompt = rng.integers(0, 8192, size=int(rng.integers(512, 1537)))
        need = -(-(prompt.size + 128) // bs)
        idx.match(prompt)
        while len(free) < need:  # rounds, as the engine's _alloc_blocks
            for b in idx.peek_victims(ref, need - len(free)):
                idx.remove_block(b)
                free.append(b)
        blocks = [free.pop() for _ in range(need)]
        idx.insert(prompt, blocks[:prompt.size // bs])
        free += [b for b in blocks if not idx.contains_block(b)]
        assert _heap_bounded(idx)
    assert len(idx) > 3900 and idx.victims > 5000
    filled = len(idx)
    while idx.evict_lru(np.zeros_like(ref)) is not None:
        assert _heap_bounded(idx)
    assert len(idx) == 0 and len(idx._heap) == 0
    assert idx.victims >= filled
    assert idx.victim_probes <= 2 * idx.victims


def test_affinity_index_cap_drops_least_recent_placements():
    """Past ``max_nodes`` the router's index drops the least recently
    placed or looked-up prompts' chunks, leaf first, as the reference's
    does."""
    port, ref = (PrefixAffinityIndex(block_size=4, max_nodes=8),
                 RefAffinity(block_size=4, max_nodes=8))
    prompts = {k: [k * 10 + i for i in range(8)] for k in range(5)}
    for idx in (port, ref):
        for k in range(4):
            idx.place(prompts[k], f"r{k}")
        idx.lookup(prompts[0] + [99])  # r0's chunks become the most recent
        idx.place(prompts[4], "r4")
    for k in range(5):
        assert port.lookup(prompts[k] + [99]) == ref.lookup(
            prompts[k] + [99])
    assert len(port) == len(ref) == 8
    assert port.lookup(prompts[1] + [99]) == (None, 0)
    assert port.lookup(prompts[0] + [99]) == ("r0", 8)
    assert port.lookup(prompts[4] + [99]) == ("r4", 8)
    # one owner's death strips exactly its chunks
    for idx in (port, ref):
        idx.forget("r2")
    assert port.lookup(prompts[2] + [99]) == (None, 0)
    assert len(port) == len(ref) == 6


def test_engine_exports_victim_probes_and_streams_as_without_cache():
    """Unique prompts through a paged engine of 20 blocks: the prefix
    cache fills and evicts; the probes reach the registry and
    ``stats()``; greedy streams equal the engine's without the cache."""
    _, _, pm = U.pair(cache_dtype="int8")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, U.V, size=int(rng.integers(17, 40)))
               .astype(np.int32) for _ in range(12)]
    cfgs = U.greedy([6] * len(prompts))

    def engine(**kw):
        return U.port_engine(pm, paged=True, num_blocks=20, **kw)

    eng = engine()
    got = U.serve(eng, prompts, cfgs)
    assert got == U.serve(engine(prefix_cache=False), prompts, cfgs)
    s = eng.stats()
    assert s["prefix_victims"] > 0
    assert s["prefix_victims"] <= s["prefix_victim_probes"] \
        <= 2 * s["prefix_victims"]
    reg = eng.registry
    assert reg.counter("serving_prefix_victim_probes_total").value \
        == s["prefix_victim_probes"]
    assert reg.counter("serving_block_evictions_total").value \
        == s["prefix_victims"]
    assert "serving_prefix_victim_probes_total" in reg.collect()
