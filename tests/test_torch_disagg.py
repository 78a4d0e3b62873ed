"""Port ServingEngine's KV-block export / import (disaggregated serving,
engine level) on the CPU: blocks exported by a prefill replica and
imported by a decode replica — straight into device blocks, or into the
host tier and RESTORING from there, into chunked and monolithic
replicas — serve streams bit-identical to solo ``generate()`` with the
migrated span served from cache; a lost race with eviction exports a
shrinking prefix and recomputes identically; a slot engine has nothing
to migrate; a mismatched layout is refused; chunks already cached keep
their resident copy."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401

from distkeras_torch.models.transformer import generate  # noqa: E402

BS = 8


@pytest.fixture(scope="module")
def trio():
    return U.pair(cache_dtype="int8", max_len=128)


@pytest.fixture(scope="module")
def pm(trio):
    return trio[2]


def _engine(pm, *, role="mixed", chunk=16, num_blocks=64,
            host_blocks=None, slots=2):
    return U.port_engine(pm, slots=slots, paged=True, block_size=BS,
                         num_blocks=num_blocks, prefill_chunk=chunk,
                         role=role, host_blocks=host_blocks)


def _migrate(src, dst, prompt):
    src.submit(prompt, max_new_tokens=1)
    src.drain()
    exp = src.export_blocks(prompt)
    assert exp["tokens"] > 0
    return exp, dst.import_blocks(prompt, exp["blocks"])


@pytest.mark.parametrize("chunk,host_blocks", [(16, None), (None, None),
                                               (16, 32)])
def test_migration_parity(pm, chunk, host_blocks):
    prompt = np.random.default_rng(0).integers(0, U.V, size=48).astype(
        np.int32)
    src = _engine(pm, role="prefill")
    dst = _engine(pm, role="decode", chunk=chunk, host_blocks=host_blocks)
    exp, imp = _migrate(src, dst, prompt)
    assert imp["imported"] == len(exp["blocks"]) == 5
    assert imp["mode"] == ("host" if host_blocks else "device")
    req = dst.submit(prompt, max_new_tokens=8, temperature=0.6, seed=3)
    dst.drain()
    want = generate(pm, prompt[None], 8, temperature=0.6, seed=3)
    assert req.stream.tokens(timeout=10) == want[0, 48:].tolist()
    assert dst.prefix_hit_tokens == imp["tokens"] > 0
    if host_blocks:
        assert dst.restores == imp["imported"]
    assert src.stats()["kv_blocks_exported"] == len(exp["blocks"])
    assert dst.stats()["kv_blocks_imported"] == imp["imported"]


def test_migrated_greedy_equals_jax_engine(trio):
    """The same migration through JAX engines (gather attends) and port
    engines: the decode replicas' greedy streams are equal."""
    jm, params, pm = trio
    prompt = np.random.default_rng(4).integers(0, U.V, size=40).astype(
        np.int32)

    def run(make):
        src, dst = make("prefill"), make("decode")
        _migrate(src, dst, prompt)
        return U.serve(dst, [prompt], U.greedy((10,)))[0], dst

    want, jdst = run(lambda role: U.jax_engine(
        jm, params, paged=True, block_size=BS, num_blocks=64,
        prefill_chunk=16, role=role))
    got, dst = run(lambda role: _engine(pm, role=role))
    assert got == want
    assert dst.prefix_hit_tokens == jdst.prefix_hit_tokens == 32


def test_exported_blocks_carry_the_cache_layout(pm):
    """One exported block is every paged leaf's ``[block_size, ...]``
    slice, in the cache's dtypes (int8 values, f32 scales) — the device
    contents, byte for byte."""
    prompt = np.random.default_rng(1).integers(0, U.V, size=24).astype(
        np.int32)
    src = _engine(pm)
    src.submit(prompt, max_new_tokens=1)
    src.drain()
    exp = src.export_blocks(prompt)
    leaves = list(src._cache.leaves())
    m = src.prefix.match(prompt)
    assert exp["tokens"] == 16 and len(exp["blocks"]) == len(m.blocks)
    for blk, got in zip(m.blocks, exp["blocks"]):
        for leaf, a in zip(leaves, got):
            assert a.dtype == leaf.dtype and torch.equal(a, leaf[blk])


def test_export_loses_race_with_eviction(pm):
    rng = np.random.default_rng(2)
    a = rng.integers(0, U.V, size=48).astype(np.int32)
    src = _engine(pm, role="prefill", num_blocks=10)
    src.submit(a, max_new_tokens=1)
    src.drain()
    assert src.export_blocks(a)["tokens"] == 40
    for _ in range(2):
        b = rng.integers(0, U.V, size=48).astype(np.int32)
        src.submit(b, max_new_tokens=1)
        src.drain()
    exp = src.export_blocks(a)
    assert exp["tokens"] == 0 and exp["blocks"] == []
    dst = _engine(pm, role="decode")
    req = dst.submit(a, max_new_tokens=6)
    dst.drain()
    assert req.stream.tokens(timeout=10) == generate(
        pm, a[None], 6)[0, 48:].tolist()


def test_slot_engine_has_no_blocks_to_migrate(pm):
    eng = U.port_engine(pm, prefill_chunk=16)
    assert eng.export_blocks([1, 2, 3]) == {"tokens": 0, "blocks": []}
    with pytest.raises(ValueError, match="paged"):
        eng.import_blocks([1, 2, 3], [[np.zeros((BS, 2, 16))]])


def test_import_rejects_mismatched_layout(pm):
    dst = _engine(pm)
    with pytest.raises(ValueError, match="cache layout"):
        dst.import_blocks(np.arange(16, dtype=np.int32),
                          [[np.zeros((BS, 1, 1), np.float32)]])


def test_import_dedups_resident_chunks(pm):
    prompt = np.random.default_rng(3).integers(0, U.V, size=48).astype(
        np.int32)
    src = _engine(pm, role="prefill")
    dst = _engine(pm, role="decode")
    exp, _ = _migrate(src, dst, prompt)
    before = dst.pool.stats()
    dst.import_blocks(prompt, exp["blocks"])
    assert dst.pool.stats() == before
