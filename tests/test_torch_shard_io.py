"""The port's disk-sharded datasets (``distkeras_torch/data/shard_io.py``)
against the JAX package's on the CPU, from the same seeded numpy columns:

- a directory written by either package reads in the other, bit for bit
  (meta.json, every shard file, every column);
- ``batches(shuffle_seed=s, shards=...)`` yields the same rows in the
  same order as the reference's (two-level shuffle, leftover carry,
  remainder batch);
- the bf16 cast (``cast_f32_bf16`` and the fused gather-cast) gives the
  reference's bits, NaN (payloads included), Inf, halfway and subnormal
  cases, with the native library and without it;
- ``ShardRowSource``, ``map_shards``, the write-time dtype checks and an
  abandoned stream behave as the reference's do.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distkeras_tpu.data import shard_io as jsio  # noqa: E402
from distkeras_tpu.data.dataset import PartitionedDataset as JDS  # noqa: E402
from distkeras_torch.data import shard_io as tsio  # noqa: E402
from distkeras_torch.data.dataset import PartitionedDataset as TDS  # noqa: E402
from torch_spawn_util import one_thread  # noqa: E402,F401


def _cols(n=53, seed=0):
    rng = np.random.default_rng(seed)
    return {"features": rng.normal(size=(n, 3, 2)).astype(np.float32),
            "label": rng.integers(0, 5, size=n).astype(np.int64),
            "weight": rng.random(size=n).astype(np.float64)}


def _same_dirs(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


@pytest.mark.parametrize("rows_per_shard", [None, 16, 64])
def test_directories_cross_read_bit_for_bit(tmp_path, rows_per_shard):
    cols = _cols()
    t = tsio.write_shards(TDS.from_arrays(cols, 3), str(tmp_path / "t"),
                          rows_per_shard)
    j = jsio.write_shards(JDS.from_arrays(cols, 3), str(tmp_path / "j"),
                          rows_per_shard)
    _same_dirs(t, j)
    for reader, d in ((tsio.ShardedDataset, j), (jsio.ShardedDataset, t)):
        sd = reader(d)
        ref = jsio.ShardedDataset(j)
        assert sd.shard_rows == ref.shard_rows and sd.columns == ref.columns
        for i in range(sd.num_shards):
            got, want = sd.read_shard(i), ref.read_shard(i)
            for c in want:
                assert got[c].dtype == want[c].dtype
                np.testing.assert_array_equal(got[c], want[c])
    loaded = tsio.ShardedDataset(j).load()
    for c in cols:
        np.testing.assert_array_equal(loaded.column(c), cols[c])


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    return x


@pytest.mark.parametrize("seed,shards,drop", [(None, None, True),
                                              (3, None, True),
                                              (7, [0, 2], True),
                                              (5, None, False)])
def test_batches_match_the_reference_order(tmp_path, seed, shards, drop):
    cols = _cols(61, seed=1)
    tsio.write_shards(TDS.from_arrays(cols), str(tmp_path / "d"),
                      rows_per_shard=17)
    kw = dict(shuffle_seed=seed, shards=shards, drop_remainder=drop,
              cast_bf16=["features"])
    got = list(tsio.ShardedDataset(str(tmp_path / "d")).batches(8, **kw))
    want = list(jsio.ShardedDataset(str(tmp_path / "d")).batches(8, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert isinstance(g["features"], torch.Tensor)
        assert g["features"].dtype == torch.bfloat16
        for c in w:
            np.testing.assert_array_equal(_bits(g[c]), _bits(w[c]))


def _edge_values():
    u32 = np.array([
        0x7F800000, 0xFF800000,  # +-inf
        0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFC12345, 0x7FFFFFFF,  # NaNs
        0x3F808000, 0x3F818000, 0x3F808001, 0x3F80FFFF,  # halfway / near
        0x00000001, 0x807FFFFF, 0x00400000,  # subnormals
        0x7F7FFFFF, 0xFF7FFFFF,  # +-max finite (rounds to inf)
        0x00000000, 0x80000000, 0x3F800000], np.uint32)
    rng = np.random.default_rng(0)
    return np.concatenate([u32, rng.integers(0, 2**32, 3985, dtype=np.uint64)
                           .astype(np.uint32)]).view(np.float32)


@pytest.mark.parametrize("native", [True, False])
def test_bf16_cast_bits_match_the_reference(monkeypatch, native):
    x = _edge_values().reshape(-1, 7)
    want = _bits(jsio.cast_f32_bf16(x))
    if not native:
        monkeypatch.setattr(tsio, "_load_native", lambda: None)
    else:
        assert tsio.native_dataio_active()
    got = tsio.cast_f32_bf16(x)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(_bits(got), want)
    sd_cls = tsio.ShardedDataset
    idx = np.arange(len(x))[::-1].copy()
    np.testing.assert_array_equal(
        _bits(sd_cls._gather(None, x, idx, True)), want[idx])


def test_narrow_cast_takes_the_same_bits():
    from distkeras_torch.utils.transfer import narrow_cast, pad_to_rows
    from distkeras_tpu.utils.transfer import pad_to_rows as jpad

    x = _edge_values().reshape(-1, 4)
    np.testing.assert_array_equal(_bits(narrow_cast(x, torch.bfloat16)),
                                  _bits(jsio.cast_f32_bf16(x)))
    np.testing.assert_array_equal(pad_to_rows(x[:3], 8), jpad(x[:3], 8))
    assert pad_to_rows(x, 2) is x


def test_row_source_and_map_shards_match_the_reference(tmp_path):
    cols = _cols(40, seed=2)
    d = tsio.write_shards(TDS.from_arrays(cols), str(tmp_path / "d"), 12)
    src = tsio.ShardRowSource(d, cache_shards=1)
    assert len(src) == 40
    for i in (0, 11, 12, 39, -1):
        row = src[i]
        for c in cols:
            np.testing.assert_array_equal(row[c], cols[c][i])
    with pytest.raises(IndexError):
        src[40]

    def fn(shard):
        return {"x2": shard["features"] * 2, "label": shard["label"]}

    t = tsio.map_shards(tsio.ShardedDataset(d), fn, str(tmp_path / "t"))
    j = jsio.map_shards(jsio.ShardedDataset(d), fn, str(tmp_path / "j"))
    _same_dirs(t, j)
    with pytest.raises(ValueError, match="ragged"):
        tsio.map_shards(tsio.ShardedDataset(d),
                        lambda s: {"a": s["label"], "b": s["label"][:1]},
                        str(tmp_path / "bad"))


def test_write_checks_raise_like_the_reference(tmp_path):
    parts = [{"x": np.zeros((2, 3), np.float32)},
             {"x": np.zeros((2, 4), np.float32)}]
    with pytest.raises(ValueError, match="row shape"):
        tsio.write_shards(TDS(parts), str(tmp_path / "a"))
    parts = [{"x": np.zeros(2, np.int8)}, {"x": np.array([300, 1])}]
    with pytest.raises(ValueError, match="survive"):
        tsio.write_shards(TDS(parts), str(tmp_path / "b"))
    parts = [{"x": np.zeros(2, np.float16)}, {"x": np.array([1e6, 1.0])}]
    with pytest.raises(ValueError, match="overflows"):
        tsio.write_shards(TDS(parts), str(tmp_path / "c"))
    parts = [{"x": np.zeros(2, np.float32)},
             {"x": np.zeros(2, np.float64)}]
    tsio.write_shards(TDS(parts), str(tmp_path / "d"))
    jsio.write_shards(JDS(parts), str(tmp_path / "e"))
    _same_dirs(str(tmp_path / "d"), str(tmp_path / "e"))


def test_abandoned_stream_stops_its_producer(tmp_path):
    import threading

    d = tsio.write_shards(TDS.from_arrays(_cols(200)), str(tmp_path / "d"),
                          20)
    before = threading.active_count()
    it = tsio.ShardedDataset(d).batches(4, prefetch=1)
    next(it)
    it.close()
    assert threading.active_count() <= before
