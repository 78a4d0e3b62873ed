"""The port's text ingestion (``distkeras_torch/data/text.py``, a numpy
copy) against the JAX package's on the same inputs: byte encode/decode,
the sorted file walk, the corpus with document separators and a byte
cap, packing, and the seeded train/holdout split — all equal exactly."""

import os

import numpy as np
import pytest

from distkeras_tpu.data import text as jt
from distkeras_torch.data import text as tt


def _tree(tmp_path):
    files = {"a.py": "print('héllo')\n", "sub/b.md": "# title\n\nbody\n",
             "sub/c.bin": "\x00\x01", "z.txt": "last file " * 50,
             ".git/x.py": "ignored", "empty.txt": ""}
    for rel, body in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(body)
    return str(tmp_path)


@pytest.mark.parametrize("s", ["", "ascii", "ünïcödé ✓", b"\xff\xfe raw"])
def test_encode_decode_match_jax(s):
    np.testing.assert_array_equal(tt.encode(s), jt.encode(s))
    assert tt.encode(s).dtype == np.int32
    ids = np.concatenate([jt.encode(s), [0, 300]]).astype(np.int64)
    assert tt.decode(ids) == jt.decode(ids)


def test_walk_and_corpus_match_jax(tmp_path):
    d = _tree(tmp_path)
    assert list(tt.iter_text_files(d)) == list(jt.iter_text_files(d))
    assert not any(".git" + os.sep in p for p in tt.iter_text_files(d))
    for cap in (None, 40):
        np.testing.assert_array_equal(tt.corpus_from_dir(d, max_bytes=cap),
                                      jt.corpus_from_dir(d, max_bytes=cap))
    with pytest.raises(ValueError, match="no text files"):
        tt.corpus_from_dir(d, exts=(".nope",))


def test_pack_and_text_dataset_match_jax(tmp_path):
    d = _tree(tmp_path)
    ids = jt.corpus_from_dir(d)
    np.testing.assert_array_equal(tt.pack_sequences(ids, 16),
                                  jt.pack_sequences(ids, 16))
    with pytest.raises(ValueError, match="shorter"):
        tt.pack_sequences(ids[:3], 16)
    (ttr, tho), (jtr, jho) = (tt.text_dataset(d, 16, holdout_frac=0.2,
                                              num_partitions=2, seed=3),
                              jt.text_dataset(d, 16, holdout_frac=0.2,
                                              num_partitions=2, seed=3))
    assert ttr.num_partitions == jtr.num_partitions == 2
    np.testing.assert_array_equal(ttr.column("tokens"), jtr.column("tokens"))
    np.testing.assert_array_equal(tho.column("tokens"), jho.column("tokens"))
    nohold, none = tt.text_dataset(d, 16, holdout_frac=0.0)
    assert none is None and nohold.num_rows == len(ids) // 16
