"""Text → token ingestion for the LM stack — a copy of
:mod:`distkeras_tpu.data.text` (numpy only).

Byte-level tokenization (vocab 256) needs no external assets, handles
any UTF-8 text losslessly, and needs nothing
downloaded: the framework's own source tree is megabytes of
legitimate text to model. The pipeline is

    corpus_from_dir(dir)  ->  bytes
    pack_sequences(data, T)  ->  [N, T] int32 rows
    text_dataset(dir, T)  ->  (train PartitionedDataset, holdout)

and composes with everything downstream exactly like synthetic tokens:
``LMTrainer.train``, ``write_shards`` for disk streaming,
``PerplexityEvaluator``, ``generate``.

Reference: the reference ingests features via Spark DataFrame columns
(distkeras/transformers.py pipeline stages); it has no text/LM path at
all — this module is capability beyond parity, built in the reference's
column-oriented vocabulary (a ``tokens`` column of fixed-length rows).
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

import numpy as np

from distkeras_torch.data.dataset import PartitionedDataset

VOCAB = 256  # byte-level: ids ARE bytes
# document separator between files: NUL never occurs in text files, so
# the model gets an explicit boundary token without shrinking the vocab
DOC_SEP = 0

DEFAULT_EXTS = (".py", ".md", ".txt", ".rst", ".json", ".yaml", ".yml",
                ".toml", ".cfg", ".sh", ".c", ".h", ".cc", ".cpp")


def encode(text) -> np.ndarray:
    """str/bytes -> [n] int32 byte ids."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    return np.frombuffer(bytes(text), np.uint8).astype(np.int32)


def decode(ids) -> str:
    """[n] int ids -> str (invalid UTF-8 replaced, NUL separators kept
    visible as newlines so samples print cleanly)."""
    b = bytes(int(i) & 0xFF for i in np.asarray(ids).ravel())
    return b.replace(b"\x00", b"\n").decode("utf-8", errors="replace")


def iter_text_files(directory: str,
                    exts: Tuple[str, ...] = DEFAULT_EXTS):
    """Deterministic (sorted) walk of text files under ``directory``."""
    for root, dirs, files in os.walk(directory):
        dirs.sort()
        # skip VCS/cache dirs — binary blobs and duplicated content
        dirs[:] = [d for d in dirs
                   if d not in (".git", "__pycache__", ".pytest_cache",
                                "node_modules")]
        for f in sorted(files):
            if exts and not f.endswith(exts):
                continue
            yield os.path.join(root, f)


def corpus_from_dir(directory: str, exts: Tuple[str, ...] = DEFAULT_EXTS,
                    max_bytes: Optional[int] = None) -> np.ndarray:
    """Concatenate every text file under ``directory`` (sorted walk,
    DOC_SEP byte between files) into one [n] int32 id stream."""
    parts = []
    total = 0
    for path in iter_text_files(directory, exts):
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError:
            continue
        if not data:
            continue
        parts.append(encode(data))
        parts.append(np.asarray([DOC_SEP], np.int32))
        total += len(data) + 1
        if max_bytes is not None and total >= max_bytes:
            break
    if not parts:
        raise ValueError(
            f"no text files with extensions {exts} under {directory!r}"
        )
    out = np.concatenate(parts)
    return out[:max_bytes] if max_bytes is not None else out


def pack_sequences(ids: np.ndarray, seq_len: int) -> np.ndarray:
    """[n] stream -> [n // T, T] int32 rows (tail dropped): the standard
    packed-LM layout — every position supervises the next, documents
    separated by DOC_SEP."""
    ids = np.asarray(ids, np.int32).ravel()
    n = (len(ids) // seq_len) * seq_len
    if n == 0:
        raise ValueError(
            f"corpus of {len(ids)} tokens is shorter than one "
            f"sequence of {seq_len}"
        )
    return ids[:n].reshape(-1, seq_len)


def text_dataset(directory: str, seq_len: int,
                 holdout_frac: float = 0.05,
                 exts: Tuple[str, ...] = DEFAULT_EXTS,
                 max_bytes: Optional[int] = None,
                 num_partitions: int = 1,
                 tokens_col: str = "tokens",
                 seed: int = 0):
    """One call from a directory of text to LM-ready datasets.

    Returns ``(train, holdout)`` PartitionedDatasets with a
    ``tokens_col`` column of [N, T] rows. The holdout is a random row
    subset (seeded, disjoint) — report perplexity on it with
    :class:`~distkeras_torch.evaluators.PerplexityEvaluator`.
    """
    rows = pack_sequences(corpus_from_dir(directory, exts, max_bytes),
                          seq_len)
    n = len(rows)
    n_hold = max(1, int(n * holdout_frac)) if holdout_frac > 0 else 0
    if n_hold >= n:
        raise ValueError(
            f"holdout_frac={holdout_frac} leaves no training rows "
            f"(corpus has {n} sequences of {seq_len})"
        )
    perm = np.random.default_rng(seed).permutation(n)
    hold_rows = rows[perm[:n_hold]]
    train_rows = rows[perm[n_hold:]]
    train = PartitionedDataset.from_arrays(
        {tokens_col: train_rows}, num_partitions=num_partitions
    )
    holdout = (PartitionedDataset.from_arrays(
        {tokens_col: hold_rows}, num_partitions=1
    ) if n_hold else None)
    return train, holdout
