"""The one generator of serving requests, read from a mix's parameters.

Request ``i`` of a run is a pure function of the seed and ``i``, so any
number of requests can be drawn and a run never repeats a prompt.
Lengths are drawn so that every seed serves the same work: requests
come in blocks of ``block``, and each block holds the same ``block``
stratified quantiles of the length law (``log_uniform`` over
``prompt_len`` and over ``new_tokens``: ``lo (hi / lo) ** u`` at ``u =
(j + 0.5) / block``), the prompt lengths and the new-token counts each
in an order of their own that the seed and the block draw. Prompt
tokens are uniform over the vocabulary, unique to the request.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _stratified(lo: int, hi: int, n: int, law: str) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    if law == "log_uniform":
        v = lo * (hi / lo) ** u
    elif law == "uniform":
        v = lo + (hi - lo) * u
    else:
        raise ValueError(f"unknown length law {law!r}")
    return np.rint(v).astype(np.int64)


def _nonneg(seed: int) -> int:
    return int(seed) % (1 << 63)


def request(mix: dict, seed: int, vocab: int, i: int
            ) -> Tuple[np.ndarray, int]:
    """``(prompt int32 [P], max_new_tokens)`` of request ``i``."""
    n = mix["block"]
    blk, j = divmod(int(i), n)
    law = mix["length_law"]
    rng = np.random.default_rng([_nonneg(seed), blk])
    p = _stratified(*mix["prompt_len"], n, law)[rng.permutation(n)[j]]
    g = _stratified(*mix["new_tokens"], n, law)[rng.permutation(n)[j]]
    toks = np.random.default_rng([_nonneg(seed), blk, j, 1]).integers(
        0, vocab, size=int(p))
    return toks.astype(np.int32), int(g)
