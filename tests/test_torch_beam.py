"""Port ``beam_search`` (``distkeras_torch.models.transformer``) on the
CPU against the reference's on the same weights, and the three
semantics of the reference's own tests: beam 1 is greedy, a full-width
beam is exhaustive search, and finished beams freeze on ``eos_id``
(with and without the GNMT length penalty)."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401

from distkeras_torch.models.transformer import (  # noqa: E402
    beam_search,
    generate,
)


def _jax_beam(jm, params, prompt, n, **kw):
    from distkeras_tpu.models.transformer import beam_search as jbeam

    return np.asarray(jbeam(jm, params, U.jnp.asarray(prompt), n, **kw))


@pytest.fixture(scope="module")
def trio():
    return U.pair(cache_dtype="int8")


@pytest.mark.parametrize("kw", [
    dict(beam_size=3),
    dict(beam_size=4, eos="probe", length_penalty=0.6),
])
def test_beams_equal_jax(trio, kw):
    jm, params, pm = trio
    kw = dict(kw)
    prompt = np.random.default_rng(0).integers(0, U.V, size=(2, 9)).astype(
        np.int32)
    if kw.pop("eos", None):
        free = beam_search(pm, prompt, 8, **kw)
        kw["eos_id"] = int(free[0, 10])
    want = _jax_beam(jm, params, prompt, 8, **kw)
    got = beam_search(pm, prompt, 8, **kw)
    assert got.tolist() == want.tolist()


def test_beam_size_one_equals_greedy(trio):
    _, _, pm = trio
    prompt = np.asarray([[2, 4, 6], [1, 3, 5]], np.int32)
    assert torch.equal(beam_search(pm, prompt, 7, beam_size=1),
                       generate(pm, prompt, 7))


def test_full_width_beam_finds_global_optimum():
    """With beam_size >= every candidate at every depth, beam search IS
    exhaustive search: the argmax-logprob continuation over all V**h."""
    V, h = 6, 3
    _, _, pm = U.pair(seed=9, vocab_size=V, d_model=32, num_heads=1,
                      num_kv_heads=None, max_len=16)
    prompt = np.asarray([[1, 2]], np.int32)
    out = beam_search(pm, prompt, h, beam_size=V ** h)
    conts = np.asarray(list(itertools.product(range(V), repeat=h)))
    seqs = np.concatenate([np.repeat(prompt, len(conts), 0), conts], 1)
    with torch.no_grad():
        # every continuation in one batch: [V**h, 2 + h - 1, V]
        lp = torch.log_softmax(pm(torch.as_tensor(seqs[:, :-1])).float(),
                               -1).numpy()
    rows, steps = np.arange(len(conts))[:, None], np.arange(h)[None]
    scores = lp[rows, 1 + steps, conts].sum(-1)
    assert out[0].tolist() == seqs[int(np.argmax(scores))].tolist()


def _assert_eos_freezes(row, Tp, eos):
    seen = False
    for t in row[Tp:]:
        if seen:
            assert t == eos, row
        seen = seen or (t == eos)
    assert seen, (row, eos)


@pytest.mark.parametrize("alpha", [0.0, 0.6])
def test_beam_eos_freezes_finished_hypotheses(trio, alpha):
    _, _, pm = trio
    prompt = np.asarray([[3, 1]], np.int32)
    free = beam_search(pm, prompt, 8, beam_size=3, length_penalty=alpha)
    eos = int(free[0, 2])
    out = beam_search(pm, prompt, 8, beam_size=3, eos_id=eos,
                      length_penalty=alpha)
    _assert_eos_freezes(out[0].tolist(), 2, eos)


def test_beam_search_validates(trio):
    _, _, pm = trio
    with pytest.raises(ValueError, match="beam_size"):
        beam_search(pm, np.zeros((1, 2), np.int32), 2, beam_size=0)
    with pytest.raises(ValueError, match="max_len"):
        beam_search(pm, np.zeros((1, 90), np.int32), 10)
    with pytest.raises(ValueError, match="prompt"):
        beam_search(pm, np.zeros((2,), np.int32), 2)
