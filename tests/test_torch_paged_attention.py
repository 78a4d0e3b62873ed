"""Port paged attention (distkeras_torch/ops/paged_attention.py) against
the reference Pallas kernel (distkeras_tpu/ops/paged_attention.py, run
in interpret mode on the CPU as its own tests run it): the same numpy
inputs through both, f32, atol 1e-5 — T in {1, 5} x MHA/GQA x int8
on/off with fragmented, trash-padded block tables, plus a zero-length
row. On the CPU the port's wrapper runs its plain version; the Hopper
kernel itself is held against that plain version on the card by
tests/test_torch_kernels.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distkeras_tpu.ops import paged_attention as jax_pa  # noqa: E402
from distkeras_torch.ops import paged_attention as pa  # noqa: E402


def _pool(rng, nb, bs, Hk, hd, quant):
    if quant:
        kp = rng.integers(-127, 128, size=(nb, bs, Hk, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, size=(nb, bs, Hk, hd)).astype(np.int8)
        ks = (rng.random(size=(nb, bs, Hk)) * 0.1).astype(np.float32)
        vs = (rng.random(size=(nb, bs, Hk)) * 0.1).astype(np.float32)
        return kp, vp, ks, vs
    kp = rng.normal(size=(nb, bs, Hk, hd)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, Hk, hd)).astype(np.float32)
    return kp, vp, None, None


def _both(q, kp, vp, tables, lens, ks=None, vs=None):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = jax_pa.paged_attention(j(q), j(kp), j(vp), j(tables), j(lens),
                                  j(ks), j(vs))
    got = pa.paged_attention(t(q), t(kp), t(vp), t(tables), t(lens),
                             t(ks), t(vs))
    return got.numpy(), np.asarray(want)


def _fragmented_tables(rng, B, NB, nb, chains):
    tables = np.zeros((B, NB), np.int32)
    perm = rng.permutation(nb - 1) + 1
    off = 0
    for b, n in enumerate(chains):
        tables[b, :n] = perm[off:off + n]
        off += n
    return tables


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("heads", ["mha", "gqa"])
@pytest.mark.parametrize("quant", [False, True])
def test_plain_matches_jax_kernel(T, heads, quant):
    """Shuffled physical pages, rows at different depths, short chains
    padded with the trash page 0 (tests/test_paged_kernel.py:69-96)."""
    rng = np.random.default_rng(0)
    B, bs, NB, hd = 3, 4, 4, 16
    H, Hk = (4, 4) if heads == "mha" else (8, 2)
    nb = B * NB + 1
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    kp, vp, ks, vs = _pool(rng, nb, bs, Hk, hd, quant)
    tables = _fragmented_tables(rng, B, NB, nb, [NB, NB - 1, NB])
    lens = np.asarray([NB * bs - T, 2, 5], np.int32)
    got, want = _both(q, kp, vp, tables, lens, ks, vs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_zero_len_rows():
    """Freshly admitted rows (seq_lens=0) attend exactly their own first
    tokens; no NaN anywhere (tests/test_paged_kernel.py:99-116)."""
    rng = np.random.default_rng(1)
    B, T, H, Hk, hd, bs, NB = 2, 3, 4, 2, 8, 4, 2
    nb = B * NB + 1
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    kp, vp, _, _ = _pool(rng, nb, bs, Hk, hd, False)
    tables = (rng.permutation(nb - 1)[:B * NB] + 1).reshape(B, NB).astype(
        np.int32)
    lens = np.asarray([0, 0], np.int32)
    got, want = _both(q, kp, vp, tables, lens)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gates_are_chosen_for_hopper():
    # the main path's shapes pass: hd 256 and 16-token pages, whatever
    # the query count, GQA group or page dtype (the TPU's sublane rules
    # on T * G and the stored itemsize do not carry over)
    assert pa.supports(256, 16)
    assert pa.supports(64, 16) and pa.supports(128, 16)
    # head dims and page sizes the kernel is not compiled for
    assert not pa.supports(96, 16)
    assert not pa.supports(256, 8)
    # preferred() is supports() on CUDA tensors only
    assert not pa.preferred(256, 16, device="cpu")
    assert pa.preferred(256, 16, device="cuda")
