"""The port's hand-written Hopper kernels against their plain PyTorch
versions on the card (``cuda`` marker: skipped where
``torch.cuda.is_available()`` is False — a CUDA kernel has no CPU mode).

This file imports neither jax nor the reference package, so the machine
with the card, which has no JAX, runs it without the JAX-side
``tests/conftest.py``::

    python -m pytest -m cuda --noconftest tests/test_torch_kernels.py

f32 is held to 1e-5 and bf16 to 1e-2, the plain version computed in f32
from the same inputs. The CPU half of each wrapper's contract (plain
version for CPU tensors, no launch counted) runs everywhere."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distkeras_torch.ops import paged_attention as pa  # noqa: E402
from distkeras_torch.ops import splash_prefill as sp  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _tables(rng, B, NB, nb, chains):
    tables = np.zeros((B, NB), np.int32)
    perm = rng.permutation(nb - 1) + 1
    off = 0
    for b, n in enumerate(chains):
        tables[b, :n] = perm[off:off + n]
        off += n
    return tables


def _paged_inputs(rng, B, T, H, Hk, hd, bs, NB, quant):
    nb = B * NB + 1
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    if quant:
        kp = rng.integers(-127, 128, size=(nb, bs, Hk, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, size=(nb, bs, Hk, hd)).astype(np.int8)
        # dequantized values within +-1.3, so bf16 output rounding stays
        # well under the 1e-2 bound
        ks = (rng.random(size=(nb, bs, Hk)) * 0.01).astype(np.float32)
        vs = (rng.random(size=(nb, bs, Hk)) * 0.01).astype(np.float32)
    else:
        kp = rng.normal(size=(nb, bs, Hk, hd)).astype(np.float32)
        vp = rng.normal(size=(nb, bs, Hk, hd)).astype(np.float32)
        ks = vs = None
    tables = _tables(rng, B, NB, nb, [NB, NB - 1, 1][:B])
    lens = np.asarray([NB * bs - T, 20, 0][:B], np.int32)
    return q, kp, vp, ks, vs, tables, lens


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,hd", [(1, 256), (5, 64), (33, 128)])
def test_paged_kernel_matches_plain(quant, dtype, T, hd):
    dev = _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    q, kp, vp, ks, vs, tables, lens = _paged_inputs(
        rng, 3, T, 8, 2, hd, 16, 4, quant)
    c = lambda a: None if a is None else torch.from_numpy(a).to(dev)  # noqa: E731
    qd, kd, vd = c(q).to(dt), c(kp), c(vp)
    if not quant:
        kd, vd = kd.to(dt), vd.to(dt)
    before = pa.paged_attention.launches
    got = pa.paged_attention(qd, kd, vd, c(tables), c(lens), c(ks), c(vs))
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    ref = pa.paged_attention_reference(
        qd.float(), kd if quant else kd.float(), vd if quant else vd.float(),
        c(tables), c(lens), c(ks), c(vs))
    assert got.dtype == dt and torch.isfinite(got.float()).all()
    tol = 1e-5 if dt == torch.float32 else 1e-2
    assert (got.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,hd,L", [(20, 128, 256), (64, 256, 512),
                                    (7, 64, 64)])
def test_splash_kernel_matches_plain(dtype, T, hd, L):
    dev = _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(4)
    B, H, Hk = 3, 8, 2
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev).to(dt)
               for s in ((B, T, H, hd), (B, L, Hk, hd), (B, L, Hk, hd)))
    starts = torch.tensor([0, L // 3, L - T], dtype=torch.int32, device=dev)
    before = sp.splash_prefill_attention.launches
    got = sp.splash_prefill_attention(q, k, v, starts)
    torch.cuda.synchronize()
    assert sp.splash_prefill_attention.launches == before + 1
    ref = sp.splash_prefill_reference(q.float(), k.float(), v.float(),
                                      starts)
    tol = 1e-5 if dt == torch.float32 else 1e-2
    assert (got.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _card()
    q = torch.zeros((1, 2, 4, 96), device=dev)  # hd 96: not compiled
    kp = torch.zeros((3, 16, 2, 96), device=dev)
    t = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    n = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        pa.paged_attention(q, kp, kp, t, n)
    with pytest.raises(TypeError):  # int64 tables
        pa.paged_attention(torch.zeros((1, 2, 4, 64), device=dev),
                           torch.zeros((3, 16, 2, 64), device=dev),
                           torch.zeros((3, 16, 2, 64), device=dev),
                           t.long(), n)
    with pytest.raises(ValueError):  # T == 1 is not a chunk
        sp.splash_prefill_attention(
            torch.zeros((1, 1, 4, 64), device=dev),
            torch.zeros((1, 32, 2, 64), device=dev),
            torch.zeros((1, 32, 2, 64), device=dev), n)


def test_wrappers_run_plain_only_for_cpu_tensors():
    """A CPU call takes the plain version and never touches the kernel
    library or its launch count."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=(1, 2, 4, 16)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(3, 16, 2, 16)).astype(np.float32))
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    lens = torch.tensor([5], dtype=torch.int32)
    before = pa.paged_attention.launches
    out = pa.paged_attention(q, kp, kp, tables, lens)
    assert pa.paged_attention.launches == before
    assert torch.equal(out, pa.paged_attention_reference(q, kp, kp, tables,
                                                         lens))
    k = torch.from_numpy(rng.normal(size=(1, 32, 2, 16)).astype(np.float32))
    starts = torch.tensor([7], dtype=torch.int32)
    before = sp.splash_prefill_attention.launches
    out = sp.splash_prefill_attention(q, k, k, starts)
    assert sp.splash_prefill_attention.launches == before
    assert torch.equal(out, sp.splash_prefill_reference(q, k, k, starts))
    with pytest.raises(ValueError):
        pa.paged_attention(q, kp, kp, tables, lens,
                           key_scales=torch.ones(3, 16, 2))
