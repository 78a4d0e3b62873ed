"""The port's hand-written Hopper kernels against their plain PyTorch
versions on the card (``cuda`` marker: skipped where
``torch.cuda.is_available()`` is False — a CUDA kernel has no CPU mode).

This file imports neither jax nor the reference package, so the machine
with the card, which has no JAX, runs it without the JAX-side
``tests/conftest.py``::

    python -m pytest -m cuda --noconftest tests/test_torch_kernels.py

f32 is held to 1e-5 and bf16 to 1e-2, the plain version computed in f32
from the same inputs. The causal training kernels (bf16 only) hold O to
1e-2 abs (v drawn at std 0.5, so bf16's output rounding of |O| < 2
stays under 4e-3), lse to 1e-3 abs, and each gradient to 2e-2 of the
plain version's max abs value (bf16 gradients at long T are not O(1);
1e-4 abs more covers a row whose true gradient is 0); the ring's pair
kernels are held to the same bounds, with a nonzero lse cotangent. The
CPU half of
each wrapper's contract (plain version for CPU tensors, no launch
counted) runs everywhere."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distkeras_torch.ops import paged_attention as pa  # noqa: E402
from distkeras_torch.ops import pallas_attention as fa  # noqa: E402
from distkeras_torch.ops import pallas_pair as pp  # noqa: E402
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


def _causal_inputs(dev, B, T, H, hd, seed):
    rng = np.random.default_rng(seed)
    mk = lambda s=1.0: torch.from_numpy(  # noqa: E731
        (s * rng.standard_normal((B, T, H, hd))).astype(np.float32)).to(
            dev).to(torch.bfloat16)
    return mk(), mk(), mk(0.5), mk()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd", [(2, 200, 2, 64), (1, 130, 2, 256),
                                      (2, 64, 1, 128), (1, 1, 1, 256),
                                      (1, 640, 2, 256)])
def test_causal_kernels_match_plain(B, T, H, hd):
    dev = _card()
    q, k, v, do = _causal_inputs(dev, B, T, H, hd, seed=T)
    before = [f.launches for f in (fa.causal_attention_fwd,
                                   fa.causal_attention_dq,
                                   fa.causal_attention_dkv)]
    out, lse = fa.causal_attention_fwd(q, k, v)
    dq = fa.causal_attention_dq(q, k, v, out, lse, do)
    dk, dv = fa.causal_attention_dkv(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    after = [f.launches for f in (fa.causal_attention_fwd,
                                  fa.causal_attention_dq,
                                  fa.causal_attention_dkv)]
    assert after == [b + 1 for b in before]
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    ref_out, ref_lse = fa.causal_attention_reference(q, k, v)
    assert (out.float() - ref_out).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    for got, ref in zip((dq, dk, dv), fa.causal_attention_bwd_reference(
            q, k, v, out, lse, do)):
        assert torch.isfinite(got.float()).all()
        err = (got.float() - ref).abs().max().item()
        assert err <= 2e-2 * ref.abs().max().item() + 1e-4


@pytest.mark.cuda
def test_causal_autograd_launches_the_three_kernels():
    """The autograd Function on CUDA tensors: forward kernel, then dq and
    dk/dv in the backward, each gradient in its primal's dtype, equal to
    the direct wrapper calls."""
    dev = _card()
    q, k, v, do = _causal_inputs(dev, 2, 192, 2, 128, seed=5)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    before = (fa.causal_attention_fwd.launches, fa.causal_attention_dq.launches,
              fa.causal_attention_dkv.launches)
    o = fa.pallas_causal_attention(qq, kk, vv)
    o.backward(do)
    torch.cuda.synchronize()
    assert (fa.causal_attention_fwd.launches, fa.causal_attention_dq.launches,
            fa.causal_attention_dkv.launches) == tuple(b + 1 for b in before)
    out, lse = fa.causal_attention_fwd(q, k, v)
    assert torch.equal(o, out)
    assert torch.equal(qq.grad, fa.causal_attention_dq(q, k, v, out, lse, do))
    dk, dv = fa.causal_attention_dkv(q, k, v, out, lse, do)
    assert torch.equal(kk.grad, dk) and torch.equal(vv.grad, dv)


@pytest.mark.cuda
def test_causal_kernels_take_unaligned_views():
    """Contiguous views that start off a 16-byte boundary are copied to
    an aligned buffer before launch: same results as aligned inputs."""
    dev = _card()
    ts = _causal_inputs(dev, 1, 96, 2, 64, seed=6)
    moved = []
    for t in ts:  # the same values, starting one bf16 element in
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.flatten()
        moved.append(flat[1:].view(t.shape))
    assert all(t.data_ptr() % 16 for t in moved)
    outs = []
    for q, k, v, do in (ts, moved):
        out, lse = fa.causal_attention_fwd(q, k, v)
        outs.append((out, lse, fa.causal_attention_dq(q, k, v, out, lse, do),
                     *fa.causal_attention_dkv(q, k, v, out, lse, do)))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_causal_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _card()
    x = torch.zeros((1, 64, 2, 128), device=dev)  # f32: bf16 kernels only
    with pytest.raises(ValueError, match="blocked"):
        fa.causal_attention_fwd(x, x, x)
    y = torch.zeros((1, 64, 2, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # hd 96: not compiled
        fa.pallas_causal_attention(y, y, y)
    assert not fa.preferred(64, 128, torch.float32, dev)
    assert fa.preferred(2048, 256, torch.bfloat16, dev)


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
    qb = q.to(torch.bfloat16)
    before = fa.causal_attention_fwd.launches
    out, lse = fa.causal_attention_fwd(qb, qb, qb)
    assert fa.causal_attention_fwd.launches == before
    ref_out, ref_lse = fa.causal_attention_reference(qb, qb, qb)
    assert torch.equal(out, ref_out.to(torch.bfloat16))
    assert torch.equal(lse, ref_lse)
    assert not fa.preferred(2048, 256, torch.bfloat16, "cpu")


def _pair_inputs(dev, B, Tq, Tk, H, hd, seed):
    """Pre-scaled q (logits O(1)), v at std 0.5, and both cotangents."""
    rng = np.random.default_rng(seed)
    mk = lambda shape, s: torch.from_numpy(  # noqa: E731
        (s * rng.standard_normal(shape)).astype(np.float32)).to(dev)
    q = mk((B, Tq, H, hd), hd ** -0.5).to(torch.bfloat16)
    k = mk((B, Tk, H, hd), 1.0).to(torch.bfloat16)
    v = mk((B, Tk, H, hd), 0.5).to(torch.bfloat16)
    do = mk((B, Tq, H, hd), 1.0).to(torch.bfloat16)
    return q, k, v, do, mk((B, Tq, H), 1.0)


def _pair_launches():
    return [dict(f.launches) for f in (pp.pair_attention_fwd,
                                        pp.pair_attention_dq,
                                        pp.pair_attention_dkv)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal,B,Tq,Tk,H,hd", [
    (True, 2, 200, 200, 2, 64), (False, 2, 200, 136, 2, 64),
    (True, 1, 130, 130, 2, 256), (False, 1, 64, 320, 2, 256),
    (False, 2, 96, 96, 1, 128), (True, 1, 1, 1, 1, 256)])
def test_pair_kernels_match_plain(causal, B, Tq, Tk, H, hd):
    dev = _card()
    q, k, v, do, dlse = _pair_inputs(dev, B, Tq, Tk, H, hd, seed=Tq + Tk)
    variant = "wedge" if causal else "rect"
    before = _pair_launches()
    o, lse = pp.pair_attention_fwd(q, k, v, causal)
    dq = pp.pair_attention_dq(q, k, v, o, lse, do, dlse, causal)
    dk, dv = pp.pair_attention_dkv(q, k, v, o, lse, do, dlse, causal)
    torch.cuda.synchronize()
    for b, a in zip(before, _pair_launches()):
        assert a[variant] == b[variant] + 1
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert lse.shape == (B, Tq, H) and lse.dtype == torch.float32
    ref_o, ref_lse = pp.pair_attention_reference(q, k, v, causal)
    assert (o.float() - ref_o).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    for got, ref in zip((dq, dk, dv), pp.pair_attention_bwd_reference(
            q, k, v, o, lse, do, dlse, causal)):
        assert torch.isfinite(got.float()).all()
        err = (got.float() - ref).abs().max().item()
        assert err <= 2e-2 * ref.abs().max().item() + 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_pair_autograd_launches_and_takes_strided_views(causal):
    """Chunks of a fused qkv projection (strided views, as the ring hands
    them over) give the results of contiguous copies; the autograd
    Function launches each kernel once and folds in the lse cotangent."""
    dev = _card()
    B, C, H, hd = 2, 96, 2, 128
    q, _, _, do, dlse = _pair_inputs(dev, B, C, C, H, hd, seed=9)
    qkv = torch.randn((B, 2 * C, 3, H, hd), device=dev).to(torch.bfloat16)
    k, v = qkv[:, C:, 1], qkv[:, C:, 2]
    assert not k.is_contiguous()
    o, lse = pp.pair_attention_fwd(q, k, v, causal)
    o2, lse2 = pp.pair_attention_fwd(q, k.contiguous(), v.contiguous(),
                                     causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    before = _pair_launches()
    oo, ll = pp.pallas_pair_attention(qq, kk, vv, causal)
    ((oo.float() * do.float()).sum() + (ll * dlse).sum()).backward()
    torch.cuda.synchronize()
    variant = "wedge" if causal else "rect"
    for b, a in zip(before, _pair_launches()):
        assert a[variant] == b[variant] + 1
    dq = pp.pair_attention_dq(q, k, v, o, lse, do, dlse, causal)
    dk, dv = pp.pair_attention_dkv(q, k, v, o, lse, do, dlse, causal)
    assert torch.equal(qq.grad, dq)
    assert torch.equal(kk.grad, dk) and torch.equal(vv.grad, dv)


@pytest.mark.cuda
def test_pair_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _card()
    x = torch.zeros((1, 64, 2, 128), device=dev)  # f32: bf16 kernels only
    with pytest.raises(ValueError, match="pair_supports"):
        pp.pair_attention_fwd(x, x, x)
    y = torch.zeros((1, 64, 2, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="pair_supports"):
        pp.pallas_pair_attention(y, y, y, True)
    z = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="Tq == Tk"):
        pp.pair_attention_fwd(z, z[:, :32], z[:, :32], True)
