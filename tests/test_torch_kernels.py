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

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distkeras_torch.ops import paged_attention as pa  # noqa: E402
from distkeras_torch.ops import pallas_attention as fa  # noqa: E402
from distkeras_torch.ops import pallas_pair as pp  # noqa: E402
from distkeras_torch.ops import splash_prefill as sp  # noqa: E402
from torch_spawn_util import one_thread  # noqa: E402,F401


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
@pytest.mark.parametrize("T,hd", [(1, 256), (5, 64), (33, 128), (64, 64)])
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
                                    (7, 64, 64), (64, 64, 1056)])
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


def _split_keys(dev, B, Hk, TG, nkeys):
    """Keys per split of the kernels' plan for this launch (both
    routes)."""
    _, splits, per = sp.split_plan(B, Hk, TG, nkeys, sp.sm_count(dev))
    assert splits > 1  # the cases below exercise the merge
    return per * sp.STAGE_KEYS


# T * G off multiples of 16 and 64 (T=5, T=17), G=1 and G=8, hd 64 and 128
_EDGES = [(5, 8, 2, 128), (17, 8, 2, 64), (3, 2, 2, 256), (2, 16, 2, 128)]
# the f32 serving shapes: phase 4's verify window (4 heads of 64 over 2 KV
# heads) and phase 17's chunk (4 heads of 64, no GQA); paged also decode
_F32_EDGES = [(5, 4, 2, 64), (64, 4, 4, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,H,Hk,hd", _EDGES + _F32_EDGES + [(1, 4, 4, 64)])
def test_paged_kernel_split_edges(quant, dtype, T, H, Hk, hd):
    """Four rows over 32 pages: a zero-length row, a row whose last query
    ends on a split boundary, one whose first query starts on one, and a
    deep row; the short rows' tails point at the trash page, so their
    last splits are all trash."""
    dev = _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(11)
    B, bs, NB = 4, 16, 32
    split = _split_keys(dev, B, Hk, T * (H // Hk), NB * bs)
    q, kp, vp, ks, vs, _, _ = _paged_inputs(rng, B, T, H, Hk, hd, bs, NB,
                                            quant)
    lens = np.asarray([0, split - T, split, NB * bs - T - 5], np.int32)
    tables = _tables(rng, B, NB, B * NB + 1,
                     [-(-(int(n) + T) // bs) for n in lens])
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
@pytest.mark.parametrize("T,H,Hk,hd", _EDGES + _F32_EDGES)
def test_splash_kernel_split_edges(dtype, T, H, Hk, hd):
    """Rows at depth 0, ending on a split boundary, starting on one, and
    at the deepest start, over L=512 (many splits)."""
    dev = _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(12)
    B, L = 4, 512
    split = _split_keys(dev, B, Hk, T * (H // Hk), L)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev).to(dt)
               for s in ((B, T, H, hd), (B, L, Hk, hd), (B, L, Hk, hd)))
    starts = torch.tensor([0, split - T, split, L - T], dtype=torch.int32,
                          device=dev)
    before = sp.splash_prefill_attention.launches
    got = sp.splash_prefill_attention(q, k, v, starts)
    torch.cuda.synchronize()
    assert sp.splash_prefill_attention.launches == before + 1
    ref = sp.splash_prefill_reference(q.float(), k.float(), v.float(),
                                      starts)
    assert got.dtype == dt and torch.isfinite(got.float()).all()
    tol = 1e-5 if dt == torch.float32 else 1e-2
    assert (got.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hk,quant", [(4, 2, True), (4, 4, False),
                                        (8, 2, True)])
def test_f32_rows_keep_their_bits_across_windows_and_layouts(H, Hk, quant):
    """The f32 route's exactness invariants on the card: each row of a
    5-token verify window has the bits of the same query decoded alone
    at its position (T=1: the same plan for every T * G <= 16), and the
    splash kernel over the gathered (dequantized) view gives the paged
    kernel's bits."""
    dev = _card()
    rng = np.random.default_rng(21)
    B, W, hd, bs, NB = 8, 5, 64, 16, 16
    q, kp, vp, ks, vs, _, _ = _paged_inputs(rng, B, W, H, Hk, hd, bs, NB,
                                            quant)
    lens = np.asarray([0, 3, 59, 60, 64, 120, 200, NB * bs - W], np.int32)
    tables = _tables(rng, B, NB, B * NB + 1,
                     [-(-(int(n) + W) // bs) for n in lens])
    c = lambda a: None if a is None else torch.from_numpy(a).to(dev)  # noqa: E731
    qd, kd, vd, td, ksd, vsd = c(q), c(kp), c(vp), c(tables), c(ks), c(vs)
    window = pa.paged_attention(qd, kd, vd, td, c(lens), ksd, vsd)
    for t in range(W):
        one = pa.paged_attention(qd[:, t:t + 1].contiguous(), kd, vd, td,
                                 c(lens + t), ksd, vsd)
        assert torch.equal(one[:, 0], window[:, t]), t
    keys, vals = pa.gathered_view(kd, vd, td, ksd, vsd, torch.float32)
    splash = sp.splash_prefill_attention(qd, keys.contiguous(),
                                         vals.contiguous(), c(lens))
    torch.cuda.synchronize()
    assert torch.equal(splash, window)
    ref = pa.paged_attention_reference(qd, kd, vd, td, c(lens), ksd, vsd)
    assert (window - ref).abs().max().item() <= 1e-5


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


def _check_causal_fwd(q, k, v, out, lse):
    ref_out, ref_lse = fa.causal_attention_reference(q, k, v)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref_out).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("T", [1, 63, 129, 191, 257])
def test_causal_forward_at_the_tile_edges(T, hd):
    """The forward's ragged edges: T against the consumer warpgroups'
    64-row halves, the 128-row blocks and the key tile (64 keys at hd
    256, 128 below)."""
    dev = _card()
    q, k, v, _ = _causal_inputs(dev, 1, T, 2, hd, seed=100 + T + hd)
    out, lse = fa.causal_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    _check_causal_fwd(q, k, v, out, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_causal_forward_reads_a_fused_projection(hd):
    """q, k and v as strided views of one fused [B, T, 3, H, hd]
    projection: the same bits as contiguous copies, within the plain
    version's tolerance, and two launches give equal bits."""
    dev = _card()
    B, T, H = 2, 200, 2
    rng = np.random.default_rng(hd)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3, H, hd)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    out, lse = fa.causal_attention_fwd(q, k, v)
    again, lse_again = fa.causal_attention_fwd(q, k, v)
    copied, lse_copied = fa.causal_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    assert torch.equal(out, copied) and torch.equal(lse, lse_copied)
    _check_causal_fwd(q, k, v, out, lse)


def _check_causal_bwd(q, k, v, out, lse, do, grads):
    for got, ref in zip(grads, fa.causal_attention_bwd_reference(
            q, k, v, out, lse, do)):
        assert got.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all()
        err = (got.float() - ref).abs().max().item()
        assert err <= 2e-2 * ref.abs().max().item() + 1e-4


def _causal_bwd(q, k, v, out, lse, do):
    return (fa.causal_attention_dq(q, k, v, out, lse, do),
            *fa.causal_attention_dkv(q, k, v, out, lse, do))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("T", [1, 63, 129, 191, 257, 1000])
def test_causal_backward_at_the_tile_edges(T, hd):
    """dq and dk/dv at their ragged edges: T against dq's 64-row halves
    and 128-row items, the 64-key tiles and dk/dv's 64-query steps (and
    a ragged T=1000 over many of them), against the plain version; two
    launches give equal bits."""
    dev = _card()
    q, k, v, do = _causal_inputs(dev, 1, T, 2, hd, seed=200 + T + hd)
    out, lse = fa.causal_attention_fwd(q, k, v)
    grads = _causal_bwd(q, k, v, out, lse, do)
    again = _causal_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
    _check_causal_bwd(q, k, v, out, lse, do, grads)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_causal_backward_reads_a_fused_projection(hd):
    """The backward with q, k and v as strided views of one fused
    [B, T, 3, H, hd] projection: the same bits as contiguous copies,
    within the plain version's tolerance."""
    dev = _card()
    B, T, H = 2, 200, 2
    rng = np.random.default_rng(300 + hd)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3, H, hd)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal((B, T, H, hd)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    out, lse = fa.causal_attention_fwd(q, k, v)
    grads = _causal_bwd(q, k, v, out, lse, do)
    copied = _causal_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                         out, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(grads, copied):
        assert torch.equal(a, b)
    _check_causal_bwd(q, k, v, out, lse, do, grads)


def _causal_bwd_digest(T, hd):
    """sha256 of the causal backward's dq, dk and dv bits (each wrapper
    called alone) from seeded [2, T, 2, hd] inputs and the forward
    kernel's out and lse."""
    dev = _card()
    q, k, v, do = _causal_inputs(dev, 2, T, 2, hd, seed=800 + T + hd)
    out, lse = fa.causal_attention_fwd(q, k, v)
    grads = _causal_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for g in grads:
        h.update(g.contiguous().view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()


# _causal_bwd_digest of the causal backward kernels as they were before
# flash_bwd_sm90.cuh was templated for the pair (NVIDIA H100 80GB HBM3,
# CUDA 12.8's nvcc; another toolkit may compile other bits): the causal
# instantiation <hd, true, false> must compute exactly these bits
_CAUSAL_BWD_BITS = {
    (63, 128):
        "bcb4dd7b144ef932155b3e8eda2db7c95534813352a640ed289740558773cb2c",
    (191, 256):
        "604492be7c4f5df5096c5356b12f85c6be377e26801b78401aeec0606332f79c",
    (257, 64):
        "fbb7703f7ccd30f42001629e25c37e3b710363e55c17ecd4e8cd3bedbb9e4794",
    (1000, 128):
        "90b65e59ba14c03de2c70bed1cb25866f942bacf4b5b9a8e179cd90a0a35b0be",
    (2048, 256):
        "218417421e1cbaec4ebdda9588f3647d8f0938d53fc622c215d59eb75fe9551c",
}


@pytest.mark.cuda
@pytest.mark.parametrize("T,hd", sorted(_CAUSAL_BWD_BITS))
def test_causal_backward_bits_are_pinned(T, hd):
    """The causal dq and dk/dv give the bits they gave before the
    backward was templated on <hd, causal, PAIR>."""
    assert _causal_bwd_digest(T, hd) == _CAUSAL_BWD_BITS[(T, hd)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("causal,Tq,Tk", [(False, 200, 328),
                                          (False, 1, 130),
                                          (True, 129, 129)])
def test_pair_forward_at_the_tile_edges(causal, Tq, Tk, hd):
    """Rectangles with Tq != Tk, both ragged, and the wedge at C=129,
    against the plain version; two launches give equal bits."""
    dev = _card()
    q, k, v, _, _ = _pair_inputs(dev, 1, Tq, Tk, 2, hd, seed=Tq + Tk + hd)
    o, lse = pp.pair_attention_fwd(q, k, v, causal)
    o2, lse2 = pp.pair_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ref_o, ref_lse = pp.pair_attention_reference(q, k, v, causal)
    assert torch.isfinite(o.float()).all()
    assert (o.float() - ref_o).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


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


def _pair_bwd(q, k, v, o, lse, do, dlse, causal, scratch=None):
    return (pp.pair_attention_dq(q, k, v, o, lse, do, dlse, causal,
                                 scratch=scratch),
            *pp.pair_attention_dkv(q, k, v, o, lse, do, dlse, causal,
                                   scratch=scratch))


def _check_pair_bwd(q, k, v, o, lse, do, dlse, causal, grads):
    for got, ref in zip(grads, pp.pair_attention_bwd_reference(
            q, k, v, o, lse, do, dlse, causal)):
        assert got.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all()
        err = (got.float() - ref).abs().max().item()
        assert err <= 2e-2 * ref.abs().max().item() + 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("causal,Tq,Tk", [
    (True, 1, 1), (True, 63, 63), (True, 129, 129), (True, 191, 191),
    (True, 257, 257), (True, 1000, 1000), (False, 1, 129), (False, 64, 320),
    (False, 320, 64), (False, 1000, 257)])
def test_pair_backward_at_the_tile_edges(causal, Tq, Tk, hd):
    """The pair's dq and dk/dv at their ragged edges, with a nonzero lse
    cotangent: the wedge's C against dq's 64-row halves and 128-row
    items, the 64-key tiles and dk/dv's 64-query steps; rectangles with
    Tq != Tk either way, a single query row, and keys past Tk on a
    partial last tile; against the plain version, two launches equal."""
    dev = _card()
    q, k, v, do, dlse = _pair_inputs(dev, 1, Tq, Tk, 2, hd,
                                     seed=400 + Tq + Tk + hd)
    o, lse = pp.pair_attention_fwd(q, k, v, causal)
    grads = _pair_bwd(q, k, v, o, lse, do, dlse, causal)
    again = _pair_bwd(q, k, v, o, lse, do, dlse, causal)
    torch.cuda.synchronize()
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
    _check_pair_bwd(q, k, v, o, lse, do, dlse, causal, grads)


@pytest.mark.cuda
@pytest.mark.parametrize("zero", ["do", "dlse"])
@pytest.mark.parametrize("causal,Tq,Tk", [(True, 191, 191),
                                          (False, 129, 320)])
def test_pair_backward_with_a_zero_cotangent(zero, causal, Tq, Tk):
    """One cotangent zero: with dO = 0 the gradients come from the lse
    cotangent alone (dV = 0), with dlse = 0 from dO alone. The autograd
    Function, given only the other output's cotangent, matches the
    wrappers called with zeros."""
    dev = _card()
    q, k, v, do, dlse = _pair_inputs(dev, 1, Tq, Tk, 2, 128,
                                     seed=500 + Tq + Tk)
    if zero == "do":
        do = torch.zeros_like(do)
    else:
        dlse = torch.zeros_like(dlse)
    o, lse = pp.pair_attention_fwd(q, k, v, causal)
    grads = _pair_bwd(q, k, v, o, lse, do, dlse, causal)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    oo, ll = pp.pallas_pair_attention(qq, kk, vv, causal)
    loss = ((ll * dlse).sum() if zero == "do"
            else (oo.float() * do.float()).sum())
    loss.backward()
    torch.cuda.synchronize()
    _check_pair_bwd(q, k, v, o, lse, do, dlse, causal, grads)
    if zero == "do":
        assert not grads[2].any()  # dV = P^T dO
    for got, want in zip((qq.grad, kk.grad, vv.grad), grads):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_pair_backward_reads_a_fused_projection(causal, hd):
    """dq and dk/dv with q, k and v as strided views of one fused
    [B, 2C, 3, H, hd] projection (a chunk against itself for the wedge,
    against the next chunk for the rectangle): the same bits as
    contiguous copies, within the plain version's tolerance."""
    dev = _card()
    B, C, H = 2, 136, 2
    rng = np.random.default_rng(600 + hd)
    x = rng.standard_normal((B, 2 * C, 3, H, hd)).astype(np.float32)
    x[:, :, 0] *= hd ** -0.5  # q arrives pre-scaled
    qkv = torch.from_numpy(x).to(dev).to(torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal((B, C, H, hd)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    dlse = torch.from_numpy(rng.standard_normal((B, C, H)).astype(
        np.float32)).to(dev)
    kv = slice(0, C) if causal else slice(C, 2 * C)
    q, k, v = qkv[:, :C, 0], qkv[:, kv, 1], qkv[:, kv, 2]
    assert not (q.is_contiguous() or k.is_contiguous())
    o, lse = pp.pair_attention_fwd(q, k, v, causal)
    grads = _pair_bwd(q, k, v, o, lse, do, dlse, causal)
    copied = _pair_bwd(q.contiguous(), k.contiguous(), v.contiguous(), o,
                       lse, do, dlse, causal)
    torch.cuda.synchronize()
    for a, b in zip(grads, copied):
        assert torch.equal(a, b)
    _check_pair_bwd(q, k, v, o, lse, do, dlse, causal, grads)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,Tq,Tk", [(True, 257, 257),
                                          (False, 200, 328)])
def test_pair_backward_shares_one_prep_pass(causal, Tq, Tk):
    """dq and dk/dv sharing one scratch (the dq launch's prep pass, read
    by dk/dv) give the bits of each called alone (each with its own prep
    pass); the scratch holds delta' = rowsum(dO * O) - dlse."""
    dev = _card()
    q, k, v, do, dlse = _pair_inputs(dev, 2, Tq, Tk, 2, 64,
                                     seed=700 + Tq + Tk)
    o, lse = pp.pair_attention_fwd(q, k, v, causal)
    scratch = pp.bwd_scratch(q)
    shared = _pair_bwd(q, k, v, o, lse, do, dlse, causal, scratch)
    alone = _pair_bwd(q, k, v, o, lse, do, dlse, causal)
    torch.cuda.synchronize()
    for a, b in zip(shared, alone):
        assert torch.equal(a, b)
    torch.testing.assert_close(
        scratch, pp.pair_attention_prep_reference(o, do, dlse), rtol=1e-5,
        atol=1e-4)


@pytest.mark.parametrize("name,group", [
    ("void paged_split_kernel<signed char, 256, 64>(__nv_bfloat16 const*, "
     "signed char const*)", "paged_attention"),
    ("_Z18paged_split_kernelIaLi256ELi16EEvPK13__nv_bfloat16", "paged_attention"),
    ("void paged_merge_kernel<256>(float const*, __nv_bfloat16*, int)",
     "paged_attention"),
    ("void splash_split_kernel<256, 64>(__nv_bfloat16 const*)",
     "splash_prefill"),
    ("_Z19splash_merge_kernelILi128EEvPKfP13__nv_bfloat16iiiii",
     "splash_prefill"),
    ("void paged_f32_split_kernel<signed char, 64, 16>(float const*, "
     "signed char const*)", "paged_attention"),
    ("_Z22paged_f32_split_kernelIfLi256ELi64EEvPKfPKT_S4_S1_S1_PKiS6_PfS7_"
     "iiiifii", "paged_attention"),
    ("void paged_f32_merge_kernel<64>(float const*, float*, int)",
     "paged_attention"),
    ("void splash_f32_split_kernel<64, 64>(float const*)",
     "splash_prefill"),
    ("_Z23splash_f32_merge_kernelILi128EEvPKfPfiiiii", "splash_prefill"),
])
def test_profile_groups_place_the_serving_kernels(name, group):
    """bench.py's profile puts every serving kernel, the merges included,
    under its op (demangled or mangled names), never under 'other'."""
    from distkeras_torch.bench import _group

    assert _group(name) == group


@pytest.mark.parametrize("name,group", [
    ("void ca::sm90::fwd_kernel<256, true, false>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, float*, ca::Shape, "
     "int, int)", "causal_attention"),
    ("_ZN2ca4sm9010fwd_kernelILi256ELb1ELb0EEEv14CUtensorMap_stS2_S2_P13__"
     "nv_bfloat16PfNS_5ShapeEii", "causal_attention"),
    ("void ca::sm90::fwd_kernel<256, true, true>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, float*, ca::Shape, "
     "int, int)", "pair_attention"),
    ("_ZN2ca4sm9010fwd_kernelILi256ELb0ELb1EEEv14CUtensorMap_stS2_S2_P13__"
     "nv_bfloat16PfNS_5ShapeEii", "pair_attention"),
    # the backward (flash_bwd_sm90.cuh: dq and dk/dv on <hd, causal, PAIR>,
    # the prep pass on <hd, PAIR>), causal self-attention's and the pair's
    ("void ca::sm90::dq_kernel<256, true, false>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, float "
     "const*, __nv_bfloat16*, ca::Shape, int, int)", "causal_attention"),
    ("_ZN2ca4sm909dq_kernelILi256ELb1ELb0EEEv14CUtensorMap_stS2_S2_S2_PKfS4_"
     "P13__nv_bfloat16NS_5ShapeEii", "causal_attention"),
    ("void ca::sm90::dkv_kernel<128, true, false>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, float "
     "const*, __nv_bfloat16*, __nv_bfloat16*, ca::Shape, int, int)",
     "causal_attention"),
    ("_ZN2ca4sm9010dkv_kernelILi64ELb1ELb0EEEv14CUtensorMap_stS2_S2_S2_PKfS4_"
     "P13__nv_bfloat16S6_NS_5ShapeEii", "causal_attention"),
    ("void ca::sm90::prep_kernel<256, false>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
     "__nv_bfloat16*, float*, ca::Shape, int)", "causal_attention"),
    ("_ZN2ca4sm9011prep_kernelILi64ELb0EEEvPK13__nv_bfloat16S4_S4_PKfPS2_PfNS"
     "_5ShapeEi", "causal_attention"),
    ("void ca::sm90::dkv_kernel<256, true, true>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, float "
     "const*, __nv_bfloat16*, __nv_bfloat16*, ca::Shape, int, int)",
     "pair_attention"),
    ("_ZN2ca4sm909dq_kernelILi256ELb0ELb1EEEv14CUtensorMap_stS2_S2_S2_PKfS4_"
     "P13__nv_bfloat16NS_5ShapeEii", "pair_attention"),
    ("void ca::sm90::dq_kernel<256, false, true>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, float "
     "const*, __nv_bfloat16*, ca::Shape, int, int)", "pair_attention"),
    ("_ZN2ca4sm909dq_kernelILi128ELb1ELb1EEEv14CUtensorMap_stS2_S2_S2_PKfS4_"
     "P13__nv_bfloat16NS_5ShapeEii", "pair_attention"),
    ("_ZN2ca4sm9010dkv_kernelILi64ELb0ELb1EEEv14CUtensorMap_stS2_S2_S2_PKfS4_"
     "P13__nv_bfloat16S6_NS_5ShapeEii", "pair_attention"),
    ("void ca::sm90::prep_kernel<256, true>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
     "__nv_bfloat16*, float*, ca::Shape, int)", "pair_attention"),
    ("_ZN2ca4sm9011prep_kernelILi256ELb1EEEvPK13__nv_bfloat16S4_S4_PKfPS2_PfN"
     "S_5ShapeEi", "pair_attention"),
])
def test_profile_groups_place_the_training_forwards(name, group):
    """The wgmma forward, dq, dk/dv and prep kernels (namespace ca::sm90)
    land under the causal or the pair group by their PAIR flag, the last
    template argument, demangled or mangled: the pair's wedge (causal
    true) never mistaken for causal self-attention."""
    from distkeras_torch.bench import _group

    assert _group(name) == group


@pytest.mark.parametrize("name,group,cifar", [
    # kernel names of a profiled CIFAR window on an H100 (bench.py's
    # top_kernels, cut at 120 characters as it prints them)
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize64x128x64_warpgroupsize1x1x1_g1_execute_segment",
     "convolution", "convolution"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize256x64x32_warpgroupsize1x1x1_g1_execute_segment",
     "convolution", "convolution"),
    ("_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConvolution"
     "INS1_11threadblock22ImplicitGemmMultistageINS_4gem", "convolution",
     "convolution"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_"
     "impl_nocast<at::native::CUDAFunctor_add<c10::BFloat16", "other",
     "elementwise"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::(anony"
     "mous namespace)::launch_clamp_scalar(at::TensorItera", "other",
     "elementwise"),
    ("void at::native::(anonymous namespace)::max_pool_backward_nhwc<c10::"
     "BFloat16, float>(c10::BFloat16 const*, long const*, ", "other",
     "other"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<c10::"
     "BFloat16, at::native::func_wrapper_t<c10::BFloat16, at:", "other",
     "other"),
    ("nvjet_hsh_64x8_64x16_2x1_v_bz_TNT", "matmul", "matmul"),
])
def test_profile_groups_of_the_cifar_window(name, group, cifar):
    """Convolutions (cuDNN's and its CUTLASS kernels, though they carry
    'gemm') land under 'convolution' on every line; only the CIFAR line
    takes PyTorch's elementwise kernels out of 'other', which keeps the
    serving and LM lines' groups as they were."""
    from distkeras_torch.bench import _cifar_group, _group

    assert (_group(name), _cifar_group(name)) == (group, cifar)
