"""Port paged attention (distkeras_torch/ops/paged_attention.py) against
the reference Pallas kernel (distkeras_tpu/ops/paged_attention.py, run
in interpret mode on the CPU as its own tests run it): the same numpy
inputs through both, f32, atol 1e-5 — T in {1, 5} x MHA/GQA x int8
on/off with fragmented, trash-padded block tables, plus a zero-length
row. On the CPU the port's wrapper runs its plain version; the Hopper
kernel itself is held against that plain version on the card by
tests/test_torch_kernels.py. The kernels' split-K math (per-split
partials and their merge, both routes: bf16 on the tensor cores, f32 on
FFMA) is held against the same reference kernel in plain PyTorch, at
the bf16 plans and at the f32 route's, and the split plan's shape-only
rule is checked here."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distkeras_tpu.ops import paged_attention as jax_pa  # noqa: E402
from distkeras_torch.ops import paged_attention as pa  # noqa: E402
from torch_spawn_util import one_thread  # noqa: E402,F401


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


def _split_edge_inputs(rng, T, H, Hk, quant, pps):
    """Four rows cut into splits of ``pps`` 4-token pages: a zero-length
    row, a row whose last query ends on a split boundary, one whose first
    query starts on one, and a full row; the short rows' chains end in
    trash-page tails, so their last splits are all trash (all empty)."""
    B, bs, NB, hd = 4, 4, 6, 16
    nb = B * NB + 1
    split_keys = pps * bs
    lens = np.asarray([0, split_keys - T, split_keys, NB * bs - T], np.int32)
    chains = [-(-(int(n) + T) // bs) for n in lens]
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    kp, vp, ks, vs = _pool(rng, nb, bs, Hk, hd, quant)
    tables = _fragmented_tables(rng, B, NB, nb, chains)
    return q, kp, vp, ks, vs, tables, lens


@pytest.mark.parametrize("pps", [1, 2])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("heads", ["mha", "gqa8"])
@pytest.mark.parametrize("quant", [False, True])
def test_split_reference_matches_jax_kernel(pps, T, heads, quant):
    """The kernel's split-K partials and merge, in plain PyTorch, against
    the TPU kernel: fragmented tables, the trash page, a zero-length row,
    rows ending and starting on a split boundary, all-empty tail splits,
    int8, MHA and GQA with G=8."""
    rng = np.random.default_rng(7)
    H, Hk = (4, 4) if heads == "mha" else (16, 2)
    q, kp, vp, ks, vs, tables, lens = _split_edge_inputs(
        rng, T, H, Hk, quant, pps)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = np.asarray(jax_pa.paged_attention(
        j(q), j(kp), j(vp), j(tables), j(lens), j(ks), j(vs)))
    got = pa.paged_attention_split_reference(
        t(q), t(kp), t(vp), t(tables), t(lens), t(ks), t(vs),
        pages_per_split=pps).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_split_plan_fills_the_card_from_shapes_alone():
    """The serving shapes (8 rows, Hk=2, G=4, 128 16-token pages, 132
    SMs): decode makes at least ~2 blocks per SM, the chunk cuts the
    deepest row's walk; every plan covers the cache with no empty
    split."""
    from distkeras_torch.ops.splash_prefill import split_plan

    bm, splits, per = split_plan(8, 2, 4, 2048, 132)
    assert bm == 16 and 8 * 2 * splits >= 2 * 132 - 16
    bm, splits, per = split_plan(8, 2, 256, 2048, 132)
    assert bm == 64 and splits > 1 and per < 2048 // 64
    for B, Hk, TG, nkeys in [(1, 1, 1, 16), (3, 2, 20, 64), (8, 2, 4, 2048),
                             (2, 8, 136, 4096), (8, 2, 256, 2048)]:
        bm, splits, per = split_plan(B, Hk, TG, nkeys, 132)
        stages = -(-nkeys // 64)
        assert (splits - 1) * per < stages <= splits * per


# (B, Hk, cache keys): phase 17's paged rows (18 pages), phase 4's engine
# (8 slots, 2 KV heads, max_len 256), the flagship's f32 check (128
# pages) and one row over one page
_F32_PLAN_SHAPES = [(8, 4, 288), (8, 2, 256), (8, 2, 2048), (1, 1, 16)]


@pytest.mark.parametrize("B,Hk,nkeys", _F32_PLAN_SHAPES)
def test_f32_plan_is_one_for_every_window_of_16_rows(B, Hk, nkeys):
    """The f32 route's plan (the split plan both routes share) reads
    shapes alone and is the same for every T * G <= 16, so a decode row
    and a verify window's row walk the same splits (the exact phases
    compare their bits); it covers the cache with no empty split and,
    with enough stages, brings the grid past the card's 132 SMs (phase
    17's decode: 160 blocks on 132 SMs)."""
    from distkeras_torch.ops.splash_prefill import STAGE_KEYS, split_plan

    plans = {split_plan(B, Hk, TG, nkeys, 132) for TG in range(1, 17)}
    assert len(plans) == 1
    bm, splits, per = plans.pop()
    stages = -(-nkeys // STAGE_KEYS)
    assert bm == 16 and (splits - 1) * per < stages <= splits * per
    blocks = B * Hk * splits
    assert blocks >= min(2 * 132, B * Hk * stages) - B * Hk
    if (B, Hk, nkeys) == (8, 4, 288):
        assert blocks == 160
    # past 16 rows a KV head, 64-row tiles (and fewer splits if the row
    # tiles fill the card)
    bm64, splits64, _ = split_plan(B, Hk, 17, nkeys, 132)
    assert bm64 == 64 and splits64 <= splits


def _f32_plan_inputs(rng, T, H, Hk, quant, NB):
    """Four rows over NB 16-token pages cut at the f32 route's plan: a
    zero-length row, a row whose last query ends on a split boundary,
    one whose first query starts on one, and a deep row."""
    from distkeras_torch.ops.splash_prefill import STAGE_KEYS, split_plan

    B, bs, hd = 4, 16, 16
    _, splits, per = split_plan(B, Hk, T * (H // Hk), NB * bs, 132)
    assert splits > 1
    split_keys = per * STAGE_KEYS
    lens = np.asarray([0, split_keys - T, split_keys, NB * bs - T - 3],
                      np.int32)
    chains = [-(-(int(n) + T) // bs) for n in lens]
    nb = B * NB + 1
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    kp, vp, ks, vs = _pool(rng, nb, bs, Hk, hd, quant)
    tables = _fragmented_tables(rng, B, NB, nb, chains)
    return q, kp, vp, ks, vs, tables, lens, per * STAGE_KEYS // bs


@pytest.mark.parametrize("T,H,Hk", [(1, 4, 4), (5, 4, 2), (20, 8, 2)])
@pytest.mark.parametrize("quant", [False, True])
def test_split_reference_at_the_f32_plan_matches_jax_kernel(T, H, Hk, quant):
    """Both routes' split-K math at the plan the f32 kernel takes for
    these shapes (16-token pages, 64-key stages), against the TPU kernel
    at 1e-5: decode over MHA, a verify window over GQA G=2 (phase 4's
    heads), a 20-token chunk over G=4 (64-row tiles); a zero-length row,
    rows ending and starting on a split boundary, int8 pages."""
    rng = np.random.default_rng(17)
    q, kp, vp, ks, vs, tables, lens, pps = _f32_plan_inputs(
        rng, T, H, Hk, quant, NB=12)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = np.asarray(jax_pa.paged_attention(
        j(q), j(kp), j(vp), j(tables), j(lens), j(ks), j(vs)))
    got = pa.paged_attention_split_reference(
        t(q), t(kp), t(vp), t(tables), t(lens), t(ks), t(vs),
        pages_per_split=pps).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_launch_route_names_what_ran():
    """The route label a CUDA launch records: the split kernel with its
    plan and the merge only when there is more than one split, bf16
    queries the tensor-core kernels and f32 queries the FFMA kernels.
    CPU calls record none."""
    from distkeras_torch.ops.splash_prefill import launch_route

    assert launch_route("paged", True, 16, 16) == (
        "paged_split_kernel bm=16 splits=16 + paged_merge_kernel")
    assert launch_route("splash", True, 64, 1) == (
        "splash_split_kernel bm=64 splits=1")
    assert launch_route("paged", False, 64, 5) == (
        "paged_f32_split_kernel bm=64 splits=5 + paged_f32_merge_kernel")
    assert launch_route("splash", False, 16, 1) == (
        "splash_f32_split_kernel bm=16 splits=1")
    rng = np.random.default_rng(4)
    q, kp, vp, ks, vs, tables, lens = _split_edge_inputs(rng, 3, 4, 2,
                                                         False, 1)
    before = (dict(pa.paged_attention.routes), pa.paged_attention.launches)
    pa.paged_attention(*map(torch.from_numpy, (q, kp, vp, tables, lens)))
    assert (pa.paged_attention.routes, pa.paged_attention.launches) == before
