"""Port splash chunked-prefill attention
(distkeras_torch/ops/splash_prefill.py) against the reference Pallas
kernel (distkeras_tpu/ops/splash_prefill.py, interpret mode on the CPU
as its own tests run it): same numpy inputs, f32, atol 1e-5 — GQA/MHA
chunk shapes and rows at distinct depths (0 / mid / max), plus
``choose_kv_block`` and the Hopper gates, and the bf16 kernel's
split-K math (per-split partials and their merge) in plain PyTorch. The
kernel itself is held against its plain version on the card by
tests/test_torch_kernels.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distkeras_tpu.ops import splash_prefill as jax_sp  # noqa: E402
from distkeras_torch.ops import splash_prefill as sp  # noqa: E402


def _both(q, k, v, starts):
    want = jax_sp.splash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(starts))
    got = sp.splash_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(starts))
    return got.numpy(), np.asarray(want)


def _inputs(rng, B, T, H, Hk, hd, L):
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, Hk, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, Hk, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,T,H,Hk,hd,L", [
    (2, 8, 4, 2, 16, 64),    # GQA, chunk mid-cache
    (3, 5, 4, 4, 8, 48),     # MHA, odd chunk
    (1, 16, 8, 2, 32, 128),  # wide group
])
def test_plain_matches_jax_kernel(B, T, H, Hk, hd, L):
    rng = np.random.default_rng(0)
    q, k, v = _inputs(rng, B, T, H, Hk, hd, L)
    starts = rng.integers(0, L - T, size=B).astype(np.int32)
    got, want = _both(q, k, v, starts)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_rows_at_distinct_depths():
    """One row at depth 0 (most KV tiles skipped), one mid-way, one at
    the deepest start the cache allows (tests/test_splash_prefill.py:
    56-71)."""
    rng = np.random.default_rng(1)
    B, T, H, Hk, hd, L = 3, 4, 4, 2, 16, 96
    q, k, v = _inputs(rng, B, T, H, Hk, hd, L)
    starts = np.asarray([0, 40, L - T], np.int32)
    got, want = _both(q, k, v, starts)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L", [64, 96, 100, 128, 1024, 7])
def test_choose_kv_block_matches_reference(L):
    assert sp.choose_kv_block(L) == jax_sp.choose_kv_block(L)
    assert L % sp.choose_kv_block(L) == 0


def test_gates_are_chosen_for_hopper():
    # the main path's chunk: T=64, hd=256, L=2048
    assert sp.supports(64, 256, 2048)
    # a decode token stays on the dense attend; unsupported head dims
    # and lengths that are not whole 16-key tiles never take the kernel
    assert not sp.supports(1, 256, 2048)
    assert not sp.supports(64, 96, 2048)
    assert not sp.supports(64, 256, 100)
    # the TPU's ragged-query-tile rule does not carry over
    assert sp.supports(3, 128, 1024)
    assert not sp.preferred(64, 256, 2048, device="cpu")
    assert sp.preferred(64, 256, 2048, device="cuda")


@pytest.mark.parametrize("keys_per_split", [16, 32])
@pytest.mark.parametrize("T", [2, 5])
@pytest.mark.parametrize("H,Hk", [(4, 4), (16, 2)])
def test_split_reference_matches_jax_kernel(keys_per_split, T, H, Hk):
    """The kernel's split-K partials and merge, in plain PyTorch, against
    the TPU kernel: a row at depth 0 (every later split empty), rows
    whose chunk ends and starts on a split boundary, the deepest row;
    MHA and GQA with G=8."""
    rng = np.random.default_rng(9)
    B, hd, L = 4, 16, 64
    q, k, v = _inputs(rng, B, T, H, Hk, hd, L)
    starts = np.asarray([0, keys_per_split - T, keys_per_split, L - T],
                        np.int32)
    want = np.asarray(jax_sp.splash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(starts)))
    got = sp.splash_prefill_split_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(starts), keys_per_split).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
