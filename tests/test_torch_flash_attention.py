"""The port's causal attention for training against the JAX package on
the CPU, from the same numpy inputs:

- ``pallas_causal_attention`` (its CPU path: the dense f32 plain
  versions of the three Hopper kernels) against the reference's Pallas
  kernels run in interpret mode, as ``tests/test_pallas_attention.py``
  runs them (B=2, T=256, H=2, hd=128, f32, block 128): forward within
  2e-5 and dq/dk/dv from a random cotangent within 2e-4, the tolerances
  that file holds the Pallas kernels to against dense attention;
- ``causal_attention_reference``'s lse against the Pallas forward
  kernel's own lse (1e-5);
- ``blocked_causal_attention`` against the reference's blocked op,
  forward and gradients, at f32 (2e-5 / 2e-4: the same algorithm, sums
  in another order) and bf16 (2e-2: bf16 rounding of the probabilities
  may land one ulp apart), including a ragged last key block.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distkeras_tpu.ops import pallas_attention as jpa  # noqa: E402
from distkeras_tpu.ops.flash_attention import (  # noqa: E402
    blocked_causal_attention as jax_blocked,
)
from distkeras_torch.ops import pallas_attention as fa  # noqa: E402
from distkeras_torch.ops.flash_attention import (  # noqa: E402
    blocked_causal_attention,
)
from torch_spawn_util import one_thread  # noqa: E402,F401

SHAPE = (2, 256, 2, 128)  # B, T, H, hd — tests/test_pallas_attention.py


def _inputs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _jax_vjp(fn, q, k, v, do, dtype=jnp.float32):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a, dtype) for a in (q, k, v)))
    grads = vjp(jnp.asarray(do, dtype))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _torch_vjp(fn, q, k, v, do, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True)
          for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(do).to(dtype))
    for t in ts:
        assert t.grad.dtype == dtype
    return (out.detach().float().numpy(),
            [t.grad.float().numpy() for t in ts])


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def test_pallas_attention_matches_jax_pallas_kernels():
    q, k, v, do = _inputs(0)
    want_out, want_g = _jax_vjp(
        lambda a, b, c: jpa.pallas_causal_attention(a, b, c, 128),
        q, k, v, do)
    before = fa.causal_attention_fwd.launches
    got_out, got_g = _torch_vjp(fa.pallas_causal_attention, q, k, v, do)
    assert fa.causal_attention_fwd.launches == before  # CPU: plain only
    _close(got_out, want_out, 2e-5, "out")
    for g, w, name in zip(got_g, want_g, ("dq", "dk", "dv")):
        _close(g, w, 2e-4, name)


def test_reference_lse_matches_pallas_kernel_lse():
    q, k, v, _ = _inputs(1)
    B, T, H, hd = SHAPE
    out3, lse3 = jpa._fwd(jpa._to_bh(jnp.asarray(q)), jpa._to_bh(
        jnp.asarray(k)), jpa._to_bh(jnp.asarray(v)), 128, 1.0 / np.sqrt(hd))
    # the TPU stores lse lane-replicated [B*H, T, 8]; the port [B, H, T]
    want = np.asarray(lse3)[:, :, 0].reshape(B, H, T)
    out, lse = fa.causal_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)))
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    _close(lse.numpy(), want, 1e-5, "lse")
    _close(out.numpy(), np.asarray(jpa._from_bh(out3, B, H)), 2e-5, "out")


def test_plain_backward_halves_equal_the_combined_plain_backward():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, (1, 70, 2, 64)))
    out, lse = fa.causal_attention_reference(q, k, v)
    dq, dk, dv = fa.causal_attention_bwd_reference(q, k, v, out, lse, do)
    torch.testing.assert_close(
        fa.causal_attention_dq_reference(q, k, v, out, lse, do), dq,
        rtol=0, atol=0)
    dk2, dv2 = fa.causal_attention_dkv_reference(q, k, v, out, lse, do)
    torch.testing.assert_close(dk2, dk, rtol=0, atol=0)
    torch.testing.assert_close(dv2, dv, rtol=0, atol=0)


@pytest.mark.parametrize("shape,block_k", [(SHAPE, 512), (SHAPE, 64),
                                           ((1, 200, 2, 64), 64)])
def test_blocked_attention_matches_jax_blocked_f32(shape, block_k):
    q, k, v, do = _inputs(3, shape)
    want_out, want_g = _jax_vjp(
        lambda a, b, c: jax_blocked(a, b, c, block_k), q, k, v, do)
    got_out, got_g = _torch_vjp(
        lambda a, b, c: blocked_causal_attention(a, b, c, block_k),
        q, k, v, do)
    _close(got_out, want_out, 2e-5, "out")
    for g, w, name in zip(got_g, want_g, ("dq", "dk", "dv")):
        _close(g, w, 2e-4, name)


def test_blocked_attention_matches_jax_blocked_bf16():
    q, k, v, do = _inputs(4, (1, 96, 2, 64))
    want_out, want_g = _jax_vjp(lambda a, b, c: jax_blocked(a, b, c, 32),
                                q, k, v, do, dtype=jnp.bfloat16)
    got_out, got_g = _torch_vjp(
        lambda a, b, c: blocked_causal_attention(a, b, c, 32), q, k, v, do,
        dtype=torch.bfloat16)
    _close(got_out, want_out, 2e-2, "out")
    for g, w, name in zip(got_g, want_g, ("dq", "dk", "dv")):
        scale = max(np.abs(w).max(), 1.0)
        assert np.abs(g - w).max() <= 2e-2 * scale, name


def test_gates_are_written_for_hopper_tiles():
    """bf16 and a compiled head dim at any T; f32 and hd 96 go 'blocked';
    only CUDA tensors are ever preferred."""
    assert fa.supports(2048, 256) and fa.supports(1000, 64)
    assert fa.supports(1, 128)
    assert not fa.supports(2048, 256, torch.float32)
    assert not fa.supports(2048, 96)
    assert not fa.supports(2048, 256, block=128)
    assert fa.choose_block(1536, 256) == fa.BLOCK
    assert fa.choose_block(1536, 256, torch.float32) is None
    assert not fa.preferred(2048, 256, torch.bfloat16, "cpu")
    assert not fa.preferred(2048, 256, torch.bfloat16, None)
