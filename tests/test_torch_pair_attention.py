"""The port's pair attention (``distkeras_torch.ops.pallas_pair``, the
zigzag ring's inner op) against the JAX package's Pallas pair kernel on
the CPU, from the same numpy inputs.

The JAX op runs in Pallas interpret mode (as the reference's own tests
run it off-TPU), in f32; the port's CPU tensors take the plain versions.
Tolerances: values 1e-4 (the reference's interpret-mode rectangle misses
1e-5 against its own dense math on a few elements, so the port is also
held against dense numpy), gradients rtol 2e-4 / atol 2e-5 with a
NONZERO lse cotangent (the ring's merge consumes lse, so a dropped dlse
would only show in the gradients). The autograd Function is also held
against autograd through a dense f32 implementation at 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distkeras_tpu.ops.pallas_pair import (  # noqa: E402
    pallas_pair_attention as jax_pair,
)
from distkeras_torch.ops import pallas_pair as pp  # noqa: E402
from torch_spawn_util import one_thread  # noqa: E402,F401


def _inputs(seed, B, Tq, Tk, H, hd, scale=0.2):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, Tq, H, hd)) * scale).astype(np.float32)
    k = (rng.normal(size=(B, Tk, H, hd)) * scale).astype(np.float32)
    v = (rng.normal(size=(B, Tk, H, hd)) * scale).astype(np.float32)
    do = rng.normal(size=(B, Tq, H, hd)).astype(np.float32)
    dlse = rng.normal(size=(B, Tq, H)).astype(np.float32)
    return q, k, v, do, dlse


def _dense(q, k, v, causal):
    """Pair attention in numpy f64: (o, lse [B, Tq, H])."""
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k)
    if causal:
        Tq, Tk = s.shape[-2:]
        s = np.where(np.tril(np.ones((Tq, Tk), bool)), s, -1e30)
    m = s.max(-1, keepdims=True)
    lse = m[..., 0] + np.log(np.exp(s - m).sum(-1))
    p = np.exp(s - lse[..., None])
    return np.einsum("bhqk,bkhd->bqhd", p, v), lse.transpose(0, 2, 1)


CASES = [(True, 64, 64), (False, 64, 64), (False, 64, 32)]


@pytest.mark.parametrize("causal,Tq,Tk", CASES)
def test_plain_pair_matches_jax_interpret(causal, Tq, Tk):
    q, k, v, _, _ = _inputs(0, 1, Tq, Tk, 2, 128)
    jo, jlse = jax.jit(lambda q, k, v: jax_pair(q, k, v, causal, 32))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    before = dict(pp.pair_attention_fwd.launches)
    o, lse = pp.pair_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                   causal)
    assert pp.pair_attention_fwd.launches == before  # CPU: no kernel
    assert o.shape == (1, Tq, 2, 128) and lse.shape == (1, Tq, 2)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-4,
                               atol=1e-4)
    do, dlse = _dense(q, k, v, causal)
    np.testing.assert_allclose(o.numpy(), do, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), dlse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,Tq,Tk", CASES)
def test_pair_grads_with_lse_cotangent_match_jax_vjp(causal, Tq, Tk):
    q, k, v, do, dlse = _inputs(1, 1, Tq, Tk, 2, 128)

    def jloss(q, k, v):
        o, lse = jax_pair(q, k, v, causal, 32)
        return jnp.sum(o * do) + jnp.sum(lse * dlse)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o, lse = pp.pallas_pair_attention(*ts, causal)
    ((o * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dlse)).sum()).backward()
    for t, w, name in zip(ts, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    # the lse cotangent matters: without it dq differs
    o2, _ = pp.pallas_pair_attention(*ts, causal)
    dq_no_lse, = torch.autograd.grad(o2, ts[0], torch.from_numpy(do))
    assert (dq_no_lse - ts[0].grad).abs().max().item() > 1e-3


@pytest.mark.parametrize("causal,Tq,Tk", CASES)
def test_folded_prep_delta_matches_jax_vjp(causal, Tq, Tk):
    """The kernels' form of the backward: the prep pass's plain version
    folds the lse cotangent into delta (delta' = rowsum(dO * O) - dlse)
    and dS = P * (dP - delta') — the same gradients as the JAX VJP,
    which adds dlse to dP - delta."""
    q, k, v, do, dlse = _inputs(1, 1, Tq, Tk, 2, 128)

    def jloss(q, k, v):
        o, lse = jax_pair(q, k, v, causal, 32)
        return jnp.sum(o * do) + jnp.sum(lse * dlse)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt, dot, dlt = map(torch.from_numpy, (q, k, v, do, dlse))
    o, lse = pp.pair_attention_fwd(qt, kt, vt, causal)
    delta = pp.pair_attention_prep_reference(o, dot, dlt)
    assert delta.shape == (1, Tq, 2) and delta.dtype == torch.float32
    np.testing.assert_allclose(
        delta.numpy(), np.einsum("bqhd,bqhd->bqh", do, o.numpy()) - dlse,
        rtol=1e-5, atol=1e-5)
    # o and dlse are not read once delta' is given
    got = pp.pair_attention_bwd_reference(qt, kt, vt, None, lse, dot, None,
                                          causal, delta=delta)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_bwd_scratch_holds_one_delta_per_row():
    """A pair's prep scratch is delta' in lse's layout, [B, Tq, H] f32,
    on q's device; CPU tensors take the plain versions and leave a given
    scratch unread."""
    q, k, v, do, dlse = (torch.from_numpy(a) for a in
                         _inputs(4, 2, 24, 40, 3, 16))
    scratch = pp.bwd_scratch(q.to(torch.bfloat16))
    assert scratch.shape == (2, 24, 3) and scratch.dtype == torch.float32
    assert scratch.device == q.device
    o, lse = pp.pair_attention_fwd(q, k, v)
    scratch.fill_(7.0)
    assert torch.equal(pp.pair_attention_dq(q, k, v, o, lse, do, dlse,
                                            scratch=scratch),
                       pp.pair_attention_dq(q, k, v, o, lse, do, dlse))
    got = pp.pair_attention_dkv(q, k, v, o, lse, do, dlse, scratch=scratch)
    want = pp.pair_attention_dkv(q, k, v, o, lse, do, dlse)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (scratch == 7.0).all()


def _dense_torch(q, k, v, causal):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return o, lse.transpose(1, 2)


@pytest.mark.parametrize("causal,Tq,Tk", CASES + [(True, 5, 5)])
@pytest.mark.parametrize("drop", [None, "do", "dlse"])
def test_autograd_function_matches_dense_autograd(causal, Tq, Tk, drop):
    """Both cotangents, or one of them absent (``None`` means zeros)."""
    q, k, v, do, dlse = _inputs(2, 2, Tq, Tk, 3, 16, scale=0.5)
    grads = []
    for fn in (pp.pallas_pair_attention, _dense_torch):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        o, lse = fn(*ts, causal)
        loss = 0.0
        if drop != "do":
            loss = loss + (o * torch.from_numpy(do)).sum()
        if drop != "dlse":
            loss = loss + (lse * torch.from_numpy(dlse)).sum()
        loss.backward()
        # autograd leaves an unreached leaf's grad None: zeros
        grads.append([torch.zeros_like(t) if t.grad is None else t.grad
                      for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_plain_backward_entry_points_and_roundings():
    """dq and dk/dv entry points equal one dense recompute; in bf16 the
    plain versions round as the reference does (P to v's dtype before
    P V)."""
    q, k, v, do, dlse = (torch.from_numpy(a) for a in
                         _inputs(3, 1, 48, 48, 2, 64))
    o, lse = pp.pair_attention_fwd(q, k, v, True)
    dq, dk, dv = pp.pair_attention_bwd_reference(q, k, v, o, lse, do, dlse,
                                                 True)
    assert torch.equal(pp.pair_attention_dq(q, k, v, o, lse, do, dlse,
                                            True), dq)
    got_dk, got_dv = pp.pair_attention_dkv(q, k, v, o, lse, do, dlse, True)
    assert torch.equal(got_dk, dk) and torch.equal(got_dv, dv)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    ob, lseb = pp.pair_attention_fwd(qb, kb, vb, True)
    assert ob.dtype == torch.bfloat16 and lseb.dtype == torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", qb.float(), kb.float())
    s = torch.where(torch.ones(48, 48, dtype=torch.bool).tril(), s,
                    torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    want = torch.einsum("bhqk,bkhd->bqhd", p, vb.float()).to(torch.bfloat16)
    assert torch.equal(ob, want)


def test_gate_and_shape_errors():
    assert pp.pair_supports(1024, 1024, 256, torch.bfloat16) == pp.BLOCK
    assert pp.pair_supports(320, 640, 64, torch.bfloat16) == pp.BLOCK
    assert pp.pair_supports(1024, 1024, 96, torch.bfloat16) is None
    assert pp.pair_supports(1024, 1024, 256, torch.float32) is None
    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="Tq == Tk"):
        pp.pallas_pair_attention(x, torch.zeros(1, 4, 2, 16),
                                 torch.zeros(1, 4, 2, 16), True)
    with pytest.raises(ValueError, match="pair attention takes"):
        pp.pair_attention_fwd(x, torch.zeros(1, 4, 3, 16),
                              torch.zeros(1, 4, 3, 16))
    with pytest.raises(ValueError, match="64-row"):
        pp.pair_attention_fwd(x, x, x, False, block=32)
