"""Shared pieces of the port's engine tests (``tests/test_torch_*.py``):
a tiny f32 model built once in JAX and bridged into the port, engines of
both packages on the CPU (the JAX engine forced onto its gather /
dense reference attends), request helpers, and the two-sample
chi-square statistic of ``tests/test_spec.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distkeras_tpu import telemetry as jax_telemetry
from distkeras_tpu.models import get_model as jax_get_model
from distkeras_tpu.serving import ServingEngine as JaxEngine
from distkeras_torch import bridge, telemetry
from distkeras_torch.models import get_model
from distkeras_torch.serving import ServingEngine

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors gain nothing from intra-op threads, and the suite
    runs several test processes at once: run each importing module on
    one torch thread, then restore the setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


V = 97
KW = dict(vocab_size=V, d_model=64, num_heads=4, num_layers=2, max_len=96,
          num_kv_heads=2, pos_emb="rope")
# chi-square critical value at alpha=0.001, by degrees of freedom
CHI2_CRIT = {15: 37.7, 31: 61.1}


def pair(seed=0, base=KW, **over):
    """The same weights in both packages: ``(jax module, params, port
    model)`` of ``base`` updated by ``over``. The port model is made from
    ``seed`` on the CPU and its weights are bridged into the flax tree
    (flax's own ``init`` runs op by op and takes seconds a model)."""
    kw = dict(base)
    kw.update(over)
    jm = jax_get_model("transformer_lm", dtype=jnp.float32, **kw)
    pm = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                   seed=seed, **kw)
    params = jax.tree.map(jnp.asarray, bridge.params_to_jax(pm))
    return jm, params, pm


def port_engine(pm, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("prefill_chunk", 8)
    return ServingEngine(pm, device="cpu", registry=telemetry.MetricRegistry(),
                         tracer=telemetry.Tracer(), **kw)


def jax_engine(jm, params, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("prefill_chunk", 8)
    return JaxEngine(jm, params, paged_kernel="gather",
                     prefill_kernel="gather",
                     registry=jax_telemetry.MetricRegistry(),
                     tracer=jax_telemetry.Tracer(), **kw)


def prompts(n=4, system=16, tails=(3, 9, 5, 12, 7, 4), seed=0):
    """``n`` prompts opening with one shared ``system``-token prefix,
    then a private tail each."""
    rng = np.random.default_rng(seed)
    sys_ = rng.integers(0, V, size=system)
    return [np.concatenate([sys_, rng.integers(0, V, size=k)]).astype(
        np.int32) for k in tails[:n]]


def serve(eng, prompts_, cfgs, timeout=120.0):
    reqs = [eng.submit(p, **c) for p, c in zip(prompts_, cfgs)]
    eng.drain(timeout=timeout)
    return [r.stream.tokens(timeout=10) for r in reqs]


def greedy(ns):
    return [dict(max_new_tokens=n) for n in ns]


MIXED = [
    dict(max_new_tokens=14),
    dict(max_new_tokens=11, temperature=1.0, seed=7),
    dict(max_new_tokens=9, temperature=0.8, seed=3, top_k=8),
    dict(max_new_tokens=12, temperature=0.9, seed=11, top_p=0.9),
]


def chi2_two_sample(a, b, vocab):
    """Two-sample chi-square statistic over token counts (df <= V-1) —
    ``_chi2_two_sample`` of ``tests/test_spec.py``."""
    c1 = np.bincount(a, minlength=vocab).astype(float)
    c2 = np.bincount(b, minlength=vocab).astype(float)
    tot = c1 + c2
    return float(np.sum(
        np.where(tot > 0, (c1 - c2) ** 2 / np.maximum(tot, 1.0), 0.0)))
