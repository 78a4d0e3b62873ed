"""Port ServingEngine's multi-step decode (``multi_step_k > 1``) on the
CPU, slot and paged layouts:

- greedy streams equal the JAX engine's with the same ``multi_step_k``;
- k-step streams equal the k=1 engine's bit for bit, greedy AND sampled
  (each slot's generator advances exactly as k one-token ticks advance
  it), sync and pipelined, chunked and monolithic;
- an EOS at any step of a window is trimmed, and the paged chain —
  including its worst-case tail — returns in the same reconcile;
- the gate falls back to k=1 with its reason counted, and a window's
  tokens get per-token timestamps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_util as U  # noqa: E402
from torch_engine_util import one_thread  # noqa: E402,F401

from distkeras_torch import bridge  # noqa: E402
from distkeras_torch.models.transformer import generate  # noqa: E402


@pytest.fixture(scope="module")
def trio():
    return U.pair(cache_dtype="int8")


def _workload(n=4, prompt_len=10):
    rng = np.random.default_rng(0)
    ps = [rng.integers(0, U.V, size=prompt_len).astype(np.int32)
          for _ in range(n)]
    lens = [17, 22, 15, 30, 19, 26][:n]
    temps = [0.0, 0.8, 0.0, 1.0, 0.0, 0.7][:n]
    return ps, [dict(max_new_tokens=m, temperature=t, seed=i)
                for i, (m, t) in enumerate(zip(lens, temps))]


def _ran_windows(eng):
    """True iff at least one k>1 window dispatched (guards the parity
    assertions against a vacuously disabled fast path)."""
    return any(r.get("multi_k", 1) > 1 for r in eng.flight.snapshots())


def _serve(pm, ps, cfgs, **kw):
    kw.setdefault("prefill_chunk", 4)
    eng = U.port_engine(pm, slots=3, **kw)
    return U.serve(eng, ps, cfgs), eng


@pytest.mark.parametrize("paged", [False, True])
def test_multistep_greedy_equals_jax_engine(trio, paged):
    jm, params, pm = trio
    ps, _ = _workload()
    cfgs = U.greedy((17, 22, 15, 30))
    want = U.serve(U.jax_engine(jm, params, slots=3, prefill_chunk=4,
                                paged=paged, multi_step_k=4), ps, cfgs)
    got, eng = _serve(pm, ps, cfgs, paged=paged, multi_step_k=4)
    assert got == want
    assert _ran_windows(eng)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("pipeline", [False, True])
def test_multistep_equals_one_step(trio, paged, pipeline):
    """k=4 streams (mixed greedy / sampled rows) equal the sync k=1
    engine's and solo generate()."""
    _, _, pm = trio
    ps, cfgs = _workload()
    base, _ = _serve(pm, ps, cfgs, paged=paged)
    got, eng = _serve(pm, ps, cfgs, paged=paged, multi_step_k=4,
                      pipeline=pipeline)
    assert got == base
    assert _ran_windows(eng)
    for p, c, s in zip(ps, cfgs, base):
        ref = generate(pm, p[None], c["max_new_tokens"],
                       temperature=c["temperature"], seed=c["seed"])
        assert s == ref[0, len(p):].tolist()
    st = eng.stats()
    assert st["dispatches"] < st["tokens_generated"]
    assert st["tokens_per_dispatch"]["p50"] is not None


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("k,chunk", [(2, 4), (3, None)])
def test_multistep_other_widths_and_monolithic(trio, paged, k, chunk):
    _, _, pm = trio
    ps, cfgs = _workload()
    base, _ = _serve(pm, ps, cfgs, paged=paged, prefill_chunk=chunk)
    got, eng = _serve(pm, ps, cfgs, paged=paged, prefill_chunk=chunk,
                      multi_step_k=k)
    assert got == base
    assert _ran_windows(eng)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_late_eos_trim_matrix(trio, paged, step):
    """EOS landing at step 1..k of a window: the device stop mask
    freezes the row, reconcile trims nothing past the EOS token, and
    (paged) the whole chain returns to the pool in the same reconcile."""
    _, _, pm = trio
    ps, cfgs = _workload()
    ref = generate(pm, ps[0][None], 17)[0, len(ps[0]):].tolist()
    eos = ref[step + 8]  # inside request 0's decode steady state
    cfgs = [dict(c, eos_id=eos) for c in cfgs]
    r1, _ = _serve(pm, ps, cfgs, paged=paged)
    rk, eng = _serve(pm, ps, cfgs, paged=paged, multi_step_k=4)
    assert rk == r1
    assert rk[0] == ref[:ref.index(eos) + 1]
    if paged:
        assert eng.pool.stats()["live"] == 0


def test_paged_block_occupancy_flat_across_eos_churn(trio):
    """Early-EOS windows never strand the preallocated tail blocks:
    occupancy is flat across churn rounds."""
    _, _, pm = trio
    ps, cfgs = _workload()
    ref = generate(pm, ps[0][None], 17)[0, len(ps[0]):].tolist()
    eng = U.port_engine(pm, slots=3, prefill_chunk=4, paged=True,
                        multi_step_k=4, num_blocks=16, prefix_cache=False)
    reclaimable = []
    for round_i in range(3):
        eos = ref[5 + round_i]
        U.serve(eng, ps, [dict(c, eos_id=eos) for c in cfgs])
        assert eng.pool.stats()["live"] == 0
        reclaimable.append(eng.stats()["blocks_reclaimable"])
    assert _ran_windows(eng)
    assert len(set(reclaimable)) == 1, reclaimable


def test_multi_gate_fallback_reasons(trio):
    """Each non-steady-state condition forces k=1 with its reason
    counted; clearing it restores the window."""
    _, _, pm = trio
    ps, _ = _workload(1)
    eng = U.port_engine(pm, slots=2, prefill_chunk=4, multi_step_k=4)
    req = eng.submit(ps[0], max_new_tokens=40)
    for _ in range(50):
        if any(st is not None and st.decoding for st in eng._slots):
            break
        eng.step()
    base = dict(eng.multi_step_fallbacks)
    assert eng._multi_gate() > 1
    assert dict(eng.multi_step_fallbacks) == base
    eng._restore_queue.append(("h", 0))
    assert eng._multi_gate() == 1
    eng._restore_queue.clear()
    eng._inflight_restores["h"] = 0
    assert eng._multi_gate() == 1
    eng._inflight_restores.clear()
    s = next(i for i, st in enumerate(eng._slots) if st is not None)
    eng._slots[s].decoding = False
    assert eng._multi_gate() == 1
    eng._slots[s].decoding = True
    saved = eng.scheduler.tick_token_budget
    eng.scheduler.tick_token_budget = 1
    assert eng._multi_gate() == 1
    eng.scheduler.tick_token_budget = saved
    seen = eng.stats()["multi_step_fallbacks"]
    delta = {r: seen.get(r, 0) - base.get(r, 0)
             for r in ("restore", "prefill", "budget")}
    assert delta == {"restore": 2, "prefill": 1, "budget": 1}
    assert eng._multi_gate() > 1
    eng.drain()
    assert req.stream.tokens(timeout=10) == generate(
        pm, ps[0][None], 40)[0, len(ps[0]):].tolist()


def test_fallback_chunk_dealt_mid_drain(trio):
    """A request arriving mid-decode forces k=1 while its chunks deal,
    then windows resume; every stream stays exact."""
    _, _, pm = trio
    ps, cfgs = _workload()
    eng = U.port_engine(pm, slots=2, prefill_chunk=4, multi_step_k=4)
    first = [eng.submit(p, **c) for p, c in zip(ps[:2], cfgs[:2])]
    for _ in range(8):
        eng.step()
    late = [eng.submit(p, **c) for p, c in zip(ps[2:], cfgs[2:])]
    eng.drain()
    streams = [r.stream.tokens(timeout=10) for r in first + late]
    for p, c, s in zip(ps, cfgs, streams):
        assert s == generate(pm, p[None], c["max_new_tokens"],
                             temperature=c["temperature"],
                             seed=c["seed"])[0, len(p):].tolist()
    assert eng.stats()["multi_step_fallbacks"].get("prefill", 0) > 0
    assert _ran_windows(eng)


def test_weight_push_mid_drain_parity(trio):
    """A swap of the same weights between windows (bumped version)
    lands at a dispatch boundary; streams stay bit-identical."""
    _, _, pm = trio
    ps, cfgs = _workload()
    base, _ = _serve(pm, ps, cfgs)
    eng = U.port_engine(pm, slots=3, prefill_chunk=4, multi_step_k=4)
    reqs = [eng.submit(p, **c) for p, c in zip(ps, cfgs)]
    for _ in range(6):
        eng.step()
    assert eng.update_weights(bridge.params_to_jax(pm),
                              version=7)["version"] == 7
    eng.drain()
    assert [r.stream.tokens(timeout=10) for r in reqs] == base
    assert _ran_windows(eng)


def test_itl_per_token_timestamps(trio):
    """One k-wide readback stamps its tokens with strictly increasing
    timestamps, not one lump."""
    _, _, pm = trio
    ps, cfgs = _workload()
    eng = U.port_engine(pm, slots=3, prefill_chunk=4, multi_step_k=4)
    captured = []
    orig = eng._emit_now

    def spy(req, toks, now, times=None):
        captured.append((len(toks), times))
        return orig(req, toks, now, times)

    eng._emit_now = spy
    U.serve(eng, ps, cfgs)
    wide = [(n, t) for n, t in captured if t is not None and n > 1]
    assert wide
    for n, times in wide:
        used = times[:n]
        assert all(b > a for a, b in zip(used, used[1:])), used


def test_stats_and_flight_surfaces(trio):
    _, _, pm = trio
    ps, cfgs = _workload()
    _, eng = _serve(pm, ps, cfgs, paged=True, multi_step_k=4)
    st = eng.stats()
    assert st["multi_step_k"] == 4 and st["dispatches"] > 0
    ks = [s["multi_k"] for s in eng.flight.snapshots() if "multi_k" in s]
    assert ks and set(ks) == {4}


def test_scheduler_plan_multi_step():
    """A k-step window charges n_decoding * k against the tick budget:
    the widest covered width, floored at 1."""
    from distkeras_torch.serving import FIFOScheduler

    s = FIFOScheduler(tick_token_budget=8)
    assert s.plan_multi_step(1, 8) == 8
    assert s.plan_multi_step(2, 8) == 4
    assert s.plan_multi_step(3, 8) == 2
    assert s.plan_multi_step(8, 4) == 1
    assert s.plan_multi_step(0, 8) == 1
    assert s.plan_multi_step(2, 3) == 3
