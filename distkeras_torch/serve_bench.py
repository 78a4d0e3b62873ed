"""Serving benchmarks of the port: the reference's
``benchmarks/serve_bench.py`` over port engines — its seven single-engine
modes, its four multi-replica modes and its tensor-parallel
``--multichip`` mode.

Run ``python -m distkeras_torch.serve_bench`` with a mode flag (none:
the Poisson bench), ``--smoke`` for the mode's small self-checking
variant (``--smoke`` alone: the shared-prefix smoke), ``--no-checks`` to
record a single-engine smoke's checks without raising, and ``--device
cpu`` to run the plain PyTorch path on the host. Without ``--device``
the engines run on the CUDA card (the fleet modes: replica ``i`` on
``cuda:{i % device_count}``, one replica per card as the reference pins
one per device; on one card every replica shares it), and the command
raises when there is no card. Each prints one JSON line.

Single-engine modes (each a function of the reference's name, signature,
defaults and smoke sizes, plus ``device=`` and ``checks=``):

- no flag: continuous batching vs back-to-back ``generate()`` under
  Poisson arrivals (:func:`bench`);
- ``--shared-prefix``: the paged engine's radix prefix cache on vs off
  (:func:`bench_shared_prefix`);
- ``--host-tier``: the host-RAM KV tier vs device-only vs an
  all-resident pool (:func:`bench_host_tier`);
- ``--long-prompt-interference``: chunked vs monolithic prefill under a
  closed loop of decoding streams (:func:`bench_long_prompt_interference`);
- ``--speculative``: an n-gram or draft-model drafter vs the plain tick
  at high acceptance (:func:`bench_speculative`);
- ``--pipeline``: the pipelined loop vs the sync one
  (:func:`bench_pipeline`);
- ``--multi-step``: the multi-step decode window's sweep over k
  (:func:`bench_multistep`).

Each records every self-check of the reference in its result, at any
size, as ``"checks": {"exact": {...}, "timing": {...}}``: exact ones
(stream parity, token counts, hits, demotions and restores, stall
counters, acceptance, exposition names, dispatch counts, steady-state
recompiles) hold on any hardware; timing ones (thresholds on tok/s,
speedups, ITL, TTFT, the flight recorder's share, the pipeline's
device wait) depend on the host. Under ``--smoke`` (unless
``--no-checks``) a mode raises listing every check that missed, where
the reference asserts. The Poisson bench has no smoke; the port records
two exact checks there (every request finished, no steady-state
recompile). Each mode builds its model as ``_lm(device, _tree(seed,
...))``, so a test can hand both packages the same weights by replacing
:func:`_tree`, and draws its traces from ``numpy.random.default_rng`` in
the reference's order (bit-identical prompts and lengths).

Fleet and multichip modes:

- ``--router``: N ``LMServer`` replicas behind the prefix-affinity
  ``Router`` vs one replica, a random-routing control arm, a one-replica
  hit-fraction reference with the fleet's aggregate block budget, and a
  kill-one-replica failover pass (:func:`bench_router`);
- ``--fleet-sim``: the ``Autoscaler`` control loop under a seeded
  diurnal load model with a QoS batch tier and a replica kill
  (:func:`bench_fleet_sim`);
- ``--disagg``: one prefill-role and N-1 decode-role replicas with KV
  migration vs N mixed replicas, plus a migration-vs-eviction race
  (:func:`bench_disagg`);
- ``--live-update``: rolling weight updates mid-flight and an SLO-burn
  auto-rollback on a bad checkpoint (:func:`bench_live_update`);
- ``--multichip``: the same paged engine at each tp degree of
  ``--tp-list``, its decode tok/s and streams against the mesh-less
  engine's (:func:`bench_multichip`). A tp > 1 runs as that many spawned
  ranks (this script, ``--multichip-rank``) under the engine's lock-step
  loop: gloo on the CPU, NCCL with one card a rank on a host of enough
  cards, gloo with every rank on the one card otherwise.

Every replica gets a model of its own, loaded from one numpy weight tree
(a port model passed to two engines shares its parameters, so a push to
one would swap the others' too). The reference streams come from the
port's ``generate()`` on yet another model carrying the same tree.

Every mode marks its engines steady after its warm-up and reports what
the measured part built, loaded or launched for the first time
(``*steady_recompiles``: the port counts kernel builds, library loads
and first launches of each kernel configuration where the reference
counts JAX retraces; on the CPU nothing is counted). Departures from the
reference, on purpose: its respawn into forced virtual host devices
(``run_router`` and its siblings, ``run_multichip``) has no counterpart:
the replicas share the cards or the host as they are, and
``--multichip`` spawns one process a tp rank; ``_overfit_cycle`` draws
its batch starts from numpy, not JAX's threefry. A fleet mode's
``--smoke`` evaluates every self-check of the reference (the same
thresholds) and fails listing each one that missed.
"""

import argparse
import io
import json
import os
import tempfile
import threading
import time

import numpy as np
import torch


def _devices(device=None):
    """The devices replica ``i`` takes round-robin: every CUDA card (the
    default; raises without one) or the one device asked for."""
    from distkeras_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device(f"cuda:{i}")
                for i in range(torch.cuda.device_count())]
    return [dev]


def _lm(device, tree=None, seed=0, **kw):
    """A port TransformerLM on ``device`` carrying the flax-layout numpy
    ``tree`` (or made from ``seed``)."""
    from distkeras_torch import bridge
    from distkeras_torch.models import get_model

    m = get_model("transformer_lm", device=device, seed=seed, **kw)
    if tree is not None:
        bridge.params_from_jax(tree, m)
    return m


def _tree(seed, **kw):
    """The flax-layout numpy weight tree of a model made from ``seed``."""
    from distkeras_torch import bridge

    return bridge.params_to_jax(_lm("cpu", seed=seed, **kw))


def _solo(model, prompt, n, **kw):
    from distkeras_torch.models.transformer import generate

    out = generate(model, torch.as_tensor(np.asarray(prompt))[None], n, **kw)
    return out[0, len(prompt):].tolist()


def _check(result, checks):
    """Evaluate every ``(name, passed)`` self-check; raise listing each
    one that failed (all are evaluated, so a missed threshold never hides
    an exactness or lost-stream failure behind it)."""
    failed = [name for name, ok in checks if not ok]
    if failed:
        raise AssertionError(f"self-checks failed: {failed}; result: "
                             f"{json.dumps(result, default=str)}")


def _kw(dtype):
    return dict(dtype=getattr(torch, dtype), attention="dense")


def _device(device):
    """The one device a single-engine mode runs on: the first CUDA card
    (the default; raises without one) or the device asked for."""
    return _devices(device)[0]


def _pct(vals, q):
    """The reference's client-side percentile of sorted samples."""
    return vals[int(q * (len(vals) - 1))] if vals else None


def _flips(model, prompts, got, want, rows):
    """Where the greedy streams of ``rows`` in ``got`` leave ``want``:
    each one's first differing token and, from one forward of the model
    over the prompt and the shared tokens, the gap between its top two
    logits there (a near tie reads at the dtype's rounding)."""
    out = []
    for i in rows:
        x, y = list(got[i]), list(want[i])
        if x == y:
            continue
        j = next((k for k, (u, v) in enumerate(zip(x, y)) if u != v),
                 min(len(x), len(y)))
        ctx = torch.as_tensor(np.concatenate(
            [prompts[i], np.asarray(x[:j], np.int32)]),
            dtype=torch.long, device=model.device)[None]
        with torch.no_grad():
            top = model(ctx)[0, -1].float().topk(2).values
        out.append({"row": i, "first_flip": j, "of": len(x),
                    "top2_gap": (top[0] - top[1]).item()})
    return out


def _verdict(result, exact, timing, smoke, checks):
    """Record every self-check of a single-engine mode in
    ``result["checks"]`` — ``exact`` (streams, counts, hits, recompiles:
    they hold on any hardware) apart from ``timing`` (thresholds on
    tok/s, speedups, ITL, TTFT and the flight recorder's share, which
    depend on the host) — print the result's JSON line, and under
    ``smoke`` with ``checks`` raise listing each check that missed (as
    the reference asserts under its smoke)."""
    result["checks"] = {"exact": {n: bool(ok) for n, ok in exact},
                        "timing": {n: bool(ok) for n, ok in timing}}
    print(json.dumps(result), flush=True)
    if smoke and checks:
        _check(result, list(exact) + list(timing))
    return result


def _engine(model, device, **kw):
    from distkeras_torch import telemetry
    from distkeras_torch.serving import ServingEngine

    kw.setdefault("registry", telemetry.MetricRegistry())
    kw.setdefault("tracer", telemetry.Tracer())
    return ServingEngine(model, device=device, **kw)


def _trace(n_requests, prompt_len, vocab, mean_interarrival_s, seed=0):
    """Poisson arrivals with mixed output lengths (the continuous-batching
    win case: a long request must not hold short ones hostage)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(
        rng.exponential(mean_interarrival_s, size=n_requests)
    )
    lengths = rng.choice([8, 16, 32, 48], size=n_requests)
    prompts = [rng.integers(0, vocab, size=prompt_len).astype(np.int32)
               for _ in range(n_requests)]
    return [
        {"at": float(a), "prompt": p, "max_new_tokens": int(m)}
        for a, p, m in zip(arrivals, prompts, lengths)
    ]


def bench(V=1024, D=256, H=4, L=4, slots=8, n_requests=48, prompt_len=16,
          mean_interarrival_s=0.002, dtype="float32", metrics_path=None,
          device=None, checks=True):
    """Serving throughput: the continuous-batching engine vs back-to-back
    ``generate()`` (B=1) over the same seeded Poisson-arrival trace with
    mixed output lengths. Sustained tokens/s is generated tokens over
    the makespan (first arrival to last completion), so queueing counts
    against each system. TTFT p50/p99 come from the engine's
    ``MetricsWriter``; the TTFT and per-token histograms from a
    run-isolated registry. The reference has no self-check here; the
    port records two exact ones (every request finished: the engine's
    tokens equal the static baseline's; nothing built or first-launched
    after the warm-up). There is no smoke, so nothing raises
    (``checks`` is taken for the CLI's sake)."""
    from distkeras_torch import telemetry
    from distkeras_torch.models.transformer import generate
    from distkeras_torch.utils.metrics import MetricsWriter

    dev = _device(device)
    max_new_max = 48
    mkw = dict(vocab_size=V, d_model=D, num_heads=H, num_layers=L,
               max_len=prompt_len + max_new_max, **_kw(dtype))
    model = _lm(dev, _tree(0, **mkw), **mkw)
    trace = _trace(n_requests, prompt_len, V, mean_interarrival_s)

    # -- warm both systems (steady state is the claim) ----------------------
    warm_prompt = torch.as_tensor(trace[0]["prompt"])[None]
    for m in sorted({r["max_new_tokens"] for r in trace}):
        generate(model, warm_prompt, m).cpu()
    warm_engine = _engine(model, dev, slots=slots)
    warm_engine.submit(trace[0]["prompt"], max_new_tokens=4)
    warm_engine.drain()

    # -- continuous-batching engine -----------------------------------------
    metrics = MetricsWriter(metrics_path)
    # run-isolated registry: the emitted histograms cover exactly this
    # measured run
    registry = telemetry.MetricRegistry()
    engine = _engine(model, dev, slots=slots, metrics=metrics,
                     registry=registry)
    engine.mark_steady()
    stop = threading.Event()
    loop = threading.Thread(target=engine.serve_forever, args=(stop,),
                            daemon=True)
    t0 = time.perf_counter()
    loop.start()
    reqs = []
    for r in trace:
        delay = t0 + r["at"] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        reqs.append(
            engine.submit(r["prompt"], max_new_tokens=r["max_new_tokens"])
        )
    tokens_engine = sum(len(r.stream.tokens(timeout=120)) for r in reqs)
    dt_engine = time.perf_counter() - t0
    stop.set()
    loop.join(timeout=10)
    stats = engine.stats()

    # -- static baseline: back-to-back generate() over the same trace -------
    t0 = time.perf_counter()
    tokens_static = 0
    for r in trace:
        delay = t0 + r["at"] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        out = generate(model, torch.as_tensor(r["prompt"])[None],
                       r["max_new_tokens"]).cpu()
        tokens_static += int(out.shape[1]) - prompt_len
    dt_static = time.perf_counter() - t0

    result = {
        "serve_tokens_per_sec": round(tokens_engine / dt_engine, 1),
        "static_tokens_per_sec": round(tokens_static / dt_static, 1),
        "speedup": round(dt_static / dt_engine, 2),
        "ttft_ms": stats["ttft_ms"],
        "ttft_hist": registry.histogram("serving_ttft_ms").value,
        "token_ms_hist": registry.histogram("serving_token_ms").value,
        "mean_occupancy": stats["mean_occupancy"],
        "flight_overhead_frac": stats["flight"]["overhead_frac"],
        "steady_recompiles": stats["recompiles_since_mark"],
        "memory": stats["memory"],
        "config": f"d{D}/h{H}/L{L}/v{V}-slots{slots}-req{n_requests}"
                  f"-prompt{prompt_len}-poisson{mean_interarrival_s}"
                  f"-mixed8to48-{dtype}",
    }
    return _verdict(result, [
        ("engine tokens == static tokens", tokens_engine == tokens_static),
        ("steady_recompiles == {}", result["steady_recompiles"] == {}),
    ], [], False, checks)


def _prefix_trace(n_requests, prefix_len, tail_len, vocab,
                  shared_frac=0.9, seed=0):
    """The prefix-caching win case: ``shared_frac`` of requests open
    with one fixed system prompt and differ only in a short tail."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, size=prefix_len).astype(np.int32)
    out = []
    for i in range(n_requests):
        tail = rng.integers(0, vocab, size=tail_len).astype(np.int32)
        if rng.random() < shared_frac or i == 0:
            prompt = np.concatenate([system, tail])
        else:  # cold request: fresh pseudo-prefix, no reuse
            prompt = np.concatenate([
                rng.integers(0, vocab, size=prefix_len).astype(np.int32),
                tail,
            ])
        out.append(prompt)
    return out


def bench_shared_prefix(V=1024, D=256, H=4, L=4, slots=8, n_requests=16,
                        prefix_len=256, tail_len=8, max_new=8,
                        block_size=16, dtype="float32", smoke=False,
                        device=None, checks=True):
    """TTFT with 90% shared system prompts: the paged engine with the
    radix prefix cache vs the same engine with the cache off (full
    prefill per request). Requests run one at a time on an idle engine,
    so TTFT is a clean prefill measurement. Self-checks: hits happen and
    the hit counters are in the Prometheus exposition, both runs emit
    every token, nothing is built or first-launched after the warm-up,
    and the flight recorder costs under 5% of tick time."""
    from distkeras_torch import telemetry
    from distkeras_torch.telemetry.exposition import render_prometheus

    if smoke:
        V, D, H, L, slots = 64, 32, 2, 2, 2
        n_requests, prefix_len, tail_len, max_new = 8, 32, 4, 4
        block_size = 8
    dev = _device(device)
    max_len = prefix_len + tail_len + max_new
    max_len += (-max_len) % block_size  # paged mode: whole blocks
    mkw = dict(vocab_size=V, d_model=D, num_heads=H, num_layers=L,
               max_len=max_len, **_kw(dtype))
    model = _lm(dev, _tree(0, **mkw), **mkw)
    trace = _prefix_trace(n_requests, prefix_len, tail_len, V)

    def run(prefix_cache):
        # warm engine: full prefill, the suffix-only prefill of the hit
        # path (two same-prefix requests back to back) and the tick at
        # both occupancies, on a throwaway engine
        rng = np.random.default_rng(99)
        sys_prompt = trace[0][:prefix_len]
        warm_eng = _engine(model, dev, slots=slots, paged=True,
                           block_size=block_size, prefix_cache=prefix_cache)
        for _ in range(2):
            tail = rng.integers(0, V, size=tail_len).astype(np.int32)
            warm_eng.submit(np.concatenate([sys_prompt, tail]),
                            max_new_tokens=max_new)
            warm_eng.drain()

        registry = telemetry.MetricRegistry()
        engine = _engine(model, dev, slots=slots, paged=True,
                         block_size=block_size, prefix_cache=prefix_cache,
                         registry=registry)
        engine.mark_steady()
        t0 = time.perf_counter()
        tokens = 0
        for p in trace:
            req = engine.submit(p, max_new_tokens=max_new)
            engine.drain()
            tokens += len(req.stream.tokens(timeout=60))
        dt = time.perf_counter() - t0
        return engine, registry, tokens, dt

    eng_hit, reg_hit, tokens_hit, dt_hit = run(prefix_cache=True)
    eng_cold, _, tokens_cold, dt_cold = run(prefix_cache=False)
    s_hit, s_cold = eng_hit.stats(), eng_cold.stats()
    exposition = render_prometheus(reg_hit)
    result = {
        "prefix_ttft_ms_p50": s_hit["ttft_ms"]["p50"],
        "full_ttft_ms_p50": s_cold["ttft_ms"]["p50"],
        "ttft_speedup": (
            round(s_cold["ttft_ms"]["p50"] / s_hit["ttft_ms"]["p50"], 2)
            if s_hit["ttft_ms"]["p50"] else None
        ),
        "prefix_hit_fraction": s_hit["prefix_hit_fraction"],
        "prefix_hit_tokens": s_hit["prefix_hit_tokens"],
        "block_evictions": reg_hit.counter(
            "serving_block_evictions_total").value,
        "tokens_per_sec": round(tokens_hit / dt_hit, 1),
        "tokens_per_sec_no_cache": round(tokens_cold / dt_cold, 1),
        "flight_overhead_frac": s_hit["flight"]["overhead_frac"],
        "steady_recompiles": s_hit["recompiles_since_mark"],
        "memory": s_hit["memory"],
        "config": f"d{D}/h{H}/L{L}/v{V}-slots{slots}-req{n_requests}"
                  f"-prefix{prefix_len}+{tail_len}-new{max_new}"
                  f"-bs{block_size}-{dtype}"
                  + ("-smoke" if smoke else ""),
    }
    return _verdict(result, [
        ("prefix_hit_fraction > 0", result["prefix_hit_fraction"] > 0),
        ("serving_prefix_hit_tokens_total in exposition",
         "serving_prefix_hit_tokens_total" in exposition),
        ("serving_blocks_in_use in exposition",
         "serving_blocks_in_use" in exposition),
        ("tokens_hit == tokens_cold == n_requests * max_new",
         tokens_hit == tokens_cold == n_requests * max_new),
        ("steady_recompiles == {}", result["steady_recompiles"] == {}),
    ], [
        ("flight_overhead_frac < 0.05",
         result["flight_overhead_frac"] < 0.05),
    ], smoke, checks)


def _tier_trace(n_groups, reps, prefix_len, tail_len, vocab, seed=0):
    """The tiered-cache win case: ``n_groups`` distinct shared system
    prompts visited round-robin, so by the time a prefix is revisited
    the LRU has evicted it from a device pool sized for a fraction of
    the working set — device-only recomputes it, the host tier swaps
    it back in."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, size=prefix_len).astype(np.int32)
                for _ in range(n_groups)]
    out = []
    for _ in range(reps):
        for p in prefixes:
            tail = rng.integers(0, vocab, size=tail_len).astype(np.int32)
            out.append(np.concatenate([p, tail]))
    return out


def bench_host_tier(V=1024, D=256, H=4, L=4, slots=4, n_groups=9,
                    reps=4, prefix_len=256, tail_len=8, max_new=16,
                    block_size=16, restore_budget=4, dtype="float32",
                    smoke=False, checks=True, device=None):
    """Tiered KV cache: a shared-prefix working set sized to ~3x the
    device pool's cache headroom, served three ways — **tier** (the
    starved pool plus a host tier holding every prefix: eviction
    demotes, a revisit restores), **device** (the same pool, no tier: a
    revisit recomputes) and **resident** (a pool large enough for
    everything, the latency reference). The same greedy trace in all
    three, so the streams must be bit-identical. Self-checks: that
    parity, the tier's hit fraction >= max(2x device-only, 0.5), real
    demotions, restores and swap-in bytes, nothing built or
    first-launched after the warm-up (exact); the flight recorder under
    5% and the tier's p99 ITL within 10% + 2.5 ms of the resident run's
    (timing). Swap bytes are the host tier's own counters."""
    from distkeras_torch import telemetry
    from distkeras_torch.serving import FIFOScheduler

    if smoke:
        V, D, H, L, slots = 64, 32, 2, 2, 2
        n_groups, reps, prefix_len, tail_len, max_new = 6, 3, 32, 4, 16
        block_size = 8
    dev = _device(device)
    pb = prefix_len // block_size  # blocks per shared prefix
    worst = -(-(prefix_len + tail_len + max_new) // block_size)
    # device cache headroom = 1/3 of the prefix working set; the pool
    # also covers every live slot's worst case so admission never
    # deadlocks on its own residents
    cache_blocks = max((n_groups * pb) // 3, pb)
    num_blocks = 1 + slots * worst + cache_blocks
    host_blocks = n_groups * pb + pb
    max_len = prefix_len + tail_len + max_new
    max_len += (-max_len) % block_size
    mkw = dict(vocab_size=V, d_model=D, num_heads=H, num_layers=L,
               max_len=max_len, **_kw(dtype))
    model = _lm(dev, _tree(0, **mkw), **mkw)
    trace = _tier_trace(n_groups, reps, prefix_len, tail_len, V)
    warm_n = n_groups  # first round-robin pass = warm-up

    def run(tier, pool_blocks):
        engine = _engine(
            model, dev, slots=slots, paged=True, block_size=block_size,
            num_blocks=pool_blocks,
            host_blocks=host_blocks if tier else None,
            scheduler=FIFOScheduler(max_queue_depth=len(trace) + 1,
                                    restore_budget=restore_budget))
        # warm-up: the first pass over every prefix, submitted
        # concurrently (both widths, the decode-only shape and, on the
        # tier leg, demotion under pressure), then a revisit's restore,
        # all before the steady mark; greedy throughout
        warm = [engine.submit(p, max_new_tokens=max_new)
                for p in trace[:warm_n]]
        engine.drain(timeout=600)
        for r in warm:
            r.stream.tokens(timeout=60)
        engine.submit(trace[0], max_new_tokens=max_new)
        engine.drain(timeout=600)
        engine.mark_steady()
        reqs = [engine.submit(p, max_new_tokens=max_new)
                for p in trace[warm_n:]]
        t0 = time.perf_counter()
        engine.drain(timeout=600)
        dt = time.perf_counter() - t0
        streams = [r.stream.tokens(timeout=60) for r in reqs]
        # the stats now, before the next leg builds or launches anything
        return engine, engine.stats(), streams, dt

    eng_t, s_t, streams_t, dt_t = run(tier=True, pool_blocks=num_blocks)
    _, s_d, streams_d, dt_d = run(tier=False, pool_blocks=num_blocks)
    resident_blocks = 1 + slots * worst + n_groups * pb + cache_blocks
    _, s_r, streams_r, dt_r = run(tier=False,
                                  pool_blocks=resident_blocks)
    parity = streams_t == streams_d == streams_r
    swap_bytes = eng_t.host.bytes_restored_total
    tokens = sum(len(s) for s in streams_t)
    result = {
        "tier_hit_fraction": s_t["prefix_hit_fraction"],
        "device_hit_fraction": s_d["prefix_hit_fraction"],
        "resident_hit_fraction": s_r["prefix_hit_fraction"],
        "hit_gain": (
            round(s_t["prefix_hit_fraction"]
                  / s_d["prefix_hit_fraction"], 2)
            if s_d["prefix_hit_fraction"] else None
        ),
        "tier_itl_ms_p99": s_t["itl_ms"]["p99"],
        "resident_itl_ms_p99": s_r["itl_ms"]["p99"],
        "device_itl_ms_p99": s_d["itl_ms"]["p99"],
        "tier_tokens_per_sec": round(tokens / dt_t, 1),
        "device_tokens_per_sec": round(tokens / dt_d, 1),
        "resident_tokens_per_sec": round(tokens / dt_r, 1),
        "demotions": s_t["block_demotions"],
        "restores": s_t["block_restores"],
        "restore_wait_ms": s_t["restore_wait_ms"],
        "swap_in_bytes": swap_bytes,
        "swap_out_bytes": eng_t.host.bytes_demoted_total,
        # effective swap-in traffic over the measured drain — a demand
        # rate, not a link-bandwidth probe
        "swap_in_mb_s": round(swap_bytes / dt_t / 1e6, 2),
        "host_blocks_cached": s_t["host_blocks_cached"],
        "host_bytes": s_t["host_bytes"],
        "parity": parity,
        "flight_overhead_frac": s_t["flight"]["overhead_frac"],
        "steady_recompiles": s_t["recompiles_since_mark"],
        "memory": s_t["memory"],
        "config": f"d{D}/h{H}/L{L}/v{V}-slots{slots}"
                  f"-groups{n_groups}x{reps}-prefix{prefix_len}"
                  f"+{tail_len}-new{max_new}-bs{block_size}"
                  f"-dev{num_blocks}-host{host_blocks}"
                  f"-rb{restore_budget}-{dtype}"
                  + ("-smoke" if smoke else ""),
    }
    if not parity:
        result["parity_flips"] = {
            leg: _flips(model, trace[warm_n:], s, streams_t,
                        range(len(s)))
            for leg, s in (("device", streams_d), ("resident", streams_r))}
    r = result
    itl_t, itl_r = r["tier_itl_ms_p99"], r["resident_itl_ms_p99"]
    return _verdict(result, [
        ("parity", parity),
        ("tier_hit_fraction >= max(2 * device_hit_fraction, 0.5)",
         r["tier_hit_fraction"] >= max(2 * r["device_hit_fraction"], 0.5)),
        ("demotions > 0 and restores > 0",
         r["demotions"] > 0 and r["restores"] > 0),
        ("swap_in_bytes > 0", r["swap_in_bytes"] > 0),
        ("steady_recompiles == {}", r["steady_recompiles"] == {}),
    ], [
        ("flight_overhead_frac < 0.05", r["flight_overhead_frac"] < 0.05),
        ("tier_itl_ms_p99 <= 1.1 * resident_itl_ms_p99 + 2.5",
         not (itl_t and itl_r) or itl_t <= 1.1 * itl_r + 2.5),
    ], smoke, checks)


def _interference_trace(V, n_short, short_prompt, short_new, n_long,
                        long_prompt, seed=0):
    """The interference bench's short prompts, their staggered output
    lengths (equal ones would let the closed loop complete in lock step,
    every long prompt landing BETWEEN streams) and the long prompts."""
    rng = np.random.default_rng(seed)
    shorts = [rng.integers(0, V, size=short_prompt).astype(np.int32)
              for _ in range(n_short)]
    short_lens = rng.integers(max(2, short_new // 2), short_new + 1,
                              size=n_short)
    longs = [rng.integers(0, V, size=long_prompt).astype(np.int32)
             for _ in range(n_long)]
    return shorts, short_lens, longs


def bench_long_prompt_interference(
        V=1024, D=256, H=4, L=4, slots=4,
        n_short=24, short_prompt=16, short_new=32,
        n_long=6, long_prompt=1024, long_new=4, long_every=4,
        prefill_chunk=64, tick_token_budget=None, think_time=0.0,
        dtype="float32", smoke=False, checks=True, device=None):
    """p99 inter-token latency of live decode streams while long prompts
    keep arriving: chunked mixed-tick prefill vs monolithic prefill.

    A closed loop of ``slots - 1`` short requests decodes continuously
    (each completion submits the next); after every ``long_every`` short
    completions one ``long_prompt``-token request takes the spare slot.
    Monolithic mode runs each long prompt as one whole-prompt dispatch
    between ticks, which every live short stream waits out; chunked
    mode streams it ``prefill_chunk`` tokens a tick under
    ``tick_token_budget``. ITL is measured client-side (a consumer
    thread a request stamps each token). ``think_time`` pauses before
    each closed-loop refill (0 saturates). Self-checks: every short
    stream in both modes equals a solo ``generate()`` of its prompt (at
    any size), monolithic mode stalled decodes and chunked mode never
    did (``serving_decode_stalls_total``), nothing built or
    first-launched after the warm-up (exact); chunked p99 ITL under
    monolithic's and the flight recorder under 5% (timing)."""
    from distkeras_torch import telemetry
    from distkeras_torch.serving import FIFOScheduler

    if smoke:
        # sized so the monolithic long-prompt prefill's compute dominates
        # the per-dispatch host overhead; slots=3 keeps two shorts
        # decoding, so a long fired at one's completion always has
        # another mid-stream
        V, D, H, L, slots = 64, 256, 4, 2, 3
        n_short, short_prompt, short_new = 8, 8, 8
        n_long, long_prompt, long_new, long_every = 3, 1024, 2, 2
        prefill_chunk = 32
    if tick_token_budget is None:
        # one full chunk of prefill alongside every decode, per tick
        tick_token_budget = slots + prefill_chunk
    dev = _device(device)
    max_len = long_prompt + max(long_new, short_new)
    mkw = dict(vocab_size=V, d_model=D, num_heads=H, num_layers=L,
               max_len=max_len, **_kw(dtype))
    model = _lm(dev, _tree(0, **mkw), **mkw)
    shorts, short_lens, longs = _interference_trace(
        V, n_short, short_prompt, short_new, n_long, long_prompt)

    def make(chunked, registry=None):
        return _engine(
            model, dev, slots=slots,
            registry=registry or telemetry.MetricRegistry(),
            prefill_chunk=prefill_chunk if chunked else None,
            scheduler=FIFOScheduler(tick_token_budget=tick_token_budget,
                                    registry=telemetry.MetricRegistry(),
                                    tracer=telemetry.Tracer()))

    def run(chunked):
        # a throwaway engine through every shape the measured run uses
        warm = make(chunked)
        warm.submit(shorts[0], max_new_tokens=2)
        warm.submit(longs[0], max_new_tokens=2)
        warm.drain()

        registry = telemetry.MetricRegistry()
        engine = make(chunked, registry)
        engine.mark_steady()
        stop = threading.Event()
        loop = threading.Thread(target=engine.serve_forever, args=(stop,),
                                daemon=True)
        lock = threading.Lock()
        itls, streams = [], {}  # streams: short idx -> emitted tokens
        tokens = [0]
        short_left = list(enumerate(shorts))
        long_left = list(longs)
        short_done, long_done, long_fired = [0], [0], [0]
        threads = []

        def consume_long(req):
            n = len(req.stream.tokens(timeout=120))
            with lock:
                tokens[0] += n
                long_done[0] += 1

        def consume(idx, req):
            stamps, toks = [], []
            for tok in req.stream:
                stamps.append(time.perf_counter())
                toks.append(tok)
            with lock:
                tokens[0] += len(toks)
                streams[idx] = toks
                itls.extend(
                    (b - a) * 1e3 for a, b in zip(stamps, stamps[1:])
                )
                short_done[0] += 1
                # closed loop: a finished short feeds the next one in;
                # every long_every-th completion also launches a long
                nxt = short_left.pop(0) if short_left else None
                fire_long = (long_left
                             and short_done[0] % long_every == 0)
                lng = long_left.pop(0) if fire_long else None
                if lng is not None:
                    long_fired[0] += 1
            if lng is not None:
                rl = engine.submit(lng, max_new_tokens=long_new)
                tl = threading.Thread(target=consume_long, args=(rl,),
                                      daemon=True)
                tl.start()
                with lock:
                    threads.append(tl)
            if nxt is not None:
                if think_time > 0:
                    time.sleep(think_time)
                i, p = nxt
                r = engine.submit(p, max_new_tokens=int(short_lens[i]))
                t = threading.Thread(target=consume, args=(i, r),
                                     daemon=True)
                t.start()
                with lock:
                    threads.append(t)

        t0 = time.perf_counter()
        loop.start()
        with lock:
            seeds = [short_left.pop(0)
                     for _ in range(min(max(slots - 1, 1),
                                        len(short_left)))]
        for i, p in seeds:
            r = engine.submit(p, max_new_tokens=int(short_lens[i]))
            t = threading.Thread(target=consume, args=(i, r), daemon=True)
            t.start()
            with lock:
                threads.append(t)
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            with lock:
                if (short_done[0] >= n_short
                        and long_done[0] >= long_fired[0]):
                    break
            time.sleep(0.005)
        dt = time.perf_counter() - t0
        stop.set()
        loop.join(timeout=10)
        while True:
            with lock:
                pend = [t for t in threads if t.is_alive()]
            if not pend:
                break
            pend[0].join(timeout=10)
        with lock:
            vals = sorted(itls)
            total = tokens[0]
        est = engine.stats()
        return {
            "itl_ms_p50": _pct(vals, 0.50), "itl_ms_p99": _pct(vals, 0.99),
            "itl_ms_max": vals[-1] if vals else None,
            "itl_samples": len(vals),
            "tokens_per_sec": round(total / dt, 1),
            "itl_hist": registry.histogram("serving_itl_ms").value,
            "decode_stalls": registry.counter(
                "serving_decode_stalls_total").value,
            "steady_recompiles": est["recompiles_since_mark"],
            "flight_overhead_frac": est["flight"]["overhead_frac"],
            "memory": est["memory"],
            "streams": streams,
        }

    chunked = run(chunked=True)
    mono = run(chunked=False)
    # parity: every short stream, in both modes, equals a solo
    # generate() of the same prompt
    want = [_solo(model, shorts[i], int(short_lens[i]))
            for i in range(n_short)]
    parity = {}
    for name, mode in (("chunked", chunked), ("monolithic", mono)):
        parity[name] = (len(mode["streams"]) == n_short, all(
            toks == want[i] for i, toks in mode["streams"].items()))
    result = {
        "chunked_itl_ms_p99": chunked["itl_ms_p99"],
        "monolithic_itl_ms_p99": mono["itl_ms_p99"],
        "itl_p99_reduction": (
            round(mono["itl_ms_p99"] / chunked["itl_ms_p99"], 2)
            if chunked["itl_ms_p99"] else None
        ),
        "chunked_itl_ms_p50": chunked["itl_ms_p50"],
        "monolithic_itl_ms_p50": mono["itl_ms_p50"],
        "chunked_itl_ms_max": chunked["itl_ms_max"],
        "monolithic_itl_ms_max": mono["itl_ms_max"],
        "chunked_tokens_per_sec": chunked["tokens_per_sec"],
        "monolithic_tokens_per_sec": mono["tokens_per_sec"],
        "monolithic_decode_stalls": mono["decode_stalls"],
        "chunked_decode_stalls": chunked["decode_stalls"],
        "chunked_steady_recompiles": chunked["steady_recompiles"],
        "monolithic_steady_recompiles": mono["steady_recompiles"],
        "chunked_flight_overhead_frac": chunked["flight_overhead_frac"],
        "monolithic_flight_overhead_frac": mono["flight_overhead_frac"],
        "memory": chunked["memory"],
        "chunked_itl_samples": chunked["itl_samples"],
        "monolithic_itl_samples": mono["itl_samples"],
        "chunked_itl_hist": chunked["itl_hist"],
        "monolithic_itl_hist": mono["itl_hist"],
        "config": f"d{D}/h{H}/L{L}/v{V}-slots{slots}"
                  f"-short{short_prompt}+{short_new}x{n_short}"
                  f"-long{long_prompt}+{long_new}x{n_long}"
                  f"-chunk{prefill_chunk}-budget{tick_token_budget}"
                  + (f"-think{think_time}" if think_time else "")
                  + f"-{dtype}" + ("-smoke" if smoke else ""),
    }
    for name, mode in (("chunked", chunked), ("monolithic", mono)):
        if not parity[name][1]:
            rows = sorted(mode["streams"])
            result[f"{name}_parity_flips"] = _flips(
                model, shorts, {i: mode["streams"][i] for i in rows},
                want, rows)
    return _verdict(result, [
        ("chunked: every short stream finished", parity["chunked"][0]),
        ("chunked: short streams == solo generate()", parity["chunked"][1]),
        ("monolithic: every short stream finished",
         parity["monolithic"][0]),
        ("monolithic: short streams == solo generate()",
         parity["monolithic"][1]),
        ("monolithic decode_stalls > 0", mono["decode_stalls"] > 0),
        ("chunked decode_stalls == 0", chunked["decode_stalls"] == 0),
        ("chunked_steady_recompiles == {}",
         chunked["steady_recompiles"] == {}),
        ("monolithic_steady_recompiles == {}",
         mono["steady_recompiles"] == {}),
    ], [
        ("chunked itl_ms_p99 < monolithic itl_ms_p99",
         None not in (chunked["itl_ms_p99"], mono["itl_ms_p99"])
         and chunked["itl_ms_p99"] < mono["itl_ms_p99"]),
        ("chunked flight_overhead_frac < 0.05",
         chunked["flight_overhead_frac"] < 0.05),
        ("monolithic flight_overhead_frac < 0.05",
         mono["flight_overhead_frac"] < 0.05),
    ], smoke, checks)


def _overfit_cycle(model, corpus, train_steps, T=32, B=8, lr=1e-3, seed=0,
                   starts=None):
    """Overfit ``model`` IN PLACE on a periodic token stream with Adam
    (the port's ``utils.losses.Adam``: optax's semantics), so its greedy
    streams carry the strong local structure a drafter's proposals
    survive on — the speculative bench's high-acceptance regime. Returns
    the last step's loss.

    Departure from the reference, on purpose: its batch starts come from
    JAX's threefry (``jax.random.randint``), which torch cannot draw;
    here they come from ``numpy.random.default_rng(seed)`` over the same
    range, or from ``starts`` (``[train_steps, B]``) when given. One step
    on the same weights and batch equals the reference's jitted optax
    step."""
    import torch.nn.functional as F

    from distkeras_torch.utils.losses import Adam

    if starts is None:
        rng = np.random.default_rng(seed)
        starts = [rng.integers(0, len(corpus) - T - 1, size=B)
                  for _ in range(train_steps)]
    opt = Adam(model.parameters(), lr)
    loss = None
    for s in starts[:train_steps]:
        xy = torch.as_tensor(np.stack([corpus[i:i + T + 1] for i in s]),
                             dtype=torch.long, device=model.device)
        logits = model(xy[:, :-1])
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                               xy[:, 1:].reshape(-1))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    opt.zero_grad(set_to_none=True)
    return float(loss.detach())


def _spec_trace(V, period, n_requests, max_new, seed=7):
    """The speculative bench's ``period``-token cycle, the corpus it is
    tiled into, the staggered output lengths and the prompts (rotations
    of the cycle), drawn in the reference's order."""
    rng = np.random.default_rng(seed)
    cycle = rng.integers(0, V, size=period).astype(np.int32)
    corpus = np.tile(cycle, 64)
    lens = rng.integers(max(4, max_new // 2), max_new + 1,
                        size=n_requests)
    prompts = [np.concatenate([cycle, cycle[:int(o)]]).astype(np.int32)
               for o in rng.integers(1, period, size=n_requests)]
    return cycle, corpus, lens, prompts


def bench_speculative(V=64, D=512, H=8, L=4, slots=4, n_requests=12,
                      max_new=48, spec_k=4, prefill_chunk=32,
                      tick_token_budget=None, train_steps=150, period=8,
                      draft="ngram", dtype="float32", smoke=False,
                      checks=True, device=None):
    """Speculative decoding vs the plain mixed tick at high acceptance:
    decode tokens/s and client-side ITL p50/p99 on a staggered-length
    trace, the same engine config with and without a drafter. The model
    is first overfit on a ``period``-token cycle
    (:func:`_overfit_cycle`); prompts are rotations of the cycle.
    ``draft`` picks the drafter: ``"ngram"`` (self-speculative suffix
    lookup) or ``"model"`` (a small port TransformerLM overfit on the
    same corpus, passed as ``draft=``; it carries its own weights).
    Self-checks: greedy bit-parity spec vs baseline, acceptance > 0.5,
    the acceptance metrics in the exposition, nothing built or
    first-launched after the warm-up (exact); >= 1.5x decode tok/s, p50
    ITL no worse than the baseline's, the flight recorder under 5%
    (timing)."""
    from distkeras_torch import telemetry
    from distkeras_torch.serving import FIFOScheduler
    from distkeras_torch.telemetry.exposition import render_prometheus

    if smoke:
        V, D, H, L, slots = 64, 256, 4, 2, 3
        n_requests, max_new, train_steps = 6, 32, 80
    if tick_token_budget is None:
        tick_token_budget = slots * (spec_k + 1) + prefill_chunk
    dev = _device(device)
    _, corpus, lens, prompts = _spec_trace(V, period, n_requests, max_new)
    max_len = 2 * period + max_new + spec_k + 1
    max_len += (-max_len) % 16
    mkw = dict(vocab_size=V, d_model=D, num_heads=H, num_layers=L,
               max_len=max_len, **_kw(dtype))
    model = _lm(dev, _tree(0, **mkw), **mkw)
    t0 = time.perf_counter()
    loss = _overfit_cycle(model, corpus, train_steps)
    train_s = time.perf_counter() - t0
    draft_kw = {"draft": "ngram"}
    if draft == "model":
        dkw = dict(vocab_size=V, d_model=32, num_heads=2, num_layers=1,
                   max_len=max_len, **_kw(dtype))
        dmodel = _lm(dev, _tree(1, **dkw), **dkw)
        _overfit_cycle(dmodel, corpus, train_steps, seed=1)
        draft_kw = {"draft": dmodel}

    def run(spec):
        def make_engine():
            return _engine(
                model, dev, slots=slots, prefill_chunk=prefill_chunk,
                scheduler=FIFOScheduler(
                    tick_token_budget=tick_token_budget,
                    registry=telemetry.MetricRegistry(),
                    tracer=telemetry.Tracer()),
                **({**draft_kw, "spec_k": spec_k} if spec else {}))

        # a throwaway engine through every shape
        warm = make_engine()
        for p, m in zip(prompts, lens):
            warm.submit(p, max_new_tokens=int(m))
        warm.drain()

        engine = make_engine()
        registry = engine.registry
        engine.mark_steady()

        # pass 1 — throughput: submit everything, drain, read the streams
        # afterwards (no consumer threads contend); best of 3 replays
        best = 0.0
        for _ in range(3):
            reqs = [engine.submit(p, max_new_tokens=int(m))
                    for p, m in zip(prompts, lens)]
            t0 = time.perf_counter()
            engine.drain()
            dt = time.perf_counter() - t0
            streams = [r.stream.tokens(timeout=300) for r in reqs]
            total = sum(map(len, streams))
            best = max(best, total / dt)

        # pass 2 — client-side ITL: one consumer thread a request stamps
        # every token as it crosses the stream boundary (a verify tick
        # releases its accepted prefix as a burst)
        stop = threading.Event()
        loop = threading.Thread(target=engine.serve_forever,
                                args=(stop,), daemon=True)
        lock = threading.Lock()
        itls = []

        def consume(req):
            stamps = [time.perf_counter() for _ in req.stream]
            with lock:
                itls.extend(
                    (b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))

        loop.start()
        threads = []
        for p, m in zip(prompts, lens):
            r = engine.submit(p, max_new_tokens=int(m))
            t = threading.Thread(target=consume, args=(r,), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=300)
        stop.set()
        loop.join(timeout=10)
        with lock:
            vals = sorted(itls)
        stats = engine.stats()
        return {
            "streams": streams,
            "tokens_per_sec": round(best, 1),
            "itl_ms_p50": _pct(vals, 0.50),
            "itl_ms_p99": _pct(vals, 0.99),
            "acceptance_rate": stats.get("acceptance_rate"),
            "accept_len": registry.histogram("serving_accept_len").value,
            "steady_recompiles": stats["recompiles_since_mark"],
            "flight_overhead_frac": stats["flight"]["overhead_frac"],
            "memory": stats["memory"],
            "exposition": render_prometheus(registry),
        }

    spec = run(True)
    base = run(False)
    result = {
        "spec_tokens_per_sec": spec["tokens_per_sec"],
        "baseline_tokens_per_sec": base["tokens_per_sec"],
        "decode_speedup": (
            round(spec["tokens_per_sec"] / base["tokens_per_sec"], 2)
            if base["tokens_per_sec"] else None
        ),
        "spec_itl_ms_p50": spec["itl_ms_p50"],
        "baseline_itl_ms_p50": base["itl_ms_p50"],
        "spec_itl_ms_p99": spec["itl_ms_p99"],
        "baseline_itl_ms_p99": base["itl_ms_p99"],
        "acceptance_rate": spec["acceptance_rate"],
        "accept_len": spec["accept_len"],
        "parity": spec["streams"] == base["streams"],
        "spec_steady_recompiles": spec["steady_recompiles"],
        "baseline_steady_recompiles": base["steady_recompiles"],
        "flight_overhead_frac": spec["flight_overhead_frac"],
        "memory": spec["memory"],
        "train_s": round(train_s, 1),
        "train_loss": round(loss, 5),
        "config": f"d{D}/h{H}/L{L}/v{V}-slots{slots}"
                  f"-req{n_requests}-new{max_new}-k{spec_k}"
                  f"-draft{draft}-period{period}"
                  f"-chunk{prefill_chunk}-budget{tick_token_budget}"
                  f"-{dtype}" + ("-smoke" if smoke else ""),
    }
    if not result["parity"]:
        result["parity_flips"] = _flips(model, prompts, spec["streams"],
                                        base["streams"],
                                        range(n_requests))
    r, expo = result, spec["exposition"]
    return _verdict(result, [
        ("parity", r["parity"]),
        ("acceptance_rate > 0.5",
         bool(r["acceptance_rate"]) and r["acceptance_rate"] > 0.5),
        ("serving_draft_tokens_total in exposition",
         "serving_draft_tokens_total" in expo),
        ("serving_accepted_tokens_total in exposition",
         "serving_accepted_tokens_total" in expo),
        ("serving_accept_len in exposition", "serving_accept_len" in expo),
        ("spec_steady_recompiles == {}", r["spec_steady_recompiles"] == {}),
        ("baseline_steady_recompiles == {}",
         r["baseline_steady_recompiles"] == {}),
    ], [
        ("decode_speedup >= 1.5",
         r["decode_speedup"] is not None and r["decode_speedup"] >= 1.5),
        ("spec_itl_ms_p50 <= baseline_itl_ms_p50",
         None not in (r["spec_itl_ms_p50"], r["baseline_itl_ms_p50"])
         and r["spec_itl_ms_p50"] <= r["baseline_itl_ms_p50"]),
        ("flight_overhead_frac < 0.05", r["flight_overhead_frac"] < 0.05),
    ], smoke, checks)


def _readback_bound(flight) -> bool:
    """True when the measured engine's sync loop blocks on token
    readback (the flight recorder's ``device_wait_ms`` p50 above its
    ``dispatch_ms`` p50): the device's time surfaces at the readback,
    which is where the pipelined loop can hide host work, so the >= 1.15x
    overlap floor is asserted only there (elsewhere a no-regression
    floor)."""
    wait = flight.percentile("device_wait_ms", 50)
    disp = flight.percentile("dispatch_ms", 50)
    return (wait is not None and disp is not None and wait > disp)


def _mixed_requests(V, n_requests, prompt_len, max_new, seed=0):
    """The pipeline and multi-step benches' staggered-length trace, every
    other request sampled at 0.8."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, V, size=prompt_len).astype(np.int32)
               for _ in range(n_requests)]
    lens = rng.integers(max(4, max_new // 2), max_new + 1,
                        size=n_requests)
    temps = [0.0 if i % 2 == 0 else 0.8 for i in range(n_requests)]
    return prompts, lens, temps


def _one_pass(eng, prompts, lens, temps):
    reqs = [eng.submit(p, max_new_tokens=int(m), temperature=t, seed=i)
            for i, (p, m, t) in enumerate(zip(prompts, lens, temps))]
    t0 = time.perf_counter()
    eng.drain()
    dt = time.perf_counter() - t0
    streams = [r.stream.tokens(timeout=300) for r in reqs]
    return streams, sum(map(len, streams)) / dt


def _solo_rows(model, prompts, lens, temps):
    """Solo ``generate()`` of every greedy row (None for sampled ones)."""
    return [_solo(model, p, int(m)) if t == 0.0 else None
            for p, m, t in zip(prompts, lens, temps)]


def bench_pipeline(V=1024, D=256, H=4, L=4, slots=8, n_requests=16,
                   prompt_len=16, max_new=48, prefill_chunk=16,
                   dtype="float32", smoke=False, checks=True, device=None):
    """The pipelined engine loop vs the sync one
    (``ServingEngine(pipeline=True)`` A/B): sustained decode tokens/s
    over a drain of staggered-length mixed greedy/sampled requests, the
    slot layout as the headline plus a paged parity leg. Each arm gets
    two warm passes before ``mark_steady``, then best-of-3 measured
    drains. :func:`_readback_bound` probes the sync arm's flight
    decomposition: where the loop blocks on readback the >= 1.15x
    overlap floor and a lower pipelined ``device_wait_ms`` p50 are
    checked, elsewhere a 0.7x no-regression floor (timing). Exact:
    streams bit-identical pipe vs sync vs paged, sampled rows included,
    greedy rows equal to solo ``generate()``, nothing built or
    first-launched after the warm-up in any measured arm."""
    if smoke:
        V, D, H, L, slots = 64, 64, 2, 2, 4
        n_requests, prompt_len, max_new, prefill_chunk = 8, 8, 24, 8
    dev = _device(device)
    max_len = prompt_len + max_new
    max_len += (-max_len) % 16  # paged leg: whole blocks
    mkw = dict(vocab_size=V, d_model=D, num_heads=H, num_layers=L,
               max_len=max_len, **_kw(dtype))
    model = _lm(dev, _tree(0, **mkw), **mkw)
    prompts, lens, temps = _mixed_requests(V, n_requests, prompt_len,
                                           max_new)

    def run(pipeline, paged):
        eng = _engine(model, dev, slots=slots, pipeline=pipeline,
                      paged=paged, block_size=16,
                      prefill_chunk=prefill_chunk)
        # pass 1 builds, pass 2 reaches the paged prefix-hit steady
        # state (suffix prefills + COW) — both before the mark
        _one_pass(eng, prompts, lens, temps)
        _one_pass(eng, prompts, lens, temps)
        eng.mark_steady()
        best, streams = 0.0, None
        for _ in range(3):
            streams, tps = _one_pass(eng, prompts, lens, temps)
            best = max(best, tps)
        st = eng.stats()
        return {
            "streams": streams,
            "tokens_per_sec": round(best, 1),
            "flight": eng.flight,
            "device_wait_ms_p50": eng.flight.percentile(
                "device_wait_ms", 50),
            "overrun_tokens": st["overrun_tokens"],
            "steady_recompiles": st["recompiles_since_mark"],
            "flight_overhead_frac": st["flight"]["overhead_frac"],
            "memory": st["memory"],
        }

    sync = run(False, False)
    pipe = run(True, False)
    sync_paged = run(False, True)
    pipe_paged = run(True, True)
    # greedy rows must also equal solo generate()
    solo = _solo_rows(model, prompts, lens, temps)
    greedy = [i for i, t in enumerate(temps) if t == 0.0]
    solo_ok = all(pipe["streams"][i] == solo[i] for i in greedy)
    capable = _readback_bound(sync["flight"])
    result = {
        "pipe_tokens_per_sec": pipe["tokens_per_sec"],
        "sync_tokens_per_sec": sync["tokens_per_sec"],
        "speedup": (
            round(pipe["tokens_per_sec"] / sync["tokens_per_sec"], 3)
            if sync["tokens_per_sec"] else None
        ),
        "paged_pipe_tokens_per_sec": pipe_paged["tokens_per_sec"],
        "paged_sync_tokens_per_sec": sync_paged["tokens_per_sec"],
        "pipe_device_wait_ms_p50": pipe["device_wait_ms_p50"],
        "sync_device_wait_ms_p50": sync["device_wait_ms_p50"],
        "overrun_tokens": pipe["overrun_tokens"],
        "parity": (pipe["streams"] == sync["streams"]
                   and pipe_paged["streams"] == sync_paged["streams"]
                   and sync_paged["streams"] == sync["streams"]
                   and solo_ok),
        "overlap_capable": capable,
        "pipe_steady_recompiles": pipe["steady_recompiles"],
        "sync_steady_recompiles": sync["steady_recompiles"],
        "paged_pipe_steady_recompiles": pipe_paged["steady_recompiles"],
        "flight_overhead_frac": pipe["flight_overhead_frac"],
        "memory": pipe["memory"],
        "config": f"d{D}/h{H}/L{L}/v{V}-slots{slots}-req{n_requests}"
                  f"-prompt{prompt_len}+{max_new}-chunk{prefill_chunk}"
                  f"-{dtype}" + ("-smoke" if smoke else ""),
    }
    if not result["parity"]:
        result["parity_flips"] = {
            "paged_vs_slot": _flips(model, prompts, sync_paged["streams"],
                                    sync["streams"], greedy),
            "slot_vs_solo": _flips(model, prompts, pipe["streams"], solo,
                                   greedy)}
    r = result
    sp = r["speedup"] or 0.0
    waits = (r["pipe_device_wait_ms_p50"], r["sync_device_wait_ms_p50"])
    return _verdict(result, [
        ("parity", r["parity"]),
        ("pipe_steady_recompiles == {}", r["pipe_steady_recompiles"] == {}),
        ("sync_steady_recompiles == {}", r["sync_steady_recompiles"] == {}),
        ("paged_pipe_steady_recompiles == {}",
         r["paged_pipe_steady_recompiles"] == {}),
    ], [
        ("flight_overhead_frac < 0.05", r["flight_overhead_frac"] < 0.05),
        (f"speedup >= {1.15 if capable else 0.7}"
         + (" (readback-bound)" if capable else ""),
         sp >= (1.15 if capable else 0.7)),
        ("pipe_device_wait_ms_p50 < sync_device_wait_ms_p50 where "
         "readback-bound",
         not capable or (None not in waits and waits[0] < waits[1])),
    ], smoke, checks)


def bench_multistep(V=1024, D=256, H=4, L=4, slots=8, n_requests=16,
                    prompt_len=16, max_new=48, prefill_chunk=16,
                    k_list=(1, 2, 4, 8), dtype="float32", smoke=False,
                    checks=True, device=None):
    """Device-resident multi-step decode (``ServingEngine(
    multi_step_k=k)``): sustained decode tokens/s against the window
    width k over a drain of staggered-length mixed greedy/sampled
    requests — the slot layout as the sweep plus a paged parity leg at
    the best k. Each arm warms its tick family on a throwaway engine,
    then measures on a fresh one (one pass before the mark, best of 3
    after). Exact: every arm and the paged leg bit-identical to k=1
    (sampled rows included), greedy rows equal to solo ``generate()``,
    nothing built or first-launched after the warm-up, fewer dispatches
    at the best k than at k=1. Timing: >= 1.3x at the best k, tok/s at
    k=4 no lower than k=1, ITL p99 within 10% + 2.5 ms of k=1's."""
    if smoke:
        V, D, H, L, slots = 64, 64, 2, 2, 4
        n_requests, prompt_len, max_new, prefill_chunk = 8, 8, 24, 8
    dev = _device(device)
    max_len = prompt_len + max_new
    max_len += (-max_len) % 16  # paged leg: whole blocks
    mkw = dict(vocab_size=V, d_model=D, num_heads=H, num_layers=L,
               max_len=max_len, **_kw(dtype))
    model = _lm(dev, _tree(0, **mkw), **mkw)
    prompts, lens, temps = _mixed_requests(V, n_requests, prompt_len,
                                           max_new)

    def run(k, paged):
        def make():
            return _engine(model, dev, slots=slots, paged=paged,
                           block_size=16, prefill_chunk=prefill_chunk,
                           multi_step_k=k)

        # a throwaway engine: pass 1 builds this (k, layout)'s ticks,
        # pass 2 reaches the paged prefix-hit steady state
        warm = make()
        _one_pass(warm, prompts, lens, temps)
        _one_pass(warm, prompts, lens, temps)
        eng = make()
        streams, tps = _one_pass(eng, prompts, lens, temps)
        eng.mark_steady()
        best = tps
        for _ in range(3):
            streams, tps = _one_pass(eng, prompts, lens, temps)
            best = max(best, tps)
        st = eng.stats()
        return {
            "streams": streams,
            "tokens_per_sec": round(best, 1),
            "itl_ms_p99": st["itl_ms"]["p99"],
            "dispatches": st["dispatches"],
            "tokens_per_dispatch_p50": st["tokens_per_dispatch"]["p50"],
            "fallbacks": st["multi_step_fallbacks"],
            "steady_recompiles": st["recompiles_since_mark"],
            "flight_overhead_frac": st["flight"]["overhead_frac"],
            "memory": st["memory"],
        }

    k_list = tuple(sorted(set(int(k) for k in k_list)))
    arms = {k: run(k, paged=False) for k in k_list}
    k1 = arms[min(k_list)]
    best_k = max(arms, key=lambda k: arms[k]["tokens_per_sec"])
    paged_arm = run(best_k, paged=True)

    # parity: every arm and the paged leg bit-identical, greedy rows also
    # equal solo generate()
    solo = _solo_rows(model, prompts, lens, temps)
    greedy = [i for i, t in enumerate(temps) if t == 0.0]
    parity = all(a["streams"] == k1["streams"] for a in arms.values())
    parity = parity and paged_arm["streams"] == k1["streams"]
    parity = parity and all(k1["streams"][i] == solo[i] for i in greedy)

    recompiles: dict = {}
    for k, a in arms.items():
        recompiles.update(a["steady_recompiles"])
    recompiles.update(paged_arm["steady_recompiles"])

    result = {
        **{f"tok_s_k{k}": a["tokens_per_sec"] for k, a in arms.items()},
        "best_k": best_k,
        "speedup_best": (
            round(arms[best_k]["tokens_per_sec"]
                  / k1["tokens_per_sec"], 3)
            if k1["tokens_per_sec"] else None
        ),
        "paged_tok_s_best": paged_arm["tokens_per_sec"],
        **{f"itl_p99_ms_k{k}": a["itl_ms_p99"]
           for k, a in arms.items()},
        **{f"dispatches_k{k}": a["dispatches"]
           for k, a in arms.items()},
        "tokens_per_dispatch_p50_best":
            arms[best_k]["tokens_per_dispatch_p50"],
        "fallbacks_best": arms[best_k]["fallbacks"],
        "parity": parity,
        "multi_steady_recompiles": recompiles,
        "flight_overhead_frac": arms[best_k]["flight_overhead_frac"],
        "memory": arms[best_k]["memory"],
        "config": f"d{D}/h{H}/L{L}/v{V}-slots{slots}-req{n_requests}"
                  f"-prompt{prompt_len}+{max_new}-chunk{prefill_chunk}"
                  f"-k{','.join(map(str, k_list))}-{dtype}"
                  + ("-smoke" if smoke else ""),
    }
    if not parity:
        result["parity_flips"] = {
            "paged_vs_slot": _flips(model, prompts, paged_arm["streams"],
                                    k1["streams"], greedy),
            "slot_vs_solo": _flips(model, prompts, k1["streams"], solo,
                                   greedy)}
    r = result
    kb, k0 = best_k, min(k_list)
    p99_1, p99_b = r[f"itl_p99_ms_k{k0}"], r[f"itl_p99_ms_k{kb}"]
    sweep = max(k_list) > 1
    return _verdict(result, [
        ("parity", parity),
        ("multi_steady_recompiles == {}", recompiles == {}),
        (f"dispatches_k{kb} < dispatches_k{k0} or best_k == {k0}",
         not sweep or kb == k0
         or r[f"dispatches_k{kb}"] < r[f"dispatches_k{k0}"]),
    ], [
        ("speedup_best >= 1.3",
         not sweep or (r["speedup_best"] or 0.0) >= 1.3),
        ("tok_s_k4 >= tok_s_k1",
         not sweep or not (4 in arms and 1 in arms)
         or r["tok_s_k4"] >= r["tok_s_k1"]),
        (f"itl_p99_ms_k{kb} <= 1.1 * itl_p99_ms_k{k0} + 2.5",
         not sweep or not (p99_1 and p99_b) or p99_b <= 1.1 * p99_1 + 2.5),
    ], smoke, checks)


def bench_router(V=512, D=256, H=4, L=2, replicas=3, slots=2,
                 n_prefixes=3, prefix_len=1024, tail_len=8, max_new=4,
                 n_requests=48, clients=3, block_size=16,
                 prefill_chunk=64, slack_blocks=5,
                 n_failover=6, failover_new=24, dtype="float32",
                 device=None, smoke=False):
    """Multi-replica serving fabric: N ``LMServer`` replicas behind the
    prefix-affinity Router vs ONE replica with the same per-replica
    config, on ``n_prefixes`` system prompts cycled round-robin by a
    closed loop of ``clients``. Each replica's pool holds ONE cached
    prefix plus working blocks, so the fleet's aggregate cache is the
    scaling resource: affine routing serves every prefix from cache while
    one replica must evict round-robin and re-prefill.

    Passes: fleet (affine) vs single replica (tokens/s over the
    makespan); fleet with random routing (the control arm, whose hit
    fraction collapses); one replica with the fleet's aggregate block
    budget (the hit-fraction reference affine routing must stay within
    10% of); then a failover pass that kills the replica carrying the
    most streams and requires every stream equal to ``generate()`` with
    none failed. The measured fleet pass also checks fleet tracing: one
    complete merged chain per sampled request, archive round trips under
    5% of the window, a valid Chrome export, and critical-path sums that
    reconcile with the client's latency.

    ``--smoke`` self-checks all of the above (>= 2.4x scaling, the 10%
    hit band, random measurably worse, zero lost streams) and shortens
    the failover tail."""
    from distkeras_torch import telemetry
    from distkeras_torch.serving import (
        LMServer, Router, ServingClient, ServingEngine,
    )

    if smoke:
        n_failover, failover_new = 4, 16
    devices = _devices(device)
    max_len = prefix_len + tail_len + max(max_new, failover_new)
    max_len += (-max_len) % block_size
    max_blocks = max_len // block_size
    prefix_blocks = prefix_len // block_size
    num_blocks = 1 + prefix_blocks + max_blocks + slack_blocks
    mkw = dict(vocab_size=V, d_model=D, num_heads=H, num_layers=L,
               max_len=max_len, **_kw(dtype))
    tree = _tree(0, **mkw)
    ref = _lm(devices[0], tree, **mkw)
    rng = np.random.default_rng(0)
    prefixes = [rng.integers(0, V, size=prefix_len).astype(np.int32)
                for _ in range(n_prefixes)]

    def make_prompt(i, r):
        tail = r.integers(0, V, size=tail_len).astype(np.int32)
        return np.concatenate([prefixes[i % n_prefixes], tail])

    def start_fleet(n, pool_blocks):
        servers = []
        for i in range(n):
            dev = devices[i % len(devices)]
            eng = ServingEngine(
                _lm(dev, tree, **mkw), slots=slots, paged=True,
                block_size=block_size, num_blocks=pool_blocks,
                prefill_chunk=prefill_chunk,
                registry=telemetry.MetricRegistry(),
                # distinct tracer process identities: one lane per
                # replica in merged chains and Chrome exports
                tracer=telemetry.Tracer(pid=1000 + i), device=dev,
            )
            servers.append(LMServer(eng).start())
        return servers

    def warm(servers):
        # every shape each replica uses — a cold prefix, a repeat (the
        # suffix-only hit path), decode — on a THROWAWAY prefix so the
        # bench prefixes start uncached
        wrng = np.random.default_rng(999)
        for s in servers:
            c = ServingClient("127.0.0.1", s.port)
            pref = wrng.integers(0, V, size=prefix_len).astype(np.int32)
            for _ in range(2):
                tail = wrng.integers(0, V, size=tail_len).astype(np.int32)
                rid = c.generate(np.concatenate([pref, tail]),
                                 max_new_tokens=max_new)
                c.result(rid, timeout=300)
            c.close()
        for s in servers:
            s.engine.mark_steady()

    def run_routed(n_replicas, policy, pool_blocks, verify_traces=False):
        servers = start_fleet(n_replicas, pool_blocks)
        warm(servers)
        router = Router(
            [("127.0.0.1", s.port, f"r{i}") for i, s in enumerate(servers)],
            policy=policy, block_size=block_size, poll_interval=0.1,
            registry=telemetry.MetricRegistry(),
            tracer=telemetry.Tracer(pid=1),
        ).start()
        client = ServingClient("127.0.0.1", router.port,
                               request_timeout=300.0)
        prng = np.random.default_rng(7)
        prompts = [make_prompt(i, prng) for i in range(n_requests)]
        lock = threading.Lock()
        nxt = [0]
        streams, traces, lats = {}, {}, {}

        def worker():
            while True:
                with lock:
                    if nxt[0] >= n_requests:
                        return
                    i = nxt[0]
                    nxt[0] += 1
                t_req = time.perf_counter()
                rid = client.generate(prompts[i], max_new_tokens=max_new)
                toks, reason = client.result(rid, timeout=300)
                lat_ms = (time.perf_counter() - t_req) * 1e3
                with lock:
                    streams[i] = (toks, reason)
                    traces[i] = client.trace_of(rid)
                    lats[i] = lat_ms

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        dt = time.perf_counter() - t0
        router.manager.probe_all()
        st = client.stats()
        recomp: dict = {}
        for s in servers:
            recomp.update(s.engine.recompiles_since_mark())
        out = {
            "tokens_per_sec": round(
                sum(len(t) for t, _ in streams.values()) / dt, 1),
            "prefix_hit_fraction": st.get("prefix_hit_fraction"),
            "requests_completed": st.get("requests_completed"),
            "spilled": st["router"]["spilled"],
            "routed": st["router"]["routed"],
            "failed": st["router"]["failed"],
            "steady_recompiles": recomp,
            "streams": streams,
            "prompts": prompts,
        }
        if verify_traces:
            out["trace"] = _verify_traces(client, st, traces, lats, dt)
        client.close()
        router.stop()
        for s in servers:
            s.stop()
        return out

    def _verify_traces(client, st, traces, lats, dt):
        required = {"router.route", "router.stream", "queued",
                    "prefill", "decode", "finish", "stream"}
        sample = sorted(traces)[:16]
        lost = 0
        for i in sample:
            chain = client.trace_dump(trace=traces[i])
            if (not required <= {s["span"] for s in chain}
                    or {s["trace"] for s in chain} != {traces[i]}):
                lost += 1
        # critical path vs the client's stopwatch on the slowest sampled
        # request: within 5%, floored at 25 ms of wire/ack overhead
        slow = max(sample, key=lambda i: lats[i])
        cp = telemetry.critical_path(client.trace_dump(trace=traces[slow]))
        phase_sum = sum(cp["phases"].values()) if cp else None
        cp_ok = (phase_sum is not None
                 and abs(phase_sum - lats[slow])
                 <= max(0.05 * lats[slow], 25.0))
        doc = client.chrome_trace(trace=traces[slow])
        events = doc["traceEvents"]
        invalid = [e for e in events
                   if not all(k in e for k in ("ph", "ts", "pid", "tid"))]
        s_ids = {e["id"] for e in events if e.get("ph") == "s"}
        f_ids = {e["id"] for e in events if e.get("ph") == "f"}
        path = os.path.join(tempfile.gettempdir(),
                            "distkeras-router-chrome-trace.json")
        with open(path, "w") as fh:
            json.dump(doc, fh)
        arch = st["router"]["trace_archive"]
        return {
            "n_traced": len(sample),
            "lost_spans": lost,
            "archived": arch["archived"],
            "archive_errors": arch["errors"],
            "overhead_frac": round((arch["ms_total"] / 1e3) / max(dt, 1e-9),
                                   4),
            "critical_path": cp,
            "client_ms": round(lats[slow], 1),
            "critical_path_reconciles": cp_ok,
            "chrome_events": len(events),
            "chrome_invalid": len(invalid),
            "chrome_flows_paired": bool(s_ids) and s_ids == f_ids,
            "chrome_path": path,
        }

    def run_failover():
        servers = start_fleet(replicas, num_blocks)
        warm(servers)
        router = Router(
            [("127.0.0.1", s.port, f"r{i}") for i, s in enumerate(servers)],
            policy="affine", block_size=block_size, poll_interval=0.05,
            down_after=1, backoff_base=0.05,
            registry=telemetry.MetricRegistry(), tracer=telemetry.Tracer(),
        ).start()
        client = ServingClient("127.0.0.1", router.port,
                               request_timeout=300.0)
        frng = np.random.default_rng(11)
        prompts = [frng.integers(0, V, size=16).astype(np.int32)
                   for _ in range(n_failover)]
        rids = [client.generate(p, max_new_tokens=failover_new)
                for p in prompts]
        deadline = time.monotonic() + 60
        by = {}
        while time.monotonic() < deadline:
            by = router.stats()["router"]["inflight_by_replica"]
            if by and max(by.values()) >= 2:
                break
            time.sleep(0.01)
        victim = max(by, key=by.get) if by else "r0"
        servers[int(victim[1:])].stop()
        lost = 0
        for p, rid in zip(prompts, rids):
            toks, reason = client.result(rid, timeout=300)
            if toks != _solo(ref, p, failover_new) or reason != "length":
                lost += 1
        st = client.stats()
        out = {"streams_lost": lost, "killed": victim,
               "inflight_on_victim": by.get(victim, 0),
               "failed_over": st["router"]["failed_over"],
               "failed": st["router"]["failed"]}
        client.close()
        router.stop()
        for s in servers:
            try:
                s.stop()
            except Exception:
                pass
        return out

    fleet = run_routed(replicas, "affine", num_blocks, verify_traces=True)
    single = run_routed(1, "affine", num_blocks)
    rand = run_routed(replicas, "random", num_blocks)
    ref_pool = run_routed(1, "affine",
                          1 + replicas * (prefix_blocks + slack_blocks)
                          + slots * max_blocks)
    failover = run_failover()

    parity = True
    for i in list(fleet["streams"])[:4]:
        got, reason = fleet["streams"][i]
        parity = (parity and reason == "length"
                  and got == _solo(ref, fleet["prompts"][i], max_new))

    result = {
        "router_scaling": (
            round(fleet["tokens_per_sec"] / single["tokens_per_sec"], 2)
            if single["tokens_per_sec"] else None),
        "fleet_tokens_per_sec": fleet["tokens_per_sec"],
        "single_tokens_per_sec": single["tokens_per_sec"],
        "fleet_hit_affine": fleet["prefix_hit_fraction"],
        "fleet_hit_random": rand["prefix_hit_fraction"],
        "single_hit_thrash": single["prefix_hit_fraction"],
        "single_hit_reference": ref_pool["prefix_hit_fraction"],
        "parity": parity,
        "spilled": fleet["spilled"],
        "failover_streams_lost": failover["streams_lost"],
        "failover_failed_over": failover["failed_over"],
        "failover_inflight_on_victim": failover["inflight_on_victim"],
        "failover_failed": failover["failed"],
        "fleet_trace": fleet.get("trace"),
        "fleet_steady_recompiles": fleet["steady_recompiles"],
        "n_devices": len(devices),
        "backend": devices[0].type,
        "config": f"d{D}/h{H}/L{L}/v{V}-replicas{replicas}x{slots}slots"
                  f"-prefix{prefix_len}x{n_prefixes}+{tail_len}"
                  f"-new{max_new}-req{n_requests}-clients{clients}"
                  f"-bs{block_size}-blocks{num_blocks}-{dtype}"
                  + ("-smoke" if smoke else ""),
    }
    print(json.dumps(result), flush=True)
    if smoke:
        tr = result["fleet_trace"]
        _check(result, [
            ("parity", result["parity"]),
            ("failover_streams_lost == 0",
             result["failover_streams_lost"] == 0),
            ("failover_failed == 0", result["failover_failed"] == 0),
            ("failover_failed_over >= 1",
             result["failover_failed_over"] >= 1),
            ("router_scaling >= 2.4", (result["router_scaling"] or 0)
             >= 2.4),
            ("fleet_hit_affine >= 0.9 * single_hit_reference",
             result["fleet_hit_affine"]
             >= 0.9 * result["single_hit_reference"]),
            ("fleet_hit_random < fleet_hit_affine - 0.1",
             result["fleet_hit_random"]
             < result["fleet_hit_affine"] - 0.1),
            ("trace lost_spans == 0", tr["lost_spans"] == 0),
            ("trace archive_errors == 0", tr["archive_errors"] == 0),
            ("trace overhead_frac < 0.05", tr["overhead_frac"] < 0.05),
            ("chrome_invalid == 0", tr["chrome_invalid"] == 0),
            ("chrome_flows_paired", tr["chrome_flows_paired"]),
            ("critical_path_reconciles", tr["critical_path_reconciles"]),
            ("fleet_steady_recompiles == {}",
             result["fleet_steady_recompiles"] == {}),
        ])
    return result


def bench_fleet_sim(V=256, D=64, H=2, L=2, slots=2,
                    min_replicas=1, max_replicas=3,
                    n_tenants=4, prefix_len=64, tail_len=16,
                    batch_body=256, interactive_new=24, batch_new=8,
                    block_size=16, prefill_chunk=32,
                    tick_token_budget=48,
                    baseline_clients=2, ramp_clients=12,
                    burst_clients=20, batch_clients=4,
                    think_time=0.005,
                    baseline_s=1.5, ramp_s=5.0, burst_s=7.0,
                    kill_after_s=2.0, settle_timeout_s=45.0,
                    itl_slo_ms=500.0, seed=0, dtype="float32",
                    device=None, smoke=False):
    """Elastic-fleet simulation: the :class:`Autoscaler` control loop
    driven by a seeded load model — a baseline trickle, an arrival ramp,
    a 10x interactive burst with long-prompt batch traffic (tenant-skewed
    prompts throughout), a replica kill mid-burst, then silence.

    The fleet starts at ``min_replicas`` replicas behind the Router;
    ``max_replicas`` more are built and warmed into a spare pool that
    the ``spawn`` actuator hands to the controller. Load is closed-loop
    per phase (N clients with seeded think time), so the controller's
    signals, not wall-clock token rates, shape the phases. Batch clients
    submit ``tier="batch"`` long prompts that the scheduler admits behind
    the interactive queue and whose prefill chunks it preempts first.

    ``--smoke`` self-checks the controller contract: ``replay()``
    reproduces the live decisions, the fleet reaches ``max_replicas`` and
    returns to ``min_replicas`` with no scale-up after the first
    scale-down, interactive burst p99 ITL within ``itl_slo_ms`` while
    batch absorbs the degradation, zero lost streams through the kill
    and a replacement scale-up after it, and the observability contract
    (journal = decision log, an anomaly fires, the timeline renders,
    sampling under 1% overhead, the p99 ITL exemplar joins an archived
    trace)."""
    from distkeras_torch import telemetry
    from distkeras_torch.serving import (
        Autoscaler, FIFOScheduler, LMServer, Router, ServingClient,
        ServingEngine,
    )
    from distkeras_torch.telemetry.report import render_fleet_timeline
    from distkeras_torch.telemetry.timeseries import write_timeline

    devices = _devices(device)
    n_servers = max_replicas + 1  # the kill consumes one for good
    max_len = prefix_len + batch_body + max(interactive_new, batch_new)
    max_len += (-max_len) % block_size
    max_blocks = max_len // block_size
    num_blocks = (1 + slots * max_blocks
                  + n_tenants * (prefix_len // block_size) + 8)
    mkw = dict(vocab_size=V, d_model=D, num_heads=H, num_layers=L,
               max_len=max_len, **_kw(dtype))
    tree = _tree(0, **mkw)

    rng = np.random.default_rng(seed)
    tenants = [rng.integers(0, V, size=prefix_len).astype(np.int32)
               for _ in range(n_tenants)]
    skew = np.array([1.0 / (k + 1) for k in range(n_tenants)])
    skew /= skew.sum()

    def make_trace(n, body_len):
        return [np.concatenate([
            tenants[int(rng.choice(n_tenants, p=skew))],
            rng.integers(0, V, size=body_len).astype(np.int32),
        ]) for _ in range(n)]

    trace_i = make_trace(1024, tail_len)
    trace_b = make_trace(128, batch_body)

    servers = {}
    for i in range(n_servers):
        dev = devices[i % len(devices)]
        reg = telemetry.MetricRegistry()
        tracer = telemetry.Tracer(pid=1000 + i)
        eng = ServingEngine(
            _lm(dev, tree, **mkw), slots=slots, paged=True,
            block_size=block_size, num_blocks=num_blocks,
            prefill_chunk=prefill_chunk,
            scheduler=FIFOScheduler(tick_token_budget=tick_token_budget,
                                    registry=reg, tracer=tracer),
            registry=reg, tracer=tracer, device=dev,
        )
        # lenient SLO bounds (queue depth drives the scaling here) plus
        # the anomaly twins: baseline and ramp train the EWMA, the burst
        # deviates
        slo = telemetry.SloMonitor(
            telemetry.default_serving_rules(
                itl_p99_ms=10_000.0, ttft_p99_ms=120_000.0,
                max_queue_depth=1e9, max_expiry_per_s=1e9)
            + telemetry.default_anomaly_rules(
                z_threshold=3.0, min_samples=8, windows=(0.75, 2.0)),
            registry=reg, tracer=tracer, interval_s=0.25)
        servers[f"r{i}"] = LMServer(eng, slo=slo).start()

    wrng = np.random.default_rng(999)
    for s in servers.values():
        c = ServingClient("127.0.0.1", s.port)
        pref = wrng.integers(0, V, size=prefix_len).astype(np.int32)
        tail_a = wrng.integers(0, V, size=tail_len).astype(np.int32)
        tail_c = tail_a.copy()
        tail_c[tail_len // 2:] = wrng.integers(
            0, V, size=tail_len - tail_len // 2)
        for tail in (tail_a, tail_a, tail_c,
                     wrng.integers(0, V, size=batch_body).astype(np.int32)):
            rid = c.generate(np.concatenate([pref, tail]), max_new_tokens=4)
            c.result(rid, timeout=300)
        c.close()
    for s in servers.values():
        s.engine.mark_steady()

    router = Router(
        [("127.0.0.1", servers["r0"].port, "r0")],
        policy="affine", block_size=block_size,
        spill_queue_depth=2, poll_interval=0.05,
        down_after=1, backoff_base=0.05,
        registry=telemetry.MetricRegistry(), tracer=telemetry.Tracer(pid=1),
    ).start()

    pool_lock = threading.Lock()
    spares = [f"r{i}" for i in range(1, n_servers)]

    def spawn():
        with pool_lock:
            if not spares:
                raise RuntimeError("spare pool exhausted")
            name = spares.pop(0)
        servers[name].engine.end_drain()
        return ("127.0.0.1", servers[name].port, name)

    def retire(name):
        with pool_lock:
            spares.append(name)
            spares.sort()

    auto = Autoscaler(
        router, spawn=spawn, retire=retire,
        interval_s=0.2, drain_timeout_s=60.0,
        registry=telemetry.MetricRegistry(), tracer=telemetry.Tracer(pid=2),
        min_replicas=min_replicas, max_replicas=max_replicas,
        queue_high=3.0, queue_low=0.5,
        up_consecutive=2, down_consecutive=8,
        cooldown_s=1.5, rebalance=False,
    )

    client = ServingClient("127.0.0.1", router.port, request_timeout=300.0)
    stop_evt = threading.Event()
    phase_box = {"name": "baseline"}
    lock = threading.Lock()
    cursor = {"interactive": 0, "batch": 0}
    samples, lost, threads = [], [0], []

    def worker(tier, wid):
        prng = np.random.default_rng(seed * 7919 + wid)
        trace = trace_i if tier == "interactive" else trace_b
        new = interactive_new if tier == "interactive" else batch_new
        while not stop_evt.is_set():
            with lock:
                i = cursor[tier]
                cursor[tier] += 1
            prompt = trace[i % len(trace)]
            ph = phase_box["name"]
            t0 = time.perf_counter()
            try:
                rid = client.generate(prompt, max_new_tokens=new, tier=tier)
                ttft, last, itls, reason = None, t0, [], None
                for kind, val in client.frames(rid, timeout=300):
                    t = time.perf_counter()
                    if kind == "end":
                        reason = val
                        break
                    if ttft is None:
                        ttft = (t - t0) * 1e3
                    else:
                        itls.append((t - last) * 1e3)
                    last = t
            except Exception:
                with lock:
                    lost[0] += 1
                continue
            with lock:
                if reason != "length":
                    lost[0] += 1
                samples.append({"phase": ph, "tier": tier,
                                "ttft_ms": ttft, "itl_ms": itls})
            if tier == "interactive" and think_time:
                stop_evt.wait(float(prng.uniform(0.5, 1.5)) * think_time)

    def add_workers(tier, n):
        for _ in range(n):
            t = threading.Thread(target=worker, args=(tier, len(threads)),
                                 daemon=True)
            threads.append(t)
            t.start()

    auto.start()
    add_workers("interactive", baseline_clients)
    time.sleep(baseline_s)
    phase_box["name"] = "ramp"
    add_workers("interactive", ramp_clients - baseline_clients)
    time.sleep(ramp_s)
    phase_box["name"] = "burst"
    add_workers("interactive", burst_clients - ramp_clients)
    add_workers("batch", batch_clients)
    time.sleep(kill_after_s)

    deadline = time.monotonic() + 30
    routable = []
    while time.monotonic() < deadline:
        routable = [r.name for r in router.manager.routable()]
        if len(routable) >= 2:
            break
        time.sleep(0.05)
    by = router.stats()["router"]["inflight_by_replica"]
    killed = max(routable, key=lambda n: (by.get(n, 0), n))
    # stamped BEFORE stop(): the manager sees the sockets die as stop()
    # starts closing them
    kill_t = time.monotonic()
    servers[killed].stop()
    time.sleep(max(burst_s - kill_after_s, 0.0))

    phase_box["name"] = "settle"
    stop_evt.set()
    for t in threads:
        t.join(timeout=600)
    deadline = time.monotonic() + settle_timeout_s
    while time.monotonic() < deadline:
        if len(router.manager.routable()) <= min_replicas:
            break
        time.sleep(0.1)
    time.sleep(0.5)
    auto.stop()

    replay_ok = auto.replay() == auto.decisions()
    acts = list(auto.events)
    ups = [e for e in acts if e["action"] == "scale_up"]
    downs = [e for e in acts if e["action"] == "scale_down"]
    osc, seen_down = 0, False
    for e in acts:
        if e["action"] == "scale_down":
            seen_down = True
        elif e["action"] == "scale_up" and seen_down:
            osc += 1
    recomp: dict = {}
    preempt = {"interactive": 0, "batch": 0}
    for s in servers.values():
        recomp.update(s.engine.recompiles_since_mark())
        try:
            qos = s.engine.stats().get("qos", {})
        except Exception:
            qos = {}
        for t in preempt:
            preempt[t] += int(qos.get(t, {}).get("preempted_chunks", 0))

    fleet_ts = router.fleet_timeseries()
    fleet_ev = router.fleet_events()
    scale_events = [e for e in fleet_ev["events"]
                    if e.get("actor") == "autoscaler"]
    journal_reconciles = (
        [(e["action"], e.get("poll"), e.get("reason"))
         for e in scale_events]
        == [(d["action"], d.get("poll"), d.get("reason"))
            for d in auto.decisions()])
    events_ordered = all(a["t"] <= b["t"] for a, b in
                         zip(fleet_ev["events"], fleet_ev["events"][1:]))
    tl_path = os.path.join(tempfile.gettempdir(),
                           "distkeras-fleet-timeline.jsonl")
    write_timeline(tl_path, fleet_ts["points"], fleet_ev["events"],
                   meta=fleet_ts["meta"])
    buf = io.StringIO()
    try:
        render_fleet_timeline(fleet_ts["points"], fleet_ev["events"],
                              meta=fleet_ts["meta"], out=buf)
        rendered = buf.getvalue()
        timeline_renders = events_ordered and all(
            e["action"] in rendered for e in scale_events)
    except Exception:
        timeline_renders = False
    anomaly_fired = {}
    for s in servers.values():
        fam = s.engine.registry.collect().get("slo_alerts_total") or {}
        for se in fam.get("series", []):
            rule = se["labels"].get("rule", "")
            if rule.endswith("_anomaly") and se["value"] > 0:
                anomaly_fired[rule] = (anomaly_fired.get(rule, 0)
                                       + int(se["value"]))
    ts_overhead = max((s.timeseries.meta()["overhead_frac"]
                       for s in servers.values()
                       if s.timeseries is not None), default=0.0)
    ts_overhead = max(ts_overhead, router.timeseries.meta()["overhead_frac"])
    archived = set(router.archive.ids()) if router.archive else set()
    exemplar_ids = []
    for s in servers.values():
        try:
            ex = s.engine.stats()["itl_ms"]["p99_exemplar"]
        except Exception:
            ex = None
        if ex and ex.get("trace_id") is not None:
            exemplar_ids.append(ex["trace_id"])

    def _resolves(tid):
        try:
            return int(tid) in archived
        except (TypeError, ValueError):
            return False

    def pct(vals, q):
        return (round(float(np.percentile(np.asarray(vals), q)), 1)
                if vals else None)

    burst_i = [s for s in samples
               if s["phase"] == "burst" and s["tier"] == "interactive"]
    burst_b = [s for s in samples
               if s["phase"] == "burst" and s["tier"] == "batch"]
    result = {
        "replay_deterministic": replay_ok,
        "scale_ups": len(ups),
        "scale_downs": len(downs),
        "oscillations": osc,
        "actuation_failures": sum(1 for e in acts if not e.get("ok")),
        "max_routable": max(s["replicas"] for _, s in auto.signal_log),
        "final_routable": auto.signal_log[-1][1]["replicas"],
        "killed": killed,
        "post_kill_scale_up": any(e["t"] >= kill_t for e in ups),
        "lost_streams": lost[0],
        "requests_interactive": sum(1 for s in samples
                                    if s["tier"] == "interactive"),
        "requests_batch": sum(1 for s in samples if s["tier"] == "batch"),
        "burst_itl_p99_interactive_ms": pct(
            [g for s in burst_i for g in s["itl_ms"]], 99),
        "burst_ttft_p99_interactive_ms": pct(
            [s["ttft_ms"] for s in burst_i if s["ttft_ms"] is not None], 99),
        "burst_ttft_p99_batch_ms": pct(
            [s["ttft_ms"] for s in burst_b if s["ttft_ms"] is not None], 99),
        "itl_slo_ms": itl_slo_ms,
        "batch_preempted_chunks": preempt["batch"],
        "interactive_preempted_chunks": preempt["interactive"],
        "steady_recompiles": recomp,
        "controller_polls": len(auto.signal_log),
        "actions": [{k: e.get(k) for k in ("action", "reason", "replica",
                                           "ok")} for e in acts],
        "journal_events": len(fleet_ev["events"]),
        "journal_scale_events": len(scale_events),
        "journal_reconciles": journal_reconciles,
        "anomaly_rules_fired": sorted(anomaly_fired),
        "anomaly_firings": sum(anomaly_fired.values()),
        "timeseries_points": len(fleet_ts["points"]),
        "timeseries_sources": fleet_ts["meta"].get("sources"),
        "timeseries_overhead_frac": round(ts_overhead, 6),
        "timeline_path": tl_path,
        "timeline_renders": timeline_renders,
        "itl_p99_exemplar_resolved": any(_resolves(t) for t in exemplar_ids),
        "n_devices": len(devices),
        "backend": devices[0].type,
        "config": f"d{D}/h{H}/L{L}/v{V}-fleet{min_replicas}.."
                  f"{max_replicas}x{slots}slots-tenants{n_tenants}"
                  f"-burst{burst_clients}+{batch_clients}batch"
                  f"-budget{tick_token_budget}-{dtype}"
                  + ("-smoke" if smoke else ""),
    }
    client.close()
    router.stop()
    for s in servers.values():
        try:
            s.stop()
        except Exception:
            pass
    print(json.dumps(result), flush=True)
    if smoke:
        r = result
        _check(r, [
            ("replay_deterministic", r["replay_deterministic"]),
            ("lost_streams == 0", r["lost_streams"] == 0),
            ("actuation_failures == 0", r["actuation_failures"] == 0),
            ("scale_ups >= 2", r["scale_ups"] >= 2),
            ("max_routable == max_replicas",
             r["max_routable"] == max_replicas),
            ("scale_downs >= 1", r["scale_downs"] >= 1),
            ("final_routable == min_replicas",
             r["final_routable"] == min_replicas),
            ("oscillations == 0", r["oscillations"] == 0),
            ("post_kill_scale_up", r["post_kill_scale_up"]),
            ("burst_itl_p99_interactive_ms <= itl_slo_ms",
             r["burst_itl_p99_interactive_ms"] is not None
             and r["burst_itl_p99_interactive_ms"] <= itl_slo_ms),
            ("burst_ttft_p99_batch_ms > burst_ttft_p99_interactive_ms",
             r["burst_ttft_p99_batch_ms"] is not None
             and r["burst_ttft_p99_interactive_ms"] is not None
             and r["burst_ttft_p99_batch_ms"]
             > r["burst_ttft_p99_interactive_ms"]),
            ("batch_preempted_chunks >= 1", r["batch_preempted_chunks"] >= 1),
            ("steady_recompiles == {}", r["steady_recompiles"] == {}),
            ("journal_reconciles", r["journal_reconciles"]),
            ("journal_scale_events == len(actions)",
             r["journal_scale_events"] == len(acts)),
            ("anomaly_firings >= 1", r["anomaly_firings"] >= 1),
            ("timeline_renders", r["timeline_renders"]),
            ("timeseries_points >= 1", r["timeseries_points"] >= 1),
            ("timeseries_overhead_frac < 0.01",
             r["timeseries_overhead_frac"] < 0.01),
            ("itl_p99_exemplar_resolved", r["itl_p99_exemplar_resolved"]),
        ])
    return result


def bench_disagg(V=64, D=256, H=4, L=2, replicas=3, slots=3,
                 n_short=12, short_prompt=8, short_new=8,
                 n_long=3, long_prompt=1024, long_new=2, long_every=2,
                 concurrency=4, block_size=32, prefill_chunk=32,
                 disagg_threshold=512, race_longs=4, race_prompt=256,
                 dtype="float32", device=None, smoke=False):
    """Prefill/decode disaggregation through the router: the
    long-prompt-interference trace against a specialized fleet (one
    prefill-role replica with monolithic prefill and ``replicas - 1``
    decode-role replicas, KV blocks migrated over export_kv/import_kv)
    vs the uniform baseline (``replicas`` mixed replicas).

    A closed loop of ``concurrency`` short requests decodes through the
    router; after every ``long_every`` short completions a
    ``long_prompt``-token request arrives. Every token of every stream is
    stamped at the client: TTFT per request (p99 over shorts and longs)
    and ITL per short stream. A race phase then points migration at a
    prefill replica whose pool barely holds one prompt and fires
    ``race_longs`` concurrent longs: every stream must equal
    ``generate()`` whatever mix of migrations and fallbacks results.

    ``--smoke`` self-checks: p99 TTFT AND p99 ITL beat the uniform
    baseline, every long migrated (outcome ok), sampled shorts and every
    long equal to ``generate()``, and zero lost or failed streams in the
    race."""
    from distkeras_torch import telemetry
    from distkeras_torch.serving import (
        FIFOScheduler, LMServer, Router, ServingClient, ServingEngine,
    )

    devices = _devices(device)
    max_len = long_prompt + max(long_new, short_new) + block_size
    max_len += (-max_len) % block_size
    max_blocks = max_len // block_size
    num_blocks = (1 + slots * max_blocks
                  + (n_long + 1) * (long_prompt // block_size) + 8)
    mkw = dict(vocab_size=V, d_model=D, num_heads=H, num_layers=L,
               max_len=max_len, **_kw(dtype))
    tree = _tree(0, **mkw)
    ref = _lm(devices[0], tree, **mkw)
    rng = np.random.default_rng(0)
    shorts = [rng.integers(0, V, size=short_prompt).astype(np.int32)
              for _ in range(n_short)]
    short_lens = rng.integers(max(2, short_new // 2), short_new + 1,
                              size=n_short)
    longs = [rng.integers(0, V, size=long_prompt).astype(np.int32)
             for _ in range(n_long)]

    def start_fleet(roles, pool_blocks=None, offset=0):
        servers = []
        for i, role in enumerate(roles):
            dev = devices[(i + offset) % len(devices)]
            # the prefill replica runs MONOLITHIC whole-prompt prefill;
            # decode/mixed replicas keep the chunked mixed tick
            chunk = None if role == "prefill" else prefill_chunk
            eng = ServingEngine(
                _lm(dev, tree, **mkw), slots=slots, paged=True,
                block_size=block_size,
                num_blocks=pool_blocks or num_blocks,
                prefill_chunk=chunk, role=role,
                scheduler=FIFOScheduler(
                    tick_token_budget=slots + (chunk or prefill_chunk),
                    registry=telemetry.MetricRegistry(),
                    tracer=telemetry.Tracer()),
                registry=telemetry.MetricRegistry(),
                tracer=telemetry.Tracer(pid=1000 + i), device=dev,
            )
            servers.append(LMServer(eng).start())
        return servers

    def router_over(servers, threshold, pid):
        router = Router(
            [("127.0.0.1", s.port, f"r{i}") for i, s in enumerate(servers)],
            block_size=block_size, poll_interval=0.1,
            disagg_prompt_tokens=threshold,
            registry=telemetry.MetricRegistry(),
            tracer=telemetry.Tracer(pid=pid),
        ).start()
        deadline = time.monotonic() + 30
        while (len(router.manager.routable()) < len(servers)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        return router

    def run_arm(roles, disagg):
        servers = start_fleet(roles)
        router = router_over(servers, disagg_threshold if disagg else None,
                             1)
        client = ServingClient("127.0.0.1", router.port,
                               request_timeout=600.0)
        # warm every shape the arm uses on throwaway prompts
        wrng = np.random.default_rng(999)
        wl = wrng.integers(0, V, size=long_prompt).astype(np.int32)
        ws = wrng.integers(0, V, size=short_prompt).astype(np.int32)
        for p, n in ((ws, short_new), (wl, long_new), (wl, long_new)):
            client.result(client.generate(p, max_new_tokens=int(n)),
                          timeout=600)
        for s in servers:
            s.engine.mark_steady()

        lock = threading.Lock()
        itls, ttfts = [], []
        short_streams, long_streams = {}, {}
        short_left = list(range(n_short))
        long_left = list(range(n_long))
        short_done, long_done, long_fired = [0], [0], [0]
        threads = []

        def consume_long(j):
            t0 = time.perf_counter()
            rid = client.generate(longs[j], max_new_tokens=long_new)
            stamps, toks = [], []
            for tok in client.stream(rid, timeout=600):
                stamps.append(time.perf_counter())
                toks.append(tok)
            with lock:
                if stamps:
                    ttfts.append((stamps[0] - t0) * 1e3)
                long_streams[j] = toks
                long_done[0] += 1

        def consume_short(i):
            t0 = time.perf_counter()
            rid = client.generate(shorts[i],
                                  max_new_tokens=int(short_lens[i]))
            stamps, toks = [], []
            for tok in client.stream(rid, timeout=600):
                stamps.append(time.perf_counter())
                toks.append(tok)
            with lock:
                if stamps:
                    ttfts.append((stamps[0] - t0) * 1e3)
                itls.extend((b - a) * 1e3
                            for a, b in zip(stamps, stamps[1:]))
                short_streams[i] = toks
                short_done[0] += 1
                nxt = short_left.pop(0) if short_left else None
                fire = long_left and short_done[0] % long_every == 0
                lng = long_left.pop(0) if fire else None
                if lng is not None:
                    long_fired[0] += 1
            for fn, arg in ((consume_long, lng), (consume_short, nxt)):
                if arg is not None:
                    t = threading.Thread(target=fn, args=(arg,), daemon=True)
                    t.start()
                    with lock:
                        threads.append(t)

        t0 = time.perf_counter()
        with lock:
            seeds = [short_left.pop(0)
                     for _ in range(min(concurrency, len(short_left)))]
        for i in seeds:
            t = threading.Thread(target=consume_short, args=(i,),
                                 daemon=True)
            t.start()
            with lock:
                threads.append(t)
        deadline = time.monotonic() + 900
        while time.monotonic() < deadline:
            with lock:
                if (short_done[0] >= n_short
                        and long_done[0] >= long_fired[0]
                        and not long_left):
                    break
                # shorts exhausted before the cadence reached a long:
                # fire the stragglers directly
                lng = (long_left.pop(0)
                       if long_left and short_done[0] >= n_short else None)
                if lng is not None:
                    long_fired[0] += 1
            if lng is not None:
                tl = threading.Thread(target=consume_long, args=(lng,),
                                      daemon=True)
                tl.start()
                with lock:
                    threads.append(tl)
            time.sleep(0.005)
        dt = time.perf_counter() - t0
        st = client.stats()
        recomp: dict = {}
        for s in servers:
            recomp.update(s.engine.recompiles_since_mark())
        vals, tt = sorted(itls), sorted(ttfts)

        def p99(v):
            return v[int(0.99 * (len(v) - 1))] if v else None

        out = {
            "itl_ms_p50": vals[int(0.50 * (len(vals) - 1))] if vals else None,
            "itl_ms_p99": p99(vals), "itl_samples": len(vals),
            "ttft_ms_p99": p99(tt), "ttft_ms_max": tt[-1] if tt else None,
            "tokens_per_sec": round(
                (sum(len(t) for t in short_streams.values())
                 + sum(len(t) for t in long_streams.values())) / dt, 1),
            "kv_migrations_ok": 0.0,
            "kv_migration_ms": st["router"].get("kv_migration_ms"),
            "failed": st["router"]["failed"],
            "steady_recompiles": recomp,
            "short_streams": short_streams,
            "long_streams": long_streams,
        }
        mig = router.metrics().get("serving_kv_migrations_total", {})
        for s_ in mig.get("series", []):
            if s_.get("labels", {}).get("outcome") == "ok":
                out["kv_migrations_ok"] = s_.get("value", 0.0)
        client.close()
        router.stop()
        for s in servers:
            s.stop()
        return out

    def run_race():
        rr = np.random.default_rng(11)
        prompts = [rr.integers(0, V, size=race_prompt).astype(np.int32)
                   for _ in range(race_longs)]
        tiny = 1 + (race_prompt + long_new) // block_size + 4
        servers = (start_fleet(["prefill"], pool_blocks=tiny)
                   + start_fleet(["decode"] * (replicas - 1), offset=1))
        router = router_over(servers, min(disagg_threshold, race_prompt), 2)
        client = ServingClient("127.0.0.1", router.port,
                               request_timeout=600.0)
        results = {}
        lock = threading.Lock()

        def one(i):
            rid = client.generate(prompts[i], max_new_tokens=long_new)
            out = client.result(rid, timeout=600)
            with lock:
                results[i] = out

        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(race_longs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        lost = sum(1 for i, (toks, reason) in results.items()
                   if toks != _solo(ref, prompts[i], long_new)
                   or reason != "length")
        st = client.stats()
        out = {"race_streams": len(results),
               "race_streams_lost": lost + (race_longs - len(results)),
               "race_failed": st["router"]["failed"],
               "race_migrations": st["router"]["kv_migrations"]}
        client.close()
        router.stop()
        for s in servers:
            s.stop()
        return out

    disagg = run_arm(["prefill"] + ["decode"] * (replicas - 1), disagg=True)
    base = run_arm(["mixed"] * replicas, disagg=False)
    race = run_race()

    parity = True
    for arm in (disagg, base):
        for j, toks in arm["long_streams"].items():
            parity = parity and toks == _solo(ref, longs[j], long_new)
        for i in list(arm["short_streams"])[:4]:
            parity = parity and arm["short_streams"][i] == _solo(
                ref, shorts[i], int(short_lens[i]))

    result = {
        "disagg_ttft_ms_p99": disagg["ttft_ms_p99"],
        "baseline_ttft_ms_p99": base["ttft_ms_p99"],
        "ttft_p99_reduction": (
            round(base["ttft_ms_p99"] / disagg["ttft_ms_p99"], 2)
            if disagg["ttft_ms_p99"] else None),
        "disagg_itl_ms_p99": disagg["itl_ms_p99"],
        "baseline_itl_ms_p99": base["itl_ms_p99"],
        "itl_p99_reduction": (
            round(base["itl_ms_p99"] / disagg["itl_ms_p99"], 2)
            if disagg["itl_ms_p99"] else None),
        "disagg_itl_ms_p50": disagg["itl_ms_p50"],
        "baseline_itl_ms_p50": base["itl_ms_p50"],
        "disagg_tokens_per_sec": disagg["tokens_per_sec"],
        "baseline_tokens_per_sec": base["tokens_per_sec"],
        "kv_migrations_ok": disagg["kv_migrations_ok"],
        "kv_migration_ms": disagg["kv_migration_ms"],
        "disagg_steady_recompiles": disagg["steady_recompiles"],
        "parity": parity,
        "failed": disagg["failed"] + base["failed"],
        "race_streams_lost": race["race_streams_lost"],
        "race_failed": race["race_failed"],
        "race_migrations": race["race_migrations"],
        "itl_samples": disagg["itl_samples"],
        "parallel_capable": (os.cpu_count() or 1) >= 2,
        "n_devices": len(devices),
        "backend": devices[0].type,
        "config": f"d{D}/h{H}/L{L}/v{V}-replicas{replicas}x{slots}slots"
                  f"-short{short_prompt}+{short_new}x{n_short}"
                  f"-long{long_prompt}+{long_new}x{n_long}"
                  f"-chunk{prefill_chunk}-bs{block_size}"
                  f"-thresh{disagg_threshold}-{dtype}"
                  + ("-smoke" if smoke else ""),
    }
    print(json.dumps(result), flush=True)
    if smoke:
        r = result
        _check(r, [
            ("parity", r["parity"]),
            ("kv_migrations_ok >= n_long", r["kv_migrations_ok"] >= n_long),
            ("failed == 0", r["failed"] == 0),
            ("race_streams_lost == 0", r["race_streams_lost"] == 0),
            ("race_failed == 0", r["race_failed"] == 0),
            ("disagg_ttft_ms_p99 < baseline_ttft_ms_p99",
             r["disagg_ttft_ms_p99"] < r["baseline_ttft_ms_p99"]),
            ("disagg_itl_ms_p99 < baseline_itl_ms_p99",
             r["disagg_itl_ms_p99"] < r["baseline_itl_ms_p99"]),
            ("disagg_steady_recompiles == {}",
             r["disagg_steady_recompiles"] == {}),
        ])
    return result


def bench_live_update(V=256, D=128, H=4, L=2, replicas=3, slots=2,
                      prompt_len=16, max_new=32, n_requests=18,
                      clients=3, block_size=16, n_updates=3,
                      dtype="float32", device=None, smoke=False):
    """Zero-downtime live weight updates at the fleet level: ``replicas``
    servers behind the Router serve a closed loop of seeded greedy
    streams while the router performs rolling updates (drain -> chunked
    push -> undrain, one replica at a time) mid-flight.

    - baseline: the workload with no pushes, client-side per-token ITLs;
    - live update: the same workload while ``n_updates`` rolling updates
      land (alternating two same-shape weight sets; the first through
      the wire ``push_weights`` op, the rest through the admin API).
      Every stream completes with its full budget, fresh streams on the
      converged fleet equal ``generate()`` on the final weights, and ITL
      p99 stays within 10% of baseline (+ 2.5 ms);
    - rollback: each replica's SloMonitor burns on the rate of
      length-finishes of a canary that, under good weights, samples its
      eos early; a structurally valid bad checkpoint makes canaries run
      to their budget, and the router's armed guard re-pushes the
      previous version with zero lost streams.

    ``--smoke`` self-checks all of the above."""
    from distkeras_torch import telemetry
    from distkeras_torch.serving import (
        LMServer, Router, ServingClient, ServingEngine,
    )
    from distkeras_torch.telemetry.slo import SloMonitor, SloRule

    devices = _devices(device)
    max_len = prompt_len + max_new + 16
    mkw = dict(vocab_size=V, d_model=D, num_heads=H, num_layers=L,
               max_len=max_len, **_kw(dtype))
    good_a, good_b = _tree(0, **mkw), _tree(1, **mkw)
    # the bad checkpoint: same tree and shapes, garbage values —
    # validation accepts it, only quality burns
    bad = _tree(666, **mkw)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, size=prompt_len).astype(np.int32)
               for _ in range(n_requests)]

    servers = []
    for i in range(replicas):
        dev = devices[i % len(devices)]
        reg = telemetry.MetricRegistry()
        eng = ServingEngine(
            _lm(dev, good_a, **mkw), slots=slots, paged=True,
            block_size=block_size, registry=reg,
            tracer=telemetry.Tracer(pid=1000 + i), device=dev,
        )
        slo = SloMonitor(
            [SloRule("canary_length_rate", "serving_requests_total",
                     "rate", 0.02, labels=(("reason", "length"),),
                     windows=(1.5, 3.0), burn_threshold=0.5)],
            registry=reg, tracer=eng.tracer, interval_s=0.25,
        )
        servers.append(LMServer(eng, slo=slo).start())
    router = Router(
        [("127.0.0.1", s.port, f"r{i}") for i, s in enumerate(servers)],
        block_size=block_size, poll_interval=0.1,
        registry=telemetry.MetricRegistry(), tracer=telemetry.Tracer(pid=1),
    ).start()
    client = ServingClient("127.0.0.1", router.port, request_timeout=600.0)

    def run_phase(tag):
        lock = threading.Lock()
        nxt = [0]
        streams, itls = {}, []

        def worker():
            while True:
                with lock:
                    if nxt[0] >= n_requests:
                        return
                    i = nxt[0]
                    nxt[0] += 1
                rid = client.generate(prompts[i], max_new_tokens=max_new)
                toks, reason, last_t, gaps = [], None, None, []
                for kind, val in client.frames(rid, timeout=600):
                    now = time.perf_counter()
                    if kind == "end":
                        reason = val
                        break
                    toks.append(val)
                    if last_t is not None:
                        gaps.append((now - last_t) * 1e3)
                    last_t = now
                with lock:
                    streams[i] = (toks, reason)
                    itls.extend(gaps)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        dt = time.perf_counter() - t0
        arr = np.asarray(sorted(itls)) if itls else np.asarray([0.0])
        return {"tag": tag, "streams": streams, "makespan_s": dt,
                "itl_p50": float(arr[int(0.50 * (len(arr) - 1))]),
                "itl_p99": float(arr[int(0.99 * (len(arr) - 1))]),
                "tokens": int(sum(len(t) for t, _ in streams.values()))}

    # warm-up: cold + repeat prompt, decode, and one same-values push
    for _ in range(2):
        client.result(client.generate(prompts[0], max_new_tokens=4),
                      timeout=600)
    router.rolling_update(good_a, retry_timeout_s=120.0)
    for s in servers:
        s.engine.mark_steady()

    base = run_phase("baseline")

    push_err = []

    def pusher():
        try:
            pc = ServingClient("127.0.0.1", router.port,
                               request_timeout=600.0)
            sets = [good_b, good_a]
            for u in range(n_updates):
                time.sleep(0.3)
                params = sets[u % 2]
                if u == 0:
                    pc.push_weights(params, chunk_bytes=256 << 10,
                                    timeout=600.0)
                else:
                    router.rolling_update(params, retry_timeout_s=120.0)
            pc.close()
        except Exception as e:  # surfaced in the JSON, fails the smoke
            push_err.append(f"{type(e).__name__}: {e}")

    pt = threading.Thread(target=pusher, daemon=True)
    pt.start()
    live = run_phase("live")
    pt.join(timeout=600)

    final = _lm(devices[0], [good_b, good_a][(n_updates - 1) % 2], **mkw)
    post_parity = True
    for i in range(4):
        toks, reason = client.result(
            client.generate(prompts[i], max_new_tokens=max_new), timeout=600)
        post_parity = (post_parity and reason == "length"
                       and toks == _solo(final, prompts[i], max_new))
    complete = all(reason == "length" and len(toks) == max_new
                   for toks, reason in live["streams"].values())
    recomp: dict = {}
    for s in servers:
        recomp.update(s.engine.recompiles_since_mark())
    swaps_total = client.stats().get("weight_swaps")

    # rollback: bad checkpoint -> SLO burn -> auto-rollback
    canary_prompt = rng.integers(0, V, size=prompt_len).astype(np.int32)
    canary_ref = _solo(final, canary_prompt, max_new)
    eos_id = int(canary_ref[3])  # the good weights emit this 4th
    canary_stop = threading.Event()
    canary_out = []

    def canary_loop():
        while not canary_stop.is_set():
            try:
                rid = client.generate(canary_prompt, max_new_tokens=max_new,
                                      eos_id=eos_id)
                toks, reason = client.result(rid, timeout=600)
                canary_out.append((time.monotonic(), reason, len(toks)))
            except Exception:
                canary_out.append((time.monotonic(), "error", 0))
            time.sleep(0.1)

    # let the earlier phases' length-finishes decay out of every burn
    # window before arming the guard
    time.sleep(3.5)
    ct = threading.Thread(target=canary_loop, daemon=True)
    ct.start()
    time.sleep(1.0)
    t_bad = time.monotonic()
    router.rolling_update(bad, guard_window_s=60.0, retry_timeout_s=120.0)
    rollback_fired = False
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        if router.stats()["router"]["weights"]["rollbacks"] >= 1:
            rollback_fired = True
            break
        time.sleep(0.2)
    t_rb = time.monotonic()
    time.sleep(2.0)
    canary_stop.set()
    ct.join(timeout=30)
    post_rb = [r for t, r, _ in canary_out if t > t_rb + 0.5]
    canary_recovered = bool(post_rb) and all(r == "eos" for r in post_rb)
    canary_lost = sum(1 for _, r, _ in canary_out
                      if r not in ("eos", "length"))
    wfinal = router.stats()["router"]["weights"]

    result = {
        "base_itl_ms_p50": round(base["itl_p50"], 3),
        "base_itl_ms_p99": round(base["itl_p99"], 3),
        "live_itl_ms_p50": round(live["itl_p50"], 3),
        "live_itl_ms_p99": round(live["itl_p99"], 3),
        "itl_p99_ratio": (round(live["itl_p99"] / base["itl_p99"], 3)
                          if base["itl_p99"] else None),
        "updates_applied": n_updates + 1,  # + the warm-up push
        "fleet_weight_swaps": swaps_total,
        "streams_complete": complete,
        "post_update_parity": post_parity,
        "push_errors": push_err,
        "rollback_fired": rollback_fired,
        "rollback_s": round(t_rb - t_bad, 2) if rollback_fired else None,
        "rollbacks_total": wfinal["rollbacks"],
        "canary_recovered": canary_recovered,
        "canary_streams_lost": canary_lost,
        "canary_runs": len(canary_out),
        "steady_recompiles": recomp,
        "n_devices": len(devices),
        "backend": devices[0].type,
        "config": f"d{D}/h{H}/L{L}/v{V}-replicas{replicas}x{slots}"
                  f"slots-new{max_new}-req{n_requests}-clients"
                  f"{clients}-updates{n_updates}-{dtype}"
                  + ("-smoke" if smoke else ""),
    }
    client.close()
    router.stop()
    for s in servers:
        try:
            s.stop()
        except Exception:
            pass
    print(json.dumps(result), flush=True)
    if smoke:
        r = result
        _check(r, [
            ("push_errors == []", r["push_errors"] == []),
            ("streams_complete", r["streams_complete"]),
            ("post_update_parity", r["post_update_parity"]),
            ("rollback_fired", r["rollback_fired"]),
            ("rollbacks_total >= 1", r["rollbacks_total"] >= 1),
            ("canary_recovered", r["canary_recovered"]),
            ("canary_streams_lost == 0", r["canary_streams_lost"] == 0),
            ("live_itl_ms_p99 <= 1.10 * base_itl_ms_p99 + 2.5",
             r["live_itl_ms_p99"] <= 1.10 * r["base_itl_ms_p99"] + 2.5),
            ("steady_recompiles == {}", r["steady_recompiles"] == {}),
        ])
    return result


def _multichip_pass(eng, prompts, max_new, looped=False):
    """One pass of ``prompts`` through ``eng`` (stepped here, or by its
    running loop when ``looped``): ``(streams, decode tok/s over the
    pass, request ids)``."""
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    t0 = time.perf_counter()
    if not looped:
        eng.drain(timeout=600)
    streams = [r.stream.tokens(timeout=600) for r in reqs]
    dt = time.perf_counter() - t0
    reasons = [r.stream.finish_reason for r in reqs]
    if any(x != "length" for x in reasons):
        raise RuntimeError(f"multichip pass: streams ended {reasons}")
    return streams, sum(map(len, streams)) / dt, [r.rid for r in reqs]


def _multichip_engine(cfg, device, mesh=None):
    from distkeras_torch import telemetry
    from distkeras_torch.serving import ServingEngine

    model = _lm(device, seed=0, vocab_size=cfg["V"], d_model=cfg["D"],
                num_heads=cfg["H"], num_kv_heads=cfg["Hk"],
                num_layers=cfg["L"], max_len=cfg["max_len"],
                pos_emb="rope", **_kw(cfg["dtype"]))
    where = dict(mesh=mesh) if mesh is not None else dict(device=device)
    return ServingEngine(model, slots=cfg["slots"], paged=True,
                         block_size=cfg["block_size"],
                         registry=telemetry.MetricRegistry(),
                         tracer=telemetry.Tracer(), **where)


def _multichip_prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg["V"], size=cfg["prompt_len"]).astype(
        np.int32) for _ in range(cfg["n_requests"])]


def multichip_rank(cfg_path: str, rank: int) -> int:
    """One tp rank of ``--multichip`` (``serve_bench.py --multichip-rank
    <cfg> <rank>``): join the world, build the same tp engine as every
    rank, and run its lock-step loop. Rank 0 leads, submitting a warm
    pass and a measured pass from its main thread, then stops the loop;
    every other rank follows until the leader stops. Each writes its
    streams by request id (the leader's measured pass, in submit order,
    and its tok/s too) to ``<out>/rank<r>.json``."""
    import datetime

    import torch.distributed as dist

    from distkeras_torch.parallel.mesh import make_mesh
    from distkeras_torch.parallel.ranks import rank_threads

    cfg = json.load(open(cfg_path))
    device = cfg["device"]
    if device.startswith("cuda"):
        torch.cuda.set_device(rank if cfg["backend"] == "nccl" else 0)
        device = f"cuda:{torch.cuda.current_device()}"
    torch.set_num_threads(rank_threads(cfg["tp"]))
    dist.init_process_group(cfg["backend"],
                            init_method=f"tcp://127.0.0.1:{cfg['port']}",
                            rank=rank, world_size=cfg["tp"],
                            timeout=datetime.timedelta(seconds=300))
    try:
        eng = _multichip_engine(cfg, device, make_mesh({"model": cfg["tp"]}))
        out = {"rank": rank, "backend": dist.get_backend()}
        if rank == 0:
            stop, err = threading.Event(), []

            def loop():
                try:
                    eng.serve_forever(stop)
                except BaseException as e:  # reported below
                    err.append(e)

            t = threading.Thread(target=loop, daemon=True)
            t.start()
            try:
                prompts = _multichip_prompts(cfg)
                by_rid = {}
                for i in range(2):  # a warm pass, then the measured one
                    if i:
                        eng.mark_steady()
                    streams, out["tok_s"], rids = _multichip_pass(
                        eng, prompts, cfg["max_new"], looped=True)
                    by_rid.update(zip(map(str, rids), streams))
                out["steady_recompiles"] = eng.recompiles_since_mark()
                out["streams"], out["by_rid"] = streams, by_rid
            finally:
                stop.set()
                t.join(300)
            if err:
                raise err[0]
        else:
            eng.serve_forever(threading.Event())
            out["by_rid"] = {str(rid): toks
                             for rid, toks, _ in eng.lockstep_streams}
        out["ticks"] = eng.ticks
        with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()
    return 0


def bench_multichip(tp_list=(1, 2), V=1024, D=256, H=8, Hk=4, L=4,
                    slots=4, n_requests=16, prompt_len=16, max_new=32,
                    block_size=16, dtype="float32", smoke=False,
                    device=None, python=None, timeout_s=600):
    """Tensor-parallel decode (the reference's ``bench_multichip``): the
    same paged chunked engine at each tp degree of ``tp_list``, its
    sustained decode tok/s against the mesh-less engine's, and every
    stream BIT-IDENTICAL to the mesh-less engine's at every tp. tp=1 is
    a mesh of one position in this process; a tp > 1 runs as that many
    ranks (:func:`multichip_rank`), the leader submitting, every rank
    stepping in the engine's lock-step loop, each follower's kept
    streams held to the leader's. ``python`` is the command prefix a
    rank starts with (default: this interpreter).

    On the CPU (``device='cpu'``, gloo ranks) and on ranks sharing one
    card the numbers measure dispatch and host staging, not a tp speed:
    parity is the point there. The steady-state recompile check reads
    the mesh-less and tp=1 engines and the leader rank of each tp > 1
    (its followers launch the same kernels at the same shapes in lock
    step, in processes of their own). Departure: no respawn into
    virtual host devices."""
    import tempfile

    from distkeras_torch.parallel.mesh import local_mesh
    from distkeras_torch.parallel.ranks import run_ranks

    if smoke:
        V, D, H, Hk, L, slots = 64, 32, 8, 4, 2, 2
        n_requests, prompt_len, max_new = 6, 8, 8
        block_size = 8
    devices = _devices(device)
    dev = devices[0]
    max_len = prompt_len + max_new
    max_len += (-max_len) % block_size
    cfg = dict(V=V, D=D, H=H, Hk=Hk, L=L, slots=slots,
               n_requests=n_requests, prompt_len=prompt_len,
               max_new=max_new, block_size=block_size, dtype=dtype,
               max_len=max_len)
    prompts = _multichip_prompts(cfg)

    def local(mesh):
        eng = _multichip_engine(cfg, dev, mesh)
        _multichip_pass(eng, prompts, max_new)  # warm
        eng.mark_steady()
        streams, tps, _ = _multichip_pass(eng, prompts, max_new)
        return streams, tps, eng.recompiles_since_mark()

    base_streams, base_tps, _ = local(None)
    result = {
        "baseline_decode_tok_s": round(base_tps, 1),
        "multichip_decode_tok_s": {},
        "parity": True,
        "follower_parity": True,
        "steady_recompiles": {},
        "tp_backend": {},
        "n_devices": len(devices),
        "backend": dev.type,
        "config": f"d{D}/h{H}kv{Hk}/L{L}/v{V}-slots{slots}"
                  f"-req{n_requests}-prompt{prompt_len}+{max_new}"
                  f"-bs{block_size}-{dtype}"
                  + ("-smoke" if smoke else ""),
    }
    for tp in tp_list:
        if tp == 1:
            streams, tps, recomp = local(local_mesh({"model": 1}))
            result["tp_backend"]["tp1"] = None
        else:
            cards = len(devices) if dev.type == "cuda" else 0
            backend = "nccl" if cards >= tp else "gloo"
            ranks, _ = run_ranks(
                f"multichip tp={tp}", os.path.abspath(__file__),
                "--multichip-rank", dict(
                    cfg, tp=tp, backend=backend, port=_free_port(),
                    device="cpu" if dev.type != "cuda" else "cuda",
                    out=tempfile.mkdtemp(prefix="dk_multichip_")),
                tp, timeout_s, python)
            streams, tps = ranks[0]["streams"], ranks[0]["tok_s"]
            recomp = ranks[0]["steady_recompiles"]
            result["tp_backend"][f"tp{tp}"] = ranks[0]["backend"]
            # every follower kept the leader's streams (both passes, by
            # request id) and ticked as often
            result["follower_parity"] = result["follower_parity"] and all(
                r["by_rid"] == ranks[0]["by_rid"]
                and r["ticks"] == ranks[0]["ticks"] for r in ranks[1:])
        result["multichip_decode_tok_s"][f"tp{tp}"] = round(tps, 1)
        result["parity"] = result["parity"] and streams == base_streams
        result["steady_recompiles"].update(recomp)
    print(json.dumps(result), flush=True)
    if smoke:
        r = result
        _check(r, [("parity", r["parity"]),
                   ("follower_parity", r["follower_parity"]),
                   ("steady_recompiles == {}", r["steady_recompiles"] == {})])
    return result


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m distkeras_torch.serve_bench",
        description="Serving benchmarks of the port: the Poisson bench "
                    "(no mode flag), the six other single-engine modes, "
                    "the four fleet modes and tensor-parallel decode.")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--shared-prefix", action="store_true",
                      help="paged-engine prefix-caching TTFT bench "
                           "(90%% shared system prompts)")
    mode.add_argument("--host-tier", action="store_true",
                      help="tiered KV cache: a shared-prefix trace sized "
                           "to 3x the device pool's cache headroom, host "
                           "tier vs device-only vs all-resident")
    mode.add_argument("--long-prompt-interference", action="store_true",
                      help="chunked-prefill ITL bench: short decode "
                           "streams vs a stream of long prompts, chunked "
                           "mixed ticks vs monolithic prefill")
    mode.add_argument("--speculative", action="store_true",
                      help="speculative decoding vs the plain mixed tick "
                           "at high acceptance (the model overfit on a "
                           "periodic stream): decode tok/s and ITL")
    mode.add_argument("--multi-step", action="store_true",
                      help="device-resident multi-step decode: tok/s and "
                           "ITL p99 against the window width k")
    mode.add_argument("--pipeline", action="store_true",
                      help="pipelined engine loop vs the sync one: decode "
                           "tok/s, device_wait_ms p50, slot and paged "
                           "parity")
    mode.add_argument("--router", action="store_true",
                      help="N replicas behind the prefix-affinity Router "
                           "vs one replica: throughput scaling, affine vs "
                           "random hit fraction, kill-one-replica failover")
    mode.add_argument("--fleet-sim", action="store_true",
                      help="the Autoscaler under a seeded diurnal load "
                           "model (ramp, burst with a batch tier, a "
                           "replica kill, settle)")
    mode.add_argument("--disagg", action="store_true",
                      help="1 prefill + (replicas-1) decode replicas with "
                           "KV migration vs the uniform mixed fleet")
    mode.add_argument("--live-update", action="store_true",
                      help="rolling weight updates mid-flight and an "
                           "SLO-burn auto-rollback")
    mode.add_argument("--multichip", action="store_true",
                      help="tensor-parallel decode: the paged engine at "
                           "each tp of --tp-list (spawned ranks) vs the "
                           "mesh-less engine, streams bit-identical")
    mode.add_argument("--multichip-rank", nargs=2,
                      metavar=("CFG", "RANK"), help=argparse.SUPPRESS)
    ap.add_argument("--smoke", action="store_true",
                    help="the mode's small self-checking variant (alone: "
                         "the --shared-prefix smoke)")
    ap.add_argument("--no-checks", action="store_true",
                    help="single-engine modes: record the --smoke "
                         "self-checks in the result without raising")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--interarrival", type=float, default=0.002,
                    help="mean Poisson inter-arrival (seconds)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--metrics", default=None,
                    help="JSONL path for the engine's MetricsWriter")
    ap.add_argument("--prefix-len", type=int, default=None,
                    help="shared system-prompt length (default 256)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--long-prompt", type=int, default=None,
                    help="interference bench: long-prompt length "
                         "(default 1024)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunk size C of the interference, speculative, "
                         "pipeline and multi-step benches")
    ap.add_argument("--tick-token-budget", type=int, default=None,
                    help="per-tick token budget (default: slots + chunk "
                         "for interference, slots * (k + 1) + chunk for "
                         "speculative)")
    ap.add_argument("--think-time", type=float, default=0.0,
                    help="interference bench: pause (s) before each "
                         "closed-loop short refill — 0 saturates")
    ap.add_argument("--restore-budget", type=int, default=4,
                    help="host-tier bench: blocks restored per tick")
    ap.add_argument("--draft", default="ngram", choices=["ngram", "model"],
                    help="speculative bench drafter: n-gram lookup or a "
                         "small overfit draft TransformerLM")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculative bench: draft tokens per row a tick")
    ap.add_argument("--multi-step-k", default="1,2,4,8",
                    help="comma list of window widths for --multi-step")
    ap.add_argument("--replicas", type=int, default=3,
                    help="replicas for --router/--disagg/--live-update; "
                         "the largest fleet of --fleet-sim (default 3)")
    ap.add_argument("--tp-list", default="1,2",
                    help="tp degrees of --multichip (default 1,2)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host; default: the CUDA card "
                         "(fleet modes: replica i on "
                         "cuda:{i %% device_count})")
    args = ap.parse_args(argv)
    if args.multichip_rank:
        return multichip_rank(args.multichip_rank[0],
                              int(args.multichip_rank[1]))
    fleet = dict(smoke=args.smoke, device=args.device)
    one = dict(smoke=args.smoke, device=args.device,
               checks=not args.no_checks)
    chunk = ({} if args.prefill_chunk is None
             else dict(prefill_chunk=args.prefill_chunk))
    if args.multi_step:
        bench_multistep(slots=args.slots, dtype=args.dtype,
                        k_list=tuple(int(x) for x
                                     in args.multi_step_k.split(",")),
                        **chunk, **one)
    elif args.pipeline:
        bench_pipeline(slots=args.slots, dtype=args.dtype, **chunk, **one)
    elif args.fleet_sim:
        bench_fleet_sim(max_replicas=args.replicas, **fleet)
    elif args.live_update:
        bench_live_update(replicas=args.replicas, **fleet)
    elif args.disagg:
        bench_disagg(replicas=args.replicas, **fleet)
    elif args.router:
        bench_router(replicas=args.replicas, **fleet)
    elif args.multichip:
        bench_multichip(tp_list=tuple(int(t) for t in
                                      args.tp_list.split(",")), **fleet)
    elif args.host_tier:
        kw = dict(slots=args.slots, block_size=args.block_size,
                  restore_budget=args.restore_budget, dtype=args.dtype)
        if args.prefix_len is not None:
            kw["prefix_len"] = args.prefix_len
        bench_host_tier(**kw, **one)
    elif args.speculative:
        kw = dict(draft=args.draft, spec_k=args.spec_k, dtype=args.dtype,
                  **chunk)
        if args.tick_token_budget is not None:
            kw["tick_token_budget"] = args.tick_token_budget
        bench_speculative(**kw, **one)
    elif args.long_prompt_interference:
        kw = dict(slots=args.slots, dtype=args.dtype,
                  tick_token_budget=args.tick_token_budget,
                  think_time=args.think_time, **chunk)
        if args.long_prompt is not None:
            kw["long_prompt"] = args.long_prompt
        bench_long_prompt_interference(**kw, **one)
    elif args.shared_prefix or args.smoke:
        # only explicit values: the function's defaults are the tuned
        # shared-prefix config, not the Poisson bench's
        kw = dict(slots=args.slots, block_size=args.block_size,
                  dtype=args.dtype)
        if args.prefix_len is not None:
            kw["prefix_len"] = args.prefix_len
        if args.requests != ap.get_default("requests"):
            kw["n_requests"] = args.requests
        bench_shared_prefix(**kw, **one)
    else:
        bench(slots=args.slots, n_requests=args.requests,
              mean_interarrival_s=args.interarrival, dtype=args.dtype,
              metrics_path=args.metrics, device=args.device,
              checks=not args.no_checks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
