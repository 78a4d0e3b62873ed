"""Serving benchmarks of the port: the four multi-replica modes of the
reference's ``benchmarks/serve_bench.py`` and its tensor-parallel
``--multichip`` mode, over port engines.

Run ``python -m distkeras_torch.serve_bench --router`` (or
``--fleet-sim``, ``--disagg``, ``--live-update``, ``--multichip``), with
``--smoke`` for the self-asserting variant, ``--replicas N`` for the
fleet size, ``--tp-list 1,2`` for ``--multichip``'s tp degrees, and
``--device cpu`` to run the plain PyTorch path on the host. Without
``--device`` the replicas run on the CUDA cards: replica ``i`` takes
``cuda:{i % device_count}`` (one replica per card, as the reference pins
one replica per device; on one card every replica shares it), and the
command raises when there is no card. Each prints one JSON line.

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
- ``--multichip``: the same paged engine at each tp degree, its decode
  tok/s and streams against the mesh-less engine's
  (:func:`bench_multichip`). A tp > 1 runs as that many spawned ranks
  (this script, ``--multichip-rank``) under the engine's lock-step loop:
  gloo on the CPU, NCCL with one card a rank on a host of enough cards,
  gloo with every rank on the one card otherwise.

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
``--multichip`` spawns one process a tp rank. ``--smoke`` evaluates
every self-check of the reference (the same thresholds) and fails
listing each one that missed.
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

    cfg = json.load(open(cfg_path))
    device = cfg["device"]
    if device.startswith("cuda"):
        torch.cuda.set_device(rank if cfg["backend"] == "nccl" else 0)
        device = f"cuda:{torch.cuda.current_device()}"
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // cfg["tp"]))
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
        description="Fleet serving benchmarks of the port.")
    mode = ap.add_mutually_exclusive_group(required=True)
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
                    help="self-check the mode's contract")
    ap.add_argument("--replicas", type=int, default=3,
                    help="replicas for --router/--disagg/--live-update; "
                         "the largest fleet of --fleet-sim (default 3)")
    ap.add_argument("--tp-list", default="1,2",
                    help="tp degrees of --multichip (default 1,2)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host; default: the CUDA cards, "
                         "replica i on cuda:{i %% device_count}")
    args = ap.parse_args(argv)
    if args.multichip_rank:
        return multichip_rank(args.multichip_rank[0],
                              int(args.multichip_rank[1]))
    kw = dict(smoke=args.smoke, device=args.device)
    if args.multichip:
        bench_multichip(tp_list=tuple(int(t) for t in
                                      args.tp_list.split(",")), **kw)
    elif args.router:
        bench_router(replicas=args.replicas, **kw)
    elif args.fleet_sim:
        bench_fleet_sim(max_replicas=args.replicas, **kw)
    elif args.disagg:
        bench_disagg(replicas=args.replicas, **kw)
    else:
        bench_live_update(replicas=args.replicas, **kw)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
