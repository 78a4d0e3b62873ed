"""LM serving — continuous batching over TCP, on the port
(``examples/lm_serving.py``).

Starts an :class:`~distkeras_torch.serving.LMServer` (slot-pooled KV
cache, FIFO admission) on a tiny f32 TransformerLM, submits a handful of
prompts over the framed-msgpack transport, and prints each request's
tokens as they stream back. Every stream is checked token for token
against a solo ``generate()`` call: the engine is the same math, just
scheduled.

Telemetry: ``--telemetry-port`` starts the HTTP scrape endpoint
(``/metrics``, ``/metrics.json``, ``/traces``, ``/flight``, ``/alerts``);
the run always prints the first request's span chain, fetched over the
TCP ``trace_dump`` op, the last flight-recorder ticks (the ``flight``
op) and the default SLO rules' state (the ``alerts`` op), with the stall
watchdog armed. ``--flight-dump PATH`` writes the flight ring as JSONL
(render: ``python -m distkeras_torch.telemetry.report --flight PATH``).

Modes, as the reference's: ``--paged`` (block-paged cache, radix prefix
sharing over a shared system prefix), ``--prefill-chunk`` (0 = monolithic
prefill), ``--pipeline``, ``--multi-step-k``, ``--draft ngram|model``
with ``--spec-k`` (speculative decoding), ``--replicas N`` (N in-process
servers behind the prefix-affinity ``Router``) and ``--tp N``
(tensor-parallel serving). The port runs one process a tp rank: ``--tp
N`` runs in a world of N processes (launch them with
:class:`~distkeras_torch.job_deployment.Job`, ``hosts=["local"] * N``);
every rank runs this module, rank 0's server serves and the others
follow its loop in ``LMServer.join()``.

Run: ``python -m distkeras_torch.examples.lm_serving [--prompts 4]
[--max-new 16] [--slots 2] [--paged] [--draft ngram] [--replicas 3]
[--device cpu]``
"""

import argparse
import time

import numpy as np

from distkeras_torch.examples import join_world, launch_hint


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=128)
    ap.add_argument("--telemetry-port", type=int, default=None,
                    help="start the HTTP scrape endpoint on this port "
                         "(0 = ephemeral)")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV cache + radix prefix sharing "
                         "(prompts share a system prefix; repeat "
                         "requests skip its prefill)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked mixed-tick prefill: prompts stream "
                         "into their slot this many tokens per decode "
                         "tick (0 = monolithic prefill; default 64)")
    ap.add_argument("--flight-dump", default=None, metavar="PATH",
                    help="write the flight-recorder ring to this JSONL "
                         "when done (render: python -m "
                         "distkeras_torch.telemetry.report --flight PATH)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel serving over this many ranks, "
                         "one process each (heads must divide)")
    ap.add_argument("--draft", default=None, choices=["ngram", "model"],
                    help="speculative decoding: 'ngram' proposes from "
                         "each stream's own history, 'model' runs a "
                         "small draft TransformerLM; streams stay "
                         "bit-identical either way")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per row per tick "
                         "(default 4)")
    ap.add_argument("--pipeline", action="store_true",
                    help="pipelined engine loop: dispatch tick N+1 "
                         "before reading tick N's tokens")
    ap.add_argument("--multi-step-k", type=int, default=1,
                    help="multi-step decode: k decode steps per dispatch "
                         "in all-decode steady state")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through the multi-replica fabric: this "
                         "many in-process LMServer replicas behind the "
                         "prefix-affinity Router")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def make_prompts(args):
    """The reference's prompts: the same generator, seed and order (with
    ``--paged``, half of each prompt is one shared system prefix)."""
    rng = np.random.default_rng(0)
    if args.paged:
        half = max(args.prompt_len // 2, 1)
        system = rng.integers(0, args.vocab, size=half).astype(np.int32)
        return [np.concatenate([
            system, rng.integers(0, args.vocab,
                                 size=args.prompt_len - half
                                 ).astype(np.int32)])
            for _ in range(args.prompts)]
    return [rng.integers(0, args.vocab, size=args.prompt_len
                         ).astype(np.int32) for _ in range(args.prompts)]


def _lm(device, params, seed, **kw):
    import torch

    from distkeras_torch import bridge
    from distkeras_torch.models import get_model

    m = get_model("transformer_lm", dtype=torch.float32, attention="dense",
                  device=device, seed=seed, **kw)
    if params is not None:
        bridge.params_from_jax(params, m)
    return m


def build_model(args, device, params=None):
    """The reference's tiny model (d_model 64, 2 heads, 2 layers, f32,
    dense attention); ``params`` (a flax-layout tree) replaces its
    initial weights."""
    return _lm(device, params, 0, vocab_size=args.vocab, d_model=64,
               num_heads=2, num_layers=2,
               max_len=args.prompt_len + args.max_new)


def build_draft(args, device, params=None):
    """The reference's draft model (d_model 32, 2 heads, 1 layer)."""
    return _lm(device, params, 1, vocab_size=args.vocab, d_model=32,
               num_heads=2, num_layers=1,
               max_len=args.prompt_len + args.max_new)


def engine_kwargs(args, device, say, mesh=None, draft_params=None):
    kw = {}
    if args.multi_step_k > 1:
        kw["multi_step_k"] = args.multi_step_k
        say(f"multi-step decode: up to {args.multi_step_k} tokens "
            f"per dispatch in all-decode steady state")
    if args.pipeline:
        kw["pipeline"] = True
        say("pipelined engine loop: depth-2 (plan/stream tick N "
            "overlaps device compute of tick N+1)")
    if args.prefill_chunk is not None:
        kw["prefill_chunk"] = (None if args.prefill_chunk == 0
                               else args.prefill_chunk)
    if args.paged:
        # the largest small block size dividing max_len (paged mode needs
        # whole blocks); small blocks keep sharing visible on tiny prompts
        max_len = args.prompt_len + args.max_new
        bs = next(b for b in (8, 4, 2, 1) if max_len % b == 0)
        kw.update(paged=True, block_size=bs)
    if mesh is not None:
        kw["mesh"] = mesh
        say(f"tensor-parallel serving: tp={args.tp} over {args.tp} "
            f"processes")
    if args.draft == "ngram":
        kw.update(draft="ngram", spec_k=args.spec_k)
        say(f"speculative decoding: n-gram drafter, k={args.spec_k}")
    elif args.draft == "model":
        kw.update(draft=build_draft(args, device, draft_params),
                  spec_k=args.spec_k)
        say(f"speculative decoding: draft model (d_model=32, 1 layer), "
            f"k={args.spec_k} — untrained drafts rarely survive "
            f"verification, so expect a low acceptance rate; the point "
            f"here is that streams stay bit-identical anyway")
    return kw


def solo(model, prompt, n):
    import torch

    from distkeras_torch.models.transformer import generate

    out = generate(model, torch.as_tensor(np.asarray(prompt))[None], n)
    return out[0, len(prompt):].tolist()


def start_servers(args, model, engine_kw, say, device):
    """``(servers, router or None, slo or None, front port)``."""
    from distkeras_torch import telemetry as tel
    from distkeras_torch.serving import LMServer, Router, ServingEngine

    if args.replicas > 1:
        # N replicas (own registries, so the fleet view is a real
        # aggregation) behind the Router; each its own model (same
        # weights): a shared one would take every replica's swap at once
        from distkeras_torch import bridge

        tree = bridge.params_to_jax(model)
        servers = []
        for _ in range(args.replicas):
            eng = ServingEngine(
                build_model(args, device, tree), slots=args.slots,
                registry=tel.MetricRegistry(), tracer=tel.Tracer(),
                device=device, **engine_kw)
            servers.append(LMServer(eng).start())
        router = Router(
            [("127.0.0.1", s.port, f"r{i}") for i, s in enumerate(servers)],
            block_size=engine_kw.get("block_size", 16), poll_interval=0.1,
            registry=tel.MetricRegistry(), tracer=tel.Tracer()).start()
        say(f"fabric: {args.replicas} replicas behind the router on port "
            f"{router.port} (prefix-affine routing)")
        return servers, router, None, router.port
    # one engine (every tp rank builds its own): the SLO monitor (default
    # serving rules) and the stall watchdog ride on the server
    engine = ServingEngine(model, slots=args.slots,
                           device=None if "mesh" in engine_kw else device,
                           **engine_kw)
    slo = tel.SloMonitor(tel.default_serving_rules(),
                         registry=engine.registry, tracer=engine.tracer,
                         interval_s=0.25)
    server = LMServer(engine, slo=slo, watchdog_timeout_s=30.0).start()
    return [server], None, slo, server.port


def drive(args, model, prompts, port, say):
    """Submit every prompt, stream each back and hold it against solo
    ``generate()``: ``(client, rids, streams, seconds)``."""
    from distkeras_torch.serving import ServingClient

    client = ServingClient("127.0.0.1", port)
    t0 = time.perf_counter()
    rids = [client.generate(p, max_new_tokens=args.max_new)
            for p in prompts]
    streams = [list(client.stream(rid)) for rid in rids]
    wall = time.perf_counter() - t0
    for p, rid, toks in zip(prompts, rids, streams):
        want = solo(model, p, args.max_new)
        tag = "parity OK" if toks == want else "PARITY MISMATCH"
        say(f"request {rid}: {toks} ({tag})")
        assert toks == want, (toks, want)
    return client, rids, streams, wall


def report(args, client, rids, total, router, engine, say):
    """The reference's stats, span chain, flight and SLO lines; returns
    the stats it read."""
    stats = client.stats()
    if router is not None:
        router.manager.probe_all()  # fresh per-replica counters
        stats = client.stats()
        served = {name: rep.get("stats", {}).get("requests_completed", 0)
                  for name, rep in stats["replicas"].items()}
        say(f"served {stats['requests_completed']} requests, "
            f"{total} tokens across "
            f"{stats['replicas_routable']} replicas (per replica: "
            f"{served})")
        r = stats["router"]
        say(f"router: {r['routed']:.0f} routed ({r['spilled']:.0f} "
            f"spilled, {r['failed_over']:.0f} failed over, "
            f"{r['failed']:.0f} failed), affinity index "
            f"{r['affinity_index_nodes']} nodes")
    else:
        say(f"served {stats['requests_completed']} requests, {total} "
            f"tokens in {stats['ticks']} ticks (mean occupancy "
            f"{stats['mean_occupancy']}, ttft p50 "
            f"{stats['ttft_ms']['p50']:.1f}ms)")
    if args.pipeline:
        dw = stats.get("device_wait_ms", {}).get("p50")
        say(f"pipeline: {stats.get('overrun_tokens', 0)} overrun tokens "
            f"dropped at reconciliation, device-wait p50 "
            + (f"{dw:.2f}ms" if dw is not None else "n/a"))
    if args.multi_step_k > 1:
        tpd = stats.get("tokens_per_dispatch", {}).get("p50")
        say(f"multi-step: k={stats.get('multi_step_k')}, "
            f"{stats.get('dispatches', 0)} dispatches, tokens/dispatch p50 "
            + (f"{tpd:.2f}" if tpd is not None else "n/a")
            + f", fallbacks {stats.get('multi_step_fallbacks', {})}")
    if args.draft is not None:
        rate = (stats["accepted_tokens"] / stats["draft_tokens"]
                if stats.get("draft_tokens") else 0.0)
        say(f"speculation: {stats['accepted_tokens']}"
            f"/{stats['draft_tokens']} draft tokens accepted (rate "
            f"{rate:.2f}, draft={args.draft}, k={args.spec_k})")
    if args.paged:
        say(f"paged cache: prefix hit fraction "
            f"{stats['prefix_hit_fraction']:.2f} "
            f"({stats['prefix_hit_tokens']}/{stats['prompt_tokens']} "
            f"prompt tokens served from cache), {stats['blocks_in_use']} "
            f"blocks in use")
    # where did request 0 spend its time? the span chain by trace id
    for s in client.trace_dump(trace=client.trace_of(rids[0])):
        attrs = {k: v for k, v in s.items()
                 if k not in ("trace", "span", "t0", "ms")}
        say(f"  trace {s['trace']} {s['span']:<8} {s['ms']:8.2f}ms "
            + " ".join(f"{k}={v}" for k, v in attrs.items()))
    if router is None:
        # why was tick N slow? the flight recorder's last ticks
        fl = client.flight(last=3)
        say(f"flight recorder: {fl['meta']['recorded']} ticks retained; "
            f"last {len(fl['ticks'])}:")
        for t in fl["ticks"]:
            say(f"  tick {t['tick']}: {t['tick_ms']:.2f}ms (plan "
                f"{t['plan_ms']:.2f} / device {t['device_ms']:.2f} / "
                f"stream {t['stream_ms']:.2f}), occ {t['occupancy']}, "
                f"emitted {t['emitted']}")
    alerts = client.alerts()
    firing = [a["rule"] for a in alerts if a["firing"]]
    say(f"slo: {len(alerts)} rules, "
        + (f"FIRING: {firing}" if firing else "none firing"))
    if args.flight_dump:
        n = engine.flight.dump(args.flight_dump, reason="example")
        say(f"flight dump: {n} ticks -> {args.flight_dump} (render: python "
            f"-m distkeras_torch.telemetry.report --flight "
            f"{args.flight_dump})")
    return stats


def run(args, params=None, draft_params=None):
    from distkeras_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    world, rank = join_world(device)
    if args.tp > 1 and args.replicas > 1:
        raise ValueError("lm_serving: --tp and --replicas do not combine "
                         "on the port (one process a tp rank)")
    if world != args.tp:
        raise ValueError(
            f"lm_serving: --tp {args.tp} takes {args.tp} process(es); this "
            f"world has {world}: {launch_hint('lm_serving', args.tp)}")
    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = None
    if args.tp > 1:
        from distkeras_torch.parallel.mesh import make_mesh

        mesh = make_mesh({"model": args.tp})
    model = build_model(args, device, params)
    prompts = make_prompts(args)
    engine_kw = engine_kwargs(args, device, say, mesh, draft_params)
    servers, router, slo, port = start_servers(args, model, engine_kw, say,
                                               device)
    engine = servers[0].engine
    if rank != 0:
        servers[0].join()  # follow the leader's loop until it stops
        return {"rank": rank}
    telemetry_server = client = None
    try:
        if args.telemetry_port is not None:
            from distkeras_torch.telemetry import TelemetryServer

            telemetry_server = TelemetryServer(
                registry=engine.registry, tracer=engine.tracer,
                flight=engine.flight, slo=slo,
                port=args.telemetry_port).start()
            say(f"telemetry: http://127.0.0.1:{telemetry_server.port}"
                f"/metrics (+ /metrics.json, /traces, /flight, /alerts)")
        client, rids, streams, wall = drive(args, model, prompts, port, say)
        tokens = sum(len(s) for s in streams)
        stats = report(args, client, rids, tokens, router, engine, say)
        return {"streams": streams, "tokens": tokens, "seconds": wall,
                "tok_s": tokens / wall, "stats": stats}
    finally:
        if client is not None:
            client.close()
        if router is not None:
            router.stop()
        for s in servers:
            s.stop()
        if telemetry_server is not None:
            telemetry_server.stop()


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
