"""The ``serve_closed_loop`` kind: client threads against the port's
``ServingEngine`` on its loop thread.

Set-up builds the model with the seed's weights and the engine the mix
names (``engine``: slots, paged cache, block size, prefill chunk,
pipelined loop, the scheduler's token budget a tick), starts
``serve_forever`` on a thread and ``clients`` closed-loop client
threads: each submits request after request (``gpubench.generator``,
greedy, no stop token) and iterates the request's stream, stamping each
token on the host clock as it arrives. The window opens once
``warmup_completed`` requests have finished, so every slot has cycled,
and closes ``--seconds`` later. With ``--trace 1`` the profiler then
records ``trace_seconds`` more of the same load twice: the device
alone, then the host too. The clients then stop
submitting and the requests in flight are waited for (at most
``drain_timeout_s``).

On the clients' clock: ``serve_tok_s`` (end to end), the tokens that
reached clients inside the window over its length; and the tails, which
a closed loop at the engine's capacity makes per-layer metrics: the p95
of time to first token over every request submitted inside the window,
and of every gap between two consecutive tokens of a stream whose later
token arrived inside the window. A request that errs or ends short
counts in ``failed``.

``correct``: once the program is freed, the plain reference runs once
over the prompt and the served tokens of ``check_requests`` finished
requests of the window, drawn from the seed with the longest among
them, and the widest gap of a served token below the reference's best
logit is held against its limit.
"""

from __future__ import annotations

import itertools
import threading
import time
import traceback

import numpy as np
import torch

from gpubench import compare, faults, generator, work
from gpubench.reference import lm as ref_lm
from gpubench.reference import precision
from gpubench.runner import Run, free, memory_peak, peaks_of
from gpubench.stats import pct
from gpubench.trace import profile
from gpubench.weights import lm_specs, make_flat, views


class Client:
    """One closed-loop client: its records, appended as requests end."""

    def __init__(self, engine, next_request, stop: threading.Event,
                 records: list):
        self.engine, self.next_request = engine, next_request
        self.stop, self.records = stop, records
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while not self.stop.is_set():
            i, prompt, n = self.next_request()
            rec = {"i": i, "prompt_len": len(prompt), "max_new": n,
                   "times": [], "tokens": [], "finish": None, "error": None}
            rec["t_submit"] = time.perf_counter()
            try:
                req = self.engine.submit(prompt, max_new_tokens=n,
                                         temperature=0.0, seed=i)
                for tok in req.stream:
                    rec["times"].append(time.perf_counter())
                    rec["tokens"].append(int(tok))
                rec["finish"] = req.stream.finish_reason
            except Exception as e:  # a refused or failed request counts
                rec["error"] = f"{type(e).__name__}: {e}"
            self.records.append(rec)


def _ok(rec) -> bool:
    return (rec["error"] is None and rec["finish"] == "length"
            and len(rec["tokens"]) == rec["max_new"])


def build_engine(cfg: dict, mix: dict, weights, device, out_dir):
    from distkeras_torch import telemetry
    from distkeras_torch.serving import FIFOScheduler, ServingEngine

    from gpubench.programs import build_model

    model = build_model(cfg, weights, device)
    e = dict(mix["engine"])
    registry, tracer = telemetry.MetricRegistry(), telemetry.Tracer()
    scheduler = FIFOScheduler(tick_token_budget=e.pop("tick_token_budget"),
                              tracer=tracer, registry=registry)
    return ServingEngine(model, scheduler=scheduler, registry=registry,
                         tracer=tracer, postmortem_dir=str(out_dir),
                         device=device, **e)


def served_positions(records, a: float, b: float, cfg: dict):
    """The useful forward work of ``[a, b]``: each prompt whose first
    token arrived then, whole, and each later token's fed position."""
    flops, attn_f, attn_b = 0.0, 0.0, 0.0
    for r in records:
        P = r["prompt_len"]
        for k, t in enumerate(r["times"]):
            if not a <= t <= b:
                continue
            if k == 0:
                flops += sum(work.serve_position_flops(cfg, c, False)
                             for c in (1, P)) / 2 * P \
                    + 2.0 * cfg["d_model"] * cfg["vocab_size"]
                call = work.serve_attn_call(cfg, P, P)
            else:
                flops += work.serve_position_flops(cfg, P + k, True)
                call = work.serve_attn_call(cfg, 1, P + k)
            attn_f += call["flops"]
            attn_b += call["bytes"]
    return {"flops": flops, "attn_flops": attn_f, "attn_bytes": attn_b}


def run(r: Run) -> None:
    with faults.planted(r.fault):
        _run(r)


def _run(r: Run) -> None:
    cfg, mix = r.cell.config, r.cell.traffic
    dev = r.device()
    if r.device_type == "cuda":
        r.device_name = torch.cuda.get_device_name(0)
    specs = lm_specs(cfg)
    flat = make_flat(specs, r.seed, dev)
    engine = build_engine(cfg, mix, views(flat, specs), dev,
                          r.cell.out_dir / "postmortem")
    del flat
    counter, lock = itertools.count(), threading.Lock()

    def next_request():
        with lock:
            i = next(counter)
        return (i,) + generator.request(mix, r.seed, cfg["vocab_size"], i)

    stop_loop, stop_clients = threading.Event(), threading.Event()
    loop_error = []

    def loop():
        try:
            engine.serve_forever(stop_loop)
        except BaseException:
            loop_error.append(traceback.format_exc())

    loop_thread = threading.Thread(target=loop, daemon=True)
    loop_thread.start()
    records: list = []
    clients = [Client(engine, next_request, stop_clients, records)
               for _ in range(mix["clients"])]
    for c in clients:
        c.thread.start()
    try:
        while sum(_ok(x) for x in list(records)) < mix["warmup_completed"]:
            if loop_error:
                raise RuntimeError(f"the engine loop died:\n{loop_error[0]}")
            time.sleep(0.01)
        r.e2e["setup_s"] = time.time() - r.t0
        ticks_a = engine.stats()["ticks"]
        a = time.perf_counter()
        time.sleep(r.seconds)
        b = time.perf_counter()
        ticks_ab = engine.stats()["ticks"] - ticks_a
        if r.trace:
            def wait():
                time.sleep(mix["trace_seconds"])

            busy = profile(wait, r.trace_path(kind="device"), cpu=False)
            summary = profile(wait, r.trace_path())
        stop_clients.set()
        deadline = time.perf_counter() + mix["drain_timeout_s"]
        for c in clients:
            c.thread.join(timeout=max(0.0, deadline - time.perf_counter()))
        stuck = [c for c in clients if c.thread.is_alive()]
        if loop_error:
            raise RuntimeError(f"the engine loop died:\n{loop_error[0]}")
    finally:
        stop_loop.set()
        loop_thread.join(timeout=60)
    if loop_thread.is_alive():
        raise RuntimeError("the engine loop did not stop")
    r.memory_peak_bytes = memory_peak(r)
    window = [x for x in records if a <= x["t_submit"] < b]
    r.attempted = len(window) + len(stuck)
    r.failed = sum(not _ok(x) for x in window) + len(stuck)
    streamed = sum(a <= t <= b for x in records for t in x["times"])
    ttft = [(x["times"][0] - x["t_submit"]) * 1e3 for x in window
            if x["times"]]
    gaps = [(t1 - t0) * 1e3 for x in records
            for t0, t1 in zip(x["times"], x["times"][1:]) if a <= t1 <= b]
    r.e2e["serve_tok_s"] = streamed / (b - a)
    tails = {"ttft_p95_ms": pct(ttft, 0.95), "itl_p95_ms": pct(gaps, 0.95),
             "requests": len(ttft), "gaps": len(gaps)}
    if r.trace:
        r.busy_s, r.window_s = busy["busy_s"], busy["window_s"]
        # the kernel-only window's host runs at its own pace: its kernels
        # and the clients' tokens of the same interval give the roofline
        r.record = {"kind": "serve", "summary": summary, "tails": tails,
                    "busy": {k: busy[k] for k in ("busy_s", "window_s")},
                    "device_groups": busy["groups"],
                    "tick_s": (b - a) / ticks_ab,
                    "window_s": b - a,
                    "work": served_positions(records, a, b, cfg),
                    "traced_work": served_positions(records, busy["t0"],
                                                    busy["t1"], cfg),
                    "peaks": peaks_of(r)}
    del engine, clients
    free()
    sample = check_sample([x for x in window if _ok(x)],
                          mix["check_requests"], r.seed)
    r.numbers = {"served_gap": served_gap(cfg, mix, r.seed, dev, sample)}
    r.sample = sample
    r.extra_ok = bool(sample)


def check_sample(done: list, n: int, seed: int) -> list:
    """``n`` finished requests drawn from the seed, the longest with
    them."""
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda k: done[k]["prompt_len"] + done[k]["max_new"])
    rest = [k for k in range(len(done)) if k != longest]
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [done[longest]] + [done[rest[k]] for k in sorted(pick)]


@torch.no_grad()
def served_gap(cfg, mix, seed, device, sample, prec=precision.F32) -> float:
    """The widest gap of the sample's served tokens under the reference
    (weights and prompts regenerated from the seed)."""
    precision.strict()
    specs = lm_specs(cfg)
    w = views(make_flat(specs, seed, device), specs)
    worst = 0.0
    for rec in sample:
        prompt, _ = generator.request(mix, seed, cfg["vocab_size"], rec["i"])
        seq = np.concatenate([prompt, np.asarray(rec["tokens"][:-1],
                                                 np.int32)])
        toks = torch.as_tensor(seq, device=device).long()[None]
        logits = ref_lm.logits(w, toks, cfg, prec)[0]
        P = len(prompt)
        worst = max(worst, compare.served_gap(logits[P - 1:], rec["tokens"]))
    return worst
