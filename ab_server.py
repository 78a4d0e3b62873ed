#!/usr/bin/env python3
"""Times the serving engine behind ``LMServer`` beside the same engine
driven in process, with ``chip_smoke.py``'s phase-3 and phase-14
harnesses, so the server's cost shows per tick on one card.

    python3 ab_server.py [--tree DIR]

``DIR`` is the root of a checkout of this repository (this script's own
directory by default); the script imports ``distkeras_torch`` from it.
It serves phase 3's workload — the flagship bf16 model (``FLAGSHIP``,
seed 0) and its 16-request mix, 8 slots, 64-token chunks — after
phase 3's warm-up, three times on each layout in each of two ways, in
turns: in process (``chip_smoke.serve``: every request submitted, then
the engine drained on this thread) and over loopback
(``chip_smoke.wire_serve``: the engine on the server's loop thread,
four clients, one thread a request). Each run is a fresh engine; each
reports its ms per tick, tok/s and the flight recorder's mean host time
per tick: the plan, the dispatch (the host issuing the tick's kernels),
the wait on the readback and the streaming.

Prints the card's name and power limit, then one JSON line: the tree
and, per layout and way, each run's numbers. It
needs a CUDA card and exits non-zero without one.
"""
import argparse
import importlib.util
import json
import os
import sys

RUNS = 3
FLIGHT = ("plan_ms", "dispatch_ms", "device_wait_ms", "stream_ms")


def _run(np, summary, eng):
    ticks = [s for s in eng.flight.snapshots() if s.get("kind") == "tick"]
    return {"ms_per_tick": summary["ms_per_tick"],
            "tok_per_s": summary["tok_per_s"], "ticks": summary["ticks"],
            **{k: float(np.mean([s[k] for s in ticks]))
               for k in FLIGHT if ticks and k in ticks[0]}}


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(
        description="Time one checkout's engine behind LMServer beside the "
                    "same engine in process.")
    ap.add_argument("--tree", default=here,
                    help="root of the checkout whose server is timed")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_server: CUDA is not available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from distkeras_torch import serving, telemetry
    from distkeras_torch.bench import nvidia_smi, serving_requests
    from distkeras_torch.models import get_model

    if not os.path.abspath(serving.__file__).startswith(tree + os.sep):
        print(f"ab_server: distkeras_torch came from {serving.__file__}, "
              f"not from {tree}", file=sys.stderr)
        return 2
    print(nvidia_smi(), flush=True)
    dk = {"ServingEngine": serving.ServingEngine, "telemetry": telemetry,
          "LMServer": serving.LMServer,
          "ServingClient": serving.ServingClient}
    model = get_model("transformer_lm", dtype=torch.bfloat16,
                      device="cuda", seed=0, **smoke.FLAGSHIP)
    requests = serving_requests(model.vocab_size, smoke.SYSTEM_PREFIX,
                                smoke.PROMPT_LENS)
    layouts = (("paged", dict(paged=True, block_size=16)),
               ("slot", dict(paged=False)))
    for _, kw in layouts:
        smoke.serve(torch, np, dk, model, requests[:2], **kw)
        *_, srv, cl, _ = smoke.wire_serve(torch, np, dk, model,
                                          requests[:2], **kw)
        cl.close()
        srv.stop()
    out = {f"{lay}_{way}": [] for lay, _ in layouts
           for way in ("direct", "wire")}
    for _ in range(RUNS):
        for lay, kw in layouts:
            summary, _, eng = smoke.serve(torch, np, dk, model, requests,
                                          **kw)
            out[f"{lay}_direct"].append(_run(np, summary, eng))
            summary, _, eng, srv, cl, _ = smoke.wire_serve(
                torch, np, dk, model, requests, **kw)
            cl.close()
            srv.stop()
            out[f"{lay}_wire"].append(_run(np, summary, eng))
    print(json.dumps({"tree": os.path.relpath(tree, here), **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
