#!/usr/bin/env python3
"""Times the sync chunked serving engine of one checkout with
``chip_smoke.py``'s phase-3 harness, so two commits compare like for
like on one card.

    python3 ab_engine.py [--tree DIR]

``DIR`` is the root of a checkout of this repository (this script's own
directory by default). The script imports ``distkeras_torch`` from
``DIR`` (whose ``kernels/build.py`` builds ``DIR``'s kernels under
``DIR``) and serves phase 3's workload through it: the flagship bf16
model (``FLAGSHIP``, seed 0) and its 16-request mix, 8 slots, 64-token
chunks, with ``serve`` of the ``chip_smoke.py`` beside this script.
After phase 3's warm-up (two requests on each layout) it drives three
runs on each layout, paged and slot in turns, each on a fresh engine,
and reads each run's host time per tick from the engine's flight
recorder: the plan, the dispatch (the host issuing the tick's
kernels), the wait on the readback and the streaming. To compare a
parent commit with its change, unpack the parent into a directory that
``.gitignore`` lists (``git archive <parent> | tar -x -C build/parent``)
and run the script in turns on one card: parent, change, change,
parent.

Prints the card's name and power limit, then one JSON line: the tree
(relative to this script's directory) and, per layout, each run's ms per
tick, tok/s and flight means. It needs a CUDA card and exits non-zero
without one.
"""
import argparse
import importlib.util
import json
import os
import sys

RUNS = 3
FLIGHT = ("plan_ms", "dispatch_ms", "device_wait_ms", "stream_ms")


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(
        description="Time one checkout's sync chunked serving engine with "
                    "chip_smoke.py's phase-3 harness.")
    ap.add_argument("--tree", default=here,
                    help="root of the checkout whose engine is timed")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_engine: CUDA is not available", file=sys.stderr)
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
        print(f"ab_engine: distkeras_torch came from {serving.__file__}, "
              f"not from {tree}", file=sys.stderr)
        return 2
    print(nvidia_smi(), flush=True)
    dk = {"ServingEngine": serving.ServingEngine, "telemetry": telemetry}
    model = get_model("transformer_lm", dtype=torch.bfloat16,
                      device="cuda", seed=0, **smoke.FLAGSHIP)
    requests = serving_requests(model.vocab_size, smoke.SYSTEM_PREFIX,
                                smoke.PROMPT_LENS)
    for paged in (True, False):
        smoke.serve(torch, np, dk, model, requests[:2], paged=paged,
                    block_size=16)
    out = {"paged": [], "slot": []}
    for _ in range(RUNS):
        for paged in (True, False):
            summary, _, eng = smoke.serve(torch, np, dk, model, requests,
                                          paged=paged, block_size=16)
            ticks = [s for s in eng.flight.snapshots()
                     if s.get("kind") == "tick"]
            out["paged" if paged else "slot"].append({
                "ms_per_tick": summary["ms_per_tick"],
                "tok_per_s": summary["tok_per_s"],
                "ticks": summary["ticks"],
                **{k: float(np.mean([s[k] for s in ticks]))
                   for k in FLIGHT if ticks and k in ticks[0]}})
    print(json.dumps({"tree": os.path.relpath(tree, here), **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
