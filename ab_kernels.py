#!/usr/bin/env python3
"""Times the attention kernels of one checkout with ``chip_smoke.py``'s
kernel-phase harness, so two commits compare like for like on one card.

    python3 ab_kernels.py [--tree DIR] [--no-spin]

``DIR`` is the root of a checkout of this repository (this script's own
directory by default). The script imports ``distkeras_torch.ops.
paged_attention``, ``splash_prefill``, ``pallas_attention`` and
``pallas_pair`` from ``DIR``, whose ``kernels/build.py`` builds ``DIR``'s
kernels under ``DIR``, and runs them through ``paged_cases`` and
``splash_cases`` (phase 2, every pool and dtype),
``serve_bench_kernel_cases`` and ``exact_kernel_cases`` (the f32 shapes
of phases 17 and 4), ``causal_cases`` (phase 5) and ``pair_cases``
(phase 5b) of the ``chip_smoke.py`` beside this script: the same seeded
inputs, the same error checks, the same ``time_ms`` (CUDA events, 64 MB
flushed and a ~1 ms spin kernel before each start event; ``--no-spin``
drops the spin, the timer of the chip runs before it) and the same SDPA
yardsticks. To compare a parent commit with its change, unpack the
parent into a directory that ``.gitignore`` lists (``git archive
<parent> | tar -x -C build/parent``) and run the script in turns on one
card: parent, change, change, parent. The kernels a change leaves alone
are the noise control.

Prints the card's name and power limit, then one JSON line: the tree
(relative to this script's directory), its ops files, whether the spin
was on, and each case's error and times. It needs a CUDA card and exits
non-zero without one.
"""
import argparse
import importlib.util
import json
import os
import sys


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(
        description="Time one checkout's attention kernels with "
                    "chip_smoke.py's kernel-phase harness.")
    ap.add_argument("--tree", default=here,
                    help="root of the checkout whose kernels are timed")
    ap.add_argument("--no-spin", action="store_true",
                    help="time without the spin kernel before each start "
                         "event")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ab_kernels: CUDA is not available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if args.no_spin:
        smoke.SPIN_CYCLES = 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from distkeras_torch.bench import nvidia_smi
    from distkeras_torch.ops import paged_attention as pa
    from distkeras_torch.ops import pallas_attention as fa
    from distkeras_torch.ops import pallas_pair as pp
    from distkeras_torch.ops import splash_prefill as sp

    for mod in (pa, sp, fa, pp):
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            print(f"ab_kernels: {mod.__name__} came from "
                  f"{mod.__file__}, not from {tree}", file=sys.stderr)
            return 2
    print(nvidia_smi(), flush=True)
    paged = smoke.paged_cases(torch, F, pa)
    splash = smoke.splash_cases(torch, F, sp)
    paged17, splash17 = smoke.serve_bench_kernel_cases(torch, F, pa, sp)
    paged4 = smoke.exact_kernel_cases(torch, F, pa)
    causal = smoke.causal_cases(torch, F, fa)
    pair = smoke.pair_cases(torch, F, pp)
    print(json.dumps({
        "tree": os.path.relpath(tree, here), "spin": not args.no_spin,
        "files": [os.path.relpath(m.__file__, tree)
                  for m in (pa, sp, fa, pp)],
        "paged_attention": paged, "splash_prefill": splash,
        "paged_attention_serve_bench": paged17,
        "splash_prefill_serve_bench": splash17,
        "paged_attention_exact_decode": paged4,
        "causal_attention": causal, "pair_attention": pair}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
