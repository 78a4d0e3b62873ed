"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It fails, printing no result, when CUDA or enough cards are
missing, when the program cannot be imported, or when JAX or the JAX
package was loaded. Its standard output ends with one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``:
each number that decided ``correct`` beside its limit, which are also
the last lines of standard error.
"""

from __future__ import annotations

import time

_T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from gpubench import guard  # noqa: E402

# before torch: nothing the program loads may bring JAX in
os.environ.update(guard.ENV)

import torch  # noqa: E402

from gpubench.cells import ROOT, kind_module, load_cell  # noqa: E402
from gpubench.compare import judge  # noqa: E402
from gpubench.runner import Run, result_line  # noqa: E402


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(base / "cuda_cache")


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def execute(run: Run) -> dict:
    """Drive the cell, judge it, and build the result line."""
    kind_module(run.cell.traffic["kind"]).run(run)
    correct, compared = judge(run.numbers, run.cell.limits)
    correct = correct and run.extra_ok and run.failed == 0
    line = result_line(run, correct, compared)
    line["compared"] = {k: {kk: _finite(vv) for kk, vv in v.items()}
                        for k, v in line["compared"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("gpubench: no CUDA device; this benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {cell.name} needs {cell.chips} cards; "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    cache_dirs()
    run = Run(cell, args.seed, args.seconds, bool(args.trace), t0=_T0)
    line = execute(run)
    bad = guard.loaded()
    if bad:
        print(f"gpubench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, v in line["compared"].items():
        print(f"compared {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
