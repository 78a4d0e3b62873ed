"""The readings that set a cell's limits (``limits/<cell>.json``).

    python3 -m gpubench.readings --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 3]

For each seed, the program's numbers as a run compares them (training:
the first steps only, no window; serving: a short window at the cell's
own load). For each control seed, the same numbers of the control (the
reference in fp8 in the program's place) and of the faults planted in
the reference (training: half of the rows left out; a stale feed inside
the checked window; under data parallelism each rank's rows alone, the
exchange left out; serving:
each served token altered). One JSON line a seed, then a summary: per
number, the largest program reading (the lower end of its limit) and
the smallest reading of the control and of each fault (the upper
ends).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from gpubench import guard

os.environ.update(guard.ENV)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpubench import compare, generator  # noqa: E402
from gpubench.cells import load_cell  # noqa: E402
from gpubench.kinds import train  # noqa: E402
from gpubench.runner import Run, free  # noqa: E402
from gpubench.weights import lm_specs, make_flat, views  # noqa: E402


def readings_job(run: Run, rank: int = 0, world: int = 1, group=None,
                 mesh=None) -> list:
    """Training readings on one rank, seed after seed."""
    out = []
    for seed in run.seeds:
        run.seed = seed
        res = train.rank_main(run, rank, world, group, mesh,
                              checks_only=True)
        row = {"seed": seed, "program": compare.train_numbers(
            res["prog"], res["ref"]),
            "worst": {k: compare.worst_leaf(res["prog"], res["ref"], k)
                      for k in ("grad_norms", "delta_norms")}}
        if seed in run.control_seeds:
            row.update(train.control_readings(run, res["check"], res["ref"],
                                              rank, world, group))
        out.append(row)
        del res
        free()
    return out


@torch.no_grad()
def serve_controls(run: Run) -> dict:
    """The control's and the altered tokens' gaps over a run's sample:
    at each served position, the token the fp8 reference puts first, and
    the served token with its lowest bit flipped."""
    from gpubench.kinds.serve_closed_loop import served_gap
    from gpubench.reference import lm as ref_lm
    from gpubench.reference import precision

    cfg, mix = run.cell.config, run.cell.traffic
    dev = run.device()
    precision.strict()
    specs = lm_specs(cfg)
    w = views(make_flat(specs, run.seed, dev), specs)
    fp8_tokens, altered = [], []
    for rec in run.sample:
        prompt, _ = generator.request(mix, run.seed, cfg["vocab_size"],
                                      rec["i"])
        seq = np.concatenate([prompt, np.asarray(rec["tokens"][:-1],
                                                 np.int32)])
        toks = torch.as_tensor(seq, device=dev).long()[None]
        low = ref_lm.logits(w, toks, cfg, precision.FP8)[0][len(prompt) - 1:]
        fp8_tokens.append(dict(rec, tokens=low.argmax(dim=-1).tolist()))
        altered.append(dict(rec, tokens=[t ^ 1 for t in rec["tokens"]]))
    del w
    free()
    return {"fp8": {"served_gap": served_gap(cfg, mix, run.seed, dev,
                                             fp8_tokens)},
            "alter_token": {"served_gap": served_gap(cfg, mix, run.seed,
                                                     dev, altered)}}


def summary(rows: list) -> dict:
    out = {}
    for row in rows:
        for who, numbers in row.items():
            if who == "seed":
                continue
            for name, v in numbers.items():
                d = out.setdefault(name, {})
                if who == "program":
                    d["lower"] = max(d.get("lower", 0.0), v)
                else:
                    d[who] = min(d.get(who, float("inf")), v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    from gpubench.run import cache_dirs, execute

    cache_dirs()
    cell = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    run = Run(cell, seeds[0], args.seconds, False, seeds=seeds,
              control_seeds=controls)
    rows = []
    if cell.traffic["kind"] == "train":
        if cell.traffic["dp"] == 1:
            rows = readings_job(run)
        else:
            rows = train.spawn(run, cell.traffic["dp"], timeout=3000,
                               job=readings_job)[0]["seeds"]
        for row in rows:
            print(json.dumps(row), flush=True)
    else:
        for seed in seeds:
            r = Run(cell, seed, args.seconds, False)
            line = execute(r)
            row = {"seed": seed, "program": r.numbers,
                   "attempted": line["attempted"], "failed": line["failed"],
                   "metrics": {k: v["value"] for k, v in
                               line["metrics"].items()}}
            if seed in controls:
                row.update(serve_controls(r))
            rows.append(row)
            print(json.dumps({k: row[k] for k in row
                              if k not in ("attempted",)}), flush=True)
            free()
    print(json.dumps({"summary": summary(
        [{k: v for k, v in r.items() if k in ("seed", "program", "fp8",
                                              "half_batch", "stale_feed",
                                              "no_allreduce",
                                              "alter_token")}
         for r in rows])}), flush=True)
    bad = guard.loaded()
    if bad:
        print(f"loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
