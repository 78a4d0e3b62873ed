#!/usr/bin/env python3
"""Learning-rate and window sweep of the parameter-server trainers on the
configurations of ``chip_smoke.py``'s phase 9a (the CIFAR CNN over 8
workers, ``examples/cifar10_training.py``'s settings) and phase 8b (the
MNIST workflow over 4 workers): which settings let each algorithm's
center learn, run by run.

Each run prints one JSON line: the task, the engine, the trainer and its
learning rate, window and lock-step flag, the center's cross-entropy on
the first 4,096 rows before and after training, the accuracy of the
trained center on every row, and whether every history row is finite.

    python3 ps_sweep.py --runs AEASGD:0.05:8,DOWNPOUR:0.00125:1 --reps 3
    python3 ps_sweep.py --task mnist --runs DOWNPOUR:0.001:5
    python3 ps_sweep.py --engine jax --rows 8192 --widths 16,32,64 \\
        --runs AEASGD:0.01:8

``--engine torch`` (the default) trains the port on the card;
``--engine jax`` trains the reference package on the CPU (the CIFAR
task only: the example's ``--small`` run at other settings). A run spec
is ``TRAINER:LR:WINDOW`` with ``:spmd`` appended for the lock-step
engine.
"""

import argparse
import json
import os
import sys

import numpy as np

EVAL_ROWS = 4096


def _torch_dk():
    from distkeras_torch import bench, evaluators, predictors, trainers
    from distkeras_torch import transformers as stages
    from distkeras_torch.data.dataset import PartitionedDataset
    from distkeras_torch.models import get_model

    import chip_smoke

    return {"get_model": get_model, "bench": bench,
            "PartitionedDataset": PartitionedDataset,
            "ModelPredictor": predictors.ModelPredictor,
            "AccuracyEvaluator": evaluators.AccuracyEvaluator,
            "MinMaxTransformer": stages.MinMaxTransformer,
            "ReshapeTransformer": stages.ReshapeTransformer,
            "OneHotTransformer": stages.OneHotTransformer,
            "LabelIndexTransformer": stages.LabelIndexTransformer,
            **{n: getattr(trainers, n) for n in chip_smoke.PS_NAMES}}


def torch_run(args, trainer, lr, window, spmd, ds, x, y):
    """One port run on the card; ``ds`` the transformed dataset, ``x``/``y``
    the rows the center's loss is taken on."""
    import torch

    import chip_smoke as cs

    dk = args.dk
    if args.task == "cifar":
        widths = {"widths": args.widths} if args.widths else {}
        model = dk["get_model"]("cifar_cnn", device="cuda", seed=0, **widths)
        kw = dict(cs.PS_CIFAR_TRAIN, **cs.PS_CIFAR[trainer])
        feat = "features"
    else:
        model = dk["get_model"]("mnist_cnn", device="cuda", seed=0)
        kw = cs._mnist_ps_train(trainer)
        feat = "matrix"
    kw.update(learning_rate=lr, communication_window=window)
    before = cs._center_loss(torch, model, x, y)
    t = dk[trainer](model, spmd=spmd, **kw)
    out = t.train(ds, shuffle=True)
    hist = [r["loss"] for h in t.executor_histories for r in h]
    return {"center_loss_before": before,
            "center_loss_after": cs._center_loss(torch, model, x, y),
            "accuracy": cs._accuracy(dk, out, ds, features_col=feat),
            "finite": bool(np.isfinite(hist).all())}


def jax_run(args, trainer, lr, window, spmd, x, y):
    """One reference run on the CPU, the CIFAR task at ``--widths``."""
    import jax
    import jax.numpy as jnp
    import optax

    import chip_smoke as cs
    from distkeras_tpu import PartitionedDataset
    from distkeras_tpu import trainers as jt
    from distkeras_tpu.evaluators import AccuracyEvaluator
    from distkeras_tpu.models import get_model
    from distkeras_tpu.predictors import ModelPredictor
    from distkeras_tpu.transformers import (LabelIndexTransformer,
                                            OneHotTransformer)

    ds = OneHotTransformer(10).transform(PartitionedDataset.from_arrays(
        {"features": x, "label": y}, num_partitions=8))
    widths = {"widths": args.widths} if args.widths else {}
    model = get_model("cifar_cnn", **widths)
    p0 = jax.jit(model.init)(jax.random.PRNGKey(0),
                             jnp.zeros((1, 32, 32, 3)))
    kw = dict(cs.PS_CIFAR_TRAIN, **cs.PS_CIFAR[trainer])
    kw.update(learning_rate=lr, communication_window=window)
    t = getattr(jt, trainer)(model, params=p0, spmd=spmd, **kw)
    out = t.train(ds, shuffle=True)

    def loss(p):
        logits = model.apply(p, jnp.asarray(x[:EVAL_ROWS]))
        return float(optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), jnp.asarray(y[:EVAL_ROWS])).mean())

    pred = LabelIndexTransformer(input_col="prediction").transform(
        ModelPredictor(out).predict(ds))
    hist = [r["loss"] for h in t.executor_histories for r in h]
    return {"center_loss_before": loss(p0), "center_loss_after": loss(out.params),
            "accuracy": AccuracyEvaluator("predicted_index", "label"
                                          ).evaluate(pred),
            "finite": bool(np.isfinite(hist).all())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=("cifar", "mnist"), default="cifar")
    ap.add_argument("--engine", choices=("torch", "jax"), default="torch")
    ap.add_argument("--runs", required=True,
                    help="TRAINER:LR:WINDOW[:spmd], comma-separated")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--widths", default=None,
                    help="cifar_cnn widths, e.g. 16,32,64 (default: full)")
    args = ap.parse_args()
    args.widths = (tuple(int(w) for w in args.widths.split(","))
                   if args.widths else None)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs

    if args.engine == "jax" and args.task != "cifar":
        ap.error("--engine jax runs the CIFAR task only")
    rows = args.rows or (cs.PS_CIFAR_ROWS if args.task == "cifar"
                         else cs.MNIST_ROWS)
    ds = None
    if args.engine == "torch":
        import torch

        if not torch.cuda.is_available():
            print("ps_sweep: --engine torch needs a CUDA card",
                  file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        args.dk = _torch_dk()
    if args.task == "cifar":
        x, y = cs.cifar_rows(np, rows)
        if args.engine == "torch":
            ds = args.dk["OneHotTransformer"](10).transform(
                args.dk["PartitionedDataset"].from_arrays(
                    {"features": x, "label": y}, num_partitions=8))
    else:
        ds = cs.mnist_dataset(np, args.dk, rows)
        x = ds.column("matrix")
        y = ds.column("label")
    x, y = x[:EVAL_ROWS], y[:EVAL_ROWS]
    for spec in args.runs.split(","):
        trainer, lr, window, *flag = spec.split(":")
        spmd = flag == ["spmd"]
        for rep in range(args.reps):
            if args.engine == "torch":
                out = torch_run(args, trainer, float(lr), int(window), spmd,
                                ds, x, y)
            else:
                out = jax_run(args, trainer, float(lr), int(window), spmd,
                              *cs.cifar_rows(np, rows))
            print(json.dumps({"task": args.task, "engine": args.engine,
                              "trainer": trainer, "lr": float(lr),
                              "window": int(window), "spmd": spmd,
                              "rows": rows, "widths": args.widths,
                              "rep": rep, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
