"""CIFAR-10 training — the throughput workload, on the port
(``examples/cifar10_training.py``).

CIFAR-shaped data (synthetic by default, ``--data`` for a real npz), the
VGG-style ``cifar_cnn`` in bfloat16, and a choice of DOWNPOUR / AEASGD
(the baseline configs) or the DataParallelTrainer fast path, with
samples/sec reported per trainer.

Run: ``python -m distkeras_torch.examples.cifar10_training --trainer
downpour --workers 8 [--device cpu --small]``
"""

import argparse
import time

import numpy as np


def load_data(path=None, n=8192):
    """A real npz if given, else a noisy prototype per class (the
    reference's generator and seed: the same rows)."""
    if path:
        with np.load(path) as d:
            return (d["x_train"].astype(np.float32) / 255.0,
                    d["y_train"].reshape(-1).astype(np.int64))
    rng = np.random.default_rng(0)
    protos = rng.uniform(0, 1, size=(10, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=n)
    x = np.clip(protos[y] + rng.normal(scale=0.25, size=(n, 32, 32, 3)),
                0, 1)
    return x.astype(np.float32), y


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None, help="path to cifar10 npz")
    ap.add_argument("--trainer", default="dataparallel",
                    choices=["downpour", "aeasgd", "dataparallel"])
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--n", type=int, default=8192, help="synthetic rows")
    ap.add_argument("--small", action="store_true",
                    help="narrow model widths (CPU/dev runs)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def dataset(x, y, workers):
    from distkeras_torch.data import PartitionedDataset
    from distkeras_torch.transformers import OneHotTransformer

    ds = PartitionedDataset.from_arrays({"features": x, "label": y},
                                        num_partitions=max(workers, 1))
    return OneHotTransformer(10).transform(ds)


def build_model(args, device):
    from distkeras_torch.models import get_model

    widths = dict(widths=(16, 32, 64)) if args.small else {}
    return get_model("cifar_cnn", device=device, seed=0, **widths)


def build_trainer(args, model, params=None):
    from distkeras_torch.trainers import AEASGD, DOWNPOUR, DataParallelTrainer

    common = dict(worker_optimizer="momentum", learning_rate=0.05,
                  loss="categorical_crossentropy", label_col="label_encoded",
                  batch_size=args.batch_size, num_epoch=args.epochs,
                  params=params)
    if args.trainer == "downpour":
        return DOWNPOUR(model, num_workers=args.workers,
                        communication_window=8, **common)
    if args.trainer == "aeasgd":
        return AEASGD(model, num_workers=args.workers,
                      communication_window=8, rho=5.0, elastic_lr=0.01,
                      **common)
    return DataParallelTrainer(model, **common)


def evaluate(model, ds):
    from distkeras_torch.evaluators import AccuracyEvaluator
    from distkeras_torch.predictors import ModelPredictor
    from distkeras_torch.transformers import LabelIndexTransformer

    out = ModelPredictor(model).predict(ds)
    out = LabelIndexTransformer(input_col="prediction").transform(out)
    return AccuracyEvaluator("predicted_index", "label").evaluate(out)


def run(args, params=None):
    from distkeras_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    x, y = load_data(args.data, n=args.n)
    ds = dataset(x, y, args.workers)
    trainer = build_trainer(args, build_model(args, device), params)
    t0 = time.time()
    model = trainer.train(ds, shuffle=True)
    dt = time.time() - t0
    samples = len(ds) * args.epochs
    print(f"{args.trainer}: {dt:.1f}s → {samples / dt:,.0f} samples/sec")
    acc = evaluate(model, ds)
    print(f"train-set accuracy: {acc:.4f}")
    hists = trainer.executor_histories or [trainer.history]
    return {"trainer": args.trainer, "seconds": dt,
            "samples_per_sec": samples / dt, "accuracy": acc,
            "losses": [float(r["loss"]) for h in hists for r in h]}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
