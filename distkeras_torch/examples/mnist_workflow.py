"""MNIST workflow — the reference's flagship example, end to end, on the
port (``examples/mnist_workflow.py``).

Preprocessing (MinMax normalize -> Reshape -> OneHot), then every trainer
named in ``--trainers`` in turn on the same dataset, then ModelPredictor
-> LabelIndexTransformer -> AccuracyEvaluator, printing each trainer's
training time and accuracy. With no network access it synthesizes
MNIST-shaped data by default; pass ``--data /path/to/mnist.npz``
(keras.datasets format: x_train/y_train) to run on the real digits.

Run: ``python -m distkeras_torch.examples.mnist_workflow [--trainers
adag,easgd] [--workers 4] [--device cpu]``
"""

import argparse

import numpy as np

from distkeras_torch import trainers as _t

TRAINERS = {
    "single": lambda m, a: _t.SingleTrainer(m, **a),
    "averaging": lambda m, a: _t.AveragingTrainer(
        m, num_workers=a.pop("num_workers"), **a),
    "downpour": lambda m, a: _t.DOWNPOUR(m, **a),
    "adag": lambda m, a: _t.ADAG(m, **a),
    "dynsgd": lambda m, a: _t.DynSGD(m, **a),
    "aeasgd": lambda m, a: _t.AEASGD(m, **a),
    "eamsgd": lambda m, a: _t.EAMSGD(m, **a),
    "easgd": lambda m, a: _t.EASGD(m, **a),
    "dataparallel": lambda m, a: _t.DataParallelTrainer(
        m, num_workers=None,
        **{k: v for k, v in a.items() if k != "num_workers"}),
}


def load_data(path=None, n=16384):
    """Real MNIST npz if given, else synthetic digit-shaped blobs (the
    reference's generator and seed: the same rows)."""
    if path:
        with np.load(path) as d:
            x = d["x_train"].reshape(-1, 784).astype(np.float32)
            y = d["y_train"].astype(np.int64)
        return x, y
    rng = np.random.default_rng(0)
    protos = rng.uniform(0, 255, size=(10, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=n)
    x = np.clip(protos[y] + rng.normal(scale=64.0, size=(n, 784)), 0, 255)
    return x.astype(np.float32), y


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None, help="path to mnist.npz")
    ap.add_argument("--trainers", default="single,adag,easgd,dataparallel")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--n", type=int, default=16384, help="synthetic rows")
    ap.add_argument("--model", default="mnist_cnn",
                    choices=["mnist_cnn", "mlp"],
                    help="mlp is the fast CPU-friendly option")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def preprocess(x, y, workers):
    """The reference notebook's stages, in its order."""
    from distkeras_torch.data import PartitionedDataset
    from distkeras_torch.transformers import (MinMaxTransformer,
                                              OneHotTransformer,
                                              ReshapeTransformer)

    ds = PartitionedDataset.from_arrays({"features": x, "label": y},
                                        num_partitions=workers)
    ds = MinMaxTransformer(o_min=0.0, o_max=255.0, input_col="features",
                           output_col="features_normalized").transform(ds)
    ds = ReshapeTransformer("features_normalized", "matrix",
                            (28, 28, 1)).transform(ds)
    return OneHotTransformer(10, "label", "label_encoded").transform(ds)


def build_model(name, device):
    from distkeras_torch.models import get_model

    return get_model(name, device=device, seed=0)


def train(name, args, ds, device, params=None):
    """``(trainer, trained Model)`` of one named trainer; ``params`` (a
    flax-layout tree) replaces the model's initial weights."""
    kwargs = dict(worker_optimizer="adam", learning_rate=1e-3,
                  loss="categorical_crossentropy", features_col="matrix",
                  label_col="label_encoded", batch_size=args.batch_size,
                  num_epoch=args.epochs, num_workers=args.workers)
    if name in ("single",):
        kwargs.pop("num_workers")
    if params is not None:
        kwargs["params"] = params
    trainer = TRAINERS[name](build_model(args.model, device), kwargs)
    return trainer, trainer.train(ds, shuffle=True)


def evaluate(model, ds):
    from distkeras_torch.evaluators import AccuracyEvaluator
    from distkeras_torch.predictors import ModelPredictor
    from distkeras_torch.transformers import LabelIndexTransformer

    out = ModelPredictor(model, features_col="matrix").predict(ds)
    out = LabelIndexTransformer(input_col="prediction").transform(out)
    return AccuracyEvaluator("predicted_index", "label").evaluate(out)


def losses(trainer):
    """Every step's loss the trainer recorded, its workers' in turn."""
    hists = trainer.executor_histories or [trainer.history]
    return [float(r["loss"]) for h in hists for r in h]


def run(args, params=None):
    from distkeras_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    x, y = load_data(args.data, n=args.n)
    print(f"dataset: {len(x)} rows")
    ds = preprocess(x, y, args.workers)
    results = {}
    for name in args.trainers.split(","):
        name = name.strip()
        trainer, model = train(name, args, ds, device, params)
        acc = evaluate(model, ds)
        results[name] = {"time": trainer.get_training_time(),
                         "accuracy": acc, "losses": losses(trainer)}
        print(f"{name:>13}: time={trainer.get_training_time():7.2f}s  "
              f"accuracy={acc:.4f}")
    best = max(results, key=lambda k: results[k]["accuracy"])
    print(f"\nbest: {best} (accuracy {results[best]['accuracy']:.4f})")
    return {"rows": len(x), "trainers": results, "best": best}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
