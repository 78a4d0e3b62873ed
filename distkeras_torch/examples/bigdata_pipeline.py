"""Disk-scale pipeline — shards in, a trained model and prediction shards
out, nothing fully resident in host memory; the port of
``examples/bigdata_pipeline.py``.

1. write a (synthetic) dataset as shards (``write_shards``);
2. stream it through ``DataParallelTrainer`` (the native loader, the
   per-epoch two-level shuffle);
3. stream batch inference shard to shard
   (``ModelPredictor.predict_sharded``);
4. evaluate from the prediction shards, and hold that against the same
   evaluation in memory.

Run: ``python -m distkeras_torch.examples.bigdata_pipeline [--n 16384]
[--rows-per-shard 2048] [--device cpu]``
"""

import argparse
import os
import shutil
import tempfile
import time

import numpy as np


def make_rows(n):
    """The reference's clusters: the same generator, seed and rows."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(10, 32)) * 3.0
    labels = rng.integers(0, 10, size=n)
    feats = (centers[labels] + rng.normal(size=(n, 32))).astype(np.float32)
    return feats, np.eye(10, dtype=np.float32)[labels]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--rows-per-shard", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--dir", default=None,
                    help="shard directory (default: a temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cleanup = args.dir is None  # auto temp dirs are removed on exit
    workdir = args.dir or tempfile.mkdtemp(prefix="dk_bigdata_")
    try:
        return run(args, workdir)
    finally:
        if cleanup:
            shutil.rmtree(workdir, ignore_errors=True)


def shard_accuracy(pred_dir):
    """Accuracy read back from the prediction shards, streamed."""
    from distkeras_torch.data import ShardedDataset

    correct = total = 0
    for batch in ShardedDataset(pred_dir).batches(batch_size=1024,
                                                  drop_remainder=False):
        correct += int((batch["prediction"].argmax(-1)
                        == batch["label"].argmax(-1)).sum())
        total += len(batch["label"])
    return correct, total


def run(args, workdir, params=None):
    from distkeras_torch.data import (PartitionedDataset, ShardedDataset,
                                      write_shards)
    from distkeras_torch.data.shard_io import native_dataio_active
    from distkeras_torch.models import get_model
    from distkeras_torch.predictors import ModelPredictor
    from distkeras_torch.trainers import DataParallelTrainer
    from distkeras_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    feats, onehot = make_rows(args.n)

    # 1) land the data as shards (in real use this is the ingest job)
    source = PartitionedDataset.from_arrays(
        {"features": feats, "label": onehot}, num_partitions=1)
    shard_dir = write_shards(source, os.path.join(workdir, "train"),
                             rows_per_shard=args.rows_per_shard)
    sd = ShardedDataset(shard_dir)
    native = native_dataio_active()
    print(f"wrote {sd.num_shards} shards ({sd.num_rows} rows) to "
          f"{shard_dir}; native loader: {native}")

    # 2) stream-train
    trainer = DataParallelTrainer(
        get_model("mlp", features=(64,), num_classes=10, in_features=32,
                  device=device, seed=0),
        params=params, batch_size=args.batch_size, num_epoch=args.epochs,
        learning_rate=0.05, loss="categorical_crossentropy")
    t0 = time.time()
    model = trainer.train(sd, shuffle=True)
    dt = time.time() - t0
    first, last = trainer.history[0]["loss"], trainer.history[-1]["loss"]
    print(f"trained {len(trainer.history)} steps in {dt:.1f}s "
          f"(loss {first:.3f} -> {last:.3f})")

    # 3) stream-predict shard -> shard
    pred_dir = ModelPredictor(model, batch_size=512).predict_sharded(
        sd, os.path.join(workdir, "pred"))

    # 4) evaluate from the prediction shards (streamed), and in memory
    correct, total = shard_accuracy(pred_dir)
    print(f"accuracy over {total} rows: {correct / total:.4f}")
    mem = ModelPredictor(model).predict(source).column("prediction")
    mem_correct = int((mem.argmax(-1) == onehot.argmax(-1)).sum())
    assert correct / total > 0.9
    if (correct, total) != (mem_correct, args.n):
        raise AssertionError(
            f"evaluation from the prediction shards ({correct}/{total}) "
            f"differs from the in-memory one ({mem_correct}/{args.n})")
    return {"shards": sd.num_shards, "rows": sd.num_rows,
            "native_dataio_active": native, "steps": len(trainer.history),
            "seconds": dt, "samples_per_sec":
            len(trainer.history) * args.batch_size / dt,
            "loss_first": float(first), "loss_last": float(last),
            "accuracy": correct / total,
            "accuracy_in_memory": mem_correct / args.n}


if __name__ == "__main__":
    main()
