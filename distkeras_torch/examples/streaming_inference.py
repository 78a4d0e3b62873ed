"""Streaming inference — the reference's Kafka demo, on the port
(``examples/streaming_inference.py``).

A :class:`~distkeras_torch.streaming.RecordProducer` serves records over
TCP (the broker stand-in; swap in ``kafka_source`` when a real broker
exists), and a :class:`~distkeras_torch.streaming.StreamingPredictor`
consumes them in padded fixed-shape micro-batches. The stream must keep
every record, in order, and its predictions must equal one batch predict
of the same rows (within ``TOL``: other batch shapes, other summation
orders); a producer that dies mid-stream raises, never
truncates.

Run: ``python -m distkeras_torch.examples.streaming_inference [--n 4096]
[--batch-size 256] [--device cpu]``
"""

import argparse
import time

import numpy as np

# a batch predict runs other batch shapes than the stream's padded
# micro-batches: the same f32 logits up to the summation order's rounding
TOL = 1e-4


def make_records(n, dim):
    """The reference's records: the same generator, seed and order."""
    rng = np.random.default_rng(0)
    return [{"id": i, "features": rng.normal(size=dim).astype(np.float32)}
            for i in range(n)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096, help="records to stream")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--dim", type=int, default=784)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def build_model(args, device, params=None):
    """The reference's MLP (256, 128) -> 10; ``params`` (a flax-layout
    tree) replaces its initial weights."""
    from distkeras_torch import bridge
    from distkeras_torch.models import get_model
    from distkeras_torch.models.wrapper import Model

    module = get_model("mlp", features=(256, 128), num_classes=10,
                       in_features=args.dim, device=device, seed=0)
    if params is not None:
        bridge.params_from_jax(params, module)
    return Model(module)


def stream(model, records, batch_size):
    """``(streamed records, seconds, predictor)``; the producer's own
    failure is raised."""
    from distkeras_torch.streaming import (RecordProducer,
                                           StreamingPredictor,
                                           socket_source)

    producer = RecordProducer(records, chunk=64).start()
    predictor = StreamingPredictor(model, batch_size=batch_size,
                                   max_latency_s=0.1)
    t0 = time.time()
    out = list(predictor.predict_stream(
        socket_source(producer.host, producer.port, timeout=30)))
    dt = time.time() - t0
    producer.join()
    return out, dt, predictor


def batch_predict(model, records):
    from distkeras_torch.data import PartitionedDataset
    from distkeras_torch.predictors import ModelPredictor

    x = np.stack([r["features"] for r in records])
    return ModelPredictor(model).predict(
        PartitionedDataset.from_arrays({"features": x})).column("prediction")


def run(args, params=None):
    from distkeras_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    records = make_records(args.n, args.dim)
    model = build_model(args, device, params)
    out, dt, predictor = stream(model, records, args.batch_size)
    n_out = len(out)
    assert n_out == args.n, f"stream dropped records: {n_out}/{args.n}"
    if [r["id"] for r in out] != list(range(args.n)):
        raise AssertionError("stream reordered records")
    got = np.stack([r["prediction"] for r in out])
    gap = float(np.abs(got - batch_predict(model, records)).max())
    if not gap <= TOL:
        raise AssertionError(f"streamed predictions differ from a batch "
                             f"predict by {gap} > {TOL}")
    checksum = float(sum(float(p.sum()) for p in got))
    print(f"streamed {n_out} records in {dt:.2f}s "
          f"({n_out / dt:.0f} rec/s, {predictor.batches_run} micro-batches, "
          f"checksum {checksum:.3f})")
    return {"records": n_out, "seconds": dt, "records_per_s": n_out / dt,
            "batches": predictor.batches_run, "checksum": checksum,
            "max_abs_gap_vs_batch": gap}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
