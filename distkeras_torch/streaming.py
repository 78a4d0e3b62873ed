"""Streaming inference — micro-batch prediction over unbounded sources;
the port of :mod:`distkeras_tpu.streaming`.

Reference: the reference ships a Kafka streaming-inference example in
which Spark Streaming micro-batches records from a Kafka topic and a
deserialized Keras model predicts each batch. The micro-batch contract is
kept — an unbounded source is consumed in bounded batches, each batch one
model call of a fixed shape — and the source is pluggable:

- :func:`iterator_source` — any Python iterable of records,
- :func:`socket_source` — framed msgpack records over TCP (the transport
  of :mod:`distkeras_torch.networking`), the stand-in for a broker,
- :func:`kafka_source` — a Kafka consumer when ``kafka-python`` is
  importable (imported only there).

Every micro-batch is padded to ``batch_size`` rows (the same shapes every
flush, so cuDNN and cuBLAS keep their plans), narrowed to the model's
compute dtype on the host, copied to the card once from pinned memory and
run; the pad is sliced off the host copy of the output.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from distkeras_torch.models.wrapper import Model
from distkeras_torch.utils.transfer import (
    narrow_cast,
    pad_to_rows,
    resolve_transfer_dtype,
)

Record = Dict[str, Any]


# -- sources ----------------------------------------------------------------


def iterator_source(records: Iterable[Record]) -> Iterator[Record]:
    """The trivial source: any iterable of ``{column: value}`` records."""
    return iter(records)


def socket_source(
    host: str,
    port: int,
    timeout: Optional[float] = None,
) -> Iterator[Record]:
    """Subscribe to framed msgpack records from a TCP endpoint.

    Each frame is one record dict (or a list of record dicts, which is
    flattened — producers may batch). The stream ends cleanly ONLY on an
    ``{"__end__": True}`` sentinel; EOF without the sentinel, a reset
    connection, or a receive timeout RAISES, so a producer crash mid-stream
    is never mistaken for end-of-stream (silent truncation).
    """
    from distkeras_torch.networking import connect, recv_msg

    sock = connect(host, port)
    if timeout is not None:
        sock.settimeout(timeout)
    try:
        while True:
            msg = recv_msg(sock)
            if msg is None:
                raise ConnectionError(
                    "record stream closed without the __end__ sentinel "
                    "(producer died mid-stream?)"
                )
            if isinstance(msg, dict) and msg.get("__end__"):
                return
            if isinstance(msg, list):
                yield from msg
            else:
                yield msg
    finally:
        sock.close()


def kafka_source(
    topic: str,
    value_deserializer: Callable[[bytes], Record],
    **consumer_kwargs,
) -> Iterator[Record]:
    """Consume records from a Kafka topic (requires ``kafka-python``,
    imported only here, like pyspark in the Spark adapter)."""
    try:
        from kafka import KafkaConsumer
    except ImportError as e:
        raise ImportError(
            "kafka_source requires kafka-python; use socket_source or "
            "iterator_source in environments without it"
        ) from e
    consumer = KafkaConsumer(topic, **consumer_kwargs)
    for msg in consumer:
        yield value_deserializer(msg.value)


# -- the streaming predictor -------------------------------------------------


class StreamingPredictor:
    """Micro-batch streaming inference over an unbounded record source.

    Records are accumulated until ``batch_size`` rows are pending or, at a
    record's arrival, ``max_latency_s`` has elapsed since the first pending
    record — then one padded fixed-shape model call runs on the model's
    device and predictions are emitted in input order. The generator is
    pull-driven: downstream consumption paces the source (backpressure for
    free). So the latency bound is evaluated when records arrive: if the
    SOURCE blocks with records pending, those records wait until it yields
    again (or ends). Bound the source itself (``socket_source(timeout=
    ...)``) when that matters. ``flush_ms`` holds each flush's wall time,
    from its first host cast to its predictions on the host.
    """

    def __init__(self, model: Model, features_col: str = "features",
                 output_col: str = "prediction", batch_size: int = 256,
                 max_latency_s: float = 0.05, transfer_dtype="auto"):
        self.model = model
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = batch_size
        self.max_latency_s = max_latency_s
        self.transfer_dtype = resolve_transfer_dtype(model.module,
                                                     transfer_dtype)
        # observability: filled as the stream runs
        self.records_seen = 0
        self.batches_run = 0
        self.flush_ms: list = []

    @torch.no_grad()
    def _flush(self, pending: list) -> Iterator[Record]:
        t0 = time.perf_counter()
        n = len(pending)
        x = np.stack([np.asarray(r[self.features_col]) for r in pending],
                     axis=0)
        x = narrow_cast(pad_to_rows(x, self.batch_size), self.transfer_dtype)
        xt = x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
        dev = self.model.device
        if dev.type == "cuda":
            xt = xt.pin_memory().to(dev, non_blocking=True)
        out = self.model.module(xt)
        out = (out.float() if out.is_floating_point() else out).cpu()
        out = out.numpy()[:n]
        self.batches_run += 1
        self.flush_ms.append((time.perf_counter() - t0) * 1e3)
        for rec, pred in zip(pending, out):
            emitted = dict(rec)
            emitted[self.output_col] = pred
            yield emitted

    def predict_stream(self, source: Iterator[Record]) -> Iterator[Record]:
        """Yield input records with ``output_col`` appended, in order."""
        pending: list = []
        first_pending_t: Optional[float] = None
        for record in source:
            self.records_seen += 1
            pending.append(record)
            if first_pending_t is None:
                first_pending_t = time.monotonic()
            full = len(pending) >= self.batch_size
            stale = (self.max_latency_s is not None
                     and time.monotonic() - first_pending_t
                     >= self.max_latency_s)
            if full or stale:
                yield from self._flush(pending)
                pending, first_pending_t = [], None
        if pending:
            yield from self._flush(pending)


# -- a producer for examples/tests -------------------------------------------


class RecordProducer:
    """Serve records over TCP for :func:`socket_source` — the stand-in for
    a broker in tests and examples. One connection, framed msgpack,
    ``{"__end__": True}`` terminator."""

    def __init__(self, records: Iterable[Record], host: str = "127.0.0.1",
                 port: int = 0, chunk: int = 32):
        self._records = list(records)
        self._chunk = chunk
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(1)
        self.host, self.port = self._sock.getsockname()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self.error: Optional[BaseException] = None

    def start(self) -> "RecordProducer":
        self._thread.start()
        return self

    def _serve(self):
        from distkeras_torch.networking import send_msg

        try:
            conn, _ = self._sock.accept()
            with conn:
                for i in range(0, len(self._records), self._chunk):
                    send_msg(conn, self._records[i : i + self._chunk])
                send_msg(conn, {"__end__": True})
        except BaseException as e:  # surfaced by join()
            self.error = e
        finally:
            self._sock.close()

    def join(self, timeout: float = 30.0):
        self._thread.join(timeout)
        if self.error is not None:
            raise self.error
