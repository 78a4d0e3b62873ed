"""p95 over the window's gaps between consecutive tokens of a stream, on
the client's clock, ms."""

from gpubench.readers import serve_summary


def read(record):
    return record["tails"]["itl_p95_ms"] if serve_summary(record) else None
