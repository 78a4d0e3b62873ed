"""p95 over the window's requests of the client's submit to its first
token, on the client's clock, ms."""

from gpubench.readers import serve_summary


def read(record):
    return record["tails"]["ttft_p95_ms"] if serve_summary(record) else None
