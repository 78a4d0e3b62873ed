"""Share of the kernel-only traced window in which no kernel, copy or
fill ran on the card, in a serving cell, %."""

from gpubench.readers import idle_pct, serve_summary


def read(record):
    return idle_pct(record) if serve_summary(record) else None
