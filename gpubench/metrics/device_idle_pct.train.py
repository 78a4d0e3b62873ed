"""Share of the kernel-only traced window in which no kernel, copy or
fill ran on the card, in a training cell, %."""

from gpubench.readers import idle_pct, train_summary


def read(record):
    return idle_pct(record) if train_summary(record) else None
