"""Device time of the ``elementwise`` kernel group a training step, ms."""

from gpubench.readers import group_ms


def read(record):
    return group_ms(record, "elementwise")
