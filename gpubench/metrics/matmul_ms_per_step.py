"""Device time of the ``matmul`` kernel group a training step, ms."""

from gpubench.readers import group_ms


def read(record):
    return group_ms(record, "matmul")
