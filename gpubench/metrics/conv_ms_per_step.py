"""Device time of the ``convolution`` kernel group a training step, ms."""

from gpubench.readers import group_ms


def read(record):
    return group_ms(record, "convolution")
