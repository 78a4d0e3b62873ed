"""Device time of the kernels launched inside the step's
``train.backward`` ranges a training step, ms: their union in the full
traced window, launches matched by correlation id on any thread
(autograd launches from its own thread)."""

from gpubench.phases import range_ms_per_step


def read(record):
    return range_ms_per_step(record, "train.backward")
