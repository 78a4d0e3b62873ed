"""Device time of the kernels launched inside the step's
``train.forward`` ranges (the forward with its loss) a training step,
ms: their union in the full traced window, launches matched by
correlation id on any thread."""

from gpubench.phases import range_ms_per_step


def read(record):
    return range_ms_per_step(record, "train.forward")
