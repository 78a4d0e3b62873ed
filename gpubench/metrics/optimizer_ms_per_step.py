"""Device time of the kernels launched in ``Optimizer.step`` ranges a
training step, ms."""

from gpubench.readers import train_summary


def read(record):
    s = train_summary(record)
    if not s or s["optimizer_s"] <= 0:
        return None
    return 1e3 * s["optimizer_s"] / record["steps"]
