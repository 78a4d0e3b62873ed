"""The training step's operations from the shapes (``gpubench.work``)
over the timed window's host-clock time a step and the card's bf16
peak, %."""

from gpubench.readers import train_summary


def read(record):
    if not train_summary(record) or not record.get("peaks"):
        return None
    return 100.0 * record["step_flops"] / record["step_s"] / record["peaks"][0]
