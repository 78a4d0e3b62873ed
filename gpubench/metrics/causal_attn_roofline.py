"""Least time of the causal attention a step
(``work.causal_attn_train``) over the causal kernels' device time a
step, %."""

from gpubench.readers import train_summary
from gpubench.work import least_seconds


def read(record):
    s, w, peaks = (train_summary(record), record.get("attn_work"),
                   record.get("peaks"))
    if not (s and w and peaks):
        return None
    kernel_s = s["groups"].get("causal_attention", 0.0)
    if kernel_s <= 0:
        return None
    least = record["steps"] * least_seconds(w["flops"], w["bytes"], *peaks)
    return 100.0 * least / kernel_s
