"""Least time of the kernel-only traced window's attention (from the
clients' tokens of that interval) over the paged and splash kernels'
device time in it, %."""

from gpubench.readers import serve_summary
from gpubench.work import least_seconds


def read(record):
    groups, peaks = record.get("device_groups"), record.get("peaks")
    if not (serve_summary(record) and groups and peaks):
        return None
    kernel_s = (groups.get("paged_attention", 0.0)
                + groups.get("splash_prefill", 0.0))
    if kernel_s <= 0:
        return None
    w = record["traced_work"]
    return 100.0 * least_seconds(w["attn_flops"], w["attn_bytes"],
                                 *peaks) / kernel_s
