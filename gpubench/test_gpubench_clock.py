"""The phase spans' clock against the device trace's, on the card: a
phase span brackets ``torch.cuda._sleep`` and a synchronize inside a
traced window; mapped by ``gpubench.phases.trace_us`` from a clock pair
read as the window opens, the sleep kernel's device interval lies
inside the span, give or take 50 us at each end. Run on the
chip with ``python3 -m pytest -m cuda -s gpubench/test_gpubench_clock.py``
(``-s`` prints the offsets)."""

import json
import time

import pytest
import torch

from gpubench import phases

SLACK_US = 50.0


@pytest.mark.cuda
@pytest.mark.parametrize("cpu", [False, True])
def test_span_brackets_its_kernel_on_the_trace_clock(card, tmp_path, cpu):
    from torch.profiler import ProfilerActivity, profile

    from distkeras_torch import telemetry

    tracer = telemetry.Tracer()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        # the first range entered under a profiler is slow: not measured
        with telemetry.Tracer().phase("clock.warm"):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        pair = phases.clock_pair()
        for _ in range(8):
            with tracer.phase("clock.sleep"):
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
            time.sleep(0.002)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    # torch.cuda._sleep's kernel is ATen's spin_kernel; the warm one is
    # a microsecond long
    kernels = sorted((e for e in phases.device_events(doc["traceEvents"])
                      if e["cat"] == "kernel" and float(e["dur"]) > 100),
                     key=lambda e: e["ts"])
    spans = tracer.phase_spans()[0]
    assert len(kernels) == len(spans) == 8
    leads, tails = [], []
    for k, s in zip(kernels, spans):
        k0, k1 = float(k["ts"]), float(k["ts"]) + float(k["dur"])
        leads.append(k0 - phases.trace_us(s[1], pair, base))
        tails.append(phases.trace_us(s[2], pair, base) - k1)
    print(f"\nclock ({'CPU+CUDA' if cpu else 'CUDA'}): kernel start after "
          f"span start, us: {[round(x, 1) for x in leads]}; span end "
          f"after kernel end, us: {[round(x, 1) for x in tails]}")
    if cpu:
        # where the lead goes: the range's start on the trace against the
        # span's mapped start, and the kernel's start against its launch
        ranges = sorted(float(e["ts"]) for e in doc["traceEvents"]
                        if e.get("cat") == "user_annotation"
                        and e.get("name") == "clock.sleep")
        launch = {e["args"]["correlation"]: float(e["ts"])
                  for e in doc["traceEvents"]
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        print("range start after span start, us:",
              [round(r - phases.trace_us(s[1], pair, base), 1)
               for r, s in zip(ranges, spans)],
              "; kernel start after its launch, us:",
              [round(float(k["ts"]) - launch[k["args"]["correlation"]], 1)
               for k in kernels if k["args"].get("correlation") in launch])
    assert min(leads) >= -SLACK_US and min(tails) >= -SLACK_US
