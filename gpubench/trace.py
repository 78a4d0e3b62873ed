"""A short profiled window and what the per-layer metrics read from it.

:func:`profile` runs a callable under ``torch.profiler`` (CPU and CUDA
activities, or the device's alone), writes the Chrome trace under
``build/gpubench/`` and reduces it (:func:`summarize`):

- ``busy_s``: the union of the device's kernel, copy and fill intervals
  over all streams (overlapping kernels, such as NCCL beside compute,
  count once), and ``window_s``, the host's wall time of the window;
- ``groups``: device seconds by kernel group (:func:`group`, a frozen
  copy of ``distkeras_torch/bench.py``'s ``_group`` and
  ``_cifar_group``), and ``kernels``: seconds by kernel name;
- ``optimizer_s``: the union of the kernels launched inside the
  profiler's ``Optimizer.step`` ranges, matched by correlation id;
- ``nccl_s``: the union of NCCL kernels;
- ``breakdown``: the ten kernels that took most time, and the ten
  longest idle gaps named by the host operation running when the gap
  began.
"""

from __future__ import annotations

import json
import re
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_HOST_CATS = ("cpu_op", "user_annotation", "python_function")

_SERVING_KERNEL = re.compile(r"(paged|splash)_(?:f32_)?(?:split|merge)_kernel")


def _group(name: str) -> str:
    if "ca::" in name or name.startswith("_ZN2ca"):
        # the training kernels: the pair instantiations carry PAIR = true
        # as the last template argument (demangled or mangled), the
        # forward, dq and dk/dv (<hd, causal, PAIR>) and the backward's
        # prep pass (<hd, PAIR>) alike; the causal ones carry false
        return ("pair_attention" if (", true>(" in name
                                     or "ELb1EEEv" in name)
                else "causal_attention")
    # the serving kernels, merges included: bf16 on the tensor cores
    # (csrc/serve_mma.cuh: <op>_split_kernel, <op>_merge_kernel) and f32
    # on FFMA (csrc/serve_f32.cuh: <op>_f32_split_kernel,
    # <op>_f32_merge_kernel)
    serving = _SERVING_KERNEL.search(name)
    if serving:
        return ("paged_attention" if serving.group(1) == "paged"
                else "splash_prefill")
    low = name.lower()
    # cuDNN's convolutions (forward, data and weight gradients), before
    # the matmul test: their implicit-GEMM kernels carry "gemm" too
    # ("conv_", not "conv": "convert" names casts)
    if any(k in low for k in ("fprop", "dgrad", "wgrad", "conv2d",
                              "convolution", "convolve", "conv_")):
        return "convolution"
    if ("gemm" in name or "gemv" in name or "nvjet" in name
            or "cutlass" in low):
        return "matmul"
    return "other"


def group(name: str) -> str:
    """:func:`_group`, with PyTorch's elementwise kernels (the bias adds,
    activations, casts and the optimizer's per-leaf passes) taken out of
    'other', which keeps pooling, reductions and copies."""
    g = _group(name)
    if g == "other" and ("elementwise_kernel" in name
                         or "multi_tensor_apply" in name):
        return "elementwise"
    return g


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of ``(start_us, end_us)`` intervals, seconds."""
    return sum(e - s for s, e in merged(intervals)) / 1e6


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events: List[dict], window_s: float) -> dict:
    """The reduction of a Chrome trace's events (see the module doc)."""
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS
           and e.get("ph") == "X"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
             for e in dev]
    kernels: Dict[str, float] = {}
    groups: Dict[str, float] = {}
    for e in dev:
        sec = float(e.get("dur", 0)) / 1e6
        kernels[e["name"]] = kernels.get(e["name"], 0.0) + sec
        g = group(e["name"]) if e["cat"] == "kernel" else "other"
        groups[g] = groups.get(g, 0.0) + sec
    launches = {}
    for e in events:
        if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (float(e["ts"]), e.get("tid"))
    opt_ranges = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e.get("tid"))
                  for e in events if e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith("Optimizer.step")]
    opt_spans = []
    for e, span in zip(dev, spans):
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch and any(s <= launch[0] <= t and tid == launch[1]
                          for s, t, tid in opt_ranges):
            opt_spans.append(span)
    nccl = [span for e, span in zip(dev, spans)
            if "nccl" in e["name"].lower()]
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": union_seconds(spans),
        "window_s": window_s,
        "groups": groups,
        "kernels": kernels,
        "optimizer_s": union_seconds(opt_spans),
        "nccl_s": union_seconds(nccl),
        "breakdown": {
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": _idle_gaps(events, dev, spans, launches),
        },
    }


def _idle_gaps(events, dev, spans, launches, n: int = 10):
    """The ``n`` longest gaps between device work, each named by the
    innermost host operation running, on the thread that launched the
    work after the gap, when the gap began."""
    busy = merged(spans)
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])
            if b[0] > a[1]]
    gaps.sort(reverse=True)
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e.get("tid"), e.get("name", "")) for e in events
            if e.get("cat") in _HOST_CATS and e.get("ph") == "X"]
    starts = sorted((s, i) for i, (s, _) in enumerate(spans))
    out = []
    for length, g0, g1 in gaps[:n]:
        nxt = next((dev[i] for s, i in starts if s >= g1), None)
        launch = launches.get((nxt or {}).get("args", {}).get("correlation"))
        tid = launch[1] if launch else None
        cover = [h for h in host if h[0] <= g0 <= h[1]
                 and (tid is None or h[2] == tid)]
        name = (min(cover, key=lambda h: h[1] - h[0])[3] if cover
                else "host")
        out.append([f"before {((nxt or {}).get('name') or '?')[:60]}: "
                    f"{name[:80]}", length / 1e6])
    return out


def profile(fn: Callable[[], object], path: Path, cpu: bool = True) -> dict:
    """Run ``fn`` once under the profiler, synchronized on both ends,
    write the trace to ``path`` and return its :func:`summarize` with the
    window's start and end on the host clock (``t0``, ``t1``). With
    ``cpu=False`` only the device is traced: the host runs at its own
    pace, so the busy and idle shares are those of an untraced run (the
    CPU activity's cost per operation slows a host-paced loop)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = (([ProfilerActivity.CPU] if cpu or not cuda else [])
            + ([ProfilerActivity.CUDA] if cuda else []))
    sync()
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        t1 = time.perf_counter()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = summarize(events, t1 - t0)
    out["t0"], out["t1"] = t0, t1
    return out
