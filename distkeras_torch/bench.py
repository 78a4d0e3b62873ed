"""Where a full-width serving run's device time goes, and how fast the
flagship LM and the CIFAR CNN train, on one CUDA card.

    python -m distkeras_torch.bench

Serves the flagship workload (:data:`FLAGSHIP`: TransformerLM d_model
2048, 8 heads, 8 layers, vocab 8192, bf16, rope, 2 KV heads, int8 KV
cache, max_len 2048, seeded random weights; 16 requests of 96-1024
prompt tokens sharing a 256-token system prefix, 32-64 new tokens,
mixed sampling — :func:`serving_requests`) through the port's
:class:`~distkeras_torch.serving.ServingEngine` (8 slots, 64-token
chunks) under ``torch.profiler``, after one warm-up pass, with the sync
loop and with ``pipeline=True``. Prints one JSON line with the
environment, then one per cache layout (paged, then slot) and loop:
wall time, ticks, the engine's ``device_wait_ms``,
device busy time (the sum of kernel times on the engine's one stream)
and idle share, device time grouped by what ran (the two attention
kernels, matrix products, everything else), and the top kernels.

The next two lines are the LM training lines (:func:`lm_bench`): tok/s
of the flagship training step — the reference's ``lm_bench``
(bench.py:130): d2048/h8/L8/v8192, T=2048, B=8, bf16, AdamW with a bf16
first moment, fused chunked CE, windows of W=5 steps — first with
``attention='standard'``, labelled with the attention the model's own
``preferred()`` gate selects, then with ``attention='ring'`` on a mesh
of one position (sp=1: the zigzag ring's step 0 through the pair
kernels, or the blocked loop where their gate fails); each with its MFU
against the bf16 peak of the reported device from the analytic count of
:func:`lm_step_flops`, and where one more window's device time goes
under ``torch.profiler`` (``lm_profile_window``: busy time, idle share,
device time by kernel group and by named range such as
``Optimizer.step``, top kernels).

The last line is the CIFAR training line (:func:`cifar_bench`), the
reference's headline (bench.py:254-323): ``cifar_cnn`` at its full
widths (64, 128, 256; Dense 256; 10 classes; bf16 compute, f32
parameters) on NHWC ``[2048, 32, 32, 3]`` seeded normal inputs with
one-hot labels, SGD 0.05 with momentum 0.9, categorical cross-entropy,
windows of 10 steps through :func:`distkeras_torch.workers.make_window_step`:
``cifar10_cnn_train_samples_per_sec`` as the best of 3 blocks of 5
windows, MFU from :func:`cifar_step_flops`, and one profiled window's
device time by group (convolution, matmul, PyTorch's elementwise
kernels, and the rest: pooling, reductions, copies) and by named range
(``Optimizer.step``), busy time and idle share. It never prints a ratio
to the reference's TPU number.

``chip_smoke.py`` drives the same workloads to prove the path; this
script only measures them. It needs the card and raises without one.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# the flagship of the reference's benchmarks (bench.py:130,
# benchmarks/decode_bench.py:31) with the serving-realistic options
FLAGSHIP = dict(vocab_size=8192, d_model=2048, num_heads=8, num_layers=8,
                max_len=2048, pos_emb="rope", num_kv_heads=2,
                cache_dtype="int8")
SYSTEM_PREFIX = 256
PROMPT_LENS = (96, 1024, 300, 640, 128, 800, 512, 200, 1000, 296, 700, 150,
               420, 960, 560, 333)
# the reference's lm_bench configuration (bench.py:130-157)
LM_FLAGSHIP = dict(vocab_size=8192, d_model=2048, num_heads=8, num_layers=8,
                   max_len=2048)
LM_BATCH, LM_WINDOW = 8, 5
# the reference's CIFAR training bench (bench.py:254-287)
CIFAR_BATCH, CIFAR_WINDOW, CIFAR_CALLS = 2048, 10, 5
CIFAR_LR, CIFAR_MOMENTUM = 0.05, 0.9
# dense bf16 tensor-core peak by device name (NVIDIA's data sheets, SXM
# parts, no sparsity), keyed by name prefix as the reference's bench.py
# keys PEAK_FLOPS by TPU kind
PEAK_FLOPS = {"NVIDIA H100": 989e12, "NVIDIA H200": 989e12}
_SAMPLERS = (dict(), dict(temperature=0.8, top_k=50),
             dict(temperature=1.0, top_p=0.9), dict(),
             dict(temperature=0.7, top_k=20, top_p=0.95))


def serving_requests(vocab_size: int, system_prefix: int = SYSTEM_PREFIX,
                     prompt_lens=PROMPT_LENS):
    """The seeded request mix: ``(prompt, submit kwargs)`` pairs. Prompts
    longer than the system prefix open with it; sampling configurations
    cycle through greedy / temperature + top-k / top-p / both."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab_size, size=system_prefix)
    out = []
    for i, n in enumerate(prompt_lens):
        tail = rng.integers(0, vocab_size, size=(
            n - system_prefix if n > system_prefix else n))
        prompt = (np.concatenate([system, tail]) if n > system_prefix
                  else tail).astype(np.int32)
        cfg = dict(_SAMPLERS[i % len(_SAMPLERS)], seed=100 + i,
                   max_new_tokens=int(32 + (i * 7) % 33))
        out.append((prompt, cfg))
    return out


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "not available"
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "not available"


def peak_flops(device_name: str):
    """The bf16 peak of a device by name, or None when unknown."""
    for kind, peak in PEAK_FLOPS.items():
        if device_name.startswith(kind):
            return peak
    return None


def lm_step_flops(D, H, L, V, B, T, block=64) -> float:
    """Analytic FLOPs of one training step of the flagship LM.

    - Projections and the vocab head: ``6 * (matmul params) * tokens``
      (2 forward + 4 backward FLOPs per multiply-add), with ``12 D^2``
      matmul parameters per layer (qkv, out, the 4x MLP) plus the head's
      ``D V``; the embedding is a lookup, not a product.
    - Causal attention as the kernels execute it (the reference's
      ``_pallas_attn_flops`` convention, bench.py:76-93): per (b*h,
      query tile i, key tile j <= i) nine ``block x block x hd``
      products of ``2 block^2 hd`` FLOPs (2 forward, 3 dq, 4 dk/dv),
      over ``nq (nq + 1) / 2`` tiles of ``block`` rows.
    Elementwise work (softmax, norms, the optimizer) is not counted."""
    dense = 6.0 * (L * 12 * D * D + D * V) * B * T
    nq = -(-T // block)
    attn = L * B * H * (nq * (nq + 1) // 2) * 9 * 2.0 * block * block * (
        D // H)
    return dense + attn


def cifar_step_flops(batch: int = 1, widths=(64, 128, 256), dense: int = 256,
                     num_classes: int = 10, input_shape=(32, 32, 3)) -> float:
    """Analytic FLOPs of one training step of ``cifar_cnn``: 3x the
    forward (forward, and a backward of twice its products). The forward
    is ``2 H W Cin Cout 9`` for each 3x3 convolution at its block's
    resolution plus the two Dense products, 307.6 MFLOP a sample at the
    full widths. ReLU, pooling, the loss and the optimizer are not
    counted."""
    H, W, cin = input_shape
    fwd = 0
    for w in widths:
        for _ in range(2):
            fwd += 2 * H * W * cin * w * 9
            cin = w
        H, W = H // 2, W // 2
    fwd += 2 * H * W * cin * dense + 2 * dense * num_classes
    return 3.0 * fwd * batch


def cifar_bench(calls: int = CIFAR_CALLS) -> dict:
    """CIFAR CNN training throughput and MFU on the card (needs one), the
    reference's protocol: one warm-up window, then the best of 3 blocks
    of ``calls`` windows of :data:`CIFAR_WINDOW` steps."""
    from distkeras_torch.models import get_model
    from distkeras_torch.utils.losses import get_loss, get_optimizer
    from distkeras_torch.workers import make_window_step

    model = get_model("cifar_cnn", seed=0)
    xs, ys = cifar_batches(model.device)
    step = make_window_step(
        model, get_loss("categorical_crossentropy"),
        get_optimizer("momentum", CIFAR_LR, momentum=CIFAR_MOMENTUM))
    float(step(xs, ys)["loss"][-1])  # warm-up window
    dt = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            ms = step(xs, ys)
        final = float(ms["loss"][-1])
        dt = min(dt, time.perf_counter() - t0)
    if not np.isfinite(final):
        raise AssertionError(f"CIFAR CNN loss diverged: {final}")
    steps = calls * CIFAR_WINDOW
    name = torch.cuda.get_device_name(0)
    out = {
        "metric": "cifar10_cnn_train_samples_per_sec",
        "cifar10_cnn_train_samples_per_sec": steps * CIFAR_BATCH / dt,
        "cifar_ms_per_window": dt * 1e3 / calls,
        "cifar_config": f"cifar_cnn-w64/128/256-d256-bf16-b{CIFAR_BATCH}"
                        f"-sgd{CIFAR_LR}-m{CIFAR_MOMENTUM}-W{CIFAR_WINDOW}",
        "device": name, "nvidia_smi": nvidia_smi(),
    }
    peak = peak_flops(name)
    if peak is not None:
        out["cifar_mfu"] = (cifar_step_flops(CIFAR_BATCH) * steps / dt
                            / peak)
        out["cifar_mfu_method"] = ("analytic: 3 x forward convolution and "
                                   "dense products (cifar_step_flops)")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(xs, ys)["loss"][-1])
        wall_ms = (time.perf_counter() - t0) * 1e3
    out["cifar_profile_window"] = dict(
        steps=CIFAR_WINDOW, **_device_summary(prof, wall_ms, _cifar_group))
    return out


def cifar_batches(device, batch: int = CIFAR_BATCH,
                  window: int = CIFAR_WINDOW, seed: int = 0):
    """One window of CIFAR-shaped batches made on ``device`` from a seed:
    ``[W, B, 32, 32, 3]`` normal features in bf16 and ``[W, B, 10]``
    one-hot f32 labels."""
    gen = torch.Generator(device=device).manual_seed(seed)
    xs = torch.randn((window, batch, 32, 32, 3), generator=gen,
                     device=device).to(torch.bfloat16)
    labels = torch.randint(0, 10, (window, batch), generator=gen,
                           device=device)
    return xs, torch.nn.functional.one_hot(labels, 10).float()


def lm_bench(calls: int = 3, attention: str = "standard") -> dict:
    """Flagship training throughput and MFU on the card (needs one), with
    ``attention`` ``'standard'`` or ``'ring'`` (sp=1)."""
    from distkeras_torch.models import get_model
    from distkeras_torch.ops import pallas_attention as fa
    from distkeras_torch.ops.ring_attention import _pair_kernel_block
    from distkeras_torch.parallel.mesh import make_mesh
    from distkeras_torch.parallel.spmd import make_lm_train_step
    from distkeras_torch.utils.losses import get_optimizer

    model = get_model("transformer_lm", dtype=torch.bfloat16, seed=0,
                      attention=attention, **LM_FLAGSHIP)
    V, D, H, L = (LM_FLAGSHIP[k] for k in ("vocab_size", "d_model",
                                           "num_heads", "num_layers"))
    B, T, W = LM_BATCH, LM_FLAGSHIP["max_len"], LM_WINDOW
    toks = torch.as_tensor(
        np.random.default_rng(0).integers(0, V, size=(W, B, T)),
        device=model.device)
    ring = attention == "ring"
    step = make_lm_train_step(
        model, get_optimizer("adamw", 3e-4, mu_dtype=torch.bfloat16),
        mesh=make_mesh({"dp": 1, "sp": 1}) if ring else None, window=True)
    float(step(toks)[-1])  # warm-up window
    dt = float("inf")
    for _ in range(3):  # best of three blocks of `calls` windows
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            losses = step(toks)
        final = float(losses[-1])
        dt = min(dt, time.perf_counter() - t0)
    if not np.isfinite(final):
        raise AssertionError(f"flagship LM loss diverged: {final}")
    hd = D // H
    # the model's own selection predicates label what ran
    if ring:
        pb = _pair_kernel_block(T // 2, hd, model.dtype, model.device)
        kernel = f"ring-sp1-zigzag-{f'pair{pb}' if pb else 'blocked'}"
    else:
        kernel = (f"pallas-causal{fa.BLOCK}"
                  if fa.preferred(T, hd, model.dtype, model.device)
                  else "blocked")
    steps = calls * W
    name = torch.cuda.get_device_name(0)
    out = {
        "lm_tokens_per_sec_per_chip": steps * B * T / dt,
        "lm_ms_per_step": dt * 1e3 / steps,
        "lm_config": f"d{D}/h{H}/L{L}/v{V}/T{T}/b{B}-bf16-{kernel}"
                     f"-adamw-mubf16-fusedce",
        "device": name, "nvidia_smi": nvidia_smi(),
    }
    peak = peak_flops(name)
    if peak is not None:
        out["lm_mfu"] = (lm_step_flops(D, H, L, V, B, T, fa.BLOCK) * steps
                         / dt / peak)
        out["lm_mfu_method"] = ("analytic: 6*matmul_params*tokens + "
                                "causal-kernel tiles (lm_step_flops)")
    # where one window's device time goes (a separate, profiled window:
    # the profiler's own cost stays out of the timed blocks above)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(toks)[-1])
        wall_ms = (time.perf_counter() - t0) * 1e3
    out["lm_profile_window"] = dict(steps=W, **_device_summary(prof,
                                                               wall_ms))
    return out


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


def _cifar_group(name: str) -> str:
    """:func:`_group`, with PyTorch's elementwise kernels (the bias adds,
    ReLUs, casts and the optimizer's per-leaf passes) taken out of
    'other', which keeps pooling, reductions and copies."""
    group = _group(name)
    if group == "other" and ("elementwise_kernel" in name
                             or "multi_tensor_apply" in name):
        return "elementwise"
    return group


def profile_layout(model, requests, paged: bool, **engine_kw) -> dict:
    """One profiled serving run of ``requests`` after a warm-up pass;
    ``engine_kw`` selects an engine mode by plain values
    (``pipeline=True``, ``multi_step_k=4``, ...). Adds the engine's
    own ``device_wait_ms`` percentiles (host time blocked on readback)
    to the device summary."""
    from torch.profiler import ProfilerActivity, profile

    from distkeras_torch import telemetry
    from distkeras_torch.serving import ServingEngine

    engine_kw.setdefault("prefill_chunk", 64)

    def engine():
        return ServingEngine(model, slots=8, paged=paged, block_size=16,
                             registry=telemetry.MetricRegistry(),
                             tracer=telemetry.Tracer(), **engine_kw)

    warm = engine()
    for p, c in requests[:2]:
        warm.submit(p, **c)
    warm.drain(timeout=600)
    eng = engine()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p, c in requests:
            eng.submit(p, **c)
        eng.drain(timeout=600)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    st = eng.stats()
    return {"layout": "paged" if paged else "slot", "mode": engine_kw,
            "ticks": st["ticks"], "tokens": st["tokens_generated"],
            "device_wait_ms": st["device_wait_ms"],
            **_device_summary(prof, wall_ms)}


def _device_summary(prof, wall_ms: float, group=_group) -> dict:
    """Device busy time (the sum of kernel times on the one stream), idle
    share, device time by ``group`` (a kernel name -> its group) and by
    named range (such as ``Optimizer.step``), and the top kernels of a
    ``torch.profiler`` run that took ``wall_ms`` on the host clock."""
    kernels, ranges = [], {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if not (dev_us > 0 and getattr(evt, "device_type", None) is not None
                and "CUDA" in str(evt.device_type)):
            continue
        if getattr(evt, "is_user_annotation", False):
            # a named range (e.g. Optimizer.step) drawn over the kernels
            # it launched: reported on its own, never added to the busy
            # time, which would count those kernels twice
            ranges[evt.key] = dev_us / 1e3
        else:
            kernels.append((evt.key, dev_us / 1e3, evt.count))
    busy = sum(ms for _, ms, _ in kernels)
    groups: dict = {}
    for name, ms, _ in kernels:
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    kernels.sort(key=lambda k: -k[1])
    return {
        "wall_ms": wall_ms,
        # None: the profiler recorded no device time (not measured)
        "device_busy_ms": busy or None,
        "idle_share": max(0.0, 1.0 - busy / wall_ms) if busy else None,
        "device_ms_by_group": groups,
        "device_ms_by_range": ranges,
        "top_kernels": [{"name": n[:120], "device_ms": ms, "calls": c}
                        for n, ms, c in kernels[:12]],
    }


def main() -> int:
    from distkeras_torch.models import get_model

    model = get_model("transformer_lm", dtype=torch.bfloat16, seed=0,
                      **FLAGSHIP)
    print(json.dumps({"env": {
        "nvidia_smi": nvidia_smi(), "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda}}),
        flush=True)
    requests = serving_requests(model.vocab_size)
    for paged in (True, False):
        for pipeline in (False, True):
            print(json.dumps(profile_layout(model, requests, paged,
                                            pipeline=pipeline)), flush=True)
    del model
    torch.cuda.empty_cache()
    for attention in ("standard", "ring"):
        print(json.dumps(lm_bench(attention=attention)), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(cifar_bench()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
