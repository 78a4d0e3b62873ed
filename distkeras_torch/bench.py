"""Where a full-width serving run's device time goes, on one CUDA card.

    python -m distkeras_torch.bench

Serves the flagship workload (:data:`FLAGSHIP`: TransformerLM d_model
2048, 8 heads, 8 layers, vocab 8192, bf16, rope, 2 KV heads, int8 KV
cache, max_len 2048, seeded random weights; 16 requests of 96-1024
prompt tokens sharing a 256-token system prefix, 32-64 new tokens,
mixed sampling — :func:`serving_requests`) through the port's
:class:`~distkeras_torch.serving.ServingEngine` (8 slots, 64-token
chunks) under ``torch.profiler``, after one warm-up pass. Prints one
JSON line with the environment, then one per cache layout (paged, then
slot): wall time, ticks,
device busy time (the sum of kernel times on the engine's one stream)
and idle share, device time grouped by what ran (the two attention
kernels, matrix products, everything else), and the top kernels.

``chip_smoke.py`` drives the same workload to prove the path; this
script only measures it. It needs the card and raises without one.
"""

from __future__ import annotations

import json
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


def _group(name: str) -> str:
    if "attn_kernel" in name:  # PAGED=true instantiations are paged
        return ("paged_attention" if ("true>" in name or "Lb1E" in name)
                else "splash_prefill")
    if "gemm" in name or "gemv" in name or "cutlass" in name.lower():
        return "matmul"
    return "other"


def profile_layout(model, requests, paged: bool) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from distkeras_torch import telemetry
    from distkeras_torch.serving import ServingEngine

    def engine():
        return ServingEngine(model, slots=8, prefill_chunk=64, paged=paged,
                             block_size=16,
                             registry=telemetry.MetricRegistry(),
                             tracer=telemetry.Tracer())

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
    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0 and getattr(evt, "device_type", None) is not None \
                and "CUDA" in str(evt.device_type):
            kernels.append((evt.key, dev_us / 1e3, evt.count))
    busy = sum(ms for _, ms, _ in kernels)
    groups: dict = {}
    for name, ms, _ in kernels:
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    kernels.sort(key=lambda k: -k[1])
    st = eng.stats()
    return {
        "layout": "paged" if paged else "slot",
        "wall_ms": wall_ms, "ticks": st["ticks"],
        "tokens": st["tokens_generated"],
        # None: the profiler recorded no device time (not measured)
        "device_busy_ms": busy or None,
        "idle_share": max(0.0, 1.0 - busy / wall_ms) if busy else None,
        "device_ms_by_group": groups,
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
        print(json.dumps(profile_layout(model, requests, paged)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
