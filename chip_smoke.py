#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``distkeras_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it exits non-zero without printing a result when
CUDA is unavailable or when the port's package is not beside it.

Phases (any failure exits non-zero):

1. **Environment + build.** The card's name and power limit as
   ``nvidia-smi`` reports them, the torch / CUDA / nvcc versions, and the
   time to build both hand-written kernels from ``distkeras_torch/csrc``.
2. **Kernels.** Each kernel against its plain PyTorch version on the
   card at the serving path's shapes — paged attention (8 rows, T in
   {1, 64}, H=8, Hk=2, hd=256, 16-token pages, 128 pages per row, bf16
   and int8 pools, fragmented tables, a zero-length row) and splash
   chunked prefill (8 rows, T=64, L=2048, starts from 0 to the deepest)
   — max abs error <= 1e-2 in bf16 and <= 1e-5 in f32 (the plain version
   computed in f32 from the same inputs). Kernel, plain and library
   (``F.scaled_dot_product_attention`` on the gathered, dequantized view
   with an explicit mask — timed here only, never called by the port)
   times come from CUDA events with the 50 MB L2 flushed before each
   launch; the bound is the larger of the bytes these inputs need over
   3.35 TB/s and their FLOPs over the dtype's peak.
3. **Serving at full width.** The flagship TransformerLM (d_model 2048,
   8 heads of 256, 8 layers, vocab 8192, bf16, rope, 2 KV heads, int8
   KV cache, max_len 2048) with seeded random weights serves 16
   requests (96-1024-token prompts sharing a 256-token system prefix,
   32-64 new tokens, mixed sampling) through a paged engine and a slot
   engine (8 slots, 64-token chunks). Every request must finish; the
   launch counts (zeroed just before each engine's run) must show the
   paged kernel in every layer of every paged tick and the splash kernel
   in every layer of every slot tick that carried a prompt chunk. The
   share of greedy tokens equal to a gather-forced twin engine is
   printed (informational at bf16).
4. **Exact.** A small f32 model (d256, 4 layers, GQA, int8 cache) with
   the kernels on: greedy engine streams on both layouts must equal the
   port's own ``generate()``.

Output: JSON lines per phase, the ``nvidia-smi`` line, one
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import os
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, no sparsity
FLUSH_BYTES = 64 << 20  # > the 50 MB L2

DEV = "cuda"
# the serving path's attention shapes (phase 2)
PAGED = dict(S=8, H=8, Hk=2, hd=256, bs=16, MB=128, T=(1, 64))
SPLASH = dict(S=8, T=64, H=8, Hk=2, hd=256, L=2048)
# the flagship at full width (bench.py:130, benchmarks/decode_bench.py:31)
# with the serving-realistic options (distkeras_torch.bench.FLAGSHIP), its
# request mix (distkeras_torch.bench.serving_requests), and the small
# exact-phase model
FLAGSHIP = dict(vocab_size=8192, d_model=2048, num_heads=8, num_layers=8,
                max_len=2048, pos_emb="rope", num_kv_heads=2,
                cache_dtype="int8")
SYSTEM_PREFIX = 256
PROMPT_LENS = (96, 1024, 300, 640, 128, 800, 512, 200, 1000, 296, 700, 150,
               420, 960, 560, 333)
EXACT = dict(vocab_size=512, d_model=256, num_heads=4, num_layers=4,
             max_len=256, pos_emb="rope", num_kv_heads=2, cache_dtype="int8")


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _nvcc_version(build):
    out = subprocess.run([build.nvcc_path(), "--version"],
                         capture_output=True, text=True, timeout=60)
    lines = [ln for ln in out.stdout.splitlines() if "release" in ln]
    return lines[-1].strip() if lines else out.stdout.strip()


# -- timing ---------------------------------------------------------------


def sync(torch):
    if DEV == "cuda":
        torch.cuda.synchronize()


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms: CUDA events around each call,
    the L2 cache flushed before each one (the serving tick finds the
    pool cold: a layer's weights pass through L2 between two calls)."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    sync(torch)
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        if DEV != "cuda":  # a host rehearsal: wall time, not a device time
            t0 = time.perf_counter()
            fn()
            total += (time.perf_counter() - t0) * 1e3
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def sdpa_ms(torch, F, q, keys, vals, qpos):
    """The yardstick: one ``scaled_dot_product_attention`` call on the
    contiguous (gathered, dequantized) view with an explicit causal
    mask, GQA expanded to full heads."""
    B, T, H, hd = q.shape
    L, Hk = keys.shape[1], keys.shape[2]
    qh = q.transpose(1, 2).contiguous()
    kh = keys.repeat_interleave(H // Hk, dim=2).transpose(1, 2).contiguous()
    vh = vals.repeat_interleave(H // Hk, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(L, device=q.device)[None, None, None, :]
            <= qpos[:, None, :, None])
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))


# -- phase 2: kernels against their plain versions -----------------------


def _work(torch, starts, T, H, hd):
    """Causal FLOPs of these inputs: every query row attends its visible
    keys (QK and PV, 2 FLOPs per multiply-add each)."""
    n = sum(int(s) * T + T * (T + 1) // 2 for s in starts.tolist())
    return 4.0 * n * H * hd


def _depths(S, hi):
    """S row depths: a zero-length row, the deepest row ``hi``, and
    depths spread between."""
    return [0] + [int(hi * (i + 0.37) / (S - 1)) for i in range(S - 2)] + [hi]


def paged_cases(torch, F, pa):
    S, H, Hk, hd, bs, MB = (PAGED[k] for k in ("S", "H", "Hk", "hd", "bs",
                                                "MB"))
    P = S * MB + 1
    gen = torch.Generator(device=DEV).manual_seed(1)
    cases = []
    for T in PAGED["T"]:
        L = MB * bs
        lens = torch.tensor(_depths(S, L - T), dtype=torch.int32,
                            device=DEV)
        perm = torch.randperm(P - 1, generator=gen, device=DEV) + 1
        tables = torch.zeros((S, MB), dtype=torch.int32, device=DEV)
        need = [(int(n) + T - 1) // bs + 1 for n in lens.tolist()]
        off = 0
        for b, n in enumerate(need):
            tables[b, :n] = perm[off:off + n].to(torch.int32)
            off += n
        for kind in ("bf16", "int8", "f32", "int8-f32"):
            dt = torch.float32 if "f32" in kind else torch.bfloat16
            q = torch.randn((S, T, H, hd), generator=gen, device=DEV).to(dt)
            if kind.startswith("int8"):
                kf = torch.randn((P, bs, Hk, hd), generator=gen, device=DEV)
                vf = torch.randn((P, bs, Hk, hd), generator=gen, device=DEV)
                ks = kf.abs().amax(-1) / 127.0
                vs = vf.abs().amax(-1) / 127.0
                kp = torch.round(kf / ks[..., None]).to(torch.int8)
                vp = torch.round(vf / vs[..., None]).to(torch.int8)
                plain_in = (kp, vp, ks, vs)
            else:
                kp = torch.randn((P, bs, Hk, hd), generator=gen,
                                 device=DEV).to(dt)
                vp = torch.randn((P, bs, Hk, hd), generator=gen,
                                 device=DEV).to(dt)
                ks = vs = None
                plain_in = (kp.float(), vp.float(), None, None)
            out = pa.paged_attention(q, kp, vp, tables, lens, ks, vs)
            sync(torch)
            ref = pa.paged_attention_reference(
                q.float(), plain_in[0], plain_in[1], tables, lens,
                plain_in[2], plain_in[3])
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"paged T={T} {kind}: non-finite output")
            err = (out.float() - ref).abs().max().item()
            tol = 1e-5 if dt == torch.float32 else 1e-2
            if err > tol:
                raise AssertionError(
                    f"paged T={T} {kind}: max abs err {err} > {tol}")
            case = {"T": T, "pool": kind, "max_abs_err": err, "tol": tol}
            if kind in ("bf16", "int8"):
                case["ms"] = time_ms(torch, lambda: pa.paged_attention(
                    q, kp, vp, tables, lens, ks, vs))
                case["plain_ms"] = time_ms(
                    torch, lambda: pa.paged_attention_reference(
                        q, kp, vp, tables, lens, ks, vs))
                view = pa.gather_pages
                if ks is not None:
                    keys = (view(kp, tables).float()
                            * view(ks, tables)[..., None]).to(dt)
                    vals = (view(vp, tables).float()
                            * view(vs, tables)[..., None]).to(dt)
                else:
                    keys, vals = view(kp, tables), view(vp, tables)
                qpos = lens.long()[:, None] + torch.arange(T, device=DEV)
                case["library_ms"] = sdpa_ms(torch, F, q, keys, vals, qpos)
                item = kp.element_size()
                pages = sum(need)
                nbytes = (2 * q.numel() * q.element_size()
                          + 2 * pages * bs * Hk * hd * item
                          + (2 * pages * bs * Hk * 4 if ks is not None else 0)
                          + tables.numel() * 4 + lens.numel() * 4)
                case["bound_ms"], case["bound_by"] = bound(
                    nbytes, _work(torch, lens, T, H, hd), "bfloat16")
            cases.append(case)
    return cases


def splash_cases(torch, F, sp):
    S, T, H, Hk, hd, L = (SPLASH[k] for k in ("S", "T", "H", "Hk", "hd",
                                               "L"))
    gen = torch.Generator(device=DEV).manual_seed(2)
    starts = torch.tensor(_depths(S, L - T), dtype=torch.int32, device=DEV)
    cases = []
    for kind in ("bf16", "f32"):
        dt = torch.float32 if kind == "f32" else torch.bfloat16
        q = torch.randn((S, T, H, hd), generator=gen, device=DEV).to(dt)
        k = torch.randn((S, L, Hk, hd), generator=gen, device=DEV).to(dt)
        v = torch.randn((S, L, Hk, hd), generator=gen, device=DEV).to(dt)
        out = sp.splash_prefill_attention(q, k, v, starts)
        sync(torch)
        ref = sp.splash_prefill_reference(q.float(), k.float(), v.float(),
                                          starts)
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"splash {kind}: non-finite output")
        err = (out.float() - ref).abs().max().item()
        tol = 1e-5 if dt == torch.float32 else 1e-2
        if err > tol:
            raise AssertionError(f"splash {kind}: max abs err {err} > {tol}")
        case = {"T": T, "L": L, "dtype": kind, "max_abs_err": err,
                "tol": tol}
        if kind == "bf16":
            case["ms"] = time_ms(torch, lambda: sp.splash_prefill_attention(
                q, k, v, starts))
            case["plain_ms"] = time_ms(
                torch, lambda: sp.splash_prefill_reference(q, k, v, starts))
            qpos = starts.long()[:, None] + torch.arange(T, device=DEV)
            case["library_ms"] = sdpa_ms(torch, F, q, k, v, qpos)
            tiles = sum((int(s) + T - 1) // sp.KV_TILE + 1
                        for s in starts.tolist())
            nbytes = (2 * q.numel() * q.element_size()
                      + 2 * tiles * sp.KV_TILE * Hk * hd * k.element_size()
                      + starts.numel() * 4)
            case["bound_ms"], case["bound_by"] = bound(
                nbytes, _work(torch, starts, T, H, hd), "bfloat16")
        cases.append(case)
    return cases


# -- phase 3: serving at full width ----------------------------------------


def serve(torch, np, dk, model, requests, **kw):
    """Drive one engine over ``requests``; returns its summary, the
    streams and the number of ticks that carried a prompt chunk."""
    eng = dk["ServingEngine"](
        model, slots=8, prefill_chunk=64, device=DEV,
        registry=dk["telemetry"].MetricRegistry(),
        tracer=dk["telemetry"].Tracer(), **kw)
    sync(torch)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, **c) for p, c in requests]
    eng.drain(timeout=900)
    sync(torch)
    wall = time.perf_counter() - t0
    streams = [r.stream.tokens(timeout=10) for r in reqs]
    V = model.vocab_size
    for (p, c), r, s in zip(requests, reqs, streams):
        if r.stream.finish_reason != "length" or len(s) != c[
                "max_new_tokens"] or not all(0 <= t < V for t in s):
            raise AssertionError(
                f"request {r.rid} did not finish cleanly: "
                f"{r.stream.finish_reason}, {len(s)} tokens")
    st = eng.stats()
    chunk_ticks = sum(1 for rec in eng.metrics.records
                      if rec.get("prefill_tokens", 0) > 0)
    summary = {
        "requests": len(reqs), "ticks": st["ticks"],
        "chunk_ticks": chunk_ticks,
        "tokens": st["tokens_generated"], "wall_s": wall,
        "tok_per_s": st["tokens_generated"] / wall,
        "ms_per_tick": wall * 1e3 / max(st["ticks"], 1),
        "ttft_ms_p50": st["ttft_ms"].get("p50"),
        "ttft_ms_p99": st["ttft_ms"].get("p99"),
        "prefix_hit_tokens": st.get("prefix_hit_tokens"),
        "peak_device_mb": (torch.cuda.max_memory_allocated() / 2**20
                           if DEV == "cuda" else None),
    }
    return summary, streams


def greedy_match(requests, a, b):
    same = total = 0
    for (_, c), x, y in zip(requests, a, b):
        if c.get("temperature", 0.0) == 0.0:
            total += len(x)
            same += sum(int(u == v) for u, v in zip(x, y))
    return same / max(total, 1)


def serving_phase(torch, np, dk, pa, sp):
    model = dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                            device=DEV, seed=0, **FLAGSHIP)
    L = model.num_layers
    requests = dk["serving_requests"](model.vocab_size, SYSTEM_PREFIX,
                                      PROMPT_LENS)
    # warm the allocator, cuBLAS and both kernels outside the counted runs
    for paged in (True, False):
        serve(torch, np, dk, model, requests[:2], paged=paged, block_size=16)
    out = {}
    pa.paged_attention.launches = 0
    sp.splash_prefill_attention.launches = 0
    paged_sum, paged_streams = serve(torch, np, dk, model, requests,
                                     paged=True, block_size=16)
    paged_sum["launches"] = {"paged_attention": pa.paged_attention.launches,
                             "splash_prefill": sp.splash_prefill_attention
                             .launches}
    if pa.paged_attention.launches < paged_sum["ticks"] * L or (
            pa.paged_attention.launches == 0):
        raise AssertionError(f"paged engine: {pa.paged_attention.launches} "
                             f"paged-attention launches < ticks x layers")
    pa.paged_attention.launches = 0
    sp.splash_prefill_attention.launches = 0
    slot_sum, slot_streams = serve(torch, np, dk, model, requests,
                                   paged=False)
    slot_sum["launches"] = {"paged_attention": pa.paged_attention.launches,
                            "splash_prefill": sp.splash_prefill_attention
                            .launches}
    if sp.splash_prefill_attention.launches < slot_sum["chunk_ticks"] * L or (
            sp.splash_prefill_attention.launches == 0):
        raise AssertionError(
            f"slot engine: {sp.splash_prefill_attention.launches} splash "
            f"launches < chunk ticks x layers")
    launches = {"paged_attention": paged_sum["launches"]["paged_attention"],
                "splash_prefill": slot_sum["launches"]["splash_prefill"]}
    _, paged_ref = serve(torch, np, dk, model, requests, paged=True,
                         block_size=16, paged_kernel="gather",
                         prefill_kernel="gather")
    _, slot_ref = serve(torch, np, dk, model, requests, paged=False,
                        prefill_kernel="gather")
    paged_sum["greedy_match_vs_gather"] = greedy_match(
        requests, paged_streams, paged_ref)
    slot_sum["greedy_match_vs_gather"] = greedy_match(
        requests, slot_streams, slot_ref)
    out["paged"], out["slot"] = paged_sum, slot_sum
    return out, launches


# -- phase 4: exact streams on a small f32 model ----------------------------


def exact_phase(torch, np, dk, pa, sp):
    model = dk["get_model"]("transformer_lm", dtype=torch.float32,
                            device=DEV, seed=3, **EXACT)
    V = model.vocab_size
    rng = np.random.default_rng(5)
    system = rng.integers(0, V, size=48)
    requests = []
    for i, n in enumerate((20, 70, 35, 90, 50, 64)):
        prompt = np.concatenate([system, rng.integers(0, V, size=n)])
        cfg = (dict(temperature=0.9, top_k=40, seed=i) if i % 3 == 2
               else dict(seed=i))
        requests.append((prompt.astype(np.int32),
                         dict(cfg, max_new_tokens=24 + 4 * i)))
    res = {}
    for paged in (True, False):
        before = (pa.paged_attention.launches,
                  sp.splash_prefill_attention.launches)
        _, streams = serve(torch, np, dk, model, requests, paged=paged,
                           block_size=16)
        used = (pa.paged_attention.launches - before[0] if paged
                else sp.splash_prefill_attention.launches - before[1])
        if used == 0:
            raise AssertionError("exact phase ran without its kernel")
        greedy_ok, sampled_same = True, 0
        n_sampled = 0
        for (p, c), s in zip(requests, streams):
            ref = dk["generate"](model, p[None], c["max_new_tokens"],
                                 temperature=c.get("temperature", 0.0),
                                 seed=c["seed"], top_k=c.get("top_k"))
            ref = ref[0, len(p):].tolist()
            if c.get("temperature", 0.0) == 0.0:
                greedy_ok &= s == ref
            else:
                n_sampled += 1
                sampled_same += int(s == ref)
        if not greedy_ok:
            raise AssertionError(f"exact phase (paged={paged}): greedy "
                                 f"streams differ from generate()")
        res["paged" if paged else "slot"] = {
            "greedy_equal": True, "kernel_launches": used,
            "sampled_streams_equal": f"{sampled_same}/{n_sampled}"}
    return res


def main() -> int:
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        return _fail(f"needs torch and numpy ({e})")
    if not torch.cuda.is_available():
        return _fail("CUDA is not available: this smoke runs on a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from distkeras_torch import telemetry
        from distkeras_torch.bench import nvidia_smi, serving_requests
        from distkeras_torch.kernels import build
        from distkeras_torch.models import get_model
        from distkeras_torch.models.transformer import generate
        from distkeras_torch.ops import paged_attention as pa
        from distkeras_torch.ops import splash_prefill as sp
        from distkeras_torch.serving import ServingEngine
    except ImportError as e:
        return _fail(f"run from a checkout of the repository ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dk = {"telemetry": telemetry, "get_model": get_model,
          "generate": generate, "ServingEngine": ServingEngine,
          "serving_requests": serving_requests}

    smi = nvidia_smi()
    kern = build.load()
    _emit({"env": {
        "nvidia_smi": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvcc": _nvcc_version(build),
        "python": sys.version.split()[0],
        "kernel_build_s": kern.seconds,
        "device": torch.cuda.get_device_name(0),
    }})
    t0 = time.perf_counter()
    paged = paged_cases(torch, F, pa)
    splash = splash_cases(torch, F, sp)
    _emit({"kernel_phase": {"paged_attention": paged,
                            "splash_prefill": splash,
                            "seconds": time.perf_counter() - t0}})

    t0 = time.perf_counter()
    serving, launches = serving_phase(torch, np, dk, pa, sp)
    serving["seconds"] = time.perf_counter() - t0
    _emit({"serving_phase": serving})

    t0 = time.perf_counter()
    exact = exact_phase(torch, np, dk, pa, sp)
    exact["seconds"] = time.perf_counter() - t0
    _emit({"exact_phase": exact})

    main_paged = next(c for c in paged if c["T"] == 64 and c["pool"] == "int8")
    main_splash = next(c for c in splash if c["dtype"] == "bf16")
    rows = []
    for name, src, rep, case, cases in (
            ("paged_attention", "distkeras_torch/csrc/paged_attention.cu",
             "distkeras_tpu/ops/paged_attention.py:166", main_paged, paged),
            ("splash_prefill", "distkeras_torch/csrc/splash_prefill.cu",
             "distkeras_tpu/ops/splash_prefill.py:163", main_splash,
             splash)):
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"],
        })
    print(smi, flush=True)
    _emit({"kernels": rows})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
