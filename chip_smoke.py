#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``distkeras_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it exits non-zero without printing a result when
CUDA is unavailable or when the port's package is not beside it.

Phases (any failure exits non-zero):

1. **Environment + build.** The card's name and power limit as
   ``nvidia-smi`` reports them, the torch / CUDA / nvcc versions, and the
   time to build the hand-written kernels (four sources, one ``nvcc``
   each, in parallel) from ``distkeras_torch/csrc``.
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
5. **Training kernels.** The causal flash-attention forward, dq and
   dk/dv kernels against their plain versions (dense, f32, from the same
   bf16 inputs; the backward's plain version takes the kernel's own
   ``out``/``lse``) at the flagship attention shape [8, 2048, 8, 256]
   and at a ragged T=1000: O within 1e-2 abs (v drawn at std 0.5, so
   |O| < 2 and bf16's output rounding stays under 4e-3), lse within
   1e-3 abs, each gradient within 2e-2 of the plain version's max abs
   value. Times of each kernel, its plain version and the library
   yardstick (``F.scaled_dot_product_attention(is_causal=True)``: its
   forward beside the forward kernel, its forward + backward beside
   fwd + dq + dk/dv), with the bound from this run's exact causal count.
5b. **Pair kernels.** The zigzag ring's pair forward, dq and dk/dv
   kernels, both variants (causal wedge and rectangle), against their
   plain versions at the flagship's ring chunk [8, 1024, 8, 256] and at
   C=320, q pre-scaled, a nonzero lse cotangent drawn from the seed: the
   tolerances of phase 5. Times of each kernel, its plain version and
   the library yardstick (``F.scaled_dot_product_attention`` at
   ``scale=1.0``, ``is_causal`` for the wedge; it returns no lse), with
   the bound from the exact count of each variant.
6. **Training at full width.** The flagship training step of the
   reference's ``lm_bench`` (d_model 2048, 8 heads of 256, 8 layers,
   vocab 8192, bf16, sinusoidal, MHA; T=2048, B=8; AdamW lr 3e-4 with a
   bf16 first moment; fused chunked CE) from seeded weights: one
   warm-up and one timed window of W=5 steps on one fixed token batch.
   Every loss finite, the second window's mean below the first's, each
   kernel launched 8 layers x 10 steps times (counts zeroed just before),
   and an ``attention='blocked'`` twin from the same weights on the same
   batches within 5e-2 of every loss. Prints ms/step, tok/s, peak
   memory and MFU (analytic count, ``distkeras_torch.bench``).
6b. **Ring training at full width, sp=1.** Phase 6's config, weights and
   batches with ``attention='ring'`` through ``make_lm_train_step(mesh=
   make_mesh({"dp": 1, "sp": 1}))``: the zigzag ring's step 0 runs the
   two causal wedges and the rectangle of each layer through the pair
   kernels. Every loss finite and within 5e-2 of phase 6's for the same
   step, each pair kernel launched exactly as the code predicts per step
   x layers (the checkpointed step 0 runs its forward twice), B1's
   kernels not at all.
7. **LMTrainer.** One epoch of ``LMTrainer`` over 40 in-memory rows at
   the same width and depth (batch 8): a finite history of 5 steps; then
   the same with ``attention='ring'`` and ``axes={"dp": 1, "sp": 1}``
   (7b).

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
# the training kernels' main-path shape and a ragged one (phase 5)
CAUSAL = dict(B=8, H=8, hd=256, T=(2048, 1000))
CAUSAL_TOL = dict(out=1e-2, lse=1e-3, grad=2e-2)
# the ring's pair kernels at the flagship's chunk (T=2048 at sp=1: C=1024,
# the same pair shape as T=8192 at sp=4) and a smaller one (phase 5b)
PAIR = dict(B=8, H=8, hd=256, C=(1024, 320))
# pair launches per layer of one ring step at sp=1: step 0 runs two
# wedges and a rectangle, checkpointed (its forward runs again in the
# backward)
PAIR_PER_LAYER = {"pair_wedge_fwd": 4, "pair_rect_fwd": 2,
                  "pair_wedge_dq": 2, "pair_rect_dq": 1,
                  "pair_wedge_dkv": 2, "pair_rect_dkv": 1}
# the reference's lm_bench step (bench.py:130-194), phases 6 and 7
TRAIN = dict(vocab_size=8192, d_model=2048, num_heads=8, num_layers=8,
             max_len=2048)
TRAIN_B, TRAIN_W, TRAIN_LR = 8, 5, 3e-4
TRAIN_LOSS_TOL = 5e-2  # kernel path vs the blocked twin, per step
TRAINER_ROWS = 40


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


# -- phase 5: the training kernels against their plain versions ---------


def causal_cases(torch, F, fa):
    B, H, hd = CAUSAL["B"], CAUSAL["H"], CAUSAL["hd"]
    gen = torch.Generator(device=DEV).manual_seed(7)
    cases = []
    for T in CAUSAL["T"]:
        shape = (B, T, H, hd)
        q, k, do = (torch.randn(shape, generator=gen, device=DEV)
                    .to(torch.bfloat16) for _ in range(3))
        v = (0.5 * torch.randn(shape, generator=gen, device=DEV)).to(
            torch.bfloat16)
        out, lse = fa.causal_attention_fwd(q, k, v)
        dq = fa.causal_attention_dq(q, k, v, out, lse, do)
        dk, dv = fa.causal_attention_dkv(q, k, v, out, lse, do)
        sync(torch)
        ref_out, ref_lse = fa.causal_attention_reference(q, k, v)
        grads = fa.causal_attention_bwd_reference(q, k, v, out, lse, do)
        for name, t in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv)):
            if not torch.isfinite(t.float()).all():
                raise AssertionError(f"causal T={T}: non-finite {name}")
        case = {"T": T, "out_abs_err": (out.float() - ref_out).abs().max()
                .item(),
                "lse_abs_err": (lse - ref_lse).abs().max().item()}
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
            case[f"{name}_rel_err"] = ((got.float() - ref).abs().max()
                                       / ref.abs().max()).item()
            case[f"{name}_abs_err"] = (got.float() - ref).abs().max().item()
        bad = [n for n, tol in (("out_abs_err", CAUSAL_TOL["out"]),
                                ("lse_abs_err", CAUSAL_TOL["lse"]),
                                ("dq_rel_err", CAUSAL_TOL["grad"]),
                                ("dk_rel_err", CAUSAL_TOL["grad"]),
                                ("dv_rel_err", CAUSAL_TOL["grad"]))
               if not case[n] <= tol]
        if bad:
            raise AssertionError(f"causal T={T}: {bad} over tolerance "
                                 f"{CAUSAL_TOL}: {case}")
        del ref_out, ref_lse, grads
        if T == CAUSAL["T"][0]:
            case.update(causal_times(torch, F, fa, q, k, v, out, lse, do))
        cases.append(case)
    return cases


def causal_times(torch, F, fa, q, k, v, out, lse, do):
    """Kernel, plain and library times with their bounds at one shape.
    The bound counts the exact causal work of these inputs (query row t
    attends t + 1 keys) and each tensor read or written once."""
    B, T, H, hd = q.shape
    pairs = B * H * T * (T + 1) // 2
    el = q.numel()
    row = 2 * el  # one bf16 [B, T, H, hd] tensor, in bytes
    lse_b = B * H * T * 4
    t = {}
    t["fwd_ms"] = time_ms(torch, lambda: fa.causal_attention_fwd(q, k, v))
    t["dq_ms"] = time_ms(torch, lambda: fa.causal_attention_dq(
        q, k, v, out, lse, do))
    t["dkv_ms"] = time_ms(torch, lambda: fa.causal_attention_dkv(
        q, k, v, out, lse, do))
    t["fwd_plain_ms"] = time_ms(
        torch, lambda: fa.causal_attention_reference(q, k, v), iters=5)
    t["dq_plain_ms"] = time_ms(torch, lambda: fa.causal_attention_dq_reference(
        q, k, v, out, lse, do), iters=5)
    t["dkv_plain_ms"] = time_ms(
        torch, lambda: fa.causal_attention_dkv_reference(
            q, k, v, out, lse, do), iters=5)
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    t["fwd_library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        torch.autograd.grad(o, (qh, kh, vh), doh)

    t["fwd_bwd_library_ms"] = time_ms(torch, sdpa_fwd_bwd)
    t["fwd_bwd_ms"] = t["fwd_ms"] + t["dq_ms"] + t["dkv_ms"]
    for name, mms, nbytes in (
            ("fwd", 2, 4 * row + lse_b),
            ("dq", 3, 6 * row + lse_b),
            ("dkv", 4, 7 * row + lse_b)):
        t[f"{name}_bound_ms"], t[f"{name}_bound_by"] = bound(
            nbytes, mms * 2.0 * pairs * hd, "bfloat16")
    return t


# -- phase 5b: the ring's pair kernels against their plain versions ------


def pair_cases(torch, F, pp):
    B, H, hd = PAIR["B"], PAIR["H"], PAIR["hd"]
    gen = torch.Generator(device=DEV).manual_seed(8)
    bf16 = torch.bfloat16
    cases = []
    for C in PAIR["C"]:
        shape = (B, C, H, hd)
        # q arrives pre-scaled, as the ring hands it over
        q = (torch.randn(shape, generator=gen, device=DEV) * hd ** -0.5).to(
            bf16)
        k, do = (torch.randn(shape, generator=gen, device=DEV).to(bf16)
                 for _ in range(2))
        v = (0.5 * torch.randn(shape, generator=gen, device=DEV)).to(bf16)
        dlse = torch.randn((B, C, H), generator=gen, device=DEV)
        for causal in (True, False):
            variant = "wedge" if causal else "rect"
            o, lse = pp.pair_attention_fwd(q, k, v, causal)
            dq = pp.pair_attention_dq(q, k, v, o, lse, do, dlse, causal)
            dk, dv = pp.pair_attention_dkv(q, k, v, o, lse, do, dlse, causal)
            sync(torch)
            ref_o, ref_lse = pp.pair_attention_reference(q, k, v, causal)
            grads = pp.pair_attention_bwd_reference(q, k, v, o, lse, do,
                                                    dlse, causal)
            for name, t in (("out", o), ("dq", dq), ("dk", dk), ("dv", dv)):
                if not torch.isfinite(t.float()).all():
                    raise AssertionError(f"pair {variant} C={C}: non-finite "
                                         f"{name}")
            case = {"C": C, "variant": variant,
                    "out_abs_err": (o.float() - ref_o).abs().max().item(),
                    "lse_abs_err": (lse - ref_lse).abs().max().item()}
            for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                      grads):
                case[f"{name}_rel_err"] = ((got.float() - ref).abs().max()
                                           / ref.abs().max()).item()
                case[f"{name}_abs_err"] = (got.float() - ref).abs().max(
                    ).item()
            bad = [n for n, tol in (("out_abs_err", CAUSAL_TOL["out"]),
                                    ("lse_abs_err", CAUSAL_TOL["lse"]),
                                    ("dq_rel_err", CAUSAL_TOL["grad"]),
                                    ("dk_rel_err", CAUSAL_TOL["grad"]),
                                    ("dv_rel_err", CAUSAL_TOL["grad"]))
                   if not case[n] <= tol]
            if bad:
                raise AssertionError(f"pair {variant} C={C}: {bad} over "
                                     f"tolerance {CAUSAL_TOL}: {case}")
            del ref_o, ref_lse, grads
            if C == PAIR["C"][0]:
                case.update(pair_times(torch, F, pp, q, k, v, o, lse, do,
                                       dlse, causal))
            cases.append(case)
    return cases


def pair_times(torch, F, pp, q, k, v, o, lse, do, dlse, causal):
    """Kernel, plain and library times of one variant with their bounds:
    the exact work of the variant (the wedge's query row t attends t + 1
    keys, the rectangle's all C), each tensor read or written once."""
    B, C, H, hd = q.shape
    pairs = B * H * (C * (C + 1) // 2 if causal else C * C)
    row = 2 * q.numel()  # one bf16 [B, C, H, hd] tensor, in bytes
    lse_b = B * C * H * 4
    t = {}
    t["fwd_ms"] = time_ms(torch, lambda: pp.pair_attention_fwd(
        q, k, v, causal))
    t["dq_ms"] = time_ms(torch, lambda: pp.pair_attention_dq(
        q, k, v, o, lse, do, dlse, causal))
    t["dkv_ms"] = time_ms(torch, lambda: pp.pair_attention_dkv(
        q, k, v, o, lse, do, dlse, causal))
    t["fwd_plain_ms"] = time_ms(torch, lambda: pp.pair_attention_reference(
        q, k, v, causal), iters=5)
    t["dq_plain_ms"] = time_ms(torch, lambda: pp.pair_attention_dq_reference(
        q, k, v, o, lse, do, dlse, causal), iters=5)
    t["dkv_plain_ms"] = time_ms(
        torch, lambda: pp.pair_attention_dkv_reference(
            q, k, v, o, lse, do, dlse, causal), iters=5)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    t["fwd_library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal, scale=1.0))
    for name, mms, nbytes in (
            ("fwd", 2, 4 * row + lse_b),
            ("dq", 3, 6 * row + 2 * lse_b),
            ("dkv", 4, 7 * row + 2 * lse_b)):
        t[f"{name}_bound_ms"], t[f"{name}_bound_by"] = bound(
            nbytes, mms * 2.0 * pairs * hd, "bfloat16")
    return t


# -- phase 6: the flagship training step at full width --------------------


CAUSAL_NAMES = ("causal_attention_fwd", "causal_attention_dq",
                "causal_attention_dkv")


def zero_training_counts(fa, pp):
    for name in CAUSAL_NAMES:
        getattr(fa, name).launches = 0
    for kern in ("fwd", "dq", "dkv"):
        getattr(pp, f"pair_attention_{kern}").launches = {"wedge": 0,
                                                          "rect": 0}


def training_counts(fa, pp):
    """The launch counts of the training kernels: B1's three and the
    pair kernels' six (``pair_<variant>_<kernel>``)."""
    out = {name: getattr(fa, name).launches for name in CAUSAL_NAMES}
    for kern in ("fwd", "dq", "dkv"):
        for variant, n in getattr(pp, f"pair_attention_{kern}"
                                  ).launches.items():
            out[f"pair_{variant}_{kern}"] = n
    return out


def train_windows(torch, np, dk, fa, pp, attention, tokens, mesh=None):
    """Two W-step windows of the port's LM step from the seeded weights:
    (losses, warm-up s, timed s, kernel launches, peak MB)."""
    model = dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                            device=DEV, seed=0, attention=attention,
                            **TRAIN)
    step = dk["make_lm_train_step"](
        model, dk["get_optimizer"]("adamw", TRAIN_LR,
                                   mu_dtype=torch.bfloat16), mesh=mesh,
        window=True)
    sync(torch)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_training_counts(fa, pp)
    t0 = time.perf_counter()
    first = step(tokens)
    sync(torch)
    t1 = time.perf_counter()
    second = step(tokens)
    sync(torch)
    t2 = time.perf_counter()
    launches = training_counts(fa, pp)
    peak = (torch.cuda.max_memory_allocated() / 2**20 if DEV == "cuda"
            else None)
    losses = torch.cat([first, second]).float().cpu().numpy()
    del step, model
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return losses, t1 - t0, t2 - t1, launches, peak


def train_tokens(torch, np):
    """Phase 6's W fixed batches (phase 6b trains on the same)."""
    return torch.as_tensor(np.random.default_rng(11).integers(
        0, TRAIN["vocab_size"], size=(TRAIN_W, TRAIN_B, TRAIN["max_len"])),
        device=DEV)


def training_phase(torch, np, dk, fa, pp):
    V, D, H, L = (TRAIN[k] for k in ("vocab_size", "d_model", "num_heads",
                                     "num_layers"))
    B, T, W = TRAIN_B, TRAIN["max_len"], TRAIN_W
    tokens = train_tokens(torch, np)
    hd = D // H
    if not fa.preferred(T, hd, torch.bfloat16, DEV):
        raise AssertionError("the flagship shape does not select the "
                             "causal kernels")
    losses, warm_s, timed_s, launches, peak = train_windows(
        torch, np, dk, fa, pp, "standard", tokens)
    if not np.isfinite(losses).all():
        raise AssertionError(f"training losses not finite: {losses}")
    if not losses[W:].mean() < losses[:W].mean():
        raise AssertionError(f"second window's mean loss did not fall: "
                             f"{losses}")
    want = L * 2 * W
    expect = {n: (want if n in CAUSAL_NAMES else 0) for n in launches}
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != {expect} "
                             f"(layers x steps)")
    twin, twin_warm_s, twin_timed_s, twin_launches, twin_peak = (
        train_windows(torch, np, dk, fa, pp, "blocked", tokens))
    if any(twin_launches.values()):
        raise AssertionError("the blocked twin launched a training kernel")
    gap = float(np.abs(losses - twin).max())
    if not gap <= TRAIN_LOSS_TOL:
        raise AssertionError(f"kernel vs blocked losses differ by {gap} > "
                             f"{TRAIN_LOSS_TOL}: {losses} vs {twin}")
    flops = dk["lm_step_flops"](D, H, L, V, B, T, fa.BLOCK)
    peak_flops = dk["peak_flops"](torch.cuda.get_device_name(0)
                                  if DEV == "cuda" else "")
    ms = timed_s * 1e3 / W
    return {
        "config": f"d{D}/h{H}/L{L}/v{V}/T{T}/b{B}-bf16-pallas-causal"
                  f"{fa.BLOCK}-adamw-mubf16-fusedce",
        "losses": losses.tolist(), "blocked_losses": twin.tolist(),
        "max_loss_gap_vs_blocked": gap, "tol": TRAIN_LOSS_TOL,
        "warmup_window_s": warm_s, "ms_per_step": ms,
        "tok_per_s": W * B * T / timed_s,
        "blocked_ms_per_step": twin_timed_s * 1e3 / W,
        "peak_device_mb": peak, "blocked_peak_device_mb": twin_peak,
        "flops_per_step": flops,
        "mfu": (flops / (ms / 1e3) / peak_flops) if peak_flops else None,
        "mfu_method": "analytic: 6*matmul_params*tokens + causal-kernel "
                      "tiles (distkeras_torch.bench.lm_step_flops) over "
                      "the bf16 peak of the device",
        "launches": {n: launches[n] for n in CAUSAL_NAMES},
    }


def ring_training_phase(torch, np, dk, fa, pp, base):
    """Phase 6b: phase 6's step with ``attention='ring'`` on a mesh of one
    position; ``base`` is phase 6's result."""
    V, D, H, L = (TRAIN[k] for k in ("vocab_size", "d_model", "num_heads",
                                     "num_layers"))
    B, T, W = TRAIN_B, TRAIN["max_len"], TRAIN_W
    C = T // 2
    if dk["pair_kernel_block"](C, D // H, torch.bfloat16, DEV) is None:
        raise AssertionError("the flagship ring chunk does not select the "
                             "pair kernels")
    losses, warm_s, timed_s, launches, peak = train_windows(
        torch, np, dk, fa, pp, "ring", train_tokens(torch, np),
        mesh=dk["make_mesh"]({"dp": 1, "sp": 1}))
    if not np.isfinite(losses).all():
        raise AssertionError(f"ring training losses not finite: {losses}")
    steps = 2 * W
    expect = {n: PAIR_PER_LAYER.get(n, 0) * L * steps for n in launches}
    if launches != expect:
        raise AssertionError(f"ring kernel launches {launches} != {expect} "
                             f"(per layer {PAIR_PER_LAYER} x {L} layers x "
                             f"{steps} steps; B1's kernels 0)")
    gap = float(np.abs(losses - np.asarray(base["losses"])).max())
    if not gap <= TRAIN_LOSS_TOL:
        raise AssertionError(f"ring vs phase 6 losses differ by {gap} > "
                             f"{TRAIN_LOSS_TOL}: {losses} vs "
                             f"{base['losses']}")
    ms = timed_s * 1e3 / W
    flops = base["flops_per_step"]
    peak_flops = dk["peak_flops"](torch.cuda.get_device_name(0)
                                  if DEV == "cuda" else "")
    return {
        "config": f"d{D}/h{H}/L{L}/v{V}/T{T}/b{B}-bf16-ring-sp1-zigzag-"
                  f"pair{C}-adamw-mubf16-fusedce",
        "losses": losses.tolist(), "max_loss_gap_vs_phase6": gap,
        "tol": TRAIN_LOSS_TOL, "warmup_window_s": warm_s,
        "ms_per_step": ms, "tok_per_s": W * B * T / timed_s,
        "peak_device_mb": peak, "flops_per_step": flops,
        "mfu": (flops / (ms / 1e3) / peak_flops) if peak_flops else None,
        "mfu_method": base["mfu_method"] + " (phase 6's count)",
        "launches": launches,
    }


def trainer_phase(torch, np, dk, attention="standard", axes=None):
    model = dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                            device=DEV, seed=1, attention=attention,
                            **TRAIN)
    rows = np.random.default_rng(12).integers(
        0, TRAIN["vocab_size"], size=(TRAINER_ROWS, TRAIN["max_len"]))
    ds = dk["PartitionedDataset"].from_arrays({"tokens": rows})
    trainer = dk["LMTrainer"](model, worker_optimizer="adamw",
                              learning_rate=TRAIN_LR, batch_size=TRAIN_B,
                              axes=axes)
    t0 = time.perf_counter()
    trainer.train(ds)
    wall = time.perf_counter() - t0
    hist = [h["loss"] for h in trainer.history]
    steps = TRAINER_ROWS // TRAIN_B
    if len(hist) != steps or not np.isfinite(hist).all():
        raise AssertionError(f"LMTrainer history {hist}: want {steps} "
                             f"finite losses")
    del trainer, model
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return {"attention": attention, "axes": axes, "steps": steps,
            "history": hist, "wall_s": wall}


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
        from distkeras_torch.bench import (lm_step_flops, nvidia_smi,
                                           peak_flops, serving_requests)
        from distkeras_torch.data.dataset import PartitionedDataset
        from distkeras_torch.kernels import build
        from distkeras_torch.models import get_model
        from distkeras_torch.models.transformer import generate
        from distkeras_torch.ops import paged_attention as pa
        from distkeras_torch.ops import pallas_attention as fa
        from distkeras_torch.ops import pallas_pair as pp
        from distkeras_torch.ops import splash_prefill as sp
        from distkeras_torch.ops.ring_attention import _pair_kernel_block
        from distkeras_torch.parallel.mesh import make_mesh
        from distkeras_torch.parallel.spmd import make_lm_train_step
        from distkeras_torch.serving import ServingEngine
        from distkeras_torch.trainers import LMTrainer
        from distkeras_torch.utils.losses import get_optimizer
    except ImportError as e:
        return _fail(f"run from a checkout of the repository ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dk = {"telemetry": telemetry, "get_model": get_model,
          "generate": generate, "ServingEngine": ServingEngine,
          "serving_requests": serving_requests,
          "make_lm_train_step": make_lm_train_step,
          "get_optimizer": get_optimizer, "lm_step_flops": lm_step_flops,
          "peak_flops": peak_flops, "LMTrainer": LMTrainer,
          "PartitionedDataset": PartitionedDataset, "make_mesh": make_mesh,
          "pair_kernel_block": _pair_kernel_block}

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

    t0 = time.perf_counter()
    causal = causal_cases(torch, F, fa)
    _emit({"training_kernel_phase": {"causal_attention": causal,
                                     "tol": CAUSAL_TOL,
                                     "seconds": time.perf_counter() - t0}})

    t0 = time.perf_counter()
    pair = pair_cases(torch, F, pp)
    _emit({"pair_kernel_phase": {"pair_attention": pair, "tol": CAUSAL_TOL,
                                 "seconds": time.perf_counter() - t0}})

    t0 = time.perf_counter()
    training = training_phase(torch, np, dk, fa, pp)
    training["seconds"] = time.perf_counter() - t0
    _emit({"training_phase": training})

    t0 = time.perf_counter()
    ring = ring_training_phase(torch, np, dk, fa, pp, training)
    ring["seconds"] = time.perf_counter() - t0
    _emit({"ring_training_phase": ring})

    t0 = time.perf_counter()
    trainer = trainer_phase(torch, np, dk)
    trainer["seconds"] = time.perf_counter() - t0
    _emit({"lm_trainer_phase": trainer})

    t0 = time.perf_counter()
    ring_trainer = trainer_phase(torch, np, dk, "ring", {"dp": 1, "sp": 1})
    ring_trainer["seconds"] = time.perf_counter() - t0
    _emit({"ring_lm_trainer_phase": ring_trainer})

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
    main_causal = causal[0]
    for kern, line, err_keys, lib in (
            ("fwd", 100, ("out_abs_err",), main_causal["fwd_library_ms"]),
            ("dq", 193, ("dq_abs_err",), None),
            ("dkv", 240, ("dk_abs_err", "dv_abs_err"), None)):
        name = f"causal_attention_{kern}"
        rows.append({
            "name": name, "route": "cuda",
            "source": "distkeras_torch/csrc/causal_attention.cu",
            "replaces": f"distkeras_tpu/ops/pallas_attention.py:{line}",
            "launches": training["launches"][name],
            "max_abs_err": max(c[k] for c in causal for k in err_keys),
            "ms": main_causal[f"{kern}_ms"],
            "plain_ms": main_causal[f"{kern}_plain_ms"],
            "bound_ms": main_causal[f"{kern}_bound_ms"],
            "bound_by": main_causal[f"{kern}_bound_by"],
            "library_ms": lib,
        })
    lines = {"fwd": (148, 128), "dq": (301, 281), "dkv": (380, 359)}
    for kern, err_keys, lib in (
            ("fwd", ("out_abs_err",), "fwd_library_ms"),
            ("dq", ("dq_abs_err",), None),
            ("dkv", ("dk_abs_err", "dv_abs_err"), None)):
        for variant, line in zip(("wedge", "rect"), lines[kern]):
            main = next(c for c in pair if c["C"] == PAIR["C"][0]
                        and c["variant"] == variant)
            name = f"pair_{variant}_{kern}"
            rows.append({
                "name": name, "route": "cuda",
                "source": "distkeras_torch/csrc/pair_attention.cu",
                "replaces": f"distkeras_tpu/ops/pallas_pair.py:{line}",
                "launches": ring["launches"][name],
                "max_abs_err": max(c[k] for c in pair
                                   if c["variant"] == variant
                                   for k in err_keys),
                "ms": main[f"{kern}_ms"],
                "plain_ms": main[f"{kern}_plain_ms"],
                "bound_ms": main[f"{kern}_bound_ms"],
                "bound_by": main[f"{kern}_bound_by"],
                "library_ms": main[lib] if lib else None,
            })
    print(smi, flush=True)
    _emit({"kernels": rows})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
