#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``distkeras_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it exits non-zero without printing a result when
CUDA is unavailable or when the port's package is not beside it.

Phases (any failure exits non-zero):

1. **Environment + build.** The card's name and power limit as
   ``nvidia-smi`` reports them, the torch / CUDA / nvcc versions, and the
   time to build the hand-written kernels (four sources, one ``nvcc``
   each, in parallel) from ``distkeras_torch/csrc``, and the build facts
   of the hd=256 training forwards and of the backward kernels (causal,
   pair wedge and pair rectangle dq and dk/dv) at hd 64, 128 and 256:
   registers and spill bytes from nvcc's ``-Xptxas -v`` report kept
   beside each library, the dynamic shared memory a launch requests, and
   (backward) the ``HGMMA`` / ``HMMA`` / ``WARPGROUP.DEPBAR`` counts of
   ``cuobjdump -sass``; a backward instantiation without ``HGMMA``, with
   ``HMMA`` or with a spill fails.
2. **Kernels.** Each kernel against its plain PyTorch version on the
   card at the serving path's shapes — paged attention (8 rows, T in
   {1, 64, 5, 1024}: decode, the chunk, a verify window at spec_k=4, a
   monolithic suffix; H=8, Hk=2, hd=256, 16-token pages, 128 pages per
   row, bf16 and int8 pools, fragmented tables, a zero-length row) and
   splash chunked prefill (8 rows, L=2048: T=64 and T=5 with starts from
   0 to the deepest, T=1024 from position 0, and hd 128 with 4 heads at
   T=64 and T=2, the draft model's feeds)
   — max abs error <= 1e-2 in bf16 and <= 1e-5 in f32 (the plain version
   computed in f32 from the same inputs). Kernel, plain and library
   (``F.scaled_dot_product_attention`` on the gathered, dequantized view
   with an explicit mask — timed here only, never called by the port)
   times come from CUDA events with the 50 MB L2 flushed before each
   launch and a spin kernel covering the host's enqueue; the bound is
   the larger of the bytes these inputs need over 3.35 TB/s and their
   FLOPs over the dtype's peak. The bf16 kernels' edges, untimed: T=5
   and T=17, G=1 and G=8, hd 64 and 128, rows ending and starting on a
   split boundary, trash-page tails.
3. **Serving at full width.** The flagship TransformerLM (d_model 2048,
   8 heads of 256, 8 layers, vocab 8192, bf16, rope, 2 KV heads, int8
   KV cache, max_len 2048) with seeded random weights serves 16
   requests (96-1024-token prompts sharing a 256-token system prefix,
   32-64 new tokens, mixed sampling) through a paged engine and a slot
   engine (8 slots, 64-token chunks). Every request must finish; the
   launch counts (zeroed just before each engine's run) must show the
   paged kernel in every layer of every paged tick and the splash kernel
   in every layer of every slot tick that carried a prompt chunk, and
   the routes the wrappers record must all be the bf16 tensor-core
   kernels. The share of greedy tokens equal to a gather-forced twin
   engine is printed (informational at bf16), with each differing
   stream's first flip and the top-2 logit gap there.
4. **Exact.** A small f32 model (d256, 4 layers, GQA, int8 cache) with
   the kernels on, every engine mode on both layouts — chunked,
   monolithic (``prefill_chunk=None``), pipelined, multi-step k=4 (sync
   and pipelined), n-gram and draft-model speculation: greedy streams
   equal the port's own ``generate()``; pipelined and multi-step streams
   equal the sync chunked engine's bit for bit, sampled rows included;
   speculative streams (sampled included) equal across layouts. Then the
   host tier (a churn of three prefixes through a pool holding one:
   demotions, restores, streams equal an all-resident engine's), a live
   weight swap (streams after it equal an engine built on the new
   weights), KV export -> import into the device pool and into a host
   tier (the importing engine's stream equals one engine's), and
   ``beam_search(beam_size=4)`` on the card equal to the same call on a
   CPU copy. A mismatch fails with each differing greedy stream's first
   flip and top-2 logit gap.
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
   fwd + dq + dk/dv, its backward alone over one saved forward beside
   dq + dk/dv as the backward runs them, with the backend that ran),
   with the bound from this run's exact causal count. dq and dk/dv
   called alone each include the prep pass (q's scaling, delta); the
   backward runs it once.
5b. **Pair kernels.** The zigzag ring's pair forward, dq and dk/dv
   kernels, both variants (causal wedge and rectangle), against their
   plain versions at the flagship's ring chunk [8, 1024, 8, 256] and at
   C=320, q pre-scaled, a nonzero lse cotangent drawn from the seed: the
   tolerances of phase 5. Times of each kernel, its plain version and
   the library yardstick (``F.scaled_dot_product_attention`` at
   ``scale=1.0``, ``is_causal`` for the wedge; it returns no lse), with
   the bound from the exact count of each variant; dq + dk/dv as the
   backward runs them (one prep pass) beside SDPA's backward alone over
   one saved forward (the same products without the lse cotangent: no
   single call computes the pair backward).
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
8. **The dist-keras core at full width.** (8a) The reference's CIFAR
   training bench (bench.py:254-287): ``cifar_cnn`` at widths (64, 128,
   256), Dense 256, 10 classes, bf16 compute with f32 parameters, on
   seeded normal NHWC ``[2048, 32, 32, 3]`` bf16 inputs with one-hot
   labels, SGD 0.05 with momentum 0.9, categorical cross-entropy,
   through ``workers.make_window_step`` in windows of 10 steps: one
   warm-up window, then 5 timed. Every loss finite, and the first step's
   loss within 2e-2 of an f32 twin's from the same weights on the same
   batch. A second witness on another backend, before the timed run: 64
   rows of the first 3 batches through the same weights as an f64 module
   on the CPU, against the card at bf16, f32 and f64 — the first batch's
   logits, the 3 steps' losses and each weight's change over them, each
   gap within ``WITNESS_TOL``. Prints ms/window, samples/s, peak memory and MFU from the
   analytic count of ``bench.cifar_step_flops``. (8b) The reference's
   MNIST workflow (examples/mnist_workflow.py) on 16,384 seeded
   MNIST-shaped rows (a noisy prototype per class): MinMax -> Reshape ->
   OneHot, then ``SingleTrainer``, ``AveragingTrainer(2)``,
   ``EnsembleTrainer(2)`` and ``DataParallelTrainer`` (a world of one)
   each train ``mnist_cnn`` (Adam 1e-3, batch 128, 2 epochs), and so do
   the six parameter-server trainers (4 workers, window 5; DOWNPOUR at
   1e-3 / 4 committing every step, EAMSGD its Nesterov SGD at 0.02),
   then ``ModelPredictor`` -> ``LabelIndexTransformer`` ->
   ``AccuracyEvaluator``: every history finite, every model at accuracy
   >= 0.9; prints samples/s per trainer. This phase adds no hand-written
   kernel: convolutions run through cuDNN and dense products through
   cuBLAS, as XLA computes them in the reference.
9. **The parameter-server family on the card.** (9a) ``BASELINE.json``'s
   CIFAR configurations as examples/cifar10_training.py runs them:
   ``cifar_cnn`` at widths (64, 128, 256), bf16 with f32 masters, 50,000
   rows made as its ``load_data`` makes them, 8 worker threads on the
   card, window 8, momentum SGD, batch 256, 2 epochs, through
   ``DOWNPOUR`` (0.01 / 8, committing every step) then ``AEASGD`` (0.01,
   rho 5, elastic_lr 0.01) — at the example's 0.05 neither trains at
   full width (``PS_CIFAR``'s comment): every history finite, one
   commit a window, the center's loss on 4,096 rows falling, accuracy
   through the pipeline stages at least ``PS_CIFAR_MIN_ACCURACY``;
   prints samples/s, commits, peak memory, and the device's idle share
   over one more epoch under the profiler. (9b) The README's Quick
   start: ``ADAG``, 4 workers, window 5, Adam 1e-3, batch 128, 5
   epochs, accuracy >= 0.9. (9c) The lock-step engines,
   ``DOWNPOUR(spmd=True)`` and ``EASGD(spmd=True)``, 2 workers, 64 rows,
   3 windows, from the same full-width weights at bf16 and f64 on the
   card against f64 on the CPU (``PS_WITNESS_TOL``: f64 logits and
   losses 1e-10, center and update 1e-8). (9d) One commit + pull round
   trip of the CIFAR CNN's parameters through a ``DeltaParameterServer``
   on the card, timed beside its bound (five f32 passes over them at
   3.35 TB/s). No kernel is added: the commits and pulls are
   ``torch._foreach`` adds and copies, as the reference's are XLA ones.
10. **The engine's modes at full width.** Phase 3's flagship and
   16-request mix, 8 slots, through (a) monolithic prefill, (b) the
   pipelined loop, (c) multi-step k=4 and (d) n-gram speculation
   (spec_k=4), each on both layouts; (e) a draft model (vocab 8192,
   d_model 512, 4 heads of 128, 2 KV heads, 2 layers, rope, int8 cache,
   bf16, seed 1; spec_k=4) on the paged layout; (f) the host tier: four
   seeded 512-token prefixes, two round-robin passes of 16 requests
   (64-256-token tails, 32 new tokens), 2 slots, pools sized by
   benchmarks/serve_bench.py's rule — the second pass must restore from
   the host; (g) ``beam_search`` of two 256-token prompts, beam 4, 32 new
   tokens; (h) one ``update_weights`` mid-drain with the pipeline on.
   Every request finishes; the launch counts (zeroed before each run)
   must show the paged kernel in every layer of every forward on the
   paged layout (ticks, window steps, verify windows, monolithic
   prefills) and splash in every layer of every forward of more than one
   token on the slot layout, every launch a bf16 split kernel. Prints
   per mode tok/s, ms per tick, TTFT p50/p99, tokens per dispatch,
   acceptance, restores, overruns, device wait, peak memory and the
   share of greedy tokens equal to phase 3's chunked engine
   (informational at bf16), with each differing stream's first flip and
   the top-2 logit gap there.
11. **I/O and deployment.** (11a) ``BASELINE.json``'s CIFAR rows (phase
   9a's 50,000, one-hot labels) written with ``write_shards(
   rows_per_shard=4096)`` (13 shards of 3,846-3,847 rows, ~616 MB) and
   streamed from disk through
   ``DataParallelTrainer`` (a world of one; ``cifar_cnn`` at phase 8a's
   settings: bf16, SGD 0.05 momentum 0.9, batch 2048, 2 epochs, shuffle
   off; the loader casts to bf16 into pinned memory): the history and
   weights equal, bit for bit, the same trainer's on the rows in memory
   (cuDNN pinned deterministic for this phase); then ``predict_sharded``
   -> ``LabelIndexTransformer.transform_sharded`` -> ``AccuracyEvaluator``
   from the prediction shards equals the in-memory pipeline's accuracy.
   Prints samples/s from disk and in memory (one ``train()`` each, the
   host's staging and casts included), the device's idle share over one
   streamed epoch's ``train()`` and ``native_dataio_active``. (11b) The
   repository's own text, byte-level, packed to T=2048, the first 64
   sequences as 4 shards, streamed (``stage_limit_bytes`` under the
   corpus) through ``LMTrainer`` at phase 6's flagship (bf16, AdamW 3e-4
   with a bf16 first moment, batch 8, 2 epochs): every loss finite,
   epoch 2's mean below epoch 1's, the history equal to the same
   trainer's on the rows staged on the card, each causal kernel launched
   8 layers x 16 steps times; prints streamed and staged tok/s. (11c) The
   same at 2 layers (a full-depth checkpoint is ~4.4 GB): run A trains 2
   epochs with a checkpointer, run B 1, and a new trainer over B's
   directory resumes to epoch 2 — B's epoch-2 losses and final weights
   equal A's, bit for bit; prints save and restore seconds and GB/s.
   (11d) A ``RecordProducer`` feeds 16,384 of 11a's rows over a local
   socket to ``StreamingPredictor`` (batch 512) on 11a's trained CNN:
   predictions within 1e-2 of ``ModelPredictor``'s; prints records/s and
   the flush latency's p50 / p99. (11e) Three Keras configs written here
   with seeded weights — the reference's CIFAR-10 CNN vocabulary
   (Conv2D 64/128/256, BatchNormalization, MaxPooling2D, Dropout,
   Flatten, Dense 256, Dense 10 softmax), a functional block with an
   ``Add`` skip connection, and Embedding -> LSTM 512 -> GRU 512 ->
   Dense — through ``from_keras_config``: on the card at f32 without
   TF32 each within 1e-4 relative of an f64 copy on the CPU; then
   ``SingleTrainer`` trains the CNN (softmax stripped) one epoch of
   8,192 rows with finite losses. (11f) With two cards or more, a
   ``Job`` of 2 local processes (``chip_smoke.py --phase11f-worker``,
   one card each over NCCL) trains ``DataParallelTrainer`` from 11a's
   shards; both ranks must end bit-identical. On one card it prints
   ``{"phase": "11f", "skipped": "one card"}``.

Output: JSON lines per phase, the ``nvidia-smi`` line, one
``{"kernels": [...]}`` line (the serving rows carry every timed shape
in ``shapes``; the three forward rows and the causal and
pair dq and dk/dv rows also carry their ``build`` facts; the dq and
dk/dv rows carry ``bwd_ms``, the two as the backward runs them with one
prep pass, ``bwd_library_ms``, SDPA's backward, and ``sdpa_backend``),
and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, no sparsity
FLUSH_BYTES = 64 << 20  # > the 50 MB L2
# ~1 ms at the H100's clock: covers one enqueue (0: no spin, the timer
# of earlier chip runs; ab_kernels.py --no-spin)
SPIN_CYCLES = 2_000_000

DEV = "cuda"
# the serving path's attention shapes (phase 2)
# (T: decode, the prefill chunk, a verify window at spec_k=4, a
# monolithic suffix)
PAGED = dict(S=8, H=8, Hk=2, hd=256, bs=16, MB=128, T=(1, 64, 5, 1024))
SPLASH = dict(S=8, T=64, H=8, Hk=2, hd=256, L=2048)
# the splash kernel's other main-path shapes: (T, hd, H, starts) — a
# verify window at depth, a whole 1024-token prompt from position 0
# (monolithic prefill, beam search's prefill), and the draft model's
# catch-up feeds at hd 128 (4 heads over 2 KV heads)
SPLASH_MORE = ((5, 256, 8, "depth"), (1024, 256, 8, "zero"),
               (64, 128, 4, "depth"), (2, 128, 4, "depth"))
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
# phase 4's draft model (hd 64) and host-tier churn (three 64-token
# prefixes through a device pool sized below them)
EXACT_DRAFT = dict(vocab_size=512, d_model=128, num_heads=2, num_layers=1,
                   max_len=256, pos_emb="rope", cache_dtype="int8")
EXACT_TIER = dict(prefixes=3, prefix_len=64, tail=8, reps=2, max_new=8)
# phase 10: the draft model of mode (e) (4 heads of 128, 2 KV heads), the
# host tier's churn (f) and beam search (g)
DRAFT = dict(vocab_size=8192, d_model=512, num_heads=4, num_layers=2,
             max_len=2048, pos_emb="rope", num_kv_heads=2,
             cache_dtype="int8")
# (2 slots: at 8 the four prefixes stay referenced by live rows and are
# never demoted before their revisit; serve_bench's tier mode likewise
# keeps fewer slots than prefix groups)
FLAG_TIER = dict(prefixes=4, prefix_len=512, tails=(64, 256), passes=2,
                 requests=16, max_new=32, slots=2)
FLAG_BEAM = dict(rows=2, prompt=256, beam=4, new=32)
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
# phase 8: the dist-keras core
CIFAR_TIMED_WINDOWS = 5
CIFAR_LOSS_TOL = 2e-2  # first step's bf16 loss vs the f32 twin's
# 8a's witness on another backend: WITNESS_ROWS rows of the first
# WITNESS_STEPS batches through the model's weights as an f64 module on
# the CPU, against the card at bf16 (the main path's dtype), at f32
# (TF32 off, as main() sets it) and at f64. Gaps: the first batch's
# logits and the steps' losses, the largest difference over the CPU's
# largest magnitude; the change of the weights over the steps, per leaf
# the norm of the difference over the norm of the CPU's change (the
# worst leaf). At init on random labels the update magnifies rounding
# some 1e5-1e6-fold (the f32 run's reading), so the bf16 bound catches
# gross faults only (no update reads 1, an unrelated one ~1.4, a flipped
# sign 2), and the f64 run, clear of rounding, holds the card's forward,
# backward and update code tightly. Bounds from H100 readings (PERF.md
# §6).
WITNESS_ROWS, WITNESS_STEPS = 64, 3
WITNESS_TOL = {"bfloat16": {"logits": 2e-2, "loss": 5e-3, "update": 5e-1},
               "float32": {"logits": 1e-5, "loss": 5e-4, "update": 2e-1},
               "float64": {"logits": 1e-10, "loss": 1e-10, "update": 1e-8}}
MNIST_ROWS = 16384  # examples/mnist_workflow.py's default
# examples/mnist_workflow.py's settings
MNIST_TRAIN = dict(worker_optimizer="adam", learning_rate=1e-3,
                   loss="categorical_crossentropy", features_col="matrix",
                   label_col="label_encoded", batch_size=128, num_epoch=2)
MNIST_MIN_ACCURACY = 0.9
# phase 8b's workers and window for the parameter-server trainers
# (examples/mnist_workflow.py: 4 workers, the trainers' default window).
# DOWNPOUR adds the 4 workers' deltas at full strength: with Adam 1e-3 at
# window 5 its center reached 0.80-0.84 on the card, 0.70-0.90 at
# 1e-3/4, and 1.0 at 1e-3/4 committing every step (ps_sweep.py, PERF.md
# §6); at 8,192 rows the elastic trainers' centers stopped at
# 0.902, at the example's 16,384 at 1.0
MNIST_PS = dict(num_workers=4, communication_window=5)
MNIST_DOWNPOUR = dict(learning_rate=1e-3 / 4, communication_window=1)
# EAMSGD's Nesterov SGD: at 0.05 its center ends under the 0.9 bound in
# a share of runs (four async worker threads order their elastic rounds
# differently each run), at 0.02 in none of those measured
# (ps_sweep.py --task mnist; PERF.md §6)
MNIST_EAMSGD_LR = 0.02
# phase 9: the parameter-server family. 9a: BASELINE.json's CIFAR
# configurations (examples/cifar10_training.py:41-72) at CIFAR-10's
# training size, made as that example's load_data makes its rows
PS_CIFAR_ROWS = 50_000
PS_CIFAR_TRAIN = dict(worker_optimizer="momentum", learning_rate=0.05,
                      loss="categorical_crossentropy",
                      label_col="label_encoded", batch_size=256,
                      num_epoch=2)
# The example's learning rate 0.05 does not train at full width: DOWNPOUR
# (8 deltas added at full strength) goes to NaN or stays at chance, and
# AEASGD's workers collapse to the uniform prediction (loss ln 10) with
# its center at 0.13-0.18; the reference's own example with --small sees
# DOWNPOUR's center loss rise 2.30 -> 2.93. ps_sweep.py on the card
# (PERF.md §6): AEASGD at 0.01 reaches 1.0 (twice), DOWNPOUR at
# 0.01 / 8 committing every step 0.94-1.0, while at window 8 no rate it
# was given got past 0.35 (its lock-step engine: 0.10). Everything else
# is the example's.
PS_CIFAR = {"DOWNPOUR": dict(num_workers=8, communication_window=1,
                             learning_rate=0.01 / 8),
            "AEASGD": dict(num_workers=8, communication_window=8, rho=5.0,
                           elastic_lr=0.01, learning_rate=0.01)}
# the accuracy each must reach: above chance (0.1) and below what the
# reference's example reached on the CPU with --small at the same
# settings (DOWNPOUR 0.151, AEASGD 0.132; the card read 0.94-1.0 and
# 1.0 at full width: PERF.md §6)
PS_CIFAR_MIN_ACCURACY = {"DOWNPOUR": 0.12, "AEASGD": 0.12}
PS_EVAL_ROWS = 4096  # the center's loss before and after, on these rows
# 9b: the README's Quick start
QUICKSTART = dict(num_workers=4, communication_window=5,
                  worker_optimizer="adam", learning_rate=1e-3,
                  loss="categorical_crossentropy", features_col="matrix",
                  label_col="label_encoded", batch_size=128, num_epoch=5)
# 9c: the lock-step engines, 2 workers, 64 rows, 3 windows of one step,
# on the card at bf16 (the main path's dtype) and f64 against f64 on the
# CPU from the same weights. Gaps as 8a's: logits of the trained center
# on the 64 rows and the workers' losses, over the CPU's largest
# magnitude; the center, its largest difference over the CPU's largest
# weight (over every leaf); the update, per leaf the norm of the
# difference of the center's change over the norm of the CPU's (the
# worst leaf). The bf16
# bounds catch gross faults only (a commit's sign flipped reads ~2 on
# the update); the card read bf16 logits 0.047, losses 5.5e-4, center
# 3.1e-3, update 0.29 and f64 2.1e-15, 0, 1.3e-16, 1.3e-14 at worst
# (PERF.md §6).
PS_WITNESS = dict(rows=64, workers=2, batch_size=32, num_epoch=3,
                  communication_window=1)
PS_WITNESS_DTYPES = ("bfloat16", "float64")  # the card's runs
PS_WITNESS_TRAIN = dict(worker_optimizer="momentum", learning_rate=0.05,
                        loss="categorical_crossentropy",
                        label_col="label_encoded")
PS_WITNESS_TOL = {"bfloat16": {"logits": 1e-1, "loss": 5e-3,
                               "center": 1e-2, "update": 5e-1},
                  "float64": {"logits": 1e-10, "loss": 1e-10,
                              "center": 1e-8, "update": 1e-8}}
# phase 11: I/O and deployment. 11a: BASELINE.json's CIFAR rows (phase
# 9a's) written at 4,096 rows a shard (write_shards splits them evenly:
# 13 shards) through DataParallelTrainer at phase 8a's settings
STREAM_CIFAR_ROWS = 50_000
STREAM_ROWS_PER_SHARD = 4096
STREAM_CIFAR_TRAIN = dict(worker_optimizer="momentum", learning_rate=0.05,
                          batch_size=2048, num_epoch=2)
# 11b: the repository's text packed to phase 6's T, as 4 shards, through
# LMTrainer at phase 6's width; 11c: the same, 2 layers deep (a full-depth
# checkpoint is ~4.4 GB: 436M f32 masters, bf16 mu, f32 nu)
LM_STREAM = dict(seqs=64, shards=4, batch_size=8, num_epoch=2)
CKPT_LAYERS = 2
# 11d: streamed records, the flush size, the bound against ModelPredictor
STREAM_RECORDS, STREAM_BATCH, STREAM_TOL = 16384, 512, 1e-2
# 11e: the Keras configs' sizes, rows through each, the card's f32 (no
# TF32) against f64 on the CPU, and the imported CNN's training run
KERAS_CNN = dict(input=(32, 32, 3), widths=(64, 128, 256), dense=256)
KERAS_TEXT = dict(vocab=256, embed=128, units=512, T=64)
KERAS_ROWS, KERAS_TOL = 16, 1e-4
KERAS_TRAIN_ROWS = 8192
KERAS_TRAIN = dict(worker_optimizer="sgd", learning_rate=0.01,
                   batch_size=256, num_epoch=1)
# 11f: the Job's CNN widths (phase 8a's)
JOB_WIDTHS = (64, 128, 256)


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
    pool cold: a layer's weights pass through L2 between two calls). A
    spin kernel of ~1 ms between the flush and the start event keeps the
    card busy while the host enqueues ``fn``'s launches, so the host's
    launch overhead is not counted as device time (it was for calls of
    tens of µs: a 45 µs decode kernel read 45 to 236 µs)."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    sync(torch)
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        if DEV == "cuda" and SPIN_CYCLES:
            torch.cuda._sleep(SPIN_CYCLES)
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


# the bf16 kernels' edges (phase 2, untimed): T * G off multiples of 16
# and 64 (T=5, T=17), G=1 and G=8, hd 64 and 128, rows ending and
# starting on a split boundary, a zero-length row, trash-page tails
EDGES = [(5, 8, 2, 128), (17, 8, 2, 64), (3, 2, 2, 256), (2, 16, 2, 128)]


def edge_cases(torch, pa, sp):
    """The edge shapes through both bf16 kernels (bf16 and int8 pools for
    paged) against their plain versions at 1e-2: four rows over 32
    pages (paged) or L=512 (splash) whose depths are set from the
    launch's split plan."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    B, bs, NB = 4, 16, 32
    L = NB * bs
    cases = []
    for T, H, Hk, hd in EDGES:
        _, splits, per = sp.split_plan(B, Hk, T * (H // Hk), L,
                                       sp.sm_count(torch.device(DEV))
                                       if DEV == "cuda" else 132)
        if splits < 2:
            raise AssertionError(f"edge T={T} H={H}: one split, no merge")
        split = per * sp.STAGE_KEYS
        lens = torch.tensor([0, split - T, split, L - T - 5],
                            dtype=torch.int32, device=DEV)
        P = B * NB + 1
        perm = torch.randperm(P - 1, generator=gen, device=DEV) + 1
        tables = torch.zeros((B, NB), dtype=torch.int32, device=DEV)
        off = 0
        for b, n in enumerate(lens.tolist()):
            need = -(-(n + T) // bs)  # the rest of the row is trash page 0
            tables[b, :need] = perm[off:off + need].to(torch.int32)
            off += need
        q = torch.randn((B, T, H, hd), generator=gen, device=DEV).to(
            torch.bfloat16)
        kf = torch.randn((P, bs, Hk, hd), generator=gen, device=DEV)
        # v at std 0.5: a zero-length row's output is one value row, and
        # bf16's output rounding of |O| < 2 stays under 4e-3
        vf = 0.5 * torch.randn((P, bs, Hk, hd), generator=gen, device=DEV)
        ks = kf.abs().amax(-1) / 127.0
        vs = vf.abs().amax(-1) / 127.0
        pools = {"bf16": (kf.to(torch.bfloat16), vf.to(torch.bfloat16),
                          None, None),
                 "int8": (torch.round(kf / ks[..., None]).to(torch.int8),
                          torch.round(vf / vs[..., None]).to(torch.int8),
                          ks, vs)}
        for kind, (kp, vp, k_s, v_s) in pools.items():
            out = pa.paged_attention(q, kp, vp, tables, lens, k_s, v_s)
            sync(torch)
            plain = (kp, vp) if k_s is not None else (kp.float(), vp.float())
            ref = pa.paged_attention_reference(q.float(), *plain, tables,
                                               lens, k_s, v_s)
            cases.append(_edge_check("paged", kind, T, H, Hk, hd, out, ref))
        keys = torch.randn((B, L, Hk, hd), generator=gen, device=DEV).to(
            torch.bfloat16)
        vals = (0.5 * torch.randn((B, L, Hk, hd), generator=gen,
                                  device=DEV)).to(torch.bfloat16)
        out = sp.splash_prefill_attention(q, keys, vals, lens)
        sync(torch)
        ref = sp.splash_prefill_reference(q.float(), keys.float(),
                                          vals.float(), lens)
        cases.append(_edge_check("splash", "bf16", T, H, Hk, hd, out, ref))
    return cases


def _edge_check(kernel, kind, T, H, Hk, hd, out, ref):
    name = f"{kernel} edge T={T} H={H} Hk={Hk} hd={hd} {kind}"
    if not out.float().isfinite().all():
        raise AssertionError(f"{name}: non-finite output")
    err = (out.float() - ref).abs().max().item()
    if err > 1e-2:
        raise AssertionError(f"{name}: max abs err {err} > 1e-2")
    return {"kernel": kernel, "pool": kind, "T": T, "H": H, "Hk": Hk,
            "hd": hd, "max_abs_err": err, "tol": 1e-2}


def splash_cases(torch, F, sp):
    S, Hk, L = SPLASH["S"], SPLASH["Hk"], SPLASH["L"]
    gen = torch.Generator(device=DEV).manual_seed(2)
    shapes = ((SPLASH["T"], SPLASH["hd"], SPLASH["H"], "depth"),
              ) + SPLASH_MORE
    cases = []
    for T, hd, H, start_kind in shapes:
        starts = (torch.zeros(S, dtype=torch.int32, device=DEV)
                  if start_kind == "zero" else
                  torch.tensor(_depths(S, L - T), dtype=torch.int32,
                               device=DEV))
        for kind in ("bf16", "f32"):
            dt = torch.float32 if kind == "f32" else torch.bfloat16
            q = torch.randn((S, T, H, hd), generator=gen, device=DEV).to(dt)
            k = torch.randn((S, L, Hk, hd), generator=gen, device=DEV).to(dt)
            v = torch.randn((S, L, Hk, hd), generator=gen, device=DEV).to(dt)
            out = sp.splash_prefill_attention(q, k, v, starts)
            sync(torch)
            ref = sp.splash_prefill_reference(q.float(), k.float(),
                                              v.float(), starts)
            name = f"splash T={T} hd={hd} starts={start_kind} {kind}"
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"{name}: non-finite output")
            err = (out.float() - ref).abs().max().item()
            tol = 1e-5 if dt == torch.float32 else 1e-2
            if err > tol:
                raise AssertionError(f"{name}: max abs err {err} > {tol}")
            case = {"T": T, "L": L, "hd": hd, "H": H, "starts": start_kind,
                    "dtype": kind, "max_abs_err": err, "tol": tol}
            if kind == "bf16":
                case["ms"] = time_ms(torch, lambda: sp.splash_prefill_attention(
                    q, k, v, starts))
                case["plain_ms"] = time_ms(
                    torch, lambda: sp.splash_prefill_reference(q, k, v,
                                                               starts))
                qpos = starts.long()[:, None] + torch.arange(T, device=DEV)
                case["library_ms"] = sdpa_ms(torch, F, q, k, v, qpos)
                tiles = sum((int(s) + T - 1) // sp.KV_TILE + 1
                            for s in starts.tolist())
                nbytes = (2 * q.numel() * q.element_size()
                          + 2 * tiles * sp.KV_TILE * Hk * hd
                          * k.element_size() + starts.numel() * 4)
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

    # as autograd runs them: one prep pass serves both (ab_kernels.py's
    # parent trees have no prep pass to share: the two calls as they are)
    prep = getattr(fa, "bwd_scratch", None)

    def backward():
        kw = {"scratch": prep(q)} if prep else {}
        fa.causal_attention_dq(q, k, v, out, lse, do, **kw)
        fa.causal_attention_dkv(q, k, v, out, lse, do, **kw)

    t["bwd_ms"] = time_ms(torch, backward)
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
    # SDPA's backward alone, over one saved forward: the yardstick of dq
    # and dk/dv together
    saved = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    def sdpa_bwd():
        torch.autograd.grad(saved, (qh, kh, vh), doh, retain_graph=True)

    t["bwd_library_ms"] = time_ms(torch, sdpa_bwd)
    t["sdpa_backend"], t["bwd_library_kernels"] = sdpa_backend(torch,
                                                                sdpa_bwd)
    del saved
    t["fwd_bwd_ms"] = t["fwd_ms"] + t["dq_ms"] + t["dkv_ms"]
    for name, mms, nbytes in (
            ("fwd", 2, 4 * row + lse_b),
            ("dq", 3, 6 * row + lse_b),
            ("dkv", 4, 7 * row + lse_b)):
        t[f"{name}_bound_ms"], t[f"{name}_bound_by"] = bound(
            nbytes, mms * 2.0 * pairs * hd, "bfloat16")
    return t


def sdpa_backend(torch, fn):
    """Which SDPA backend ``fn`` ran, from the names of the device kernels
    one profiled call launched: ``(backend, names)``."""
    if DEV != "cuda":
        return None, []
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync(torch)
    names = sorted({e.key for e in prof.key_averages()
                    if getattr(e, "device_type", None) is not None
                    and "cuda" in str(e.device_type).lower()})
    low = " ".join(names).lower()
    backend = ("cudnn" if "cudnn" in low else "flash" if "flash" in low
               else "efficient" if ("fmha" in low or "efficient" in low
                                    or "mem_eff" in low) else "math")
    return backend, [n[:120] for n in names]


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

    # dq and dk/dv as autograd runs them: one prep pass serves both
    # (ab_kernels.py's parent trees may have no pair scratch to share: the
    # two calls as they are)
    prep = getattr(pp, "bwd_scratch", None)

    def backward():
        kw = {"scratch": prep(q)} if prep else {}
        pp.pair_attention_dq(q, k, v, o, lse, do, dlse, causal, **kw)
        pp.pair_attention_dkv(q, k, v, o, lse, do, dlse, causal, **kw)

    t["bwd_ms"] = time_ms(torch, backward)
    # the yardstick of dq and dk/dv together: SDPA's backward alone over
    # one saved forward, the same products without the lse cotangent (no
    # single call computes the pair backward)
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (qh, kh, vh))
    doh = do.transpose(1, 2).contiguous()
    saved = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                           scale=1.0)

    def sdpa_bwd():
        torch.autograd.grad(saved, (qg, kg, vg), doh, retain_graph=True)

    t["bwd_library_ms"] = time_ms(torch, sdpa_bwd)
    t["bwd_library_what"] = "same products, no lse cotangent"
    t["sdpa_backend"], t["bwd_library_kernels"] = sdpa_backend(torch,
                                                                sdpa_bwd)
    del saved
    for name, mms, nbytes in (
            ("fwd", 2, 4 * row + lse_b),
            ("dq", 3, 6 * row + 2 * lse_b),
            ("dkv", 4, 7 * row + 2 * lse_b)):
        t[f"{name}_bound_ms"], t[f"{name}_bound_by"] = bound(
            nbytes, mms * 2.0 * pairs * hd, "bfloat16")
    return t


# -- the kernels' build facts (kernels line, rows 3-7) ------------------


# row -> (source, template flags <CAUSAL, PAIR> of its forward instantiation)
FWD_INSTANCES = {"causal_attention_fwd": ("causal_attention.cu", "ELb1ELb0E"),
                 "pair_wedge_fwd": ("pair_attention.cu", "ELb1ELb1E"),
                 "pair_rect_fwd": ("pair_attention.cu", "ELb0ELb1E")}


def ptxas_facts(log, key):
    """Registers and spill bytes of the kernel whose mangled name holds
    ``key``, from nvcc's ``-Xptxas -v`` report ``log``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and key in line:
            block = []
            for nxt in lines[i + 1:]:
                if "Compiling entry function" in nxt:
                    break
                block.append(nxt)
            text = "\n".join(block)
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", text)
            if regs and spill:
                return {"registers": int(regs.group(1)),
                        "spill_store_bytes": int(spill.group(1)),
                        "spill_load_bytes": int(spill.group(2))}
    raise AssertionError(f"no ptxas report for a kernel named like {key}")


def _smem_fn(kern):
    smem = kern.libs["causal_attention.cu"].dk_attention_smem
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return smem


def fwd_build_facts(build, kern, hd):
    """Per forward row: the hd instantiation's registers at entry (the
    consumers then take 240 with setmaxnreg, the producer 24) and spill
    bytes from the report ``build`` keeps beside each library, and the
    dynamic shared memory a launch requests."""
    smem = _smem_fn(kern)
    facts = {}
    for row, (source, flags) in FWD_INSTANCES.items():
        log = build._target(source).with_suffix(".log").read_text()
        facts[row] = dict(ptxas_facts(log, f"sm9010fwd_kernelILi{hd}{flags}"),
                          smem_bytes=smem(hd, 0))
    return facts


# row -> (source, mangled name stem, template flags <CAUSAL, PAIR>, the
# smem query's kernel index) of the backward kernels
# (csrc/flash_bwd_sm90.cuh), each instantiated at every hd
BWD_INSTANCES = {
    "causal_attention_dq": ("causal_attention.cu", "sm909dq_kernelILi",
                            "ELb1ELb0E", 1),
    "causal_attention_dkv": ("causal_attention.cu", "sm9010dkv_kernelILi",
                             "ELb1ELb0E", 2),
    "pair_wedge_dq": ("pair_attention.cu", "sm909dq_kernelILi", "ELb1ELb1E",
                      1),
    "pair_rect_dq": ("pair_attention.cu", "sm909dq_kernelILi", "ELb0ELb1E",
                     1),
    "pair_wedge_dkv": ("pair_attention.cu", "sm9010dkv_kernelILi",
                       "ELb1ELb1E", 2),
    "pair_rect_dkv": ("pair_attention.cu", "sm9010dkv_kernelILi",
                      "ELb0ELb1E", 2),
}


def sass_counts(sass, key):
    """``HGMMA``, ``HMMA`` and ``WARPGROUP.DEPBAR`` instructions of the
    kernel whose mangled name holds ``key``, in ``cuobjdump -sass``
    output."""
    counts, inside = None, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = key in line
            if inside:
                counts = {"HGMMA": 0, "HMMA": 0, "WARPGROUP_DEPBAR": 0}
            continue
        if inside:
            counts["HGMMA"] += len(re.findall(r"\bHGMMA\.", line))
            counts["HMMA"] += len(re.findall(r"\bHMMA\.", line))
            counts["WARPGROUP_DEPBAR"] += line.count("WARPGROUP.DEPBAR")
    if counts is None:
        raise AssertionError(f"no SASS for a kernel named like {key}")
    return counts


def bwd_build_facts(build, kern):
    """Per backward row and head dim: registers and spill bytes (nvcc's
    report), the dynamic shared memory a launch requests, and the tensor
    instructions in the kernel's SASS. Fails unless every instantiation
    issues HGMMA, no HMMA, and spills nothing."""
    smem = _smem_fn(kern)
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    listings = {}  # source -> (nvcc's report, SASS)
    for source in {v[0] for v in BWD_INSTANCES.values()}:
        lib = build._target(source)
        listings[source] = (lib.with_suffix(".log").read_text(),
                            subprocess.run([cuobjdump, "-sass", str(lib)],
                                           capture_output=True, text=True,
                                           timeout=300, check=True).stdout)
    facts = {}
    for row, (source, stem, flags, which) in BWD_INSTANCES.items():
        log, sass = listings[source]
        facts[row] = {}
        for hd in (64, 128, 256):
            key = f"{stem}{hd}{flags}"
            f = dict(ptxas_facts(log, key), smem_bytes=smem(hd, which),
                     **sass_counts(sass, key))
            if (f["HGMMA"] == 0 or f["HMMA"] or f["spill_store_bytes"]
                    or f["spill_load_bytes"]):
                raise AssertionError(f"{row} hd={hd}: want HGMMA, no HMMA "
                                     f"and no spills: {f}")
            facts[row][str(hd)] = f
    return facts


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


# -- phase 8: the dist-keras core at full width ----------------------------


def _witness_run(torch, dk, model, xs, ys, loss_fn, device, dtype):
    """``model``'s weights as a ``dtype`` module on ``device`` (f64: the
    masters, every layer and the head in f64): its logits on ``xs[0]``,
    then one window over ``xs`` with 8a's optimizer; returns the logits,
    the window's losses and each weight's change, on the CPU in f64."""
    bench = dk["bench"]
    f64 = dtype == torch.float64
    twin = dk["get_model"]("cifar_cnn", dtype=torch.float32 if f64 else dtype,
                           device=device)
    twin.load_state_dict(model.state_dict())
    if f64:
        for m in twin.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
        twin.double()
    xs = xs.to(device, torch.float64 if f64 else torch.float32)
    ys = ys.to(device, xs.dtype)
    with torch.no_grad():
        logits = twin(xs[0]).double().cpu()
    before = {k: v.detach().double().cpu().clone()
              for k, v in twin.named_parameters()}
    step = dk["make_window_step"](
        twin, loss_fn, dk["get_optimizer"]("momentum", bench.CIFAR_LR,
                                           momentum=bench.CIFAR_MOMENTUM))
    losses = step(xs, ys)["loss"].double().cpu()
    update = {k: v.detach().double().cpu() - before[k]
              for k, v in twin.named_parameters()}
    return logits, losses, update


def cpu_witness(torch, dk, model, xs, ys, loss_fn):
    """8a's second witness, on another backend (see WITNESS_TOL): the
    card's forward, backward and momentum update against the CPU's in
    f64, from ``model``'s weights before the main path trains them."""
    xs = xs[:WITNESS_STEPS, :WITNESS_ROWS].cpu()
    ys = ys[:WITNESS_STEPS, :WITNESS_ROWS].cpu()
    want = _witness_run(torch, dk, model, xs, ys, loss_fn, "cpu",
                        torch.float64)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def rel2(a, b):
        return float((a - b).norm() / b.norm())

    out = {"rows": WITNESS_ROWS, "steps": WITNESS_STEPS}
    for dtype in (torch.bfloat16, torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        got = _witness_run(torch, dk, model, xs, ys, loss_fn, DEV, dtype)
        gaps = {"logits": rel(got[0], want[0]),
                "loss": rel(got[1], want[1]),
                "update": max(rel2(got[2][k], u)
                              for k, u in want[2].items())}
        out[name] = gaps
        for key, gap in gaps.items():
            if not gap <= WITNESS_TOL[name][key]:
                raise AssertionError(
                    f"CIFAR {name} on the card vs f64 on the CPU: {key} "
                    f"gap {gap} > {WITNESS_TOL[name][key]}")
    out["tol"] = WITNESS_TOL
    return out


def cifar_phase(torch, np, dk):
    """8a: the reference's CIFAR training bench through the port's window
    step."""
    bench = dk["bench"]
    B, W = bench.CIFAR_BATCH, bench.CIFAR_WINDOW
    model = dk["get_model"]("cifar_cnn", device=DEV, seed=0)
    twin = dk["get_model"]("cifar_cnn", dtype=torch.float32, device=DEV)
    twin.load_state_dict(model.state_dict())
    xs, ys = bench.cifar_batches(model.device, B, W)
    loss_fn = dk["get_loss"]("categorical_crossentropy")
    with torch.no_grad():
        twin_loss = float(loss_fn(twin(xs[0]), ys[0]))
    del twin
    witness = cpu_witness(torch, dk, model, xs, ys, loss_fn)
    step = dk["make_window_step"](
        model, loss_fn, dk["get_optimizer"]("momentum", bench.CIFAR_LR,
                                            momentum=bench.CIFAR_MOMENTUM))
    sync(torch)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(xs, ys)["loss"]]
    sync(torch)
    t1 = time.perf_counter()
    for _ in range(CIFAR_TIMED_WINDOWS):
        losses.append(step(xs, ys)["loss"])
    sync(torch)
    t2 = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated() / 2**20 if DEV == "cuda"
            else None)
    losses = torch.cat(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"CIFAR losses not finite: {losses}")
    gap = abs(float(losses[0]) - twin_loss)
    if not gap <= CIFAR_LOSS_TOL:
        raise AssertionError(f"CIFAR first loss {losses[0]} vs the f32 "
                             f"twin's {twin_loss}: {gap} > {CIFAR_LOSS_TOL}")
    timed = t2 - t1
    ms = timed * 1e3 / CIFAR_TIMED_WINDOWS
    flops = bench.cifar_step_flops(B) * W
    peak_flops = dk["peak_flops"](torch.cuda.get_device_name(0)
                                  if DEV == "cuda" else "")
    del step, model
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return {
        "config": f"cifar_cnn-w64/128/256-d256-bf16-b{B}-sgd"
                  f"{bench.CIFAR_LR}-m{bench.CIFAR_MOMENTUM}-W{W}",
        "losses": losses.tolist(), "f32_twin_first_loss": twin_loss,
        "first_loss_gap": gap, "tol": CIFAR_LOSS_TOL,
        "cpu_witness": witness,
        "warmup_window_s": t1 - t0, "ms_per_window": ms,
        "samples_per_s": CIFAR_TIMED_WINDOWS * W * B / timed,
        "peak_device_mb": peak, "flops_per_window": flops,
        "mfu": (flops / (ms / 1e3) / peak_flops) if peak_flops else None,
        "mfu_method": "analytic: 3 x forward convolution and dense "
                      "products (distkeras_torch.bench.cifar_step_flops) "
                      "over the bf16 peak of the device",
    }


def mnist_dataset(np, dk, rows=None):
    """examples/mnist_workflow.py's synthetic digits (a noisy prototype per
    class) through MinMax -> Reshape -> OneHot."""
    rows = rows or MNIST_ROWS
    rng = np.random.default_rng(0)
    protos = rng.uniform(0, 255, size=(10, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=rows)
    x = np.clip(protos[y] + rng.normal(scale=64.0, size=(rows, 784)), 0,
                255).astype(np.float32)
    ds = dk["PartitionedDataset"].from_arrays({"features": x, "label": y},
                                              num_partitions=4)
    ds = dk["MinMaxTransformer"](o_min=0.0, o_max=255.0,
                                 input_col="features",
                                 output_col="features_normalized"
                                 ).transform(ds)
    ds = dk["ReshapeTransformer"]("features_normalized", "matrix",
                                  (28, 28, 1)).transform(ds)
    return dk["OneHotTransformer"](10, "label", "label_encoded"
                                   ).transform(ds)


def mnist_phase(torch, np, dk, rows=None):
    """8b: every dist-keras trainer of the port on the MNIST workflow."""
    ds = mnist_dataset(np, dk, rows)
    trainers = (
        ("single", lambda m: dk["SingleTrainer"](m, **MNIST_TRAIN)),
        ("averaging", lambda m: dk["AveragingTrainer"](m, num_workers=2,
                                                       **MNIST_TRAIN)),
        ("ensemble", lambda m: dk["EnsembleTrainer"](m, num_models=2,
                                                     **MNIST_TRAIN)),
        ("data_parallel", lambda m: dk["DataParallelTrainer"](
            m, **MNIST_TRAIN)),
    ) + tuple((name.lower(), lambda m, name=name: dk[name](
        m, **_mnist_ps_train(name))) for name in PS_NAMES)
    out = {}
    for name, make in trainers:
        trainer = make(dk["get_model"]("mnist_cnn", device=DEV, seed=0))
        trained = trainer.train(ds, shuffle=True)
        sync(torch)
        wall = trainer.get_training_time()
        models = trained if isinstance(trained, list) else [trained]
        accs = []
        for m in models:
            pred = dk["ModelPredictor"](m, features_col="matrix").predict(ds)
            pred = dk["LabelIndexTransformer"](input_col="prediction"
                                               ).transform(pred)
            accs.append(dk["AccuracyEvaluator"]("predicted_index", "label"
                                                ).evaluate(pred))
        hist = [r[k] for h in trainer.executor_histories for r in h
                for k in ("loss", "accuracy")]
        steps = sum(len(h) for h in trainer.executor_histories)
        if not steps or not np.isfinite(hist).all():
            raise AssertionError(f"{name}: history not finite or empty")
        if not min(accs) >= MNIST_MIN_ACCURACY:
            raise AssertionError(f"{name}: accuracy {accs} < "
                                 f"{MNIST_MIN_ACCURACY}")
        out[name] = {"accuracy": accs, "steps": steps, "train_s": wall,
                     "samples_per_s": steps * MNIST_TRAIN["batch_size"]
                     / wall,
                     "final_loss": [h[-1]["loss"]
                                    for h in trainer.executor_histories]}
        del trainer, trained, models
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return {"rows": len(ds), "train": MNIST_TRAIN,
            "ps_train": {n: _mnist_ps_train(n) for n in PS_NAMES},
            "trainers": out}


PS_NAMES = ("DOWNPOUR", "ADAG", "DynSGD", "AEASGD", "EAMSGD", "EASGD")


def _mnist_ps_train(name):
    """8b's settings for a PS trainer: MNIST_TRAIN with MNIST_PS; DOWNPOUR
    with MNIST_DOWNPOUR; EAMSGD trains its own Nesterov SGD (it refuses
    another worker optimizer) at MNIST_EAMSGD_LR."""
    kw = dict(MNIST_TRAIN, **MNIST_PS)
    if name == "DOWNPOUR":
        kw.update(MNIST_DOWNPOUR)
    if name == "EAMSGD":
        del kw["worker_optimizer"]
        kw["learning_rate"] = MNIST_EAMSGD_LR
    return kw


# -- phase 9: the parameter-server family ----------------------------------


def cifar_rows(np, rows):
    """examples/cifar10_training.py's load_data: a uniform prototype per
    class plus normal noise of scale 0.25, clipped to [0, 1]."""
    rng = np.random.default_rng(0)
    protos = rng.uniform(0, 1, size=(10, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=rows)
    x = np.clip(protos[y] + rng.normal(scale=0.25, size=(rows, 32, 32, 3)),
                0, 1).astype(np.float32)
    return x, y


def _center_loss(torch, model, x, y):
    """The mean categorical cross-entropy of ``model`` on rows ``x``."""
    with torch.no_grad():
        total = 0.0
        for i in range(0, len(x), 512):
            xb = torch.as_tensor(x[i:i + 512], device=model.device)
            logits = model(xb).float()
            yb = torch.as_tensor(y[i:i + 512], device=model.device)
            total += float(torch.nn.functional.cross_entropy(
                logits, yb, reduction="sum"))
    return total / len(x)


def _accuracy(dk, model, ds, features_col="features"):
    pred = dk["ModelPredictor"](model, features_col=features_col
                                ).predict(ds)
    pred = dk["LabelIndexTransformer"](input_col="prediction"
                                       ).transform(pred)
    return dk["AccuracyEvaluator"]("predicted_index", "label"
                                   ).evaluate(pred)


def _idle_share(torch, dk, run):
    """Device busy time and idle share of ``run()`` under torch.profiler
    (CUDA activity only, so the host is slowed as little as it can be)."""
    if DEV != "cuda":
        return {"device_busy_ms": None, "idle_share": None,
                "note": "not measured (no card)"}
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync(torch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    summary = dk["bench"]._device_summary(prof, wall_ms)
    return {k: summary[k] for k in ("wall_ms", "device_busy_ms",
                                    "idle_share")}


def ps_cifar_phase(torch, np, dk, rows=None, widths=None):
    """9a: DOWNPOUR, then AEASGD, on the CIFAR CNN over 8 workers (one
    card), as examples/cifar10_training.py runs them."""
    rows = rows or PS_CIFAR_ROWS
    x, y = cifar_rows(np, rows)
    ds = dk["PartitionedDataset"].from_arrays({"features": x, "label": y},
                                              num_partitions=8)
    ds = dk["OneHotTransformer"](10).transform(ds)
    ev_x, ev_y = x[:PS_EVAL_ROWS], y[:PS_EVAL_ROWS]
    kw = {"widths": widths} if widths else {}
    out = {}
    for name, cfg in PS_CIFAR.items():
        model = dk["get_model"]("cifar_cnn", device=DEV, seed=0, **kw)
        before = _center_loss(torch, model, ev_x, ev_y)
        train = dict(PS_CIFAR_TRAIN, **cfg)
        trainer = dk[name](model, **train)
        sync(torch)
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trained = trainer.train(ds, shuffle=True)
        sync(torch)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() / 2**20
                if DEV == "cuda" else None)
        hist = [r[k] for h in trainer.executor_histories for r in h
                for k in ("loss", "accuracy")]
        steps = sum(len(h) for h in trainer.executor_histories)
        if not steps or not np.isfinite(hist).all():
            raise AssertionError(f"{name}: history not finite or empty")
        per_worker = [len(h) // train["num_epoch"]
                      for h in trainer.executor_histories]
        windows = sum(-(-b // cfg["communication_window"])
                      for b in per_worker) * train["num_epoch"]
        commits = trainer.parameter_server.num_updates
        if commits != windows:
            raise AssertionError(f"{name}: {commits} commits for {windows} "
                                 f"windows")
        after = _center_loss(torch, trained.module, ev_x, ev_y)
        if not after < before:
            raise AssertionError(f"{name}: the center's loss {after} did not "
                                 f"fall below {before}")
        acc = _accuracy(dk, trained, ds)
        if not acc >= PS_CIFAR_MIN_ACCURACY[name]:
            raise AssertionError(f"{name}: accuracy {acc} < "
                                 f"{PS_CIFAR_MIN_ACCURACY[name]}")
        # the device's idle share: one more epoch from the trained center,
        # under the profiler
        again = dk[name](trained.module, **dict(train, num_epoch=1))
        idle = _idle_share(torch, dk, lambda: again.train(ds, shuffle=True))
        out[name] = {"config": train, "steps": steps,
                     "train_s": wall,
                     "samples_per_s": steps * train["batch_size"]
                     / wall,
                     "commits": commits, "center_loss_before": before,
                     "center_loss_after": after, "accuracy": acc,
                     "min_accuracy": PS_CIFAR_MIN_ACCURACY[name],
                     "peak_device_mb": peak, "profiled_epoch": idle}
        del trainer, trained, again, model
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return {"rows": rows, "eval_rows": PS_EVAL_ROWS, "trainers": out}


def quickstart_phase(torch, np, dk, rows=None):
    """9b: the README's Quick start, ADAG on mnist_cnn over 4 workers."""
    ds = mnist_dataset(np, dk, rows)
    trainer = dk["ADAG"](dk["get_model"]("mnist_cnn", device=DEV, seed=0),
                         **QUICKSTART)
    model = trainer.train(ds, shuffle=True)
    sync(torch)
    hist = [r[k] for h in trainer.executor_histories for r in h
            for k in ("loss", "accuracy")]
    if not hist or not np.isfinite(hist).all():
        raise AssertionError("Quick start: history not finite or empty")
    acc = _accuracy(dk, model, ds, features_col="matrix")
    if not acc >= MNIST_MIN_ACCURACY:
        raise AssertionError(f"Quick start: accuracy {acc} < "
                             f"{MNIST_MIN_ACCURACY}")
    steps = sum(len(h) for h in trainer.executor_histories)
    return {"rows": len(ds), "config": QUICKSTART, "accuracy": acc,
            "commits": trainer.parameter_server.num_updates,
            "steps": steps, "train_s": trainer.get_training_time(),
            "samples_per_s": steps * QUICKSTART["batch_size"]
            / trainer.get_training_time()}


def _ps_witness_run(torch, dk, model, name, cols, device, dtype):
    """``model``'s weights as a ``dtype`` module on ``device`` (f64: masters
    and every layer), trained by ``name``'s lock-step engine with every
    worker and the center there; returns the trained center's logits on
    the rows, the workers' losses, and its weights, on the CPU in f64."""
    f64 = dtype == torch.float64
    twin = dk["get_model"]("cifar_cnn", dtype=torch.float32 if f64 else dtype,
                           device=device)
    twin.load_state_dict(model.state_dict())
    if f64:
        for m in twin.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
        twin.double()
    ds = dk["PartitionedDataset"].from_arrays(cols, num_partitions=2)
    trainer = dk[name](twin, num_workers=PS_WITNESS["workers"], spmd=True,
                       devices=[device],
                       batch_size=PS_WITNESS["batch_size"],
                       num_epoch=PS_WITNESS["num_epoch"],
                       communication_window=PS_WITNESS[
                           "communication_window"], **PS_WITNESS_TRAIN)
    trainer.train(ds)
    x = torch.as_tensor(cols["features"], device=device)
    with torch.no_grad():
        logits = twin(x.to(torch.float64 if f64 else torch.float32)
                      ).double().cpu()
    losses = torch.tensor([r["loss"] for h in trainer.executor_histories
                           for r in h], dtype=torch.float64)
    center = {k: v.detach().double().cpu()
              for k, v in twin.named_parameters()}
    return logits, losses, center


def ps_witness(torch, np, dk, model):
    """9c: DOWNPOUR(spmd=True) and EASGD(spmd=True) on the card at bf16 and
    f64 against f64 on the CPU, from ``model``'s weights (see
    PS_WITNESS_TOL)."""
    x, y = cifar_rows(np, PS_WITNESS["rows"])
    cols = {"features": x, "label": y,
            "label_encoded": np.eye(10, dtype=np.float32)[y]}
    init = {k: v.detach().double().cpu()
            for k, v in model.named_parameters()}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    out = {"config": PS_WITNESS, "tol": PS_WITNESS_TOL}
    for name in ("DOWNPOUR", "EASGD"):
        want = _ps_witness_run(torch, dk, model, name, cols, "cpu",
                               torch.float64)
        out[name] = {}
        for key in PS_WITNESS_DTYPES:
            got = _ps_witness_run(torch, dk, model, name, cols, DEV,
                                  getattr(torch, key))
            gaps = {
                "logits": rel(got[0], want[0]), "loss": rel(got[1], want[1]),
                "center": max(float((got[2][k] - c).abs().max())
                              for k, c in want[2].items())
                / max(float(c.abs().max()) for c in want[2].values()),
                "update": max(float((got[2][k] - c).norm()
                                    / (c - init[k]).norm())
                              for k, c in want[2].items()
                              if float((c - init[k]).norm()) > 0),
            }
            out[name][key] = gaps
            for g, gap in gaps.items():
                if not gap <= PS_WITNESS_TOL[key][g]:
                    raise AssertionError(
                        f"{name}(spmd=True) {key} on the card vs f64 on the "
                        f"CPU: {g} gap {gap} > {PS_WITNESS_TOL[key][g]}")
    return out


def ps_roundtrip(torch, dk, model):
    """9d: one commit + pull round trip of ``model``'s parameters through a
    DeltaParameterServer on the card (the port's counterpart of
    benchmarks/ps_roundtrip.py), beside its bound: the commit reads the
    center and the delta and writes the center, the pull reads the
    center and writes a copy — five f32 passes over the parameters."""
    from distkeras_torch import bridge

    ps = dk["DeltaParameterServer"](bridge.params_to_jax(model), device=DEV)
    delta = {k: torch.full_like(v, 1e-3) for k, v in ps.center.items()}
    n = sum(v.numel() for v in ps.center.values())
    nbytes = 5 * 4 * n

    def round_trip():
        ps.commit(delta)
        ps.pull(device=DEV)

    ms = time_ms(torch, round_trip)
    bound_ms, by = bound(nbytes, 0, "float32")
    return {"params": n, "leaves": len(ps.center), "bytes": nbytes,
            "ms": ms, "bound_ms": bound_ms, "bound_by": by,
            "commits": ps.num_updates}


# -- phase 3: serving at full width ----------------------------------------


def serve(torch, np, dk, model, requests, **kw):
    """Drive one engine over ``requests`` (8 slots, 64-token chunks
    unless ``kw`` says otherwise); returns its summary, the streams and
    the engine."""
    kw.setdefault("slots", 8)
    kw.setdefault("prefill_chunk", 64)
    eng = dk["ServingEngine"](
        model, device=DEV, registry=dk["telemetry"].MetricRegistry(),
        tracer=dk["telemetry"].Tracer(), **kw)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
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
        "device_wait_ms": st["device_wait_ms"],
        "peak_device_mb": (torch.cuda.max_memory_allocated() / 2**20
                           if DEV == "cuda" else None),
    }
    return summary, streams, eng


def greedy_match(requests, a, b):
    same = total = 0
    for (_, c), x, y in zip(requests, a, b):
        if c.get("temperature", 0.0) == 0.0:
            total += len(x)
            same += sum(int(u == v) for u, v in zip(x, y))
    return same / max(total, 1)


def greedy_flips(torch, np, model, requests, a, b):
    """Where the greedy streams ``a`` leave the gather twin's ``b``: for
    each stream that differs, its first differing token's index and,
    from one dense forward of the model over the prompt and the tokens
    both streams share, the gap between the top two logits there and
    between the two tokens the paths chose (a near tie when both are
    at bf16's rounding of the logits)."""
    flips = []
    for i, ((p, c), x, y) in enumerate(zip(requests, a, b)):
        if c.get("temperature", 0.0) != 0.0 or list(x) == list(y):
            continue
        j = next(k for k, (u, v) in enumerate(zip(x, y)) if u != v)
        ctx = torch.tensor(np.concatenate([p, np.asarray(x[:j], p.dtype)]),
                           dtype=torch.long, device=DEV)[None]
        with torch.no_grad():
            logits = model(ctx)[0, -1].float()
        top = logits.topk(2).values
        flips.append({"request": i, "first_flip": j, "of": len(x),
                      "top2_gap": (top[0] - top[1]).item(),
                      "chosen_gap": (logits[x[j]] - logits[y[j]]).abs()
                      .item()})
    return flips


def serving_phase(torch, np, dk, pa, sp):
    model = dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                            device=DEV, seed=0, **FLAGSHIP)
    L = model.num_layers
    requests = dk["serving_requests"](model.vocab_size, SYSTEM_PREFIX,
                                      PROMPT_LENS)
    # warm the allocator, cuBLAS and both kernels outside the counted runs
    for paged in (True, False):
        serve(torch, np, dk, model, requests[:2], paged=paged,
              block_size=16)
    out = {}
    pa.paged_attention.launches = 0
    sp.splash_prefill_attention.launches = 0
    pa.paged_attention.routes.clear()
    sp.splash_prefill_attention.routes.clear()
    paged_sum, paged_streams, _ = serve(torch, np, dk, model, requests,
                                        paged=True, block_size=16)
    paged_sum["launches"] = {"paged_attention": pa.paged_attention.launches,
                             "splash_prefill": sp.splash_prefill_attention
                             .launches}
    if pa.paged_attention.launches < paged_sum["ticks"] * L or (
            pa.paged_attention.launches == 0):
        raise AssertionError(f"paged engine: {pa.paged_attention.launches} "
                             f"paged-attention launches < ticks x layers")
    routes = {"paged_attention": dict(pa.paged_attention.routes)}
    pa.paged_attention.launches = 0
    sp.splash_prefill_attention.launches = 0
    pa.paged_attention.routes.clear()
    sp.splash_prefill_attention.routes.clear()
    slot_sum, slot_streams, _ = serve(torch, np, dk, model, requests,
                                      paged=False)
    slot_sum["launches"] = {"paged_attention": pa.paged_attention.launches,
                            "splash_prefill": sp.splash_prefill_attention
                            .launches}
    if sp.splash_prefill_attention.launches < slot_sum["chunk_ticks"] * L or (
            sp.splash_prefill_attention.launches == 0):
        raise AssertionError(
            f"slot engine: {sp.splash_prefill_attention.launches} splash "
            f"launches < chunk ticks x layers")
    routes["splash_prefill"] = dict(sp.splash_prefill_attention.routes)
    for name, seen in routes.items():
        # the bf16 model's calls run the tensor-core kernels, never the
        # scalar f32 kernel
        if not seen or any("split_kernel" not in r for r in seen):
            raise AssertionError(f"{name}: launch routes {seen} are not "
                                 f"all the bf16 split kernels")
    launches = {"paged_attention": paged_sum["launches"]["paged_attention"],
                "splash_prefill": slot_sum["launches"]["splash_prefill"]}
    _, paged_ref, _ = serve(torch, np, dk, model, requests, paged=True,
                            block_size=16, paged_kernel="gather",
                            prefill_kernel="gather")
    _, slot_ref, _ = serve(torch, np, dk, model, requests, paged=False,
                           prefill_kernel="gather")
    paged_sum["greedy_match_vs_gather"] = greedy_match(
        requests, paged_streams, paged_ref)
    slot_sum["greedy_match_vs_gather"] = greedy_match(
        requests, slot_streams, slot_ref)
    paged_sum["greedy_flips"] = greedy_flips(torch, np, model, requests,
                                             paged_streams, paged_ref)
    slot_sum["greedy_flips"] = greedy_flips(torch, np, model, requests,
                                            slot_streams, slot_ref)
    paged_sum["routes"] = routes["paged_attention"]
    slot_sum["routes"] = routes["splash_prefill"]
    out["paged"], out["slot"] = paged_sum, slot_sum
    return out, launches, routes, {"paged": paged_streams,
                                   "slot": slot_streams}


# -- phase 4: exact streams on a small f32 model ----------------------------


def exact_requests(np, V, seed=5):
    """Phase 4's six requests: a 48-token shared prefix, 20-90-token
    tails, every third request sampled (temperature 0.9, top-k 40)."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, V, size=48)
    requests = []
    for i, n in enumerate((20, 70, 35, 90, 50, 64)):
        prompt = np.concatenate([system, rng.integers(0, V, size=n)])
        cfg = (dict(temperature=0.9, top_k=40, seed=i) if i % 3 == 2
               else dict(seed=i))
        requests.append((prompt.astype(np.int32),
                         dict(cfg, max_new_tokens=24 + 4 * i)))
    return requests


def _launches(pa, sp):
    return (pa.paged_attention.launches, sp.splash_prefill_attention.launches)


def _differ(torch, np, model, requests, got, want, what):
    """Fail phase 4 on a stream mismatch, naming each differing greedy
    stream's first flip and its top-2 logit gap (a near tie shows as a
    gap at f32's rounding of the logits) and the differing sampled
    requests."""
    if got == want:
        return
    flips = greedy_flips(torch, np, model, requests, got, want)
    sampled = [i for i, ((_, c), x, y) in enumerate(zip(requests, got, want))
               if c.get("temperature", 0.0) != 0.0 and x != y]
    raise AssertionError(f"exact phase: {what}: streams differ (greedy "
                         f"flips {flips}, sampled requests {sampled})")


EXACT_MODES = (("chunked", {}), ("monolithic", dict(prefill_chunk=None)),
               ("pipelined", dict(pipeline=True)),
               ("multi_step", dict(multi_step_k=4)),
               ("multi_step_pipelined", dict(multi_step_k=4, pipeline=True)),
               ("ngram", dict(draft="ngram", spec_k=4)),
               ("draft_model", dict(spec_k=4)))
# modes whose streams must equal the sync chunked engine's bit for bit,
# sampled rows included (the same computation, scheduled differently)
EXACT_SAME_AS_CHUNKED = ("pipelined", "multi_step", "multi_step_pipelined")


def exact_modes(torch, np, dk, pa, sp, model, requests, refs):
    """Every engine mode on both layouts with the kernels on: greedy
    streams equal ``generate()``; pipelined and multi-step streams equal
    the sync k=1 engine's bit for bit; speculative streams (sampled
    included) equal across layouts."""
    draft = dk["get_model"]("transformer_lm", dtype=torch.float32,
                            device=DEV, seed=4, **EXACT_DRAFT)
    res, streams_by = {}, {}
    for paged in (True, False):
        layout = "paged" if paged else "slot"
        res[layout] = {}
        for name, kw in EXACT_MODES:
            if name == "draft_model":
                kw = dict(kw, draft=draft)
            before = _launches(pa, sp)
            _, streams, eng = serve(torch, np, dk, model, requests,
                                    paged=paged, block_size=16, **kw)
            used = _launches(pa, sp)[0 if paged else 1] - before[
                0 if paged else 1]
            if used == 0:
                raise AssertionError(f"exact phase ({layout} {name}) ran "
                                     f"without its kernel")
            greedy = [s if c.get("temperature", 0.0) == 0.0 else None
                      for (_, c), s in zip(requests, streams)]
            want = [r if c.get("temperature", 0.0) == 0.0 else None
                    for (_, c), r in zip(requests, refs)]
            _differ(torch, np, model, requests, greedy, want,
                    f"{layout} {name} greedy vs generate()")
            if name in EXACT_SAME_AS_CHUNKED:
                _differ(torch, np, model, requests, streams,
                        streams_by[(layout, "chunked")],
                        f"{layout} {name} vs the sync chunked engine")
            st = eng.stats()
            res[layout][name] = {
                "greedy_equal": True, "kernel_launches": used,
                "sampled_equal_generate": sum(
                    int(s == r) for (_, c), s, r in zip(requests, streams,
                                                        refs)
                    if c.get("temperature", 0.0) != 0.0),
                "acceptance_rate": st.get("acceptance_rate"),
                "tokens_per_dispatch_p50": st["tokens_per_dispatch"]["p50"],
            }
            streams_by[(layout, name)] = streams
    for name in ("ngram", "draft_model"):
        _differ(torch, np, model, requests, streams_by[("slot", name)],
                streams_by[("paged", name)],
                f"{name} speculative streams across layouts")
    return res


def exact_tier(torch, np, dk, pa, model):
    """The host tier on the paged layout: a churn of three 64-token
    prefixes through a device pool sized below them demotes and restores
    blocks; streams (greedy and sampled) equal an all-resident engine's,
    greedy ones ``generate()``."""
    T = EXACT_TIER
    rng = np.random.default_rng(9)
    prefixes = [rng.integers(0, model.vocab_size, size=T["prefix_len"])
                for _ in range(T["prefixes"])]
    reqs = []
    for r in range(T["reps"]):
        for i, pre in enumerate(prefixes):
            tail = rng.integers(0, model.vocab_size, size=T["tail"])
            cfg = (dict(temperature=0.8, seed=r * 10 + i) if i % 2
                   else dict(seed=0))
            reqs.append((np.concatenate([pre, tail]).astype(np.int32),
                         dict(cfg, max_new_tokens=T["max_new"])))

    def run(**kw):
        eng = dk["ServingEngine"](
            model, slots=2, paged=True, block_size=16, prefill_chunk=16,
            device=DEV, registry=dk["telemetry"].MetricRegistry(),
            tracer=dk["telemetry"].Tracer(), **kw)
        out = []
        for p, c in reqs:  # one at a time: the churn order is the trace
            r = eng.submit(p, **c)
            eng.drain(timeout=300)
            out.append(r.stream.tokens(timeout=10))
        return out, eng

    before = pa.paged_attention.launches
    # one request's worst case plus ONE prefix of cache: the third
    # prefix demotes the first, whose revisit restores it
    pb = T["prefix_len"] // 16
    worst = -(-(T["prefix_len"] + T["tail"] + T["max_new"]) // 16)
    tiered, eng = run(num_blocks=1 + worst + pb,
                      host_blocks=T["prefixes"] * pb + pb)
    resident, _ = run(num_blocks=256)
    st = eng.stats()
    if st["block_demotions"] == 0 or st["block_restores"] == 0:
        raise AssertionError(f"exact phase: the host tier never restored "
                             f"({st['block_demotions']} demotions, "
                             f"{st['block_restores']} restores)")
    _differ(torch, np, model, reqs, tiered, resident,
            "host tier vs the all-resident engine")
    refs = [dk["generate"](model, p[None], c["max_new_tokens"])[
        0, len(p):].tolist() if c.get("temperature", 0.0) == 0.0 else s
        for (p, c), s in zip(reqs, tiered)]
    _differ(torch, np, model, reqs, tiered, refs,
            "host tier greedy vs generate()")
    return {"streams_equal": True, "demotions": st["block_demotions"],
            "restores": st["block_restores"],
            "kernel_launches": pa.paged_attention.launches - before}


def exact_swap_and_migrate(torch, np, dk, model, requests):
    """Live weights and KV migration on the paged layout: after an
    ``update_weights`` at a tick boundary (pipelined engine) the streams
    equal an engine built on the new weights; after ``export_blocks`` ->
    ``import_blocks`` (into the device pool and into a host tier) the
    importing engine's greedy stream equals one engine's."""
    make = dk["get_model"]
    old = make("transformer_lm", dtype=torch.float32, device=DEV, seed=3,
               **EXACT)
    new = make("transformer_lm", dtype=torch.float32, device=DEV, seed=8,
               **EXACT)
    kw = dict(paged=True, block_size=16)
    _, _, eng = serve(torch, np, dk, old, requests[:3], pipeline=True, **kw)
    out = eng.update_weights(dk["bridge"].params_to_jax(new))
    reqs = [eng.submit(p, **c) for p, c in requests]
    eng.drain(timeout=900)
    swapped = [r.stream.tokens(timeout=10) for r in reqs]
    _, fresh, _ = serve(torch, np, dk, new, requests, **kw)
    _differ(torch, np, new, requests, swapped, fresh,
            "after update_weights vs an engine on the new weights")
    res = {"swap": {"streams_equal": True, "version": out["version"],
                    "swap_ms": out["swap_ms"]}}
    prompt, _ = requests[3]
    greedy = [(prompt, dict(max_new_tokens=16, seed=0))]
    _, one, _ = serve(torch, np, dk, model, greedy, **kw)
    for dst_kw in ({}, dict(host_blocks=32)):
        _, _, src = serve(torch, np, dk, model,
                          [(prompt, dict(max_new_tokens=1, seed=0))], **kw)
        exp = src.export_blocks(prompt)
        dst = dk["ServingEngine"](
            model, slots=8, prefill_chunk=64, device=DEV,
            registry=dk["telemetry"].MetricRegistry(),
            tracer=dk["telemetry"].Tracer(), **kw, **dst_kw)
        imp = dst.import_blocks(prompt, exp["blocks"])
        r = dst.submit(prompt, **greedy[0][1])
        dst.drain(timeout=300)
        got = [r.stream.tokens(timeout=10)]
        _differ(torch, np, model, greedy, got, one,
                f"imported ({imp['mode']}) vs one engine")
        if dst.prefix_hit_tokens != imp["tokens"] or imp["tokens"] == 0:
            raise AssertionError(f"exact phase: the import ({imp}) did not "
                                 f"serve the prompt's prefix")
        res[f"migrate_{imp['mode']}"] = {"streams_equal": True,
                                         "tokens": imp["tokens"]}
    return res


def exact_beam(torch, np, dk, model):
    """``beam_search(beam_size=4)`` on the card equals the same call on a
    CPU copy of the weights (the plain attends)."""
    from distkeras_torch.models.transformer import beam_search

    cpu = dk["get_model"]("transformer_lm", dtype=torch.float32,
                          device="cpu", seed=3, **EXACT)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    prompt = np.random.default_rng(11).integers(
        0, model.vocab_size, size=(2, 40)).astype(np.int32)
    got = beam_search(model, prompt, 16, beam_size=4).cpu()
    want = beam_search(cpu, prompt, 16, beam_size=4)
    if not torch.equal(got, want):
        raise AssertionError(f"exact phase: beam search on the card "
                             f"{got[:, 40:].tolist()} != on the CPU "
                             f"{want[:, 40:].tolist()}")
    return {"beams_equal": True, "rows": 2, "beam_size": 4, "new": 16}


def exact_phase(torch, np, dk, pa, sp):
    model = dk["get_model"]("transformer_lm", dtype=torch.float32,
                            device=DEV, seed=3, **EXACT)
    requests = exact_requests(np, model.vocab_size)
    refs = [dk["generate"](model, p[None], c["max_new_tokens"],
                           temperature=c.get("temperature", 0.0),
                           seed=c["seed"], top_k=c.get("top_k"))[
        0, len(p):].tolist() for p, c in requests]
    res = exact_modes(torch, np, dk, pa, sp, model, requests, refs)
    res["host_tier"] = exact_tier(torch, np, dk, pa, model)
    res.update(exact_swap_and_migrate(torch, np, dk, model, requests))
    res["beam_search"] = exact_beam(torch, np, dk, model)
    return res


# -- phase 10: the engine's modes at full width -------------------------------


def _zero_counts(pa, sp):
    for f in (pa.paged_attention, sp.splash_prefill_attention):
        f.launches = 0
        f.routes.clear()


def _steps(eng):
    """Forward passes of the flagship's decode twin in one run: one per
    tick, k per multi-step window (from the flight recorder)."""
    return sum(s.get("multi_k", 1) for s in eng.flight.snapshots()
               if s.get("kind") == "tick")


def mode_check(eng, summary, pa, sp, L, paged, expect_splash=None,
               prefills=0):
    """The launch counts and routes of one phase-10 run: on the paged
    layout the paged kernel in every layer of every forward (ticks,
    window steps, monolithic prefills); on the slot layout splash in
    every layer of every forward carrying more than one token
    (``expect_splash``); every launch a bf16 tensor-core split kernel."""
    launches = {"paged_attention": pa.paged_attention.launches,
                "splash_prefill": sp.splash_prefill_attention.launches}
    routes = {"paged_attention": dict(pa.paged_attention.routes),
              "splash_prefill": dict(sp.splash_prefill_attention.routes)}
    if paged:
        want = (_steps(eng) + prefills) * L
        if launches["paged_attention"] < want:
            raise AssertionError(f"paged kernel launched "
                                 f"{launches['paged_attention']} < {want}")
    if expect_splash is not None:
        if launches["splash_prefill"] < expect_splash:
            raise AssertionError(f"splash kernel launched "
                                 f"{launches['splash_prefill']} < "
                                 f"{expect_splash}")
    for name, seen in routes.items():
        if any("split_kernel" not in r for r in seen):
            raise AssertionError(f"{name}: launch routes {seen} are not "
                                 f"all the bf16 split kernels")
    summary["launches"], summary["routes"] = launches, routes
    return summary


def mode_summary(requests, summary, eng, streams, ref):
    st = eng.stats()
    summary.update({
        "tokens_per_dispatch_p50": st["tokens_per_dispatch"]["p50"],
        "dispatches": st["dispatches"],
        "acceptance_rate": st.get("acceptance_rate"),
        "restores": st.get("block_restores"),
        "overrun_tokens": st["overrun_tokens"],
        "multi_step_fallbacks": st["multi_step_fallbacks"],
        "greedy_match_vs_chunked": (greedy_match(requests, streams, ref)
                                    if ref is not None else None),
    })
    return summary


def tier_requests(np, V):
    """Phase 10(f): four distinct seeded 512-token prefixes, two
    round-robin passes of 16 requests, 64-256-token tails, 32 new
    tokens, sampling as the main mix cycles it."""
    T = FLAG_TIER
    rng = np.random.default_rng(21)
    prefixes = [rng.integers(0, V, size=T["prefix_len"])
                for _ in range(T["prefixes"])]
    passes = []
    for _ in range(T["passes"]):
        reqs = []
        for i in range(T["requests"]):
            tail = rng.integers(0, V, size=int(rng.integers(
                T["tails"][0], T["tails"][1] + 1)))
            prompt = np.concatenate([prefixes[i % T["prefixes"]], tail])
            reqs.append((prompt.astype(np.int32),
                         dict(seed=200 + i, max_new_tokens=T["max_new"])))
        passes.append(reqs)
    return passes


def tier_sizes(block_size=16):
    """``num_blocks`` and ``host_blocks`` by the rule of
    benchmarks/serve_bench.py:357-362: every slot's worst case plus a
    third of the prefix working set on the device, the whole working set
    plus one prefix on the host."""
    T = FLAG_TIER
    pb = T["prefix_len"] // block_size
    worst = -(-(T["prefix_len"] + T["tails"][1] + T["max_new"])
              // block_size)
    cache_blocks = max((T["prefixes"] * pb) // 3, pb)
    return (1 + T["slots"] * worst + cache_blocks,
            T["prefixes"] * pb + pb)


def modes_phase(torch, np, dk, pa, sp, chunked):
    """Phase 10: the flagship's 16-request mix through every engine mode
    (8 slots), plus the host tier's churn, beam search and a weight swap
    mid-drain; ``chunked`` holds phase 3's streams per layout."""
    model = dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                            device=DEV, seed=0, **FLAGSHIP)
    L = model.num_layers
    requests = dk["serving_requests"](model.vocab_size, SYSTEM_PREFIX,
                                      PROMPT_LENS)
    draft = dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                            device=DEV, seed=1, **DRAFT)
    out = {}

    def run(name, paged, kw, splash=None, ref=True):
        _zero_counts(pa, sp)
        summary, streams, eng = serve(
            torch, np, dk, model, requests, paged=paged, block_size=16,
            flight_capacity=1 << 16, **kw)
        prefills = len(requests) if kw.get("prefill_chunk", 1) is None \
            else 0
        want_splash = None
        if not paged:
            want_splash = splash(eng, summary) * L
        mode_check(eng, summary, pa, sp, L, paged, want_splash,
                   prefills=prefills)
        base = (chunked["paged" if paged else "slot"] if ref and chunked
                else None)
        out[name] = mode_summary(requests, summary, eng, streams, base)
        if base is not None:
            # each greedy stream that leaves the chunked engine's, with
            # the top-2 logit gap where it does (bf16 near ties)
            out[name]["greedy_flips"] = greedy_flips(
                torch, np, model, requests, streams, base)
        return eng

    chunk_ticks = lambda eng, summ: summ["chunk_ticks"]  # noqa: E731
    every_tick = lambda eng, summ: summ["ticks"]  # noqa: E731
    prompts_gt1 = lambda eng, summ: sum(  # noqa: E731
        1 for p, _ in requests if len(p) > 1)
    for paged in (True, False):
        lay = "paged" if paged else "slot"
        # the sync chunked engine of phase 3, under this phase's conditions:
        # the yardstick of every mode below
        run(f"chunked_{lay}", paged, {}, chunk_ticks)
        run(f"monolithic_{lay}", paged, dict(prefill_chunk=None),
            prompts_gt1)
        run(f"pipelined_{lay}", paged, dict(pipeline=True), chunk_ticks)
        run(f"multi_step_{lay}", paged, dict(multi_step_k=4), chunk_ticks)
        run(f"ngram_{lay}", paged, dict(draft="ngram", spec_k=4),
            every_tick)
    eng = run("draft_model_paged", True, dict(draft=draft, spec_k=4))
    # the draft's catch-up feeds run splash (hd 128) in every draft layer
    want = eng.draft_feeds * draft.num_layers
    if eng.draft_feeds == 0 or sp.splash_prefill_attention.launches < want:
        raise AssertionError(f"draft model: splash launched "
                             f"{sp.splash_prefill_attention.launches} < "
                             f"{eng.draft_feeds} feeds x "
                             f"{draft.num_layers} layers")
    out["draft_model_paged"].update(
        draft_feeds=eng.draft_feeds,
        draft_splash_launches=sp.splash_prefill_attention.launches)
    del draft, eng
    out["host_tier_paged"] = tier_phase(torch, np, dk, pa, sp, model)
    out["beam_search"] = beam_phase(torch, np, sp, model)
    out["update_weights_pipelined"] = swap_phase(torch, np, dk, pa, sp,
                                                 model, requests, chunked)
    return out


def tier_phase(torch, np, dk, pa, sp, model):
    """Phase 10(f): the host tier under the flagship. The second pass
    must restore prefixes from the host."""
    L = model.num_layers
    num_blocks, host_blocks = tier_sizes()
    passes = tier_requests(np, model.vocab_size)
    _zero_counts(pa, sp)
    eng = dk["ServingEngine"](
        model, slots=FLAG_TIER["slots"], prefill_chunk=64, paged=True,
        block_size=16, num_blocks=num_blocks, host_blocks=host_blocks,
        device=DEV,
        flight_capacity=1 << 16,
        registry=dk["telemetry"].MetricRegistry(),
        tracer=dk["telemetry"].Tracer())
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res = {"num_blocks": num_blocks, "host_blocks": host_blocks}
    t_all = time.perf_counter()
    for i, reqs in enumerate(passes):
        before = eng.restores
        sync(torch)
        t0 = time.perf_counter()
        rs = [eng.submit(p, **c) for p, c in reqs]
        eng.drain(timeout=900)
        sync(torch)
        wall = time.perf_counter() - t0
        toks = [r.stream.tokens(timeout=10) for r in rs]
        if any(len(t) != FLAG_TIER["max_new"] for t in toks):
            raise AssertionError("host tier: a request did not finish")
        res[f"pass_{i + 1}"] = {
            "wall_s": wall, "tok_per_s": sum(map(len, toks)) / wall,
            "restores": eng.restores - before}
    if res["pass_2"]["restores"] == 0:
        raise AssertionError("host tier: the second pass restored nothing "
                             "from the host")
    st = eng.stats()
    summary = {"ticks": st["ticks"], "wall_s": time.perf_counter() - t_all,
               "ms_per_tick": (time.perf_counter() - t_all) * 1e3
               / max(st["ticks"], 1),
               "ttft_ms_p50": st["ttft_ms"].get("p50"),
               "ttft_ms_p99": st["ttft_ms"].get("p99"),
               "demotions": st["block_demotions"],
               "prefix_hit_fraction": st["prefix_hit_fraction"],
               "restore_wait_ms": st["restore_wait_ms"],
               "peak_device_mb": (torch.cuda.max_memory_allocated() / 2**20
                                  if DEV == "cuda" else None)}
    mode_check(eng, summary, pa, sp, L, True)
    res.update(summary)
    return res


def beam_phase(torch, np, sp, model):
    """Phase 10(g): ``beam_search`` of two 256-token prompts, beam 4, 32
    new tokens; its prefill runs splash in every layer."""
    from distkeras_torch.models.transformer import beam_search

    B = FLAG_BEAM
    prompt = np.random.default_rng(31).integers(
        0, model.vocab_size, size=(B["rows"], B["prompt"])).astype(np.int32)
    sp.splash_prefill_attention.launches = 0
    sp.splash_prefill_attention.routes.clear()
    sync(torch)
    t0 = time.perf_counter()
    out = beam_search(model, prompt, B["new"], beam_size=B["beam"])
    sync(torch)
    ms = (time.perf_counter() - t0) * 1e3
    toks = out[:, B["prompt"]:].cpu()
    if tuple(out.shape) != (B["rows"], B["prompt"] + B["new"]) or not (
            (toks >= 0) & (toks < model.vocab_size)).all():
        raise AssertionError(f"beam search: bad output {tuple(out.shape)}")
    if sp.splash_prefill_attention.launches < model.num_layers:
        raise AssertionError(f"beam search: splash launched "
                             f"{sp.splash_prefill_attention.launches} < "
                             f"{model.num_layers}")
    return {"ms": ms, "tok_per_s": B["rows"] * B["new"] / (ms / 1e3),
            "splash_launches": sp.splash_prefill_attention.launches,
            "routes": dict(sp.splash_prefill_attention.routes)}


def swap_phase(torch, np, dk, pa, sp, model, requests, chunked):
    """Phase 10(h): one ``update_weights`` mid-drain, pipeline on (the
    model's own weights pushed back, so the streams stay comparable):
    every request finishes, the version moves, and the swap's time."""
    L = model.num_layers
    tree = dk["bridge"].params_to_jax(model)
    _zero_counts(pa, sp)
    eng = dk["ServingEngine"](
        model, slots=8, prefill_chunk=64, paged=True, block_size=16,
        pipeline=True, device=DEV, flight_capacity=1 << 16,
        registry=dk["telemetry"].MetricRegistry(),
        tracer=dk["telemetry"].Tracer())
    sync(torch)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, **c) for p, c in requests]
    for _ in range(20):
        eng.step()
    swap = eng.update_weights(tree)
    eng.drain(timeout=900)
    sync(torch)
    wall = time.perf_counter() - t0
    streams = [r.stream.tokens(timeout=10) for r in reqs]
    if any(len(s) != c["max_new_tokens"] for s, (_, c) in zip(streams,
                                                              requests)):
        raise AssertionError("weight swap: a request did not finish")
    if eng.weight_version != 2:
        raise AssertionError(f"weight swap: version {eng.weight_version}")
    st = eng.stats()
    summary = {"ticks": st["ticks"], "wall_s": wall,
               "tok_per_s": st["tokens_generated"] / wall,
               "ms_per_tick": wall * 1e3 / max(st["ticks"], 1),
               "swap_ms": swap["swap_ms"], "version": swap["version"],
               "overrun_tokens": st["overrun_tokens"],
               "greedy_match_vs_chunked": (greedy_match(
                   requests, streams, chunked["paged"]) if chunked
                   else None)}
    return mode_check(eng, summary, pa, sp, L, True)


# -- phase 11: I/O and deployment ---------------------------------------------


def _delta(np, a, b):
    """max |a - b| over max |b| (0 when both are 0)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = float(np.abs(b).max()) if b.size else 0.0
    gap = float(np.abs(a - b).max()) if b.size else 0.0
    return gap / scale if scale else gap


def _params_equal(np, dk, a, b) -> bool:
    fa, fb = dk["rules"].flatten(a), dk["rules"].flatten(b)
    return sorted(fa) == sorted(fb) and all(
        np.array_equal(fa[k], fb[k]) for k in fa)


def _free(torch):
    if DEV == "cuda":
        torch.cuda.empty_cache()


def dp_stream_phase(torch, np, dk, workdir):
    """11a: BASELINE.json's CIFAR rows written as shards and streamed
    through DataParallelTrainer (a world of one) against the same trainer
    on the rows in memory; then predict_sharded -> transform_sharded ->
    AccuracyEvaluator against the in-memory pipeline. Returns (summary,
    the streamed run's model, the shard directory, the rows)."""
    x, y = cifar_rows(np, STREAM_CIFAR_ROWS)
    onehot = np.eye(10, dtype=np.float32)[y]
    rows = dk["PartitionedDataset"].from_arrays({"features": x,
                                                 "label": onehot})
    t0 = time.perf_counter()
    shard_dir = dk["write_shards"](rows, os.path.join(workdir, "cifar"),
                                   STREAM_ROWS_PER_SHARD)
    write_s = time.perf_counter() - t0
    sds = dk["ShardedDataset"](shard_dir)
    nbytes = sum(os.path.getsize(os.path.join(shard_dir, f))
                 for f in os.listdir(shard_dir))
    # cuDNN's default algorithms may reduce in a varying order (a
    # backward-weight split); pinned for this phase, so two runs of the
    # same batches can be held equal bit for bit
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def run(data, epochs=None):
        model = dk["get_model"]("cifar_cnn", device=DEV, seed=0)
        tr = dk["DataParallelTrainer"](model, **dict(
            STREAM_CIFAR_TRAIN, **({"num_epoch": epochs} if epochs else {})))
        sync(torch)
        t = time.perf_counter()
        tr.train(data)
        sync(torch)
        return tr, model, time.perf_counter() - t

    try:
        mem, _, _ = run(rows)  # the reference (and warm-up)
        disk, model, disk_s = run(sds)
        mem2, _, mem_s = run(rows)
        idle = _idle_share(torch, dk, lambda: run(sds, epochs=1))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # informational: the same in-memory run under cuDNN's defaults
    free = run(rows)[0].history
    free_equal = free == mem.history
    free_gap = max(abs(a["loss"] - b["loss"])
                   for a, b in zip(free, mem.history))
    B = STREAM_CIFAR_TRAIN["batch_size"]
    steps = STREAM_CIFAR_TRAIN["num_epoch"] * (STREAM_CIFAR_ROWS // B)
    if len(disk.history) != steps:
        raise AssertionError(f"11a: {len(disk.history)} streamed steps, "
                             f"want {steps}")
    losses = [h["loss"] for h in disk.history]
    if not np.isfinite(losses).all():
        raise AssertionError(f"11a: streamed losses not finite: {losses}")
    if disk.history != mem.history or mem2.history != mem.history:
        gap = max(abs(a["loss"] - b["loss"])
                  for a, b in zip(disk.history, mem.history))
        raise AssertionError(f"11a: streamed history != in-memory history "
                             f"(largest loss gap {gap})")
    if not _params_equal(np, dk, disk.params, mem.params):
        raise AssertionError("11a: streamed params != in-memory params")
    del mem, mem2
    # the pipeline from disk against the same stages in memory
    trained = dk["Model"](model)
    t0 = time.perf_counter()
    pred_dir = dk["ModelPredictor"](trained).predict_sharded(
        sds, os.path.join(workdir, "pred"))
    idx_dir = dk["LabelIndexTransformer"](10).transform_sharded(
        dk["ShardedDataset"](pred_dir), os.path.join(workdir, "index"))
    acc_disk = dk["AccuracyEvaluator"]().evaluate(dk["ShardedDataset"](
        idx_dir))
    pipe_s = time.perf_counter() - t0
    loaded = sds.load()
    pred = dk["LabelIndexTransformer"](10).transform(
        dk["ModelPredictor"](trained).predict(loaded))
    acc_mem = dk["AccuracyEvaluator"]().evaluate(pred)
    if acc_disk != acc_mem:
        raise AssertionError(f"11a: accuracy from shards {acc_disk} != in "
                             f"memory {acc_mem}")
    for d in (pred_dir, idx_dir):
        shutil.rmtree(d)
    samples = steps * B
    return {
        "config": f"cifar_cnn-bf16-b{B}-momentum"
                  f"{STREAM_CIFAR_TRAIN['learning_rate']}-"
                  f"{STREAM_CIFAR_TRAIN['num_epoch']}ep-shuffle_off",
        "rows": STREAM_CIFAR_ROWS, "shards": sds.num_shards,
        "shard_bytes": nbytes, "write_s": write_s,
        "native_dataio_active": dk["native_dataio_active"](),
        "cudnn_deterministic": True,
        "default_cudnn_history_equal": free_equal,
        "default_cudnn_max_loss_gap": free_gap,
        "history_equal": True, "params_equal": True, "steps": steps,
        "first_loss": losses[0], "last_loss": losses[-1],
        "disk_samples_per_s": samples / disk_s,
        "memory_samples_per_s": samples / mem_s,
        "disk_s": disk_s, "memory_s": mem_s,
        "streamed_epoch": idle,
        "accuracy": acc_disk, "pipeline_s": pipe_s,
    }, model, sds, x


def lm_corpus(np, dk, here):
    """11b's corpus: the repository's own text, byte-level, packed to the
    flagship's T, the first LM_STREAM["seqs"] sequences."""
    T, n = TRAIN["max_len"], LM_STREAM["seqs"]
    text = dk["text"]
    ids = text.corpus_from_dir(here, max_bytes=n * T + 1)
    return text.pack_sequences(ids, T)[:n]


def _lm_trainer(torch, dk, layers=None, **kw):
    """An LMTrainer at phase 6's width (``layers`` deep) from seed 2,
    AdamW with a bf16 first moment; ``kw`` overrides LM_STREAM's batch
    and epochs."""
    cfg = dict(TRAIN, **({"num_layers": layers} if layers else {}))
    model = dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                            device=DEV, seed=2, **cfg)
    opts = dict(batch_size=LM_STREAM["batch_size"],
                num_epoch=LM_STREAM["num_epoch"],
                worker_optimizer=dk["get_optimizer"](
                    "adamw", TRAIN_LR, mu_dtype=torch.bfloat16))
    opts.update(kw)
    return dk["LMTrainer"](model, **opts)


def lm_stream_phase(torch, np, dk, fa, pp, workdir, here):
    """11b: the corpus as shards streamed through LMTrainer at the
    flagship's width against the same trainer on the rows staged on the
    device. Returns (summary, the shard directory)."""
    toks = lm_corpus(np, dk, here)
    n, T = toks.shape
    if n != LM_STREAM["seqs"]:
        raise AssertionError(f"11b: the corpus packs {n} sequences")
    ds = dk["PartitionedDataset"].from_arrays({"tokens": toks})
    shard_dir = dk["write_shards"](ds, os.path.join(workdir, "corpus"),
                                   n // LM_STREAM["shards"])
    sds = dk["ShardedDataset"](shard_dir)
    stage = toks.nbytes // 2  # under the corpus: it streams
    staged = _lm_trainer(torch, dk)
    sync(torch)
    t0 = time.perf_counter()
    staged.train(ds)
    sync(torch)
    staged_s = time.perf_counter() - t0
    del staged.model
    _free(torch)
    streamed = _lm_trainer(torch, dk, stage_limit_bytes=stage)
    if not streamed._maybe_materialize(sds)[1]:
        raise AssertionError("11b: the corpus did not stream")
    zero_training_counts(fa, pp)
    sync(torch)
    t0 = time.perf_counter()
    streamed.train(sds)
    sync(torch)
    streamed_s = time.perf_counter() - t0
    launches = training_counts(fa, pp)
    del streamed.model
    _free(torch)
    losses = np.array([h["loss"] for h in streamed.history])
    per = n // LM_STREAM["batch_size"]
    steps = LM_STREAM["num_epoch"] * per
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"11b: history {losses}: want {steps} finite "
                             f"losses")
    if not losses[per:2 * per].mean() < losses[:per].mean():
        raise AssertionError(f"11b: epoch 2's mean loss did not fall: "
                             f"{losses}")
    if streamed.history != staged.history:
        gap = float(np.abs(losses - [h["loss"] for h in staged.history]
                           ).max())
        raise AssertionError(f"11b: streamed history != staged history "
                             f"(largest gap {gap})")
    L = TRAIN["num_layers"]
    hd = TRAIN["d_model"] // TRAIN["num_heads"]
    want = L * steps if fa.preferred(T, hd, torch.bfloat16, DEV) else 0
    expect = {k: (want if k in CAUSAL_NAMES else 0) for k in launches}
    if launches != expect:
        raise AssertionError(f"11b: kernel launches {launches} != {expect} "
                             f"(layers x steps)")
    tokens = steps * LM_STREAM["batch_size"] * T
    return {
        "corpus": f"{n} x {T} bytes of the repository's text, "
                  f"{sds.num_shards} shards",
        "stage_limit_bytes": stage, "steps": steps,
        "losses": losses.tolist(), "history_equal": True,
        "epoch_means": [float(losses[:per].mean()),
                        float(losses[per:].mean())],
        "launches": {k: launches[k] for k in CAUSAL_NAMES},
        "streamed_tok_per_s": tokens / streamed_s,
        "staged_tok_per_s": tokens / staged_s,
        "streamed_s": streamed_s, "staged_s": staged_s,
    }, sds


def _timed_checkpointer(dk, directory, log):
    """A Checkpointer whose saves and restores append (seconds, bytes of
    the step's file) to ``log["save"]`` / ``log["restore"]``."""
    ck = dk["Checkpointer"](directory, every_steps=1)
    save, restore = ck.maybe_save, ck.restore

    def timed_save(step, *a, **kw):
        t0 = time.perf_counter()
        saved = save(step, *a, **kw)
        if saved:
            log["save"].append((time.perf_counter() - t0,
                                os.path.getsize(ck._path(step))))
        return saved

    def timed_restore(step=None, like=None):
        t0 = time.perf_counter()
        got, state = restore(step, like)
        if state is not None:
            log["restore"].append((time.perf_counter() - t0,
                                   os.path.getsize(ck._path(got))))
        return got, state

    ck.maybe_save, ck.restore = timed_save, timed_restore
    return ck


def resume_phase(torch, np, dk, workdir, sds):
    """11c: run A trains 2 epochs from 11b's shards with a checkpointer;
    run B trains 1, and a new trainer over B's directory resumes to epoch
    2: B's epoch-2 losses and final weights must equal A's."""
    log = {"save": [], "restore": []}
    stage = 1  # stream
    dirs = [os.path.join(workdir, d) for d in ("ckpt_a", "ckpt_b")]
    a = _lm_trainer(torch, dk, CKPT_LAYERS, stage_limit_bytes=stage,
                    checkpointer=_timed_checkpointer(dk, dirs[0], log))
    a.train(sds)
    del a.model
    _free(torch)
    b1 = _lm_trainer(torch, dk, CKPT_LAYERS, stage_limit_bytes=stage,
                     checkpointer=_timed_checkpointer(dk, dirs[1], log),
                     num_epoch=1)
    b1.train(sds)
    del b1.model
    _free(torch)
    b2 = _lm_trainer(torch, dk, CKPT_LAYERS, stage_limit_bytes=stage,
                     checkpointer=_timed_checkpointer(dk, dirs[1], log))
    b2.train(sds)
    del b2.model
    _free(torch)
    per = len(a.history) // 2
    if not (b1.history == a.history[:per] and b2.history == a.history[per:]):
        raise AssertionError(
            f"11c: resumed losses {b2.history} != run A's epoch 2 "
            f"{a.history[per:]}")
    if not _params_equal(np, dk, b2.params, a.params):
        raise AssertionError("11c: resumed weights != run A's")
    # A saves epochs 1 and 2, B epoch 1, the resumed run epoch 2
    if len(log["restore"]) != 1 or len(log["save"]) != 4:
        raise AssertionError(f"11c: saves {log['save']}, restores "
                             f"{log['restore']}")
    for d in dirs:
        shutil.rmtree(d)
    save_s = [s for s, _ in log["save"]]
    nbytes = log["save"][0][1]
    rs, rb = log["restore"][0]
    return {"layers": CKPT_LAYERS, "steps": len(a.history),
            "epoch2_losses": [h["loss"] for h in b2.history],
            "losses_equal": True, "params_equal": True,
            "checkpoint_bytes": nbytes, "save_s": save_s,
            "save_gb_per_s": [b / s / 1e9 for s, b in log["save"]],
            "restore_s": rs, "restore_gb_per_s": rb / rs / 1e9}


def streaming_phase(torch, np, dk, model, x):
    """11d: RecordProducer -> socket -> StreamingPredictor on 11a's
    trained CNN against ModelPredictor on the same rows."""
    n = STREAM_RECORDS
    records = [{"id": i, "features": x[i]} for i in range(n)]
    trained = dk["Model"](model)
    prod = dk["RecordProducer"](records, chunk=32).start()
    pred = dk["StreamingPredictor"](trained, batch_size=STREAM_BATCH)
    t0 = time.perf_counter()
    out = list(pred.predict_stream(dk["socket_source"](prod.host, prod.port,
                                                       timeout=120)))
    wall = time.perf_counter() - t0
    prod.join()
    if [r["id"] for r in out] != list(range(n)):
        raise AssertionError("11d: records out of order or missing")
    got = np.stack([r["prediction"] for r in out])
    want = dk["ModelPredictor"](trained).predict(
        dk["PartitionedDataset"].from_arrays({"features": x[:n]})
    ).column("prediction")
    gap = float(np.abs(got - want).max())
    if not gap <= STREAM_TOL:
        raise AssertionError(f"11d: streamed predictions differ from "
                             f"ModelPredictor's by {gap} > {STREAM_TOL}")
    flush = np.asarray(pred.flush_ms)
    return {"records": n, "batch_size": STREAM_BATCH,
            "flushes": pred.batches_run, "records_per_s": n / wall,
            "flush_ms_p50": float(np.percentile(flush, 50)),
            "flush_ms_p99": float(np.percentile(flush, 99)),
            "max_abs_gap_vs_model_predictor": gap, "tol": STREAM_TOL}


def _keras_layer(cls, **cfg):
    return {"class_name": cls, "config": cfg}


def keras_configs(np):
    """11e's three Keras configs (as ``model.get_config()`` writes them)
    and seeded ``get_weights()`` lists: the reference's CIFAR-10 CNN
    vocabulary, a functional block with an Add skip connection, and an
    Embedding -> LSTM -> GRU -> Dense text model. Returns [(name, config,
    weights, input shape, integer vocabulary or None)]."""
    rng = np.random.default_rng(21)
    w, seq = [], []

    def conv(cin, cout):
        w.extend([(rng.normal(size=(3, 3, cin, cout))
                   * np.sqrt(2.0 / (9 * cin))).astype(np.float32),
                  (rng.normal(size=cout) * 0.05).astype(np.float32)])
        return _keras_layer("Conv2D", filters=cout, kernel_size=[3, 3],
                            padding="same", activation="relu")

    def bn(c):
        w.extend([(1 + 0.1 * rng.normal(size=c)).astype(np.float32),
                  (0.1 * rng.normal(size=c)).astype(np.float32),
                  (0.1 * rng.normal(size=c)).astype(np.float32),
                  rng.uniform(0.5, 1.5, size=c).astype(np.float32)])
        return _keras_layer("BatchNormalization", epsilon=1e-3)

    def dense(cin, cout, act):
        w.extend([(rng.normal(size=(cin, cout)) / np.sqrt(cin)
                   ).astype(np.float32),
                  (rng.normal(size=cout) * 0.05).astype(np.float32)])
        return _keras_layer("Dense", units=cout, activation=act)

    cin, hw = KERAS_CNN["input"][2], KERAS_CNN["input"][0]
    for width in KERAS_CNN["widths"]:
        seq += [conv(cin, width), bn(width), conv(width, width), bn(width),
                _keras_layer("MaxPooling2D", pool_size=[2, 2]),
                _keras_layer("Dropout", rate=0.25)]
        cin, hw = width, hw // 2
    seq += [_keras_layer("Flatten"), dense(hw * hw * cin, KERAS_CNN["dense"],
                                           "relu"),
            _keras_layer("Dropout", rate=0.5), dense(KERAS_CNN["dense"], 10,
                                                     "softmax")]
    cnn = {"name": "cifar10_cnn", "layers": [_keras_layer(
        "InputLayer", batch_shape=[None] + list(KERAS_CNN["input"]))] + seq}
    out = [("sequential_cifar_cnn", cnn, w, KERAS_CNN["input"], None)]

    # the weights in layer order: c1's kernel and bias, c2's, the head's
    w = []
    c = KERAS_CNN["widths"][0]
    c1 = conv(KERAS_CNN["input"][2], c)["config"]
    c2 = dict(conv(c, c)["config"], activation="linear")
    dense(c, 10, "softmax")

    def node(cls, name, parents, **cfg):
        return {"class_name": cls, "name": name,
                "config": dict(cfg, name=name),
                "inbound_nodes": [[[p, 0, 0, {}] for p in parents]]
                if parents else []}

    graph = {"name": "skip_block", "layers": [
        node("InputLayer", "in", [],
             batch_shape=[None] + list(KERAS_CNN["input"])),
        node("Conv2D", "c1", ["in"], **c1),
        node("Conv2D", "c2", ["c1"], **c2),
        node("Add", "skip", ["c1", "c2"]),
        node("Activation", "act", ["skip"], activation="relu"),
        node("MaxPooling2D", "pool", ["act"], pool_size=[2, 2]),
        node("GlobalAveragePooling2D", "gap", ["pool"]),
        node("Dense", "head", ["gap"], units=10, activation="softmax")],
        "input_layers": [["in", 0, 0]], "output_layers": [["head", 0, 0]]}
    out.append(("functional_add_skip", graph, w, KERAS_CNN["input"], None))

    V, E, U, T = (KERAS_TEXT[k] for k in ("vocab", "embed", "units", "T"))
    w = [(rng.normal(size=(V, E)) * 0.1).astype(np.float32)]
    for cls, cin, gates in (("LSTM", E, 4), ("GRU", U, 3)):
        w += [(rng.normal(size=(cin, gates * U)) / np.sqrt(cin)
               ).astype(np.float32),
              (rng.normal(size=(U, gates * U)) / np.sqrt(U)
               ).astype(np.float32),
              (rng.normal(size=(gates * U,) if cls == "LSTM"
                          else (2, gates * U)) * 0.05).astype(np.float32)]
    dense(U, 10, "softmax")
    text = {"name": "text", "layers": [
        _keras_layer("InputLayer", batch_shape=[None, T], dtype="int32"),
        _keras_layer("Embedding", input_dim=V, output_dim=E),
        _keras_layer("LSTM", units=U, return_sequences=True),
        _keras_layer("GRU", units=U),
        _keras_layer("Dense", units=10, activation="softmax")]}
    out.append(("embedding_lstm_gru", text, w, (T,), V))
    return out


def keras_phase(torch, np, dk):
    """11e: each config through from_keras_config on the card at f32 (no
    TF32) against an f64 copy on the CPU; then SingleTrainer trains the
    CNN one epoch with its softmax stripped."""
    rng = np.random.default_rng(22)
    out = {}
    for name, config, weights, shape, vocab in keras_configs(np):
        x = (rng.integers(0, vocab, size=(KERAS_ROWS,) + tuple(shape))
             if vocab else rng.uniform(0, 1, size=(KERAS_ROWS,)
                                       + tuple(shape)).astype(np.float32))
        card = dk["from_keras_config"](config, weights, precision="highest",
                                       device=DEV)
        cpu = dk["from_keras_config"](config, weights, device="cpu")
        cpu.module.double()
        with torch.no_grad():
            got = card.module(x).cpu().numpy()
            want = cpu.module(x).numpy()
        gap = _delta(np, got, want)
        if not gap <= KERAS_TOL:
            raise AssertionError(f"11e {name}: card f32 vs CPU f64 relative "
                                 f"gap {gap} > {KERAS_TOL}")
        out[name] = {"module": type(card.module).__name__,
                     "params": sum(p.numel() for p in
                                   card.module.parameters()),
                     "rel_gap_vs_cpu_f64": gap}
        del card, cpu
    name, config, weights, shape, _ = keras_configs(np)[0]
    model = dk["from_keras_config"](config, weights, strip_final_softmax=True,
                                    device=DEV)
    xs, y = cifar_rows(np, KERAS_TRAIN_ROWS)
    ds = dk["PartitionedDataset"].from_arrays(
        {"features": xs, "label": np.eye(10, dtype=np.float32)[y]})
    tr = dk["SingleTrainer"](model.module, **KERAS_TRAIN)
    t0 = time.perf_counter()
    tr.train(ds)
    wall = time.perf_counter() - t0
    losses = [h["loss"] for h in tr.history]
    if len(losses) != KERAS_TRAIN_ROWS // KERAS_TRAIN["batch_size"] or \
            not np.isfinite(losses).all():
        raise AssertionError(f"11e: imported CNN's losses {losses}")
    out["single_trainer"] = {"steps": len(losses), "first_loss": losses[0],
                             "last_loss": losses[-1], "wall_s": wall}
    del model, tr
    _free(torch)
    return out


def job_phase(torch, np, dk, shard_dir, here, cards=None):
    """11f: a Job of 2 local processes trains DataParallelTrainer from
    11a's shards, one card each over NCCL (gloo on the CPU); both ranks
    must end bit-identical. Skipped, and said so, below two cards."""
    cards = torch.cuda.device_count() if cards is None else cards
    if cards < 2:
        return {"phase": "11f", "skipped": "one card"}
    out = tempfile.mkdtemp(dir=os.path.dirname(shard_dir))
    cfg = {"out": out, "shards": shard_dir, "device": DEV,
           "train": STREAM_CIFAR_TRAIN, "widths": JOB_WIDTHS}
    job = dk["Job"](os.path.join(here, "chip_smoke.py"),
                    ["--phase11f-worker", json.dumps(cfg)],
                    hosts=["local", "local"], python=sys.executable,
                    coordinator_port=_free_port(), ps_port=_free_port(),
                    env={"PYTHONPATH": here})
    t0 = time.perf_counter()
    procs = job.run(wait=False)
    try:
        codes = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if codes != [0, 0]:
        raise AssertionError(f"11f: job processes exited {codes}")
    ranks = [json.load(open(os.path.join(out, f"rank{r}.json")))
             for r in (0, 1)]
    shutil.rmtree(out)
    if ranks[0]["digest"] != ranks[1]["digest"] or \
            ranks[0]["history"] != ranks[1]["history"]:
        raise AssertionError("11f: the two ranks ended with different "
                             "parameters or histories")
    losses = [h["loss"] for h in ranks[0]["history"]]
    if not np.isfinite(losses).all():
        raise AssertionError(f"11f: losses not finite: {losses}")
    return {"phase": "11f", "processes": 2, "backend": ranks[0]["backend"],
            "steps": len(losses), "batches_per_rank": ranks[0]["batches"],
            "bit_identical": True, "wall_s": wall,
            "digest": ranks[0]["digest"]}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def job_worker(cfg_json: str) -> int:
    """One process of 11f's Job (``chip_smoke.py --phase11f-worker
    <json>``): join the world from the DK_TPU_* environment, train
    DataParallelTrainer from the shards, write the parameters' digest."""
    import hashlib

    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distkeras_torch import runtime, trainers
    from distkeras_torch.data.shard_io import ShardedDataset
    from distkeras_torch.models import get_model
    from distkeras_torch.ops import rules

    cfg = json.loads(cfg_json)
    cpu = cfg["device"] == "cpu"
    ctx = runtime.initialize(device="cpu" if cpu else None)
    dev = ctx.device
    model = get_model("cifar_cnn", device=dev, seed=0,
                      widths=tuple(cfg["widths"]))
    tr = trainers.DataParallelTrainer(model, **cfg["train"])
    seen = []
    windows = tr._stream_windows

    def counted(*a):
        inner = windows(*a)

        def feed(epoch):
            for xs, ys in inner(epoch):
                seen.append(len(xs))
                yield xs, ys
        return feed

    tr._stream_windows = counted
    tr.train(ShardedDataset(cfg["shards"]))
    h = hashlib.sha256()
    for k, v in sorted(rules.flatten(tr.params).items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    with open(os.path.join(cfg["out"], f"rank{ctx.process_id}.json"),
              "w") as fh:
        json.dump({"digest": h.hexdigest(), "history": tr.history,
                   "batches": sum(seen),
                   "backend": torch.distributed.get_backend()}, fh)
    runtime.shutdown()
    return 0


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
        from distkeras_torch import bench, bridge, telemetry
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
        from distkeras_torch.utils.losses import get_loss, get_optimizer
        from distkeras_torch.workers import make_window_step
        from distkeras_torch import evaluators, predictors, trainers
        from distkeras_torch import transformers as stages
        from distkeras_torch.parameter_servers import DeltaParameterServer
        from distkeras_torch import streaming
        from distkeras_torch.checkpoint import Checkpointer
        from distkeras_torch.data import shard_io, text
        from distkeras_torch.job_deployment import Job
        from distkeras_torch.models.wrapper import Model
        from distkeras_torch.ops import rules
        from distkeras_torch.utils.keras_import import from_keras_config
    except ImportError as e:
        return _fail(f"run from a checkout of the repository ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dk = {"telemetry": telemetry, "get_model": get_model, "bridge": bridge,
          "generate": generate, "ServingEngine": ServingEngine,
          "serving_requests": serving_requests,
          "make_lm_train_step": make_lm_train_step,
          "get_optimizer": get_optimizer, "lm_step_flops": lm_step_flops,
          "peak_flops": peak_flops, "LMTrainer": LMTrainer,
          "PartitionedDataset": PartitionedDataset, "make_mesh": make_mesh,
          "pair_kernel_block": _pair_kernel_block, "bench": bench,
          "get_loss": get_loss, "make_window_step": make_window_step,
          "SingleTrainer": trainers.SingleTrainer,
          "AveragingTrainer": trainers.AveragingTrainer,
          "EnsembleTrainer": trainers.EnsembleTrainer,
          "DataParallelTrainer": trainers.DataParallelTrainer,
          "ModelPredictor": predictors.ModelPredictor,
          "AccuracyEvaluator": evaluators.AccuracyEvaluator,
          "MinMaxTransformer": stages.MinMaxTransformer,
          "ReshapeTransformer": stages.ReshapeTransformer,
          "OneHotTransformer": stages.OneHotTransformer,
          "LabelIndexTransformer": stages.LabelIndexTransformer,
          "DeltaParameterServer": DeltaParameterServer,
          **{name: getattr(trainers, name) for name in PS_NAMES},
          "write_shards": shard_io.write_shards,
          "ShardedDataset": shard_io.ShardedDataset,
          "native_dataio_active": shard_io.native_dataio_active,
          "text": text, "Checkpointer": Checkpointer, "Model": Model,
          "StreamingPredictor": streaming.StreamingPredictor,
          "RecordProducer": streaming.RecordProducer,
          "socket_source": streaming.socket_source,
          "from_keras_config": from_keras_config, "Job": Job,
          "rules": rules}

    smi = nvidia_smi()
    kern = build.load()
    fwd_facts = fwd_build_facts(build, kern, CAUSAL["hd"])
    bwd_facts = bwd_build_facts(build, kern)
    _emit({"env": {
        "nvidia_smi": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvcc": _nvcc_version(build),
        "python": sys.version.split()[0],
        "kernel_build_s": kern.seconds, "forward_build": fwd_facts,
        "backward_build": bwd_facts,
        "device": torch.cuda.get_device_name(0),
    }})
    t0 = time.perf_counter()
    paged = paged_cases(torch, F, pa)
    splash = splash_cases(torch, F, sp)
    edges = edge_cases(torch, pa, sp)
    _emit({"kernel_phase": {"paged_attention": paged,
                            "splash_prefill": splash, "edges": edges,
                            "seconds": time.perf_counter() - t0}})

    t0 = time.perf_counter()
    serving, launches, routes, chunked = serving_phase(torch, np, dk, pa,
                                                      sp)
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

    t0 = time.perf_counter()
    cifar = cifar_phase(torch, np, dk)
    cifar["seconds"] = time.perf_counter() - t0
    _emit({"cifar_phase": cifar})

    t0 = time.perf_counter()
    mnist = mnist_phase(torch, np, dk)
    mnist["seconds"] = time.perf_counter() - t0
    _emit({"mnist_workflow_phase": mnist})

    t0 = time.perf_counter()
    ps_cifar = ps_cifar_phase(torch, np, dk)
    ps_cifar["seconds"] = time.perf_counter() - t0
    _emit({"ps_cifar_phase": ps_cifar})

    t0 = time.perf_counter()
    quick = quickstart_phase(torch, np, dk)
    quick["seconds"] = time.perf_counter() - t0
    _emit({"quickstart_phase": quick})

    t0 = time.perf_counter()
    cnn = get_model("cifar_cnn", device=DEV, seed=0)
    witness = ps_witness(torch, np, dk, cnn)
    witness["seconds"] = time.perf_counter() - t0
    _emit({"ps_witness_phase": witness})
    _emit({"ps_roundtrip_phase": ps_roundtrip(torch, dk, cnn)})
    del cnn

    t0 = time.perf_counter()
    modes = modes_phase(torch, np, dk, pa, sp, chunked)
    modes["seconds"] = time.perf_counter() - t0
    _emit({"engine_modes_phase": modes})

    workdir = tempfile.mkdtemp(prefix="dk_phase11_")
    try:
        t0 = time.perf_counter()
        dp, cnn, cifar_sds, cifar_x = dp_stream_phase(torch, np, dk,
                                                      workdir)
        dp["seconds"] = time.perf_counter() - t0
        _emit({"dp_stream_phase": dp})
        t0 = time.perf_counter()
        lm, corpus = lm_stream_phase(torch, np, dk, fa, pp, workdir, here)
        lm["seconds"] = time.perf_counter() - t0
        _emit({"lm_stream_phase": lm})
        t0 = time.perf_counter()
        resume = resume_phase(torch, np, dk, workdir, corpus)
        resume["seconds"] = time.perf_counter() - t0
        _emit({"resume_phase": resume})
        t0 = time.perf_counter()
        stream = streaming_phase(torch, np, dk, cnn, cifar_x)
        stream["seconds"] = time.perf_counter() - t0
        _emit({"streaming_phase": stream})
        del cnn, cifar_x
        t0 = time.perf_counter()
        keras = keras_phase(torch, np, dk)
        keras["seconds"] = time.perf_counter() - t0
        _emit({"keras_phase": keras})
        _emit(job_phase(torch, np, dk, cifar_sds.directory, here))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    main_paged = next(c for c in paged if c["T"] == 64 and c["pool"] == "int8")
    main_splash = next(c for c in splash if c["dtype"] == "bf16")
    timed = ("T", "hd", "pool", "dtype", "starts", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")
    rows = []
    for name, src, rep, case, cases in (
            ("paged_attention", "distkeras_torch/csrc/paged_attention.cu",
             "distkeras_tpu/ops/paged_attention.py:166", main_paged,
             paged + [c for c in edges if c["kernel"] == "paged"]),
            ("splash_prefill", "distkeras_torch/csrc/splash_prefill.cu",
             "distkeras_tpu/ops/splash_prefill.py:163", main_splash,
             splash + [c for c in edges if c["kernel"] == "splash"])):
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            # the main path's launches by what each ran (launch_route)
            "kernels_run": routes[name],
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"],
            # every timed shape of the main path (the row's own numbers
            # are the first one's): decode, chunk, verify, monolithic
            "shapes": [{k: c[k] for k in timed if k in c}
                       for c in cases if "ms" in c],
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
        if name in fwd_facts:
            rows[-1]["build"] = fwd_facts[name]
        if name in bwd_facts:
            # by hd; SDPA's backward alone is the yardstick of dq and dk/dv
            # together (no single call computes either alone)
            rows[-1]["build"] = bwd_facts[name]
            rows[-1]["bwd_ms"] = main_causal["bwd_ms"]
            rows[-1]["bwd_library_ms"] = main_causal["bwd_library_ms"]
            rows[-1]["sdpa_backend"] = main_causal["sdpa_backend"]
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
            if name in fwd_facts:
                rows[-1]["build"] = fwd_facts[name]
            if name in bwd_facts:
                # by hd; SDPA's backward alone (the same products, no lse
                # cotangent) is the yardstick of dq and dk/dv together
                rows[-1]["build"] = bwd_facts[name]
                rows[-1]["bwd_ms"] = main["bwd_ms"]
                rows[-1]["bwd_library_ms"] = main["bwd_library_ms"]
                rows[-1]["sdpa_backend"] = main["sdpa_backend"]
    print(smi, flush=True)
    _emit({"kernels": rows})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--phase11f-worker":
        sys.exit(job_worker(sys.argv[2]))
    sys.exit(main())
