#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``distkeras_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it exits non-zero without printing a result when
CUDA is unavailable or when the port's package is not beside it.
``python3 chip_smoke.py --phase12`` runs phase 12 alone after phase 3
(its yardstick), ``python3 chip_smoke.py --phase13`` phase 13 alone
after phases 6 and 6b (its yardsticks): on a host of two cards or more
their ranks run over NCCL. ``python3 chip_smoke.py --phase14`` runs
phase 14 alone after phase 3 (its yardstick), ``python3 chip_smoke.py
--phase15`` phase 15 alone after phase 3 (its yardstick), ``python3
chip_smoke.py --phase16`` phase 16 alone after phase 3 (its yardstick;
on a host of two cards or more its ranks run over NCCL), ``python3
chip_smoke.py --phase17`` phase 17 alone after phase 2's cases at its
shapes. Phases 14 and 15 run right after phase 4 in the whole smoke,
phase 16 right after phase 12, phase 17 right after phase 10.
``python3 chip_smoke.py --phase18`` runs phase 18 (the examples) alone
after phase 1; in the whole smoke it runs last.

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
   FLOPs over the dtype's peak. Every case is timed, the f32 and
   int8-f32 ones (the FFMA kernels) as the bf16 ones. The bf16 kernels'
   edges, untimed: T=5
   and T=17, G=1 and G=8, hd 64 and 128, rows ending and starting on a
   split boundary, trash-page tails. Then both kernels in f32, timed, at
   phase 4's decode (``PAGED_EXACT``: 4 heads of 64 over 2 KV heads,
   int8 pages) and at phase 17's shapes (``PAGED17``, ``SPLASH17``: 4
   heads of 64, paged T in {1, 16, 5, 64} over 18 pages a row, splash
   T=16 over L=64 and T=64 over L=1056).
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
   kernels (``BF16_ROUTE``, never an f32 one). The share of greedy
   tokens equal to a gather-forced twin engine is printed
   (informational at bf16), with each differing stream's first flip and
   the top-2 logit gap there. Each counted
   engine is marked steady before its mix (``mark_steady()``, after the
   warm-up engines ran): the mix must build, load and first-launch no
   kernel configuration (``recompiles_since_mark()`` empty), and the
   process totals of kernel builds, loads and first launches print.
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
   CPU copy, and ``Model(model).beam_search`` on the card equal to both,
   its prefill on the splash kernel (launches counted around the call).
   A mismatch fails with each differing greedy stream's first flip and
   top-2 logit gap.
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
   >= 0.9; prints samples/s per trainer. (8c) The synchronous
   data-parallel step, ``parallel.spmd.make_dp_train_step`` over
   ``parallel.mesh.default_mesh()`` (a world of one): ``mnist_cnn`` in
   f32 from seed 0, 3 Adam steps on batches of 128 of 8b's digits (seed
   12), against ``workers.make_train_step`` on the same weights and
   batches (cuDNN pinned deterministic for this phase): losses and
   weights equal bit for bit; prints ms a step of each beside the card's
   name and power limit. This phase adds no hand-written kernel:
   convolutions run through cuDNN and dense products through cuBLAS, as
   XLA computes them in the reference.
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
12. **Tensor parallelism (tp=2).** Two ranks, subprocesses of this
   script (``--phase12-worker``), started after the kernels are built:
   one card each over NCCL with two cards or more, else both on the one
   card over gloo on CUDA tensors; the phase's line says which backend
   and how many cards ran. (12a) An f32 witness first: phase 4's
   ``EXACT`` widths, one SGD step of ``make_lm_train_step(tp_axis='tp')``
   on [2, 128] tokens — its loss and the gathered parameters within 1e-5
   of the tp=1 step on the same weights and tokens. Then phase 6's
   flagship (d2048/h8/L8/v8192, bf16 with f32 masters, T=2048, AdamW
   3e-4, bf16 first moment, fused CE) at tp=2 for 3 steps, B=8 with two
   cards or more, B=2 on one card (gloo stages every all-reduce through
   the host): every loss finite and within 5e-2 of the tp=1 step's
   (rank 0 runs it), the replicated parameters bit-identical across the
   ranks, each causal kernel (forward, dq, dk/dv) launched layers x
   steps times on each rank at [B, 2048, 4, 256]; prints ms/step and
   tok/s. (12b) The f32 witness: phase 4's model through chunked,
   monolithic, pipelined, multi-step k=4 and n-gram engines on both
   layouts, the host tier's churn and a block export -> import both
   ways between a tp=2 and a tp=1 engine — every stream equal to the
   tp=1 engine's token for token on each rank. Then phase 3's flagship
   (2 KV heads: one a rank) on phase 3's mix, paged and slot, chunked:
   the streams bit-identical across the ranks, the paged and splash
   launches of each rank equal to phase 3's counts; prints the share of
   greedy tokens equal to phase 3's, each flip's ``top2_gap``, ms/tick
   and tok/s (on one card the ranks share it: not a tp speed).
13. **Pipeline, experts and the ring at sp=2.** (13b, in this process)
   the MoE twin of phase 6's flagship (``moe_lm``: 8 experts of 2048 x
   8192, top-1, capacity factor 1.25; ~2.3 B parameters) at ep=1, 3
   AdamW steps on phase 6's first batch: losses finite and falling, the
   causal kernels launched layers x steps times; prints ms/step, tok/s,
   peak memory, each layer's share of dropped (token, choice) pairs and
   the aux loss. Then two ranks (``--phase13-worker``, as phase 12's:
   NCCL one card each on two cards or more, else gloo on the one card,
   every permute, all-to-all and all-reduce staged through the host).
   Each first runs three f32 witnesses at phase 4's widths, one SGD step
   each: pp=2 (M=4) against the unsharded step and sp=2 against sp=1
   (loss and gathered weights within 1e-5), and the MoE step at ep=2
   against dp=2 x ep=1 on the same rows (within 1e-6). Then (13a) phase
   6's flagship, weights and first 3 batches at pp=2, M=8 microbatches
   of 1 row, AdamW: every loss within 5e-2 of phase 6's, the replicated
   embedding, final norm and head bit-identical across the stages, each
   causal kernel launched 4 layers x 8 microbatches x 3 steps times a
   rank at [1, 2048, 8, 256]; (13b) the MoE flagship at ep=2 for 2
   steps: losses finite and equal on both ranks, the replicated leaves
   bit-identical; (13c) phase 6b's ring at sp=2 (two 512-token zigzag
   chunks a rank) for 3 steps through the bucketed gradient reduce:
   every loss within 5e-2 of phase 6b's, the replicas bit-identical,
   each pair kernel launched as ``pair_per_layer(2)`` predicts. Prints
   ms/step, tok/s and peak memory a rank, the bubble (pp-1)/(M+pp-1),
   the all-reduces a step against the per-parameter count (on one card
   the ranks share it: not a parallel speed). Then the causal kernels at
   the pp microbatch [1, 2048, 8, 256] and the pair kernels at the sp=2
   chunk [8, 512, 8, 256], timed as phases 5 and 5b time theirs.

14. **One server.** (14a) Phase 3's flagship and 16-request mix behind
   ``LMServer(engine, slo=SloMonitor(default_serving_rules()),
   watchdog_timeout_s=30)`` on loopback, paged then slot (each after a
   two-request warm-up through its own server): 4 ``ServingClient``
   connections, one thread a request that submits and reads its stream
   frame by frame, stamping each frame's arrival. Every request ends
   ``length`` with its full count of in-vocab tokens; the launch counts
   (zeroed just before each counted run) show the paged kernel in every
   layer of every tick and splash in every layer of every chunk tick,
   every route a bf16 split kernel; ``stats``, ``metrics``,
   ``timeseries``, ``flight``, ``alerts``, ``events`` (after a drain and
   an undrain) and ``chrome_trace`` answer with content; ``stop()``
   joins every thread; each counted engine is marked steady before its
   mix and ``recompiles_since_mark()`` must be empty after it, as in
   phase 3. Prints tok/s over the wire beside phase 3's,
   client TTFT and inter-token p50/p99, ms a tick and the share of greedy
   tokens equal to phase 3's streams (informational at bf16: admission
   over the wire changes which rows share a tick). (14b) Phase 4's f32
   model with the kernels on, behind pipelined servers on both layouts:
   greedy streams over TCP equal ``generate()``; a ``push_weights`` of
   phase 4's swap weights sent once six streams have their first token
   drops none, moves the version to 2 and lands while at least one is
   still in flight (its ``finish`` span carries version 2; the count is
   ``streams_across_push``), and greedy requests admitted after
   its ack equal an engine built on those weights (sampled ones are
   counted); ``export_kv`` from a prefill server and ``import_kv`` into
   a decode server give a stream equal to ``generate()`` served from the
   migrated prefix; a control call holding the loop for 3x the
   watchdog's 0.5 s while requests queue writes a postmortem that
   ``report.report_flight`` renders as a stall. Any exception that ends
   a server, handler, pump or loop thread fails the phase (collected
   through ``threading.excepthook``). The whole phase runs under the
   port's lock-order detector (every lock allocated from
   ``distkeras_torch`` meanwhile): a cycle fails it, the edge count
   prints.
15. **The fleet.** (15a) Phase 3's flagship and mix through
   ``Router(policy="affine")`` over three paged replicas on the card,
   each over a model of its own (int8 cache, 8 slots, 64-token chunks;
   a throwaway warm-up request each), 4 clients as in phase 14: every
   request ends ``length`` with its full count; the router's routed
   counts (per replica, equal to what each replica served) and spills
   account for all 16; the 12 prompts sharing the system prefix land on
   one replica unless routed as a spill; the paged kernel's launches
   (zeroed just before) cover every layer of every tick of every
   replica, all bf16 split routes. Then the same through one ``prefill``
   replica (monolithic prefill) and two ``decode`` replicas with
   ``disagg_prompt_tokens=512``: the router's ``kv_migrations`` equals
   the count of prompts of >= 512 tokens, each a one-token run on the
   prefill replica. Printed, not gated: fleet tok/s, client TTFT and
   inter-token p50/p99, ms a tick a replica, beside phase 3's engine
   and phase 14a's server (when it ran). (15b) Phase 4's f32 model with
   the kernels on, pipelined paged replicas: greedy streams through the
   router equal ``generate()`` and seeded sampled ones a solo engine's;
   (1) with every stream's first token out, the replica holding the most
   streams is held and stopped: every stream completes equal, ``failed``
   0, at least one ``replayed``; (2) ``rolling_update`` to phase 4's
   swap weights with streams in flight: never fewer than n-1 routable,
   version 2 everywhere, no stream dropped, greedy requests after it
   equal an engine built on the new weights; (3) a prefill -> decode
   migration gives streams equal to ``generate()``; (4) an
   ``Autoscaler`` whose ``spawn`` builds a fresh server on the card
   scales up under queue pressure and back down, and ``replay()``
   reproduces its decisions. Replicas never share a model's parameters
   (checked); any exception in a router, manager, server, pump or loop
   thread fails the phase. The whole phase runs under the lock-order
   detector, as phase 14.
16. **A tensor-parallel server.** Two ranks (``--phase16-worker``, as
   phase 12's: NCCL one card each on two cards or more, else gloo on
   the one card), each building the same tp=2 engine and
   ``LMServer``: rank 0 serves the wire, rank 1 follows its lock-step
   loop; this process plays the clients and tells rank 0 when to
   ``stop()`` (files in the phase's directory). (16a) Phase 3's bf16
   flagship (2 KV heads: one a rank; int8 cache; 8 slots; 64-token
   chunks), paged then slot, after a short warm-up of a tp engine
   driven directly: phase 3's 16 requests from 4 clients; every
   request ``length`` with its full count, the follower's kept streams
   bit-identical to the leader's and its ticks equal, each rank's paged
   launches >= its ticks x layers (splash: chunk ticks x layers), all
   bf16 split routes; ``stats``, ``metrics``, ``flight``, ``events``
   (after a drain and an undrain) and ``chrome_trace`` answer; on the
   paged layout one push of the flagship's own weights as version 2
   lands on both ranks (version 2, one swap, every parameter's sum
   unchanged); ``stop()`` ends both loops. Prints tok/s over the wire
   beside phase 3's, 12b's and 14a's (where the run has them), client
   TTFT and inter-token p50/p99, ms a tick, the control record's ms a
   step, the push's bytes, broadcast and swap ms a rank, and the share
   of greedy tokens equal to phase 3's. (16b) Phase 4's f32 model on
   the tp=2 server of each layout against tp=1 servers in this
   process: phase 4's first greedy and first sampled requests one at
   a time, equal token for token; on the paged layout again
   after a push, a reconfigure and a drain (a submit refused while
   draining), against a server built on the new weights, then through a
   ``Router(disagg_prompt_tokens=64)`` with the tp=2 server as its
   prefill replica and a tp=1 decode replica (tp=2 -> tp=1 migrations),
   and an ``export_kv`` from a tp=1 server imported into the tp=2 one
   (tp=1 -> tp=2). A rank that fails fails the phase with its own
   error, which names it.
17. **serve_bench's engine modes.** The seven single-engine modes of
   ``distkeras_torch.serve_bench`` (the Poisson bench, shared prefix,
   host tier, long-prompt interference, speculative with the n-gram
   drafter, pipeline, multi-step) called in this process on the card at
   the reference's default sizes (``SERVE_BENCH_MODES``: f32, d256 or
   d512 with heads of 64, 16-token pages), the launch counts zeroed
   before each. A mode fails unless the kernel its layout uses launched
   (paged attention on the paged engines, splash on the slot engines'
   chunk and verify ticks), every route is the f32 FFMA kernel's
   (``F32_ROUTE``) and every
   ``exact`` check of its result held (stream parity, token counts,
   hits, restores, stall counters, acceptance, dispatch counts, every
   ``*steady_recompiles`` empty); its ``timing`` checks, headline
   numbers, launches and seconds print on its own line. Every mode runs,
   then the phase fails naming each mode that failed.
18. **The examples.** The six modules of ``distkeras_torch/examples/``
   through their stages. 18a ``lm_training`` on one card at the
   flagship's widths with the example's own flags (``LM18``: d_model
   2048, 8 heads, 2 KV heads, 8 layers, vocab 8192, T=2048, rope, 8
   rows a step, lr 3e-4), 8 steps (8 epochs of one batch of rows), then
   ``--sample 32``:
   the losses finite and falling, the causal forward, dq and dk/dv each
   launched once a layer a step, the sample's route and launches
   printed. 18b ``lm_training --sp 2`` on two ranks (``--phase18-worker``,
   each given the ``DK_TPU_*`` environment of a two-process ``Job``:
   gloo when they share a card, NCCL one card each) at the same widths
   cut to 2 layers and 2 steps (one batch, two epochs): the pair kernels launched on both ranks
   as the ring schedules them, the two ranks' parameters bit-identical.
   18c the four dist-keras examples at the reference's defaults: MNIST
   accuracy >= 0.9 for ``single`` and ``dataparallel``, the other
   trainers finite and above chance; CIFAR's losses finite; streaming
   equal to a batch predict; the evaluation from prediction shards equal
   to the in-memory one. 18d ``lm_serving`` at the reference's sizes in
   each mode (default, ``--paged``, ``--prefill-chunk 0``, ``--draft
   ngram``, ``--draft model``, ``--pipeline``, ``--multi-step-k 4``,
   ``--replicas 3``): every f32 stream equal to ``generate()``; at head
   dim 32 no serving kernel takes these shapes, and the route each
   mode ran (``plain``) is printed. ``python3 chip_smoke.py --phase18``
   runs phase 18 alone after phase 1.

Output: JSON lines per phase, the ``nvidia-smi`` line, one
``{"kernels": [...]}`` line (the serving rows carry every timed shape
in ``shapes``, phase 14a's launches in ``server_launches`` and phase
16a's a rank in ``tp_server_launches_per_rank``, phase 17's in
``serve_bench_launches``, the paged row phase 15a's in
``fleet_launches``; the three forward rows and the causal and
pair dq and dk/dv rows also carry their ``build`` facts; the dq and
dk/dv rows carry ``bwd_ms``, the two as the backward runs them with one
prep pass, ``bwd_library_ms``, SDPA's backward, and ``sdpa_backend``;
the causal rows carry ``pp_microbatch`` (phase 13's shape, timed),
``pp_launches_per_rank`` and ``moe_launches``, the pair rows
``sp2_chunk`` and ``sp2_launches_per_rank``; phase 18's launches ride
on the causal rows as ``example_launches`` and on the pair rows as
``example_sp2_launches_per_rank``),
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
# phase 17's shapes (serve_bench's engine modes at the reference's default
# sizes: f32 pools and queries, 4 heads of 64, no GQA), timed in f32:
# paged decode, the pipeline and multi-step legs' 16-token chunk, a
# 5-token verify window and the shared-prefix and host-tier engines'
# 64-token chunk over 16-token pages (the host tier's 18-page rows);
# splash at the 16-token chunk over the 64-token slot cache and at the
# interference bench's 64-token chunk over its 1056-token cache
PAGED17 = dict(S=8, H=4, Hk=4, hd=64, bs=16, MB=18, T=(1, 16, 5, 64))
# phase 4's decode (EXACT: 8 slots, 4 heads of 64 over 2 KV heads, int8
# pages, max_len 256), timed in f32
PAGED_EXACT = dict(S=8, H=4, Hk=2, hd=64, bs=16, MB=16, T=(1,))
SPLASH17 = (dict(S=8, T=16, H=4, Hk=4, hd=64, L=64),
            dict(S=4, T=64, H=4, Hk=4, hd=64, L=1056))
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


def pair_per_layer(sp):
    """Pair launches per layer of one ring step at ``sp`` shards, as the
    zigzag ring runs them: step 0 two wedges and a rectangle, each of
    the sp - 1 ring steps two rectangles, every step checkpointed (its
    forward runs again in the backward)."""
    rects = 1 + 2 * (sp - 1)
    return {"pair_wedge_fwd": 4, "pair_rect_fwd": 2 * rects,
            "pair_wedge_dq": 2, "pair_rect_dq": rects,
            "pair_wedge_dkv": 2, "pair_rect_dkv": rects}


PAIR_PER_LAYER = pair_per_layer(1)
# the reference's lm_bench step (bench.py:130-194), phases 6 and 7
TRAIN = dict(vocab_size=8192, d_model=2048, num_heads=8, num_layers=8,
             max_len=2048)
TRAIN_B, TRAIN_W, TRAIN_LR = 8, 5, 3e-4
TRAIN_LOSS_TOL = 5e-2  # kernel path vs the blocked twin, per step
TRAINER_ROWS = 40
# phase 12: tensor parallelism over two ranks; the shard shapes its
# kernels run at (phase 2 and 5 time them beside the full ones)
TP = 2
TP_TRAIN_STEPS = 3
# B with two cards or more, and on one card: two ranks share it over
# gloo, which stages every all-reduce through the host
TP_TRAIN_B = {"cards": 8, "one_card": 2}
TP_WITNESS = dict(B=2, T=128, lr=0.1, tol=1e-5)
TP_MODES = ("chunked", "monolithic", "pipelined", "multi_step", "ngram")
TP_TIMEOUT_S = 900
PAGED_TP = dict(H=4, Hk=1)
SPLASH_TP = dict(H=4, Hk=1)
CAUSAL_TP = dict(H=4, T=(2048,))
# phase 13: pipeline (13a), expert (13b) and sequence (13c) parallelism
# over two ranks at phase 6's flagship: pp=2 with M=8 microbatches of 1
# row; the MoE twin (8 experts, top-1, capacity factor 1.25) at ep=1 in
# this process, then at ep=2; the ring at sp=2 (two 512-token zigzag
# chunks a rank). The f32 witnesses at phase 4's widths (EXACT): pp=2 and
# sp=2 against the unsharded step within 1e-5, ep=2 against dp=2 x ep=1
# on the same rows within 1e-6, one SGD step each
P13 = 2
PP_MICRO = 8
P13_STEPS = 3
MOE = dict(moe_experts=8, moe_top_k=1)
MOE_EP_STEPS = 2
P13_WITNESS = dict(M=4, B=2, T=128, lr=0.1, pp_tol=1e-5, ep_tol=1e-6,
                   sp_tol=1e-5)
P13_TIMEOUT_S = 900
# the kernels' shapes on phase 13's path: one pp microbatch, one sp=2
# rank's chunk
CAUSAL_PP = dict(B=1, T=(2048,))
PAIR_SP2 = dict(C=(512,))
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
# phase 8c: the dp step against make_train_step (MNIST_TRAIN's batch and
# Adam rate)
DP_STEP = dict(rows=128, steps=3, lr=1e-3)
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
# phase 14: the server. Four clients; the stall watchdog's timeout at
# full width (14a: a tick never takes this long) and in 14b's stall
# check (it holds the loop for 3x it); stop()'s join timeout
SERVER_CLIENTS = 4
FLAGSHIP_WATCHDOG_S = 30.0
WATCHDOG_S = 0.5
SERVER_STOP_S = 10.0
# phase 15: the fleet. Three replicas, a model each; 15a's disaggregated
# pass sends prompts of at least this many tokens through the prefill
# replica
FLEET_REPLICAS = 3
FLEET_DISAGG_TOKENS = 512
# phase 16: the tp=2 server. The longest the parent and the ranks wait
# for each other's files; 16b's router sends prompts of at least this
# many tokens through the tp=2 prefill replica (all of phase 4's)
TP_SERVER_WAIT_S = 600
TP_SERVER_DISAGG_TOKENS = 64
# phase 18: the examples. 18a: lm_training's own flags at the flagship's
# widths (3e-4: the example's help for flagship-size models), 8 steps,
# then a 32-token sample. The steps are 8 epochs of one batch of rows:
# over 8 distinct batches the loss did not fall (each row's pattern is
# learned in context, after many more steps; PERF.md, PR 19)
LM18 = ["--d-model", "2048", "--heads", "8", "--kv-heads", "2",
        "--layers", "8", "--vocab", "8192", "--seq-len", "2048", "--rope",
        "--batch-size", "8", "--lr", "3e-4"]
LM18_STEPS = 8
LM18_SAMPLE = 32
# 18b: the same at sp=2 over two ranks, cut to 2 layers and 2 steps (one
# batch, two epochs: two steps cannot show a falling loss on two batches)
LM18_SP = dict(sp=2, layers=2, steps=2)
P18_TIMEOUT_S = 600
# 18c: the four dist-keras examples' flags (none: the reference's
# defaults, nothing cut)
EXAMPLES18 = {"mnist_workflow": [], "cifar10_training": [],
              "streaming_inference": [], "bigdata_pipeline": []}
MNIST18_STRICT = ("single", "dataparallel")  # held to MNIST_MIN_ACCURACY
# 18d: lm_serving at the reference's sizes, one run a mode flag
SERVING18 = {"default": [], "paged": ["--paged"],
             "monolithic": ["--prefill-chunk", "0"],
             "ngram": ["--draft", "ngram"], "draft_model": ["--draft", "model"],
             "pipeline": ["--pipeline"], "multi_step": ["--multi-step-k", "4"],
             "replicas": ["--replicas", "3"]}


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


def paged_cases(torch, F, pa, over=None,
                kinds=("bf16", "int8", "f32", "int8-f32"),
                timed=("bf16", "int8", "f32", "int8-f32")):
    """The paged kernel at phase 2's shapes, with ``over`` replacing some
    of them (``PAGED_TP``: one tp=2 rank's heads; ``PAGED17``: phase 17's
    f32 shapes), for each pool of ``kinds``, those of ``timed`` timed."""
    cfg = dict(PAGED, **(over or {}))
    S, H, Hk, hd, bs, MB = (cfg[k] for k in ("S", "H", "Hk", "hd", "bs",
                                              "MB"))
    P = S * MB + 1
    gen = torch.Generator(device=DEV).manual_seed(1)
    cases = []
    for T in cfg["T"]:
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
        for kind in kinds:
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
            case = {"T": T, "H": H, "Hk": Hk, "pool": kind,
                    "max_abs_err": err, "tol": tol,
                    # the exact result's own rounding to the output dtype
                    "out_rounding": (ref.to(dt).float() - ref).abs().max()
                    .item()}
            if kind in timed:
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
                    nbytes, _work(torch, lens, T, H, hd),
                    str(dt).split(".")[-1])
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


def splash_cases(torch, F, sp, over=None, more=None, v_std=1.0,
                 kinds=("bf16", "f32"), timed=("bf16", "f32")):
    """The splash kernel at phase 2's shapes (``over`` replacing some of
    the main one's, ``more`` the other shapes, ``SPLASH_MORE`` by
    default; values drawn at ``v_std``) in each dtype of ``kinds``, those
    of ``timed`` timed."""
    cfg = dict(SPLASH, **(over or {}))
    more = SPLASH_MORE if more is None else more
    S, Hk, L = cfg["S"], cfg["Hk"], cfg["L"]
    gen = torch.Generator(device=DEV).manual_seed(2)
    shapes = ((cfg["T"], cfg["hd"], cfg["H"], "depth"),) + tuple(more)
    cases = []
    for T, hd, H, start_kind in shapes:
        starts = (torch.zeros(S, dtype=torch.int32, device=DEV)
                  if start_kind == "zero" else
                  torch.tensor(_depths(S, L - T), dtype=torch.int32,
                               device=DEV))
        for kind in kinds:
            dt = torch.float32 if kind == "f32" else torch.bfloat16
            q = torch.randn((S, T, H, hd), generator=gen, device=DEV).to(dt)
            k = torch.randn((S, L, Hk, hd), generator=gen, device=DEV).to(dt)
            v = (v_std * torch.randn((S, L, Hk, hd), generator=gen,
                                     device=DEV)).to(dt)
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
            case = {"T": T, "L": L, "hd": hd, "H": H, "Hk": Hk,
                    "starts": start_kind, "dtype": kind, "max_abs_err": err,
                    "tol": tol, "out_rounding": (ref.to(dt).float() - ref)
                    .abs().max().item()}
            if kind in timed:
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
                    nbytes, _work(torch, starts, T, H, hd),
                    str(dt).split(".")[-1])
            cases.append(case)
    return cases


# -- phase 5: the training kernels against their plain versions ---------


def causal_cases(torch, F, fa, over=None):
    """The causal kernels at phase 5's shapes (``over`` replacing some:
    ``CAUSAL_TP``, one tp=2 rank's heads); the first T is timed."""
    cfg = dict(CAUSAL, **(over or {}))
    B, H, hd = cfg["B"], cfg["H"], cfg["hd"]
    gen = torch.Generator(device=DEV).manual_seed(7)
    cases = []
    for T in cfg["T"]:
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
        case = {"T": T, "H": H, "out_abs_err": (out.float() - ref_out)
                .abs().max().item(),
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
        if T == cfg["T"][0]:
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


def pair_cases(torch, F, pp, over=None):
    """The pair kernels at phase 5b's shapes (``over`` replacing some:
    ``PAIR_SP2``, the sp=2 ring's chunk); the first C is timed."""
    cfg = dict(PAIR, **(over or {}))
    B, H, hd = cfg["B"], cfg["H"], cfg["hd"]
    gen = torch.Generator(device=DEV).manual_seed(8)
    bf16 = torch.bfloat16
    cases = []
    for C in cfg["C"]:
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
            if C == cfg["C"][0]:
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


def mnist_rows(np, rows, seed=0):
    """examples/mnist_workflow.py's synthetic digits: a noisy prototype per
    class, ``[rows, 784]`` f32 in [0, 255], and the labels."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0, 255, size=(10, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=rows)
    x = np.clip(protos[y] + rng.normal(scale=64.0, size=(rows, 784)), 0,
                255).astype(np.float32)
    return x, y


def mnist_dataset(np, dk, rows=None):
    """:func:`mnist_rows` through MinMax -> Reshape -> OneHot."""
    x, y = mnist_rows(np, rows or MNIST_ROWS)
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


def dp_step_phase(torch, np, dk, smi):
    """8c: ``make_dp_train_step`` over ``default_mesh()`` (a world of one)
    against ``workers.make_train_step`` on 8b's digits scaled to [0, 1]:
    the same ops, so the losses and weights must be equal bit for bit
    (see DP_STEP; cuDNN deterministic for both runs). Each step is timed
    alone (a sync on each side)."""
    n, rows = DP_STEP["steps"], DP_STEP["rows"]
    x, y = mnist_rows(np, n * rows, seed=12)
    x = torch.as_tensor(x / 255.0, device=DEV).reshape(n, rows, 28, 28, 1)
    y = torch.as_tensor(np.eye(10, dtype=np.float32)[y],
                        device=DEV).reshape(n, rows, 10)
    loss_fn = dk["get_loss"]("categorical_crossentropy")
    mesh = dk["default_mesh"]()
    init = dk["get_model"]("mnist_cnn", dtype=torch.float32, device=DEV,
                           seed=0).state_dict()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for name in ("dp", "single"):
            model = dk["get_model"]("mnist_cnn", dtype=torch.float32,
                                    device=DEV)
            model.load_state_dict(init)
            opt = dk["get_optimizer"]("adam", DP_STEP["lr"])
            if name == "dp":
                step = dk["make_dp_train_step"](model, loss_fn, opt, mesh)
            else:
                one = dk["make_train_step"](model, loss_fn, opt)

                def step(a, b, one=one):
                    return one(a, b)["loss"]
            losses, ms = [], []
            for i in range(n):
                sync(torch)
                t0 = time.perf_counter()
                losses.append(step(x[i], y[i]))
                sync(torch)
                ms.append((time.perf_counter() - t0) * 1e3)
            runs[name] = (torch.stack(losses).cpu(),
                          {k: v.detach().cpu()
                           for k, v in model.state_dict().items()}, ms)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (dp, dp_w, dp_ms), (one, one_w, one_ms) = runs["dp"], runs["single"]
    if not torch.isfinite(dp).all():
        raise AssertionError(f"8c: dp step losses not finite: {dp}")
    if not torch.equal(dp, one):
        raise AssertionError(f"8c: make_dp_train_step's losses "
                             f"{dp.tolist()} != make_train_step's "
                             f"{one.tolist()}")
    differ = [k for k, v in one_w.items() if not torch.equal(dp_w[k], v)]
    if differ:
        raise AssertionError(f"8c: weights after {n} steps differ from "
                             f"make_train_step's: {differ}")
    return {"mesh": mesh.shape, "model": "mnist_cnn-f32",
            "optimizer": f"adam{DP_STEP['lr']}", "rows": rows, "steps": n,
            "losses": dp.tolist(), "equal_bit_for_bit": True,
            "ms_per_step": dp_ms, "make_train_step_ms_per_step": one_ms,
            "nvidia_smi": smi}


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


def serve(torch, np, dk, model, requests, steady=False, **kw):
    """Drive one engine over ``requests`` (8 slots, 64-token chunks
    unless ``kw`` says otherwise); returns its summary, the streams and
    the engine. With ``steady`` (a warm-up already ran) the engine is
    marked steady before the mix and the summary carries what the mix
    built, loaded or launched for the first time
    (``recompiles_since_mark``)."""
    kw.setdefault("slots", 8)
    kw.setdefault("prefill_chunk", 64)
    if "mesh" not in kw:  # a tp engine runs on its model's device
        kw["device"] = DEV
    eng = dk["ServingEngine"](
        model, registry=dk["telemetry"].MetricRegistry(),
        tracer=dk["telemetry"].Tracer(), **kw)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    if steady:
        eng.mark_steady()
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
    if steady:
        summary["recompiles_since_mark"] = eng.recompiles_since_mark()
    return summary, streams, eng


def steady_check(phase, summary):
    """A warm engine's mix built, loaded and first-launched nothing."""
    got = summary["recompiles_since_mark"]
    if got:
        raise AssertionError(f"{phase}: the mix after the warm-up built, "
                             f"loaded or first-launched {got}")


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
                                        paged=True, block_size=16,
                                        steady=True)
    steady_check("serving phase (paged)", paged_sum)
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
                                      paged=False, steady=True)
    steady_check("serving phase (slot)", slot_sum)
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
        # f32 FFMA kernels
        if not seen or any(not BF16_ROUTE.fullmatch(r) for r in seen):
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
    # process totals by kind (kernel builds, loads, first launches)
    out["recompiles"] = dk["telemetry"].recompiles.counts()
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


def _differ(torch, np, model, requests, got, want, what,
            phase="exact phase"):
    """Fail phase 4 (or ``phase``) on a stream mismatch, naming each
    differing greedy stream's first flip and its top-2 logit gap (a near
    tie shows as a gap at f32's rounding of the logits) and the
    differing sampled requests."""
    if got == want:
        return
    flips = greedy_flips(torch, np, model, requests, got, want)
    sampled = [i for i, ((_, c), x, y) in enumerate(zip(requests, got, want))
               if c.get("temperature", 0.0) != 0.0 and x != y]
    raise AssertionError(f"{phase}: {what}: streams differ (greedy "
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


def exact_beam(torch, np, dk, sp, model):
    """``beam_search(beam_size=4)`` on the card equals the same call on a
    CPU copy of the weights (the plain attends), and ``Model.beam_search``
    on the card equals both, its prefill through the splash kernel."""
    from distkeras_torch.models.transformer import beam_search
    from distkeras_torch.models.wrapper import Model

    cpu = dk["get_model"]("transformer_lm", dtype=torch.float32,
                          device="cpu", seed=3, **EXACT)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    prompt = np.random.default_rng(11).integers(
        0, model.vocab_size, size=(2, 40)).astype(np.int32)
    got = beam_search(model, prompt, 16, beam_size=4).cpu()
    before = sp.splash_prefill_attention.launches
    method = Model(model).beam_search(prompt, 16, beam_size=4)
    launches = sp.splash_prefill_attention.launches - before
    want = beam_search(cpu, prompt, 16, beam_size=4)
    if not torch.equal(got, want):
        raise AssertionError(f"exact phase: beam search on the card "
                             f"{got[:, 40:].tolist()} != on the CPU "
                             f"{want[:, 40:].tolist()}")
    if not np.array_equal(method, got.numpy()):
        raise AssertionError(f"exact phase: Model.beam_search on the card "
                             f"{method[:, 40:].tolist()} != beam_search's "
                             f"{got[:, 40:].tolist()}")
    if launches == 0:
        raise AssertionError("exact phase: Model.beam_search's prefill "
                             "never launched the splash kernel")
    return {"beams_equal": True, "method_equal": True,
            "method_splash_launches": launches, "rows": 2, "beam_size": 4,
            "new": 16}


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
    res["beam_search"] = exact_beam(torch, np, dk, sp, model)
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
        if any(not BF16_ROUTE.fullmatch(r) for r in seen):
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


# -- phase 17: serve_bench's engine modes ------------------------------------


# phase 17: each single-engine mode of distkeras_torch.serve_bench at the
# reference's default sizes (benchmarks/serve_bench.py; f32, 4 heads of
# 64), with these keywords added (none: no cut), and the kernels its
# engines must launch: paged attention on the paged layouts, splash on
# the slot engines' chunk and verify ticks
SERVE_BENCH_MODES = {
    "bench": {}, "bench_shared_prefix": {}, "bench_host_tier": {},
    "bench_long_prompt_interference": {}, "bench_speculative": {},
    "bench_pipeline": {}, "bench_multistep": {}}
SERVE_BENCH_KERNELS = {
    "bench": ("splash_prefill",),
    "bench_shared_prefix": ("paged_attention",),
    "bench_host_tier": ("paged_attention",),
    "bench_long_prompt_interference": ("splash_prefill",),
    "bench_speculative": ("splash_prefill",),
    "bench_pipeline": ("paged_attention", "splash_prefill"),
    "bench_multistep": ("paged_attention", "splash_prefill")}
# the routes the wrappers record (``launch_route``): the bf16 tensor-core
# split kernels and the f32 FFMA split kernels, each with its merge when
# the plan has more than one split
BF16_ROUTE = re.compile(
    r"(paged|splash)_split_kernel bm=\d+ splits=(1|\d+ \+ \1_merge_kernel)")
F32_ROUTE = re.compile(
    r"(paged|splash)_f32_split_kernel bm=\d+ splits="
    r"(1|\d+ \+ \1_f32_merge_kernel)")


def _headline(result):
    """A mode's scalar numbers (histograms, memory and checks left out)."""
    return {k: v for k, v in result.items()
            if k != "checks" and not isinstance(v, (dict, list))}


def serve_bench_phase(torch, pa, sp, sb):
    """Phase 17: each mode of ``SERVE_BENCH_MODES`` called in this
    process on the card, the launch counts and routes zeroed just before
    it. A mode fails unless each kernel of ``SERVE_BENCH_KERNELS`` for it
    launched, every recorded route is the f32 kernel's and every exact
    check of its result held; its timing checks are printed, not gated.
    Every mode runs; the phase then fails naming each mode that did."""
    import contextlib
    import io
    import traceback

    out, failed = {}, {}
    for name, kw in SERVE_BENCH_MODES.items():
        _zero_counts(pa, sp)
        t0 = time.perf_counter()
        line, problems = {"mode": name, "cut": kw or None}, []
        try:
            # the mode's own JSON line (histograms and all) stays out of
            # the smoke's output: the numbers it needs are returned
            with contextlib.redirect_stdout(io.StringIO()):
                res = getattr(sb, name)(device=DEV, **kw)
        except Exception as e:
            res = None
            problems.append(f"raised {type(e).__name__}: {e}")
            line["traceback"] = traceback.format_exc()[-3000:]
        line["seconds"] = time.perf_counter() - t0
        launches = {"paged_attention": pa.paged_attention.launches,
                    "splash_prefill": sp.splash_prefill_attention.launches}
        routes = {"paged_attention": dict(pa.paged_attention.routes),
                  "splash_prefill": dict(sp.splash_prefill_attention.routes)}
        for kern in SERVE_BENCH_KERNELS[name]:
            if launches[kern] == 0:
                problems.append(f"{kern} never launched")
        for kern, seen in routes.items():
            if any(not F32_ROUTE.fullmatch(r) for r in seen):
                problems.append(f"{kern} routes {seen} are not all the f32 "
                                f"split kernels")
        line.update(launches=launches, routes=routes)
        if res is not None:
            missed = [n for n, ok in res["checks"]["exact"].items() if not ok]
            if missed:
                problems.append(f"exact checks missed: {missed}")
            line.update(headline=_headline(res),
                        exact=res["checks"]["exact"],
                        timing=res["checks"]["timing"])
            for key in ("parity_flips", "chunked_parity_flips",
                        "monolithic_parity_flips"):
                if key in res:
                    line[key] = res[key]
        line["ok"] = not problems
        if problems:
            line["problems"] = problems
            failed[name] = problems
        _emit({"serve_bench_mode": line})
        out[name] = line
    if failed:
        raise AssertionError(f"phase 17 (serve_bench's engine modes): "
                             f"{failed}")
    out["launches"] = {k: sum(out[m]["launches"][k] for m in SERVE_BENCH_MODES)
                       for k in ("paged_attention", "splash_prefill")}
    return out


def serve_bench_kernel_cases(torch, F, pa, sp):
    """Phase 2's cases at phase 17's shapes (``PAGED17``, ``SPLASH17``),
    f32, each timed beside its plain version, SDPA and its bound."""
    f32 = dict(kinds=("f32",), timed=("f32",))
    paged = paged_cases(torch, F, pa, PAGED17, **f32)
    splash = [c for over in SPLASH17
              for c in splash_cases(torch, F, sp, over, (), **f32)]
    return paged, splash


def exact_kernel_cases(torch, F, pa):
    """Phase 2's paged case at phase 4's decode (``PAGED_EXACT``), int8
    pages and f32 queries, timed beside its plain version, SDPA and its
    bound."""
    return paged_cases(torch, F, pa, PAGED_EXACT, kinds=("int8-f32",),
                       timed=("int8-f32",))


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


# -- phase 12: tensor parallelism -----------------------------------------------


def tp_phase(torch, np, here, phase3, cards=None, python=None):
    """Phase 12: two tp ranks (``chip_smoke.py --phase12-worker``, one
    card each over NCCL with two cards or more, else both on one card
    over gloo; gloo CPU ranks when ``DEV`` is the CPU) train (12a) and
    serve (12b); ``phase3`` holds phase 3's streams and launch counts by
    layout. A rank that fails stops the phase (its error quoted); a rank
    still running at the deadline is named as stalled. ``python`` is the
    command prefix that starts a worker (default: this interpreter)."""
    if cards is None:
        cards = torch.cuda.device_count() if DEV == "cuda" else 1
    backend = "nccl" if DEV == "cuda" and cards >= 2 else "gloo"
    one_card = DEV == "cuda" and cards < 2
    out = tempfile.mkdtemp(prefix="dk_phase12_")
    cfg = {"out": out, "port": _free_port(), "device": DEV,
           "backend": backend, "cards": min(cards, TP) if DEV == "cuda"
           else 0, "train": TRAIN, "lr": TRAIN_LR, "steps": TP_TRAIN_STEPS,
           "train_b": TP_TRAIN_B["one_card" if one_card else "cards"],
           "witness": TP_WITNESS, "exact": EXACT, "exact_tier": EXACT_TIER,
           "exact_requests": [(p.tolist(), c) for p, c in exact_requests(
               np, EXACT["vocab_size"])],
           "modes": TP_MODES, "flagship": FLAGSHIP,
           "system_prefix": SYSTEM_PREFIX, "prompt_lens": PROMPT_LENS,
           "phase3_streams": phase3["streams"]}
    ranks, wall = run_ranks("12", cfg, TP, TP_TIMEOUT_S, here, python)
    return tp_check(np, ranks, phase3, cfg, wall)


def run_ranks(phase, cfg, world, timeout_s, here, python=None):
    """Run ``world`` ranks of ``phase`` (``chip_smoke.py
    --phase<phase>-worker <cfg> <rank>``, each logging to
    ``cfg['out']``) to their end: ``(each rank's JSON result,
    seconds)``. A rank that fails stops the phase quoting every failed
    rank's log; ranks still running at the deadline are named as
    stalled; every rank is killed on the way out."""
    from distkeras_torch.parallel import ranks

    return ranks.run_ranks(phase, os.path.join(here, "chip_smoke.py"),
                           f"--phase{phase}-worker", cfg, world, timeout_s,
                           python)


def tp_check(np, ranks, phase3, cfg, wall):
    """The cross-rank checks of phase 12 and its summary line."""
    tr = [r["train"] for r in ranks]
    L, W = cfg["train"]["num_layers"], cfg["steps"]
    for r, t in enumerate(tr):
        losses = np.asarray(t["losses"])
        if not np.isfinite(losses).all():
            raise AssertionError(f"12a: rank {r} losses not finite: "
                                 f"{losses}")
        gap = float(np.abs(losses - np.asarray(tr[0]["tp1_losses"])).max())
        if not gap <= TRAIN_LOSS_TOL:
            raise AssertionError(f"12a: rank {r}'s losses {losses} are "
                                 f"{gap} off the tp=1 step's "
                                 f"{tr[0]['tp1_losses']}")
        want = L * W if t["kernel_selected"] else 0
        if t["launches"] != {n: want for n in CAUSAL_NAMES}:
            raise AssertionError(f"12a: rank {r} launched {t['launches']}, "
                                 f"not {want} (layers x steps) each")
        if t["kernel_selected"] and t["shapes"] != [t["shard_shape"]]:
            raise AssertionError(f"12a: rank {r} ran the causal kernels at "
                                 f"{t['shapes']}, not {t['shard_shape']}")
    if len({t["replicated_digest"] for t in tr}) != 1:
        raise AssertionError("12a: the replicated parameters differ across "
                             "the ranks")
    sv = [r["serve"] for r in ranks]
    for layout in ("paged", "slot"):
        if sv[0][layout]["streams"] != sv[1][layout]["streams"]:
            raise AssertionError(f"12b: {layout} streams differ across the "
                                 f"ranks")
        for r, v in enumerate(sv):
            if v[layout]["launches"] != phase3["launches"][layout]:
                raise AssertionError(
                    f"12b: rank {r}'s {layout} launches "
                    f"{v[layout]['launches']} != phase 3's "
                    f"{phase3['launches'][layout]}")
    if ranks[0]["serve_witness"] != ranks[1]["serve_witness"]:
        raise AssertionError("12b: the witness streams differ across the "
                             "ranks")
    label = {"backend": ranks[0]["backend"], "cards": cfg["cards"],
             "processes": TP}
    if cfg["cards"] == 1:
        label["note"] = ("both ranks share one card over gloo: not a tp "
                         "speed")
    t0 = tr[0]
    B, T = cfg["train_b"], cfg["train"]["max_len"]
    a = {**label, "config": f"d{cfg['train']['d_model']}/h"
         f"{cfg['train']['num_heads']}/L{L}/v{cfg['train']['vocab_size']}"
         f"/T{T}/b{B}-bf16-adamw-mubf16-fusedce-tp{TP}",
         "witness": ranks[0]["train_witness"],
         "losses": [t["losses"] for t in tr], "tp1_losses": t0["tp1_losses"],
         "max_loss_gap_vs_tp1": max(float(np.abs(np.asarray(t["losses"])
                                                 - t0["tp1_losses"]).max())
                                    for t in tr),
         "replicated_bit_identical": True,
         "ms_per_step": [t["ms_per_step"] for t in tr],
         "tok_per_s": [B * T / (t["ms_per_step"] / 1e3) for t in tr],
         "launches_per_rank": [t["launches"] for t in tr],
         "kernel_shape": t0["shard_shape"], "batch": B}
    if cfg["cards"] == 1:
        a["batch_note"] = (f"B cut to {B} from {TP_TRAIN_B['cards']} on one "
                           f"card: gloo stages every all-reduce through "
                           f"the host")
    b = {**label, "witness_modes": ranks[0]["serve_witness"]["modes"],
         "witness_tier": ranks[0]["serve_witness"]["tier"],
         "witness_migrate": ranks[0]["serve_witness"]["migrate"]}
    for layout in ("paged", "slot"):
        v = {k: x for k, x in sv[0][layout].items() if k != "streams"}
        v["ms_per_tick"] = [x[layout]["ms_per_tick"] for x in sv]
        v["tok_per_s"] = [x[layout]["tok_per_s"] for x in sv]
        v["launches_per_rank"] = [x[layout]["launches"] for x in sv]
        v["streams_bit_identical_across_ranks"] = True
        b[layout] = v
    return {"phase": "12", "12a": a, "12b": b, "wall_s": wall}


def _digest(torch, tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def tp_train_witness(torch, np, dk, mesh, cfg):
    """12a's f32 witness: one SGD step at tp=2 against the tp=1 step on
    the same weights and tokens (loss and the gathered parameters)."""
    w, E = cfg["witness"], cfg["exact"]
    tokens = np.random.default_rng(12).integers(
        0, E["vocab_size"], size=(w["B"], w["T"]))
    one = dk["get_model"]("transformer_lm", dtype=torch.float32, device=DEV,
                          seed=3, **E)
    want = dk["make_lm_train_step"](one, dk["get_optimizer"](
        "sgd", w["lr"]))(tokens).item()
    want_p = dk["rules"].flatten(dk["bridge"].params_to_jax(one))
    with mesh:
        tp = dk["get_model"]("transformer_lm", dtype=torch.float32,
                             device=DEV, seed=3, tp_size=TP, **E)
    got = dk["make_lm_train_step"](tp, dk["get_optimizer"]("sgd", w["lr"]),
                                   mesh=mesh, tp_axis="tp")(tokens).item()
    with mesh:
        got_p = dk["rules"].flatten(dk["bridge"].params_to_jax(tp))
    res = {"loss": got, "tp1_loss": want, "loss_gap": abs(got - want),
           "param_gap": max(float(np.abs(got_p[k] - v).max())
                            for k, v in want_p.items()), "tol": w["tol"]}
    if not (res["loss_gap"] <= w["tol"] and res["param_gap"] <= w["tol"]):
        raise AssertionError(f"12a: the f32 witness is off the tp=1 step: "
                             f"{res}")
    return res


def tp_train(torch, np, dk, fa, mesh, cfg, rank):
    """12a: the flagship's step at tp=2 (rank 0 also runs the tp=1 step
    on the same weights and tokens)."""
    tcfg, B, W = cfg["train"], cfg["train_b"], cfg["steps"]
    T, H = tcfg["max_len"], tcfg["num_heads"]
    hd = tcfg["d_model"] // H
    tokens = torch.as_tensor(np.random.default_rng(13).integers(
        0, tcfg["vocab_size"], size=(W, B, T)), device=DEV)

    def opt():
        return dk["get_optimizer"]("adamw", cfg["lr"],
                                   mu_dtype=torch.bfloat16)

    tp1 = None
    if rank == 0:
        one = dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                              device=DEV, seed=0, **tcfg)
        step = dk["make_lm_train_step"](one, opt())
        tp1 = [step(t).item() for t in tokens]
        del one, step
        _free(torch)
    with mesh:
        model = dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                                device=DEV, seed=0, tp_size=TP, **tcfg)
    step = dk["make_lm_train_step"](model, opt(), mesh=mesh, tp_axis="tp")
    shapes = set()
    plain = fa.pallas_causal_attention

    def seen(q, k, v, block=None):
        shapes.add(tuple(q.shape))
        return plain(q, k, v, block)

    fa.pallas_causal_attention = seen
    zero_training_counts(fa, dk["pp"])
    losses, times = [], []
    try:
        for t in tokens:
            sync(torch)
            t0 = time.perf_counter()
            losses.append(step(t).item())
            times.append(time.perf_counter() - t0)
    finally:
        fa.pallas_causal_attention = plain
    launches = {n: getattr(fa, n).launches for n in CAUSAL_NAMES}
    rep = [p for n, p in model.named_parameters()
           if dk["tp_dim"](n) is None]
    out = {"losses": losses, "tp1_losses": tp1,
           "ms_per_step": float(np.mean(times[1:]) * 1e3),
           "first_step_ms": times[0] * 1e3, "launches": launches,
           "shapes": sorted(list(s) for s in shapes),
           "shard_shape": [B, T, H // TP, hd],
           "kernel_selected": bool(fa.preferred(T, hd, torch.bfloat16,
                                                DEV)),
           "replicated_digest": _digest(torch, rep)}
    del step, model
    _free(torch)
    return out


def tp_serve_witness(torch, np, dk, mesh, cfg, rank):
    """12b's f32 witness on each rank: the tp=2 engine's streams equal the
    tp=1 engine's in every mode of ``cfg['modes']`` on both layouts, over
    the host tier's churn, and after a block export -> import each way
    between a tp=2 and a tp=1 engine."""
    model = dk["get_model"]("transformer_lm", dtype=torch.float32,
                            device=DEV, seed=3, **cfg["exact"])
    requests = [(np.asarray(p, np.int32), c)
                for p, c in cfg["exact_requests"]]
    modes = dict(EXACT_MODES)
    res = {"modes": {}}
    for paged in (True, False):
        layout = "paged" if paged else "slot"
        for name in cfg["modes"]:
            kw = dict(modes[name], paged=paged, block_size=16)
            _, want, _ = serve(torch, np, dk, model, requests, **kw)
            _, got, eng = serve(torch, np, dk, model, requests, mesh=mesh,
                                **kw)
            _differ(torch, np, model, requests, got, want,
                    f"{layout} {name} tp={TP} vs tp=1", phase="12b")
            res["modes"][f"{layout}_{name}"] = {
                "streams_equal": True, "tp": eng.stats()["tp"],
                "digest": _digest(torch, [torch.tensor(s) for s in got])}
    T = cfg["exact_tier"]
    rng = np.random.default_rng(9)
    prefixes = [rng.integers(0, model.vocab_size, size=T["prefix_len"])
                for _ in range(T["prefixes"])]
    churn = [(np.concatenate([pre, rng.integers(
        0, model.vocab_size, size=T["tail"])]).astype(np.int32),
        dict(temperature=0.8, seed=r * 10 + i, max_new_tokens=T["max_new"]))
        for r in range(T["reps"]) for i, pre in enumerate(prefixes)]
    pb = T["prefix_len"] // 16
    worst = -(-(T["prefix_len"] + T["tail"] + T["max_new"]) // 16)
    tier = dict(slots=2, paged=True, block_size=16, prefill_chunk=16,
                num_blocks=1 + worst + pb, host_blocks=T["prefixes"] * pb + pb)
    streams = {}
    for where in ({}, {"mesh": mesh}):
        eng, out = None, []
        for p, c in churn:  # one at a time: the churn order is the trace
            if eng is None:
                _, s, eng = serve(torch, np, dk, model, [(p, c)], **where,
                                  **tier)
            else:
                r = eng.submit(p, **c)
                eng.drain(timeout=300)
                s = [r.stream.tokens(timeout=10)]
            out += s
        streams["tp2" if where else "tp1"] = out
    st = eng.stats()
    if st["block_restores"] == 0:
        raise AssertionError("12b: the tp=2 host tier never restored")
    _differ(torch, np, model, churn, streams["tp2"], streams["tp1"],
            f"host tier tp={TP} vs tp=1", phase="12b")
    res["tier"] = {"streams_equal": True,
                   "demotions": st["block_demotions"],
                   "restores": st["block_restores"]}
    prompt, _ = requests[3]
    greedy = [(prompt, dict(max_new_tokens=16, seed=0))]
    kw = dict(paged=True, block_size=16)
    _, one, _ = serve(torch, np, dk, model, greedy, **kw)
    res["migrate"] = {}
    for tag, src_w, dst_w in (("tp2_to_tp1_device", {"mesh": mesh}, {}),
                              ("tp1_to_tp2_host", {},
                               {"mesh": mesh, "host_blocks": 32})):
        _, _, src = serve(torch, np, dk, model,
                          [(prompt, dict(max_new_tokens=1, seed=0))],
                          **src_w, **kw)
        exp = src.export_blocks(prompt)
        dst = dk["ServingEngine"](
            model, slots=8, prefill_chunk=64,
            registry=dk["telemetry"].MetricRegistry(),
            tracer=dk["telemetry"].Tracer(), **kw,
            **(dst_w if "mesh" in dst_w else dict(dst_w, device=DEV)))
        imp = dst.import_blocks(prompt, exp["blocks"])
        r = dst.submit(prompt, **greedy[0][1])
        dst.drain(timeout=300)
        _differ(torch, np, model, greedy, [r.stream.tokens(timeout=10)],
                one, f"imported {tag} vs one engine", phase="12b")
        if dst.prefix_hit_tokens != imp["tokens"] or imp["tokens"] == 0:
            raise AssertionError(f"12b: the import {tag} ({imp}) did not "
                                 f"serve the prompt's prefix")
        res["migrate"][tag] = {"streams_equal": True,
                               "tokens": imp["tokens"], "mode": imp["mode"]}
    del model
    _free(torch)
    return res


def tp_serve(torch, np, dk, pa, sp, mesh, cfg):
    """12b at full width: phase 3's flagship and mix on tp=2 engines,
    paged and slot; returns per layout the streams, this rank's launch
    counts, rates and the share of greedy tokens equal to phase 3's."""
    model = dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                            device=DEV, seed=0, **cfg["flagship"])
    requests = dk["serving_requests"](model.vocab_size,
                                      cfg["system_prefix"],
                                      tuple(cfg["prompt_lens"]))
    out = {}
    for paged in (True, False):
        layout = "paged" if paged else "slot"
        kw = dict(mesh=mesh, paged=paged, block_size=16)
        serve(torch, np, dk, model, requests[:2], **kw)  # warm
        pa.paged_attention.launches = 0
        sp.splash_prefill_attention.launches = 0
        summary, streams, eng = serve(torch, np, dk, model, requests, **kw)
        summary["launches"] = {
            "paged_attention": pa.paged_attention.launches,
            "splash_prefill": sp.splash_prefill_attention.launches}
        ref = cfg["phase3_streams"][layout]
        summary["greedy_match_vs_tp1"] = greedy_match(requests, streams, ref)
        summary["greedy_flips_vs_tp1"] = greedy_flips(torch, np, model,
                                                      requests, streams, ref)
        summary["cache_kv_heads"] = int(eng._cache.layers[0]["key"]
                                        .shape[-2])
        summary["streams"] = streams
        summary["tp"] = eng.stats()["tp"]
        out[layout] = summary
        del eng
    del model
    _free(torch)
    return out


def tp_worker(cfg_path: str, rank: int) -> int:
    """One rank of phase 12 (``chip_smoke.py --phase12-worker <cfg>
    <rank>``): join the two-rank world, run 12a and 12b, write this
    rank's results."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    global DEV
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distkeras_torch import bridge, telemetry
    from distkeras_torch.bench import serving_requests
    from distkeras_torch.kernels import build
    from distkeras_torch.parallel.ranks import rank_threads
    from distkeras_torch.models import get_model
    from distkeras_torch.ops import paged_attention as pa
    from distkeras_torch.ops import pallas_attention as fa
    from distkeras_torch.ops import pallas_pair as pp
    from distkeras_torch.ops import rules
    from distkeras_torch.ops import splash_prefill as sp
    from distkeras_torch.parallel.mesh import make_mesh
    from distkeras_torch.parallel.spmd import make_lm_train_step, tp_dim
    from distkeras_torch.serving import ServingEngine
    from distkeras_torch.utils.losses import get_optimizer

    cfg = json.load(open(cfg_path))
    DEV = cfg["device"]
    if DEV == "cuda":
        # one card a rank over NCCL; both on card 0 over gloo
        torch.cuda.set_device(rank if cfg["backend"] == "nccl" else 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.load()
    torch.set_num_threads(rank_threads(TP))
    dist.init_process_group(cfg["backend"],
                            init_method=f"tcp://127.0.0.1:{cfg['port']}",
                            rank=rank, world_size=TP,
                            timeout=datetime.timedelta(seconds=300))
    dk = {"get_model": get_model, "bridge": bridge, "rules": rules,
          "make_lm_train_step": make_lm_train_step,
          "get_optimizer": get_optimizer, "tp_dim": tp_dim, "pp": pp,
          "ServingEngine": ServingEngine, "telemetry": telemetry,
          "serving_requests": serving_requests}
    try:
        train_mesh = make_mesh({"dp": 1, "sp": 1, "tp": TP})
        serve_mesh = make_mesh({"model": TP})
        res = {"rank": rank, "backend": dist.get_backend()}
        res["train_witness"] = tp_train_witness(torch, np, dk, train_mesh,
                                                cfg)
        res["train"] = tp_train(torch, np, dk, fa, train_mesh, cfg, rank)
        res["serve_witness"] = tp_serve_witness(torch, np, dk, serve_mesh,
                                                cfg, rank)
        res["serve"] = tp_serve(torch, np, dk, pa, sp, serve_mesh, cfg)
        with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        dist.destroy_process_group()
    return 0


# -- phase 13: pipeline, expert and sequence parallelism -------------------


def _peak_mb(torch):
    return (torch.cuda.max_memory_allocated() / 2**20 if DEV == "cuda"
            else None)


def _reset_peak(torch):
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()


def moe_routing(torch, np, model, tokens):
    """The share of (token, choice) pairs each MoE layer of ``model``
    drops at capacity on ``tokens`` (one no-grad forward, the layers'
    inputs routed again), and the mean aux loss."""
    from distkeras_torch.ops.moe import route

    seen = []
    hooks = [b.moe.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[0])))
        for b in model.blocks]
    try:
        with torch.no_grad():
            _, auxes = model(tokens, return_aux=True)
            dropped = []
            for mod, x in seen:
                x = x.reshape(-1, x.shape[-1]).float()
                E = mod.router.shape[1]
                C = max(1, int(mod.capacity_factor * mod.top_k
                               * x.shape[0] / E))
                keep = route(x, mod.router, E, mod.top_k, C)[-1]
                dropped.append(1.0 - keep.float().mean().item())
    finally:
        for h in hooks:
            h.remove()
    return dropped, float(sum(a.item() for a in auxes) / len(auxes))


def moe_phase(torch, np, dk, fa, pp):
    """13b in this process: the MoE twin of phase 6's flagship (8
    experts, top-1, capacity factor 1.25) at ep=1, P13_STEPS AdamW steps
    on phase 6's first batch."""
    V, D, H, L = (TRAIN[k] for k in ("vocab_size", "d_model", "num_heads",
                                     "num_layers"))
    B, T = TRAIN_B, TRAIN["max_len"]
    tokens = train_tokens(torch, np)[0]
    model = dk["get_model"]("moe_lm", dtype=torch.bfloat16, device=DEV,
                            seed=0, **TRAIN, **MOE)
    n_params = sum(p.numel() for p in model.parameters())
    step = dk["make_moe_lm_train_step"](
        model, dk["get_optimizer"]("adamw", TRAIN_LR,
                                   mu_dtype=torch.bfloat16))
    _reset_peak(torch)
    zero_training_counts(fa, pp)
    losses, times = [], []
    for _ in range(P13_STEPS):
        sync(torch)
        t0 = time.perf_counter()
        losses.append(step(tokens).item())
        times.append(time.perf_counter() - t0)
    launches = {n: getattr(fa, n).launches for n in CAUSAL_NAMES}
    peak = _peak_mb(torch)
    del step
    _free(torch)
    dropped, aux = moe_routing(torch, np, model, tokens)
    del model
    _free(torch)
    if not np.isfinite(losses).all():
        raise AssertionError(f"13b: MoE losses not finite: {losses}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"13b: MoE losses do not fall on the fixed "
                             f"batch: {losses}")
    want = L * P13_STEPS if fa.preferred(T, D // H, torch.bfloat16,
                                         DEV) else 0
    if launches != {n: want for n in CAUSAL_NAMES}:
        raise AssertionError(f"13b: the MoE step launched {launches}, not "
                             f"{want} (layers x steps) each")
    ms = float(np.mean(times[1:]) * 1e3)
    return {"config": f"d{D}/h{H}/L{L}/v{V}/T{T}/b{B}-bf16-moe"
                      f"{MOE['moe_experts']}-top{MOE['moe_top_k']}-cf1.25-"
                      f"ep1-adamw-mubf16",
            "params": n_params, "losses": losses, "ms_per_step": ms,
            "first_step_ms": times[0] * 1e3,
            "tok_per_s": B * T / (ms / 1e3), "peak_device_mb": peak,
            "dropped_share_per_layer": dropped, "aux_loss": aux,
            "launches": launches}


def p13_phase(torch, np, here, yard, cards=None, python=None):
    """Phase 13: two ranks (``chip_smoke.py --phase13-worker``, one card
    each over NCCL with two cards or more, else both on one card over
    gloo; gloo CPU ranks when ``DEV`` is the CPU) run 13a (pp=2), 13b at
    ep=2 and 13c (sp=2), each after its f32 witness. ``yard`` holds phase
    6's and 6b's losses. A rank that fails stops the phase (its error
    quoted); a rank still running at the deadline is named as stalled.
    ``python`` is the command prefix that starts a worker."""
    if cards is None:
        cards = torch.cuda.device_count() if DEV == "cuda" else 1
    backend = "nccl" if DEV == "cuda" and cards >= 2 else "gloo"
    out = tempfile.mkdtemp(prefix="dk_phase13_")
    cfg = {"out": out, "port": _free_port(), "device": DEV,
           "backend": backend, "cards": min(cards, P13) if DEV == "cuda"
           else 0, "train": TRAIN, "train_b": TRAIN_B, "train_w": TRAIN_W,
           "lr": TRAIN_LR, "steps": P13_STEPS, "micro": PP_MICRO,
           "moe": MOE, "moe_steps": MOE_EP_STEPS, "witness": P13_WITNESS,
           "exact": EXACT, "pair_per_layer": pair_per_layer(P13),
           "losses6": yard["losses6"], "losses6b": yard["losses6b"]}
    ranks, wall = run_ranks("13", cfg, P13, P13_TIMEOUT_S, here, python)
    return p13_check(np, ranks, cfg, wall)


def _launch_check(what, r, got, want, shapes=None, shape=None):
    if got != want:
        raise AssertionError(f"{what}: rank {r} launched {got}, not {want}")
    if shape is not None and any(want.values()) and shapes != [shape]:
        raise AssertionError(f"{what}: rank {r} ran the causal kernels at "
                             f"{shapes}, not {shape}")


def p13_check(np, ranks, cfg, wall):
    """The cross-rank checks of phase 13 and its summary line."""
    tc = cfg["train"]
    L, T, B, W = (tc["num_layers"], tc["max_len"], cfg["train_b"],
                  cfg["steps"])
    H, D = tc["num_heads"], tc["d_model"]
    label = {"backend": ranks[0]["backend"], "cards": cfg["cards"],
             "processes": P13}
    if cfg["cards"] == 1:
        label["note"] = ("both ranks share one card over gloo: not a "
                         "parallel speed")
    # 13a
    pa = [r["pp"] for r in ranks]
    for r, a in enumerate(pa):
        gap = float(np.abs(np.asarray(a["losses"])
                           - np.asarray(cfg["losses6"][:W])).max())
        if not np.isfinite(a["losses"]).all() or not gap <= TRAIN_LOSS_TOL:
            raise AssertionError(f"13a: rank {r}'s pp losses {a['losses']} "
                                 f"are {gap} off phase 6's "
                                 f"{cfg['losses6'][:W]}")
        if a["held_blocks"] != list(range(r * L // P13, (r + 1) * L // P13)):
            raise AssertionError(f"13a: rank {r} holds blocks "
                                 f"{a['held_blocks']}, not its stage's")
        n = (L // P13) * cfg["micro"] * W if a["kernel_selected"] else 0
        _launch_check("13a", r, a["launches"],
                      {k: n for k in CAUSAL_NAMES}, a["shapes"],
                      [B // cfg["micro"], T, H, D // H])
    if len({a["rest_digest"] for a in pa}) != 1:
        raise AssertionError("13a: the replicated embedding, final norm "
                             "and head differ across the stages")
    M = cfg["micro"]
    a = {**label, "config": f"d{D}/h{H}/L{L}/v{tc['vocab_size']}/T{T}/"
         f"b{B}-bf16-adamw-mubf16-pp{P13}-M{M}",
         "witness": ranks[0]["pp_witness"], "losses": pa[0]["losses"],
         "phase6_losses": cfg["losses6"][:W],
         "max_loss_gap_vs_phase6": float(np.abs(
             np.asarray(pa[0]["losses"])
             - np.asarray(cfg["losses6"][:W])).max()),
         "rest_bit_identical_across_stages": True,
         "ms_per_step": [x["ms_per_step"] for x in pa],
         "tok_per_s": [B * T / (x["ms_per_step"] / 1e3) for x in pa],
         "peak_device_mb": [x["peak_mb"] for x in pa],
         "blocks_held_per_rank": [x["held_blocks"] for x in pa],
         "bubble": (P13 - 1) / (M + P13 - 1),
         "launches_per_rank": [x["launches"] for x in pa],
         "kernel_shape": [B // M, T, H, D // H]}
    # 13b at ep=2
    eb = [r["ep"] for r in ranks]
    for r, e in enumerate(eb):
        if not np.isfinite(e["losses"]).all():
            raise AssertionError(f"13b: rank {r}'s ep=2 losses not finite: "
                                 f"{e['losses']}")
    if len({e["replicated_digest"] for e in eb}) != 1:
        raise AssertionError("13b: the replicated parameters differ across "
                             "the ep ranks")
    if eb[0]["losses"] != eb[1]["losses"]:
        raise AssertionError("13b: the ep ranks report different losses")
    b = {**label, "config": f"d{D}/h{H}/L{L}/v{tc['vocab_size']}/T{T}/b{B}"
         f"-bf16-moe{cfg['moe']['moe_experts']}-top"
         f"{cfg['moe']['moe_top_k']}-cf1.25-ep{P13}-adamw-mubf16",
         "witness": ranks[0]["ep_witness"], "losses": eb[0]["losses"],
         "replicated_bit_identical": True,
         "ms_per_step": [x["ms_per_step"] for x in eb],
         "tok_per_s": [B * T / (x["ms_per_step"] / 1e3) for x in eb],
         "peak_device_mb": [x["peak_mb"] for x in eb],
         "launches_per_rank": [x["launches"] for x in eb]}
    # 13c
    sc = [r["sp"] for r in ranks]
    for r, c in enumerate(sc):
        gap = float(np.abs(np.asarray(c["losses"])
                           - np.asarray(cfg["losses6b"][:W])).max())
        if not np.isfinite(c["losses"]).all() or not gap <= TRAIN_LOSS_TOL:
            raise AssertionError(f"13c: rank {r}'s sp=2 losses "
                                 f"{c['losses']} are {gap} off phase 6b's "
                                 f"{cfg['losses6b'][:W]}")
        # the ring runs the pair kernels only, never B1's
        want = {n: 0 for n in c["launches"]}
        want.update({n: (k * L * W if c["kernel_selected"] else 0)
                     for n, k in cfg["pair_per_layer"].items()})
        _launch_check("13c", r, c["launches"], want)
    if len({c["digest"] for c in sc}) != 1:
        raise AssertionError("13c: the sp=2 replicas differ")
    c = {**label, "config": f"d{D}/h{H}/L{L}/v{tc['vocab_size']}/T{T}/b{B}"
         f"-bf16-ring-sp{P13}-zigzag-pair{T // P13 // 2}-adamw-mubf16-"
         f"fusedce", "witness": ranks[0]["sp_witness"],
         "losses": sc[0]["losses"], "phase6b_losses": cfg["losses6b"][:W],
         "max_loss_gap_vs_phase6b": float(np.abs(
             np.asarray(sc[0]["losses"])
             - np.asarray(cfg["losses6b"][:W])).max()),
         "replicas_bit_identical": True,
         "ms_per_step": [x["ms_per_step"] for x in sc],
         "tok_per_s": [B * T / (x["ms_per_step"] / 1e3) for x in sc],
         "peak_device_mb": [x["peak_mb"] for x in sc],
         "allreduces_per_step": sc[0]["allreduces_per_step"],
         "per_leaf_allreduces_per_step": sc[0]["n_params"],
         "launches_per_rank": [x["launches"] for x in sc],
         "pair_per_layer": cfg["pair_per_layer"]}
    return {"phase": "13", "13a": a, "13b_ep2": b, "13c": c, "wall_s": wall}


def _p13_tokens(np, cfg):
    """Phase 6's batches (``train_tokens``), on the host."""
    tc = cfg["train"]
    return np.random.default_rng(11).integers(
        0, tc["vocab_size"], size=(cfg["train_w"], cfg["train_b"],
                                   tc["max_len"]))


def _gap(np, a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in b)


def _plain(dk, model, mesh=None):
    if mesh is None:
        return dk["rules"].flatten(dk["bridge"].params_to_jax(model))
    with mesh:
        return dk["rules"].flatten(dk["bridge"].params_to_jax(model))


def p13_witnesses(torch, np, dk, cfg):
    """The f32 witnesses of phase 13 at phase 4's widths, one SGD step
    each: pp=2 and sp=2 against the unsharded step, ep=2 against dp=2 x
    ep=1 on the same rows with the same capacity per source."""
    w, E = cfg["witness"], cfg["exact"]
    f32 = dict(dtype=torch.float32, device=DEV, seed=3)
    sgd = dk["get_optimizer"]("sgd", w["lr"])
    M, B, T = w["M"], w["B"], w["T"]
    tokens = np.random.default_rng(14).integers(0, E["vocab_size"],
                                                size=(M, B, T))
    out = {}
    # pp=2 against the unsharded step on all M x B rows
    one = dk["get_model"]("transformer_lm", **f32, **E)
    want = dk["make_lm_train_step"](one, sgd, fused_ce=False)(
        tokens.reshape(M * B, T)).item()
    mesh = dk["make_mesh"]({"dp": 1, "pp": P13, "tp": 1})
    pp_model = dk["get_model"]("transformer_lm", **f32, **E)
    got = dk["make_pp_lm_train_step"](pp_model, sgd, mesh)(tokens).item()
    dk["sync_blocks"](pp_model, mesh)
    res = {"loss": got, "unsharded_loss": want, "loss_gap": abs(got - want),
           "param_gap": _gap(np, _plain(dk, pp_model), _plain(dk, one)),
           "tol": w["pp_tol"]}
    if not (res["loss_gap"] <= w["pp_tol"] and res["param_gap"]
            <= w["pp_tol"]):
        raise AssertionError(f"13a: the f32 witness is off the unsharded "
                             f"step: {res}")
    out["pp"] = res
    # ep=2 against dp=2 x ep=1: the same rows, the same capacity a source
    rows = tokens.reshape(M * B, T)
    moe = dict(f32, **E, **cfg["moe"])
    dp_mesh = dk["make_mesh"]({"dp": P13, "ep": 1})
    dp_model = dk["get_model"]("moe_lm", **moe)
    want = dk["make_moe_lm_train_step"](dp_model, sgd, dp_mesh)(rows).item()
    ep_mesh = dk["make_mesh"]({"dp": 1, "ep": P13})
    with ep_mesh:
        ep_model = dk["get_model"]("moe_lm", ep_size=P13, **moe)
    got = dk["make_moe_lm_train_step"](ep_model, sgd, ep_mesh)(rows).item()
    res = {"loss": got, "dp2_ep1_loss": want, "loss_gap": abs(got - want),
           "param_gap": _gap(np, _plain(dk, ep_model, ep_mesh),
                             _plain(dk, dp_model)), "tol": w["ep_tol"]}
    if not (res["loss_gap"] <= w["ep_tol"] and res["param_gap"]
            <= w["ep_tol"]):
        raise AssertionError(f"13b: the f32 witness is off dp=2 x ep=1: "
                             f"{res}")
    res.update(_remat_gaps(np, dk, "moe_lm", dict(moe, ep_size=P13),
                           ep_mesh, rows, got, ep_model,
                           dk["make_moe_lm_train_step"]))
    if not (res["remat_loss_gap"] <= w["ep_tol"] and res["remat_param_gap"]
            <= w["ep_tol"]):
        raise AssertionError(f"13b: the ep=2 step under remat='block' is "
                             f"off the stored-activation step: {res}")
    out["ep"] = res
    # sp=2 against sp=1
    ring = dict(f32, attention="ring", **E)
    one = dk["get_model"]("transformer_lm", **f32, **E)
    want = dk["make_lm_train_step"](one, sgd)(rows).item()
    sp_mesh = dk["make_mesh"]({"dp": 1, "sp": P13})
    sp_model = dk["get_model"]("transformer_lm", **ring)
    got = dk["make_lm_train_step"](sp_model, sgd, mesh=sp_mesh)(rows).item()
    res = {"loss": got, "sp1_loss": want, "loss_gap": abs(got - want),
           "param_gap": _gap(np, _plain(dk, sp_model), _plain(dk, one)),
           "tol": w["sp_tol"]}
    if not (res["loss_gap"] <= w["sp_tol"] and res["param_gap"]
            <= w["sp_tol"]):
        raise AssertionError(f"13c: the f32 witness is off sp=1: {res}")
    res.update(_remat_gaps(np, dk, "transformer_lm", ring, sp_mesh, rows,
                           got, sp_model,
                           lambda m, o, mesh: dk["make_lm_train_step"](
                               m, o, mesh=mesh)))
    if not (res["remat_loss_gap"] <= w["sp_tol"] and res["remat_param_gap"]
            <= w["sp_tol"]):
        raise AssertionError(f"13c: the sp=2 step under remat='block' is "
                             f"off the stored-activation step: {res}")
    out["sp"] = res
    return out


def _remat_gaps(np, dk, name, kw, mesh, rows, loss, trained, make_step):
    """One SGD step of a ``remat='block'`` twin (built from the same
    seed inside ``mesh``) against the stored-activation step's ``loss``
    and ``trained`` model: its blocks are recomputed in the backward, on
    a card in autograd's device thread, where no mesh is bound but the
    one the recompute rebinds."""
    with mesh:
        model = dk["get_model"](name, remat="block", **kw)
    step = make_step(model, dk["get_optimizer"]("sgd", P13_WITNESS["lr"]),
                     mesh)
    got = step(rows).item()
    return {"remat_loss_gap": abs(got - loss),
            "remat_param_gap": _gap(np, _plain(dk, model, mesh),
                                    _plain(dk, trained, mesh))}


def _timed_steps(torch, step, batches):
    """Run ``step`` on each batch, each timed to a synchronize: (losses,
    seconds)."""
    losses, times = [], []
    for t in batches:
        sync(torch)
        t0 = time.perf_counter()
        losses.append(step(t).item())
        times.append(time.perf_counter() - t0)
    return losses, times


def _run_stats(torch, np, fa, times):
    return {"ms_per_step": float(np.mean(times[1:] or times) * 1e3),
            "first_step_ms": times[0] * 1e3, "peak_mb": _peak_mb(torch),
            "launches": {n: getattr(fa, n).launches for n in CAUSAL_NAMES}}


def pp_train(torch, np, dk, fa, cfg):
    """13a: phase 6's flagship, weights and first batches at pp=2, M
    microbatches of B/M rows, AdamW."""
    tc, B, M, W = cfg["train"], cfg["train_b"], cfg["micro"], cfg["steps"]
    T, H = tc["max_len"], tc["num_heads"]
    hd = tc["d_model"] // H
    tokens = torch.as_tensor(_p13_tokens(np, cfg)[:W].reshape(
        W, M, B // M, T), device=DEV)
    mesh = dk["make_mesh"]({"dp": 1, "pp": P13, "tp": 1})
    model = dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                            device=DEV, seed=0, **tc)
    step = dk["make_pp_lm_train_step"](model, dk["get_optimizer"](
        "adamw", cfg["lr"], mu_dtype=torch.bfloat16), mesh)
    shapes = set()
    plain = fa.pallas_causal_attention

    def seen(q, k, v, block=None):
        shapes.add(tuple(q.shape))
        return plain(q, k, v, block)

    fa.pallas_causal_attention = seen
    _reset_peak(torch)
    zero_training_counts(fa, dk["pp"])
    try:
        losses, times = _timed_steps(torch, step, tokens)
    finally:
        fa.pallas_causal_attention = plain
    out = {"losses": losses, **_run_stats(torch, np, fa, times),
           # the blocks whose storage this rank keeps while it trains
           "held_blocks": [i for i, b in enumerate(model.blocks)
                           if all(p.numel() for p in b.parameters())],
           "shapes": sorted(list(s) for s in shapes),
           "kernel_selected": bool(fa.preferred(T, hd, torch.bfloat16,
                                                DEV)),
           "rest_digest": _digest(torch, [model.embed.embedding,
                                          model.ln_f.scale, model.ln_f.bias,
                                          model.head.kernel,
                                          model.head.bias])}
    del step, model
    _free(torch)
    return out


def ep_train(torch, np, dk, fa, cfg):
    """13b at ep=2: the MoE twin of phase 6's flagship, phase 6's first
    batches (the global batch sharded over the two ranks)."""
    tc, W = cfg["train"], cfg["moe_steps"]
    tokens = torch.as_tensor(_p13_tokens(np, cfg)[:W], device=DEV)
    mesh = dk["make_mesh"]({"dp": 1, "ep": P13})
    with mesh:
        model = dk["get_model"]("moe_lm", dtype=torch.bfloat16, device=DEV,
                                seed=0, ep_size=P13, **tc, **cfg["moe"])
    step = dk["make_moe_lm_train_step"](model, dk["get_optimizer"](
        "adamw", cfg["lr"], mu_dtype=torch.bfloat16), mesh)
    _reset_peak(torch)
    zero_training_counts(fa, dk["pp"])
    losses, times = _timed_steps(torch, step, tokens)
    rep = [p for n, p in model.named_parameters()
           if dk["ep_dim"](n) is None]
    out = {"losses": losses, **_run_stats(torch, np, fa, times),
           "replicated_digest": _digest(torch, rep)}
    del step, model
    _free(torch)
    return out


def sp_train(torch, np, dk, fa, cfg):
    """13c: phase 6b's ring step at sp=2 (each rank two T/4 zigzag
    chunks) through the bucketed gradient reduce."""
    tc, W = cfg["train"], cfg["steps"]
    T, H = tc["max_len"], tc["num_heads"]
    tokens = torch.as_tensor(_p13_tokens(np, cfg)[:W], device=DEV)
    mesh = dk["make_mesh"]({"dp": 1, "sp": P13})
    model = dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                            device=DEV, seed=0, attention="ring", **tc)
    step = dk["make_lm_train_step"](model, dk["get_optimizer"](
        "adamw", cfg["lr"], mu_dtype=torch.bfloat16), mesh=mesh)
    _reset_peak(torch)
    zero_training_counts(fa, dk["pp"])
    calls = dk["reduce_grads"].calls
    losses, times = _timed_steps(torch, step, tokens)
    out = {"losses": losses, **_run_stats(torch, np, fa, times),
           "launches": training_counts(fa, dk["pp"]),
           "allreduces_per_step": (dk["reduce_grads"].calls - calls) / W,
           "n_params": len(list(model.parameters())),
           "kernel_selected": dk["pair_kernel_block"](
               T // P13 // 2, tc["d_model"] // H, torch.bfloat16, DEV)
           is not None,
           "digest": _digest(torch, list(model.parameters()))}
    del step, model
    _free(torch)
    return out


def p13_worker(cfg_path: str, rank: int) -> int:
    """One rank of phase 13 (``chip_smoke.py --phase13-worker <cfg>
    <rank>``): join the two-rank world, run the three f32 witnesses, then
    13a, 13b at ep=2 and 13c, and write this rank's results."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    global DEV
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distkeras_torch import bridge
    from distkeras_torch.kernels import build
    from distkeras_torch.parallel.ranks import rank_threads
    from distkeras_torch.models import get_model
    from distkeras_torch.ops import pallas_attention as fa
    from distkeras_torch.ops import pallas_pair as pp
    from distkeras_torch.ops import rules
    from distkeras_torch.ops.ring_attention import _pair_kernel_block
    from distkeras_torch.parallel.collectives import reduce_grads
    from distkeras_torch.parallel.mesh import make_mesh
    from distkeras_torch.parallel.pipeline import (make_pp_lm_train_step,
                                                   sync_blocks)
    from distkeras_torch.parallel.spmd import (ep_dim, make_lm_train_step,
                                               make_moe_lm_train_step)
    from distkeras_torch.utils.losses import get_optimizer

    cfg = json.load(open(cfg_path))
    DEV = cfg["device"]
    if DEV == "cuda":
        # one card a rank over NCCL; both on card 0 over gloo
        torch.cuda.set_device(rank if cfg["backend"] == "nccl" else 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.load()
    torch.set_num_threads(rank_threads(P13))
    dist.init_process_group(cfg["backend"],
                            init_method=f"tcp://127.0.0.1:{cfg['port']}",
                            rank=rank, world_size=P13,
                            timeout=datetime.timedelta(seconds=300))
    dk = {"get_model": get_model, "bridge": bridge, "rules": rules,
          "make_mesh": make_mesh, "make_lm_train_step": make_lm_train_step,
          "make_pp_lm_train_step": make_pp_lm_train_step,
          "make_moe_lm_train_step": make_moe_lm_train_step,
          "sync_blocks": sync_blocks, "get_optimizer": get_optimizer,
          "ep_dim": ep_dim, "pp": pp, "reduce_grads": reduce_grads,
          "pair_kernel_block": _pair_kernel_block}
    try:
        res = {"rank": rank, "backend": dist.get_backend()}
        wit = p13_witnesses(torch, np, dk, cfg)
        res["pp_witness"], res["ep_witness"], res["sp_witness"] = (
            wit["pp"], wit["ep"], wit["sp"])
        res["pp"] = pp_train(torch, np, dk, fa, cfg)
        res["ep"] = ep_train(torch, np, dk, fa, cfg)
        res["sp"] = sp_train(torch, np, dk, fa, cfg)
        with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        dist.destroy_process_group()
    return 0


def p13_kernel_shapes(torch, F, fa, pp):
    """The training kernels at phase 13's shapes, as phases 5 and 5b
    measure them: the causal kernels at one pp microbatch, the pair
    kernels at one sp=2 rank's chunk."""
    t0 = time.perf_counter()
    causal = causal_cases(torch, F, fa, CAUSAL_PP)
    pair = pair_cases(torch, F, pp, PAIR_SP2)
    return {"causal_attention_pp_microbatch": causal,
            "pair_attention_sp2_chunk": pair, "tol": CAUSAL_TOL,
            "seconds": time.perf_counter() - t0}


def phase13(torch, np, F, dk, fa, pp, here, training, ring):
    """Phase 13 after phases 6 and 6b (its yardsticks): 13b's one-process
    MoE flagship, the two-rank phase, the kernels at its shapes."""
    _free(torch)
    t0 = time.perf_counter()
    moe = moe_phase(torch, np, dk, fa, pp)
    moe["seconds"] = time.perf_counter() - t0
    _emit({"moe_phase": moe})
    _free(torch)
    ranks = p13_phase(torch, np, here, {"losses6": training["losses"],
                                        "losses6b": ring["losses"]})
    _emit(ranks)
    shapes = p13_kernel_shapes(torch, F, fa, pp)
    _emit({"phase13_kernel_phase": shapes})
    return moe, ranks, shapes


# -- phase 14: the server -------------------------------------------------------


class _ThreadErrors:
    """Collects the exceptions that end any thread (server, handler,
    pump, loop) while installed as ``threading.excepthook``."""

    def __init__(self):
        self.seen = []

    def __enter__(self):
        import threading

        self._prev = threading.excepthook
        threading.excepthook = lambda a: self.seen.append(
            f"{a.thread.name if a.thread else '?'}: "
            f"{a.exc_type.__name__}: {a.exc_value}")
        return self

    def __exit__(self, *exc):
        import threading

        threading.excepthook = self._prev
        return False


def _client(dk, srv, **kw):
    kw.setdefault("timeout", 300.0)
    kw.setdefault("request_timeout", 300.0)
    return dk["ServingClient"]("127.0.0.1", srv.port, **kw)


def _stop_server(srv):
    """``stop()`` within ``SERVER_STOP_S``, every thread of the server
    joined (fails otherwise); returns the seconds it took."""
    t0 = time.perf_counter()
    srv.stop(timeout=SERVER_STOP_S)
    took = time.perf_counter() - t0
    alive = [t.name for t in srv._threads if t.is_alive()]
    if alive or took > SERVER_STOP_S:
        raise AssertionError(f"server phase: stop() left threads {alive} "
                             f"after {took:.2f} s")
    return took


def _pct(np, xs, q):
    return float(np.percentile(xs, q)) if xs else None


def drive_clients(torch, np, dk, port, requests, V, phase):
    """``SERVER_CLIENTS`` clients on ``port`` (a server or a router), each
    submitting its share of ``requests`` from one thread per request,
    which reads the stream frame by frame and stamps each frame's
    arrival. Every request must end ``length`` with its full count of
    in-vocab tokens. Returns (per request ``(tokens, reason, submit
    time, frame stamps, rid, trace id)``, wall seconds, the first
    client, still open; the caller closes it)."""
    import threading

    clients = SERVER_CLIENTS
    cls = [dk["ServingClient"]("127.0.0.1", port, timeout=300.0,
                               request_timeout=300.0)
           for _ in range(clients)]
    n = len(requests)
    out = [None] * n
    errors = []

    def one(i):
        p, c = requests[i]
        try:
            cl = cls[i % clients]
            t_sub = time.perf_counter()
            rid = cl.generate(p, **c)
            stamps, toks, reason = [], [], None
            for kind, val in cl.frames(rid):
                if kind == "tok":
                    stamps.append(time.perf_counter())
                    toks.append(val)
                else:
                    reason = val
            out[i] = (toks, reason, t_sub, stamps, rid, cl.trace_of(rid))
        except Exception as e:  # reported below, with the request
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    sync(torch)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    for c in cls[1:]:
        c.close()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"{phase}: client errors {errors}")
    for i, ((_, c), (toks, reason, *_)) in enumerate(zip(requests, out)):
        if reason != "length" or len(toks) != c["max_new_tokens"] or not all(
                0 <= t < V for t in toks):
            raise AssertionError(
                f"{phase}: request {i} ended {reason!r} after "
                f"{len(toks)} of {c['max_new_tokens']} tokens")
    return out, wall, cls[0]


def client_latency(np, out):
    """Client TTFT and inter-token p50 / p99 (ms) of ``drive_clients``'s
    streams."""
    ttft = [(o[3][0] - o[2]) * 1e3 for o in out]
    itl = [(b - a) * 1e3 for o in out for a, b in zip(o[3], o[3][1:])]
    return ({"p50": _pct(np, ttft, 50), "p99": _pct(np, ttft, 99)},
            {"p50": _pct(np, itl, 50), "p99": _pct(np, itl, 99)})


def wire_serve(torch, np, dk, model, requests, steady=False, **kw):
    """Serve ``requests`` through an ``LMServer`` on loopback (8 slots,
    64-token chunks unless ``kw`` says otherwise; an SLO monitor and the
    stall watchdog at ``FLAGSHIP_WATCHDOG_S`` armed), driven by
    ``drive_clients``. Returns (summary, streams, engine, server, a
    client, request ids) with the server still up; the caller stops
    it. ``steady`` as in :func:`serve`."""
    kw.setdefault("slots", 8)
    kw.setdefault("prefill_chunk", 64)
    tel = dk["telemetry"]
    eng = dk["ServingEngine"](model, device=DEV,
                              registry=tel.MetricRegistry(),
                              tracer=tel.Tracer(), **kw)
    slo = tel.SloMonitor(tel.default_serving_rules(),
                         registry=eng.registry, tracer=eng.tracer)
    srv = dk["LMServer"](eng, slo=slo,
                         watchdog_timeout_s=FLAGSHIP_WATCHDOG_S)
    if steady:
        eng.mark_steady()
    srv.start()
    out, wall, cl = drive_clients(torch, np, dk, srv.port, requests,
                                  model.vocab_size, "server phase")
    since = eng.recompiles_since_mark() if steady else None
    ttft, itl = client_latency(np, out)
    st = cl.stats()
    summary = {
        "requests": len(requests), "clients": SERVER_CLIENTS,
        "ticks": st["ticks"],
        "chunk_ticks": sum(1 for rec in eng.metrics.records
                           if rec.get("prefill_tokens", 0) > 0),
        "tokens": st["tokens_generated"], "wall_s": wall,
        "tok_per_s": st["tokens_generated"] / wall,
        "ms_per_tick": wall * 1e3 / max(st["ticks"], 1),
        "client_ttft_ms": ttft, "client_itl_ms": itl,
        "engine_ttft_ms": st["ttft_ms"],
        "prefix_hit_tokens": st.get("prefix_hit_tokens"),
        "stalls": eng.registry.counter("slo_stalls_total").value,
    }
    if steady:
        summary["recompiles_since_mark"] = since
    return summary, [o[0] for o in out], eng, srv, cl, [o[4] for o in out]


def server_ops(np, srv, client, rid):
    """Every telemetry op of the protocol answers ``ok`` with content:
    stats, metrics, timeseries (two forced samples), flight, alerts,
    events (after a drain and an undrain) and chrome_trace (one
    request's chain). Returns each reply's size."""
    srv.timeseries.sample()
    srv.timeseries.sample()
    client.drain()
    client.undrain()
    got = {
        "stats": len(client.stats()),
        "metrics": len(client.metrics()),
        "timeseries": len(client.timeseries()["points"]),
        "flight": len(client.flight()["ticks"]),
        "alerts": len(client.alerts()),
        "events": len(client.events()["events"]),
        "chrome_trace": len(client.chrome_trace(
            trace=client.trace_of(rid))["traceEvents"]),
    }
    empty = [k for k, v in got.items() if not v]
    if empty:
        raise AssertionError(f"server phase: ops {empty} answered empty "
                             f"({got})")
    return got


def server_flagship(torch, np, dk, pa, sp, phase3, direct):
    """14a: phase 3's flagship and mix behind an ``LMServer`` on each
    layout; launch counts zeroed just before each counted run."""
    model = dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                            device=DEV, seed=0, **FLAGSHIP)
    L = model.num_layers
    requests = dk["serving_requests"](model.vocab_size, SYSTEM_PREFIX,
                                      PROMPT_LENS)
    out, launches = {}, {}
    for layout, kw in (("paged", dict(paged=True, block_size=16)),
                       ("slot", dict(paged=False))):
        # a warm-up through its own server (the allocator, the threads)
        *_, srv, cl, _ = wire_serve(torch, np, dk, model, requests[:2], **kw)
        cl.close()
        _stop_server(srv)
        _zero_counts(pa, sp)
        summary, streams, eng, srv, cl, rids = wire_serve(
            torch, np, dk, model, requests, steady=True, **kw)
        steady_check(f"server phase ({layout})", summary)
        used = {"paged_attention": pa.paged_attention.launches,
                "splash_prefill": sp.splash_prefill_attention.launches}
        routes = {"paged_attention": dict(pa.paged_attention.routes),
                  "splash_prefill": dict(sp.splash_prefill_attention.routes)}
        summary["ops"] = server_ops(np, srv, cl, rids[0])
        cl.close()
        summary["stop_s"] = _stop_server(srv)
        if layout == "paged":
            key, need = "paged_attention", summary["ticks"] * L
        else:
            key, need = "splash_prefill", summary["chunk_ticks"] * L
        if used[key] < need or used[key] == 0:
            raise AssertionError(f"server phase ({layout}): {used[key]} "
                                 f"{key} launches < {need}")
        if not routes[key] or any(not BF16_ROUTE.fullmatch(r)
                                  for r in routes[key]):
            raise AssertionError(f"server phase ({layout}): routes "
                                 f"{routes[key]} are not all the bf16 "
                                 f"split kernels")
        summary["launches"] = used
        summary["routes"] = routes[key]
        summary["direct_tok_per_s"] = phase3[layout]["tok_per_s"]
        summary["direct_ms_per_tick"] = phase3[layout]["ms_per_tick"]
        summary["greedy_match_vs_direct"] = greedy_match(
            requests, streams, direct[layout])
        out[layout] = summary
        launches[key] = used[key]
        del eng
    del model
    _free(torch)
    return out, launches


def _rest_of_stream(head, frames):
    """(tokens, finish reason) of a stream whose first frame ``head``
    was already read from ``frames``."""
    toks = []
    kind, val = head
    while kind != "end":
        toks.append(val)
        kind, val = next(frames)
    return toks, val


def _wire_streams(np, client, requests):
    rids = [client.generate(p, **c) for p, c in requests]
    return [client.result(r) for r in rids]


def server_exact(torch, np, dk, pa, sp, workdir):
    """14b: phase 4's small f32 model behind ``LMServer`` with the
    kernels on: greedy streams over TCP equal ``generate()`` on both
    layouts; a ``push_weights`` sent mid-stream drops no stream, bumps
    the version, and requests admitted after its ack equal an engine
    built on the new weights; ``export_kv`` -> ``import_kv`` between two
    servers gives a decode stream equal to ``generate()`` from the
    migrated cache; a control call that holds the loop for 3x the
    watchdog's timeout while requests are queued writes a postmortem
    that ``report.report_flight`` renders; every ``stop()`` joins its
    threads."""
    import io
    import threading

    tel = dk["telemetry"]
    make = dk["get_model"]
    model = make("transformer_lm", dtype=torch.float32, device=DEV, seed=3,
                 **EXACT)
    new = make("transformer_lm", dtype=torch.float32, device=DEV, seed=8,
               **EXACT)
    new_tree = dk["bridge"].params_to_jax(new)
    requests = exact_requests(np, model.vocab_size)
    greedy = [(p, c) for p, c in requests if c.get("temperature", 0.0) == 0]
    refs = [dk["generate"](model, p[None], c["max_new_tokens"])[
        0, len(p):].tolist() for p, c in greedy]

    def server(m, **kw):
        srv = start_server(dk, m, **kw)
        return srv.engine, srv, _client(dk, srv)

    res = {}
    for layout, lkw in (("paged", dict(paged=True, block_size=16)),
                        ("slot", dict(paged=False))):
        before = _launches(pa, sp)
        m = make("transformer_lm", dtype=torch.float32, device=DEV, seed=3,
                 **EXACT)
        eng, srv, cl = server(m, pipeline=True, **lkw)
        got = _wire_streams(np, cl, greedy)
        _differ(torch, np, model, greedy, [t for t, _ in got], refs,
                f"{layout} greedy over TCP vs generate()",
                phase="server phase")
        # the push goes out once every stream below has its first token
        # (emitted on version 1); a stream whose finish span carries the
        # pushed version was in flight when the swap landed
        rids = [cl.generate(p, **c) for p, c in requests]
        streams = [cl.frames(r) for r in rids]
        heads = [next(s) for s in streams]
        pusher = _client(dk, srv)
        ack = pusher.push_weights(new_tree, chunk_bytes=1 << 20)
        pusher.close()
        mid = [_rest_of_stream(h, s) for h, s in zip(heads, streams)]
        if any(reason != "length" or len(t) != c["max_new_tokens"]
               for (t, reason), (_, c) in zip(mid, requests)):
            raise AssertionError(f"server phase ({layout}): a stream in "
                                 f"flight across the push ended short "
                                 f"{[(len(t), r) for t, r in mid]}")
        if ack["version"] != 2 or eng.weight_version != 2:
            raise AssertionError(f"server phase ({layout}): push ack "
                                 f"{ack}, engine at {eng.weight_version}")
        finish_wv = [[sp["wv"] for sp in cl.trace_dump(trace=cl.trace_of(r))
                      if sp["span"] == "finish"] for r in rids]
        across = sum(wv == [2] for wv in finish_wv)
        if across == 0:
            raise AssertionError(f"server phase ({layout}): every stream "
                                 f"ended before the swap landed (finish "
                                 f"versions {finish_wv}): the push was "
                                 f"not mid-stream")
        after = [t for t, _ in _wire_streams(np, cl, requests)]
        _, fresh, _ = serve(torch, np, dk, new, requests, **lkw)
        # greedy streams must be equal; sampled ones are counted (the
        # wire's admission timing sets which rows share a tick)
        sampled = [c.get("temperature", 0.0) != 0.0 for _, c in requests]
        _differ(torch, np, new, requests,
                [None if x else t for x, t in zip(sampled, after)],
                [None if x else t for x, t in zip(sampled, fresh)],
                f"{layout} greedy after a wire push vs an engine on the "
                f"new weights", phase="server phase")
        cl.close()
        stop_s = _stop_server(srv)
        used = _launches(pa, sp)[0 if layout == "paged" else 1] - before[
            0 if layout == "paged" else 1]
        if used == 0:
            raise AssertionError(f"server phase ({layout}) ran without "
                                 f"its kernel")
        res[layout] = {"greedy_equal": True, "push": ack,
                       "streams_across_push": across,
                       "after_push_greedy_equal": True,
                       "after_push_sampled_equal": sum(
                           int(a == f) for x, a, f in zip(sampled, after,
                                                          fresh) if x),
                       "sampled": sum(sampled), "kernel_launches": used,
                       "stop_s": stop_s}
        del eng, m

    # KV migration between a prefill and a decode server
    prompt, _ = requests[3]
    want = dk["generate"](model, prompt[None], 16)[0, len(prompt):].tolist()
    kw = dict(paged=True, block_size=16)
    src_eng, src, c1 = server(model, role="prefill", **kw)
    dst_eng, dst, c2 = server(model, role="decode", **kw)
    c1.result(c1.generate(prompt, max_new_tokens=1))
    exp = c1.export_kv(prompt)
    imp = c2.import_kv(prompt, exp["blocks"])
    toks, _ = c2.result(c2.generate(prompt, max_new_tokens=16))
    if toks != want:
        _differ(torch, np, model, [(prompt, dict(max_new_tokens=16))],
                [toks], [want], "decode server after import_kv vs "
                "generate()", phase="server phase")
    if imp["tokens"] == 0 or dst_eng.prefix_hit_tokens != imp["tokens"]:
        raise AssertionError(f"server phase: the import ({imp}) did not "
                             f"serve the prompt's prefix")
    res["migrate"] = {"exported_tokens": exp["tokens"], **imp,
                      "stream_equal": True}
    for c, s in ((c1, src), (c2, dst)):
        c.close()
        _stop_server(s)

    # the watchdog: hold the loop while requests queue
    eng = dk["ServingEngine"](model, device=DEV, slots=8, prefill_chunk=64,
                              postmortem_dir=workdir,
                              registry=tel.MetricRegistry(),
                              tracer=tel.Tracer(), **kw)
    srv = dk["LMServer"](eng, watchdog_timeout_s=WATCHDOG_S).start()
    cl = _client(dk, srv)
    cl.result(cl.generate(greedy[0][0], max_new_tokens=4))  # ticks to dump
    holding = threading.Event()

    def hold():
        holding.set()
        time.sleep(3 * WATCHDOG_S)

    t = threading.Thread(target=eng.call_in_loop, args=(hold, 60.0),
                         daemon=True)
    t.start()
    holding.wait(60.0)
    rids = [cl.generate(p, **c) for p, c in greedy]
    t.join(60.0)
    queued = [cl.result(r) for r in rids]
    dump = srv._watchdog.last_dump
    if not dump or not os.path.exists(dump):
        raise AssertionError("server phase: the watchdog wrote no "
                             "postmortem while the loop was held")
    text = io.StringIO()
    dk["report"].report_flight(dump, out=text)
    if "reason=stall" not in text.getvalue():
        raise AssertionError(f"server phase: the postmortem does not "
                             f"render as a stall: {text.getvalue()[:300]}")
    if [tk for tk, _ in queued] != refs:
        raise AssertionError("server phase: requests queued behind the "
                             "held loop differ from generate()")
    res["watchdog"] = {"postmortem": os.path.basename(dump),
                       "stalls": eng.registry.counter(
                           "slo_stalls_total").value,
                       "rendered_lines": len(text.getvalue().splitlines())}
    cl.close()
    res["watchdog"]["stop_s"] = _stop_server(srv)
    del model, new
    _free(torch)
    return res


def lock_order():
    """The port's lock-order detector over the port's own locks (every
    ``threading.Lock`` / ``RLock`` allocated from ``distkeras_torch``
    while it is installed)."""
    from distkeras_torch.analysis.lockorder import LockOrderDetector

    return LockOrderDetector(packages=("distkeras_torch",))


def lock_order_result(phase, det):
    """The edges the phase's locks formed; a cycle fails the phase."""
    try:
        det.assert_no_cycles()
    except AssertionError as e:
        raise AssertionError(f"{phase}: {e}") from None
    return {"edges": det.edge_count(), "cycles": 0}


def server_phase(torch, np, dk, pa, sp, phase3, direct):
    """Phase 14: 14a then 14b, every thread's exceptions collected (any
    fails the phase), the servers and clients under the lock-order
    detector (a cycle fails the phase)."""
    workdir = tempfile.mkdtemp(prefix="dk_phase14_")
    try:
        with _ThreadErrors() as errs, lock_order() as det:
            flagship, launches = server_flagship(torch, np, dk, pa, sp,
                                                 phase3, direct)
            exact = server_exact(torch, np, dk, pa, sp, workdir)
        if errs.seen:
            raise AssertionError(f"server phase: threads raised "
                                 f"{errs.seen}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"14a": flagship, "14b": exact, "thread_errors": 0,
            "lock_order": lock_order_result("server phase", det)}, launches


def start_server(dk, model, **kw):
    """A started ``LMServer`` over an engine of ``model`` on the card (8
    slots, 64-token chunks unless ``kw`` says otherwise)."""
    kw.setdefault("slots", 8)
    kw.setdefault("prefill_chunk", 64)
    tel = dk["telemetry"]
    eng = dk["ServingEngine"](model, device=DEV,
                              registry=tel.MetricRegistry(),
                              tracer=tel.Tracer(), **kw)
    return dk["LMServer"](eng).start()


def fleet_router(dk, servers, **kw):
    """A started ``Router`` over ``servers`` (named r0, r1, ...), once
    every replica is probed routable with its role known."""
    tel = dk["telemetry"]
    kw = {"block_size": 16, "poll_interval": 0.1,
          "registry": tel.MetricRegistry(), "tracer": tel.Tracer(), **kw}
    router = dk["Router"]([("127.0.0.1", s.port, f"r{i}")
                           for i, s in enumerate(servers)], **kw).start()
    deadline = time.monotonic() + 60
    while len(router.manager.routable()) < len(servers):
        if time.monotonic() > deadline:
            raise AssertionError("fleet phase: replicas never routable")
        router.manager.probe_all()
        time.sleep(0.02)
    return router


def _stop_router(router):
    t0 = time.perf_counter()
    router.stop(timeout=SERVER_STOP_S)
    alive = [t.name for t in router._threads if t.is_alive()]
    if alive:
        raise AssertionError(f"fleet phase: the router's stop() left "
                             f"threads {alive}")
    return time.perf_counter() - t0


def _own_models(models):
    """Fail if two replicas' models share a parameter: a push to one
    replica would then swap the others' weights too."""
    seen = {}
    for i, m in enumerate(models):
        for p in m.parameters():
            j = seen.setdefault(p.data_ptr(), i)
            if j != i:
                raise AssertionError(f"fleet phase: replicas {j} and {i} "
                                     f"share their model's parameters")


def _settle(engines, done0, want, timeout=30.0):
    """Requests completed on each engine since ``done0``, once they sum
    to ``want`` (an engine counts a request after its last frame is
    out)."""
    deadline = time.monotonic() + timeout
    while True:
        served = [e.requests_completed - d for e, d in zip(engines, done0)]
        if sum(served) >= want or time.monotonic() > deadline:
            return served
        time.sleep(0.01)


def _tick_ms(np, eng, since):
    """Mean ms of ``eng``'s ticks after tick ``since`` (its flight
    recorder), None when it ticked none."""
    ms = [r["tick_ms"] for r in eng.flight.snapshots()
          if r.get("kind") == "tick" and r.get("tick", 0) > since]
    return float(np.mean(ms)) if ms else None


def _routing(router):
    """(routed a replica, routed by decision) from the router's
    counters."""
    by_rep, by_dec = {}, {}
    for s in router.registry.get(
            "router_requests_routed_total").snapshot()["series"]:
        r, d = s["labels"]["replica"], s["labels"]["decision"]
        by_rep[r] = by_rep.get(r, 0) + int(s["value"])
        by_dec[d] = by_dec.get(d, 0) + int(s["value"])
    return by_rep, by_dec


def _route_of(client, tid):
    """(replica, decision) of the last ``router.route`` span of a
    request's merged chain."""
    spans = [s for s in client.trace_dump(trace=tid)
             if s["span"] == "router.route"]
    return spans[-1]["replica"], spans[-1]["decision"]


def fleet_flagship(torch, np, dk, pa, sp, phase3, direct, server14=None):
    """15a: phase 3's flagship and mix through ``Router(policy=
    'affine')`` over three paged replicas (a model each, int8 cache, 8
    slots, 64-token chunks), 4 clients; then one ``prefill`` replica
    (monolithic prefill) and two ``decode`` replicas with
    ``disagg_prompt_tokens=FLEET_DISAGG_TOKENS``. Launch counts zeroed
    just before each counted run."""
    models = [dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                              device=DEV, seed=0, **FLAGSHIP)
              for _ in range(FLEET_REPLICAS)]
    _own_models(models)
    L, V = models[0].num_layers, models[0].vocab_size
    requests = dk["serving_requests"](V, SYSTEM_PREFIX, PROMPT_LENS)
    group = [i for i, (p, _) in enumerate(requests) if len(p) > SYSTEM_PREFIX]
    longs = [i for i, (p, _) in enumerate(requests)
             if len(p) >= FLEET_DISAGG_TOKENS]
    res, launches = {}, {}
    for name, roles, rkw in (
            ("uniform", ("mixed",) * FLEET_REPLICAS, {"policy": "affine"}),
            ("disagg", ("prefill",) + ("decode",) * (FLEET_REPLICAS - 1),
             {"policy": "affine",
              "disagg_prompt_tokens": FLEET_DISAGG_TOKENS})):
        servers = [start_server(dk, m, paged=True, block_size=16, role=r,
                                **({"prefill_chunk": None}
                                   if r == "prefill" else {}))
                   for m, r in zip(models, roles)]
        # a warm-up request a replica (the allocator, the threads), on a
        # throwaway prompt
        wrng = np.random.default_rng(999)
        for s in servers:
            c = _client(dk, s)
            c.result(c.generate(wrng.integers(0, V, size=96).astype(
                np.int32), max_new_tokens=4))
            c.close()
        router = fleet_router(dk, servers, **rkw)
        engines = [s.engine for s in servers]
        _settle(engines, [0] * len(engines), len(engines))
        ticks0 = [e.ticks for e in engines]
        done0 = [e.requests_completed for e in engines]
        _zero_counts(pa, sp)
        out, wall, cl = drive_clients(torch, np, dk, router.port, requests,
                                      V, f"fleet phase ({name})")
        st = cl.stats()["router"]
        served = _settle(engines, done0, len(requests) + int(
            st["kv_migrations"]))
        used = pa.paged_attention.launches
        routes = dict(pa.paged_attention.routes)
        ticks = [e.ticks - t for e, t in zip(engines, ticks0)]
        by_rep, by_dec = _routing(router)
        spilled = int(st["spilled"])
        place = [_route_of(cl, o[5]) for o in out]
        cl.close()
        names = [f"r{i}" for i in range(len(servers))]
        if sum(by_rep.values()) != len(requests) or any(
                by_rep.get(n, 0) != k for n, k, r in
                zip(names, served, roles) if r != "prefill"):
            raise AssertionError(f"fleet phase ({name}): routed {by_rep} "
                                 f"(spilled {spilled}) against served "
                                 f"{served}")
        if name == "uniform":
            homes = {place[i][0] for i in group if place[i][1] != "spill"}
            if len(homes) != 1:
                raise AssertionError(f"fleet phase: the prefix group went "
                                     f"to {sorted(homes)} without a spill "
                                     f"({[place[i] for i in group]})")
        else:
            migrations = int(st["kv_migrations"])
            if migrations != len(longs) or served[0] != migrations:
                raise AssertionError(
                    f"fleet phase: {migrations} KV migrations, {served[0]} "
                    f"prefill runs for {len(longs)} prompts of >= "
                    f"{FLEET_DISAGG_TOKENS} tokens")
        if used < sum(ticks) * L or any(t == 0 for t, k in zip(ticks, served)
                                        if k):
            raise AssertionError(f"fleet phase ({name}): {used} paged "
                                 f"launches < ticks {ticks} x {L}")
        if not routes or any(not BF16_ROUTE.fullmatch(r) for r in routes):
            raise AssertionError(f"fleet phase ({name}): routes {routes} "
                                 f"are not all the bf16 split kernels")
        ttft, itl = client_latency(np, out)
        streams = [o[0] for o in out]
        tokens = sum(len(t) for t in streams)
        res[name] = {
            "replicas": dict(zip(names, roles)), "requests": len(requests),
            "tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
            "ticks": ticks, "served": served,
            # each replica's own ticks (flight recorder: plan + device +
            # streaming), not the wall over its ticks: a replica idles
            # part of the run
            "ms_per_tick": [_tick_ms(np, e, t) for e, t in zip(engines,
                                                             ticks0)],
            "client_ttft_ms": ttft, "client_itl_ms": itl,
            "routed": by_rep, "decisions": by_dec, "spilled": spilled,
            "prefix_group_replicas": sorted({place[i][0] for i in group}),
            "kv_migrations": int(st["kv_migrations"]),
            "launches": used, "routes": routes,
            "greedy_match_vs_direct": greedy_match(requests, streams,
                                                   direct["paged"]),
        }
        launches[name] = used
        res[name]["stop_s"] = _stop_router(router) + sum(
            _stop_server(s) for s in servers)
        del engines
    res["direct_tok_per_s"] = phase3["paged"]["tok_per_s"]
    res["direct_ms_per_tick"] = phase3["paged"]["ms_per_tick"]
    if server14:
        res["server_tok_per_s"] = server14["tok_per_s"]
        res["server_ms_per_tick"] = server14["ms_per_tick"]
        res["server_client_ttft_ms"] = server14["client_ttft_ms"]
        res["server_client_itl_ms"] = server14["client_itl_ms"]
    del models
    _free(torch)
    return res, launches


def _hold(eng):
    """Hold ``eng``'s loop at the top of its next step (nothing is
    emitted meanwhile); returns the Event that releases it."""
    import threading

    held, release = threading.Event(), threading.Event()

    def hold():
        held.set()
        release.wait(120)

    threading.Thread(target=eng.call_in_loop, args=(hold, 120.0),
                     daemon=True).start()
    if not held.wait(60):
        raise AssertionError("fleet phase: the loop was never held")
    return release


def _fleet_refs(torch, np, dk, model, requests, solo):
    """The streams each request must equal: ``generate()``'s for greedy
    requests, the solo engine's ``solo`` for seeded sampled ones."""
    return [dk["generate"](model, p[None], c["max_new_tokens"])[
        0, len(p):].tolist() if c.get("temperature", 0.0) == 0.0 else s
        for (p, c), s in zip(requests, solo)]


def fleet_exact(torch, np, dk, pa, sp):
    """15b: phase 4's f32 model with the kernels on, three pipelined
    paged replicas behind the router: greedy streams equal
    ``generate()``, seeded sampled ones a solo engine's, through a
    failover, a rolling update, a disaggregated migration and an
    ``Autoscaler`` that scales up and down with an exact ``replay()``."""
    import threading

    tel = dk["telemetry"]

    def make(seed=3):
        return dk["get_model"]("transformer_lm", dtype=torch.float32,
                               device=DEV, seed=seed, **EXACT)

    model, new = make(), make(8)
    new_tree = dk["bridge"].params_to_jax(new)
    requests = exact_requests(np, model.vocab_size)
    kw = dict(paged=True, block_size=16)
    _, solo, _ = serve(torch, np, dk, model, requests, **kw)
    refs = _fleet_refs(torch, np, dk, model, requests, solo)
    before = _launches(pa, sp)[0]
    probe = dict(poll_interval=0.05, down_after=1, backoff_base=0.05)
    res = {}

    def fleet(n, **ekw):
        models = [make() for _ in range(n)]
        _own_models(models)
        return [start_server(dk, m, **kw, **ekw) for m in models]

    def streams(cl, reqs):
        rids = [cl.generate(p, **c) for p, c in reqs]
        frames = [cl.frames(r) for r in rids]
        return frames, [next(f) for f in frames]

    # (1) failover: every stream has its first token; the replica with
    # the most streams in flight is held, then stopped
    servers = fleet(FLEET_REPLICAS, pipeline=True)
    router = fleet_router(dk, servers, **probe)
    cl = _client(dk, router)
    got = _wire_streams(np, cl, requests)
    _differ(torch, np, model, requests, [t for t, _ in got], refs,
            "streams through the router vs generate() / a solo engine",
            phase="fleet phase")
    frames, heads = streams(cl, requests)
    by = router.stats()["router"]["inflight_by_replica"]
    victim = max(by, key=by.get)
    held = servers[int(victim[1:])]
    release = _hold(held.engine)
    time.sleep(0.2)  # frames already sent reach the router
    on_victim = router.stats()["router"]["inflight_by_replica"][victim]
    stopper = threading.Thread(target=held.stop, args=(SERVER_STOP_S,),
                               daemon=True)
    stopper.start()
    after = [_rest_of_stream(h, f) for h, f in zip(heads, frames)]
    release.set()
    stopper.join(60)
    _differ(torch, np, model, requests, [t for t, _ in after], refs,
            f"streams across the failover of {victim}", phase="fleet phase")
    fam = router.registry.get("router_requests_failed_over_total")
    kinds = {s["labels"]["kind"]: int(s["value"])
             for s in fam.snapshot()["series"]}
    st = cl.stats()["router"]
    if (st["failed"] != 0 or kinds.get("replayed", 0) < 1
            or any(r != "length" for _, r in after)):
        raise AssertionError(f"fleet phase: failover of {victim} "
                             f"({on_victim} in flight): failed "
                             f"{st['failed']}, failed over {kinds}, "
                             f"reasons {[r for _, r in after]}")
    res["failover"] = {"victim": victim, "in_flight": on_victim,
                       "failed_over": kinds, "failed": int(st["failed"]),
                       "streams_equal": True}
    cl.close()
    _stop_router(router)
    for s in servers:
        s.stop(SERVER_STOP_S)

    # (2) a rolling update with streams in flight
    servers = fleet(FLEET_REPLICAS, pipeline=True)
    router = fleet_router(dk, servers, **probe)
    cl = _client(dk, router)
    frames, heads = streams(cl, requests)
    low = [len(servers)]
    watching = threading.Event()

    def watch():
        while not watching.is_set():
            low[0] = min(low[0], len(router.manager.routable()))
            time.sleep(0.002)

    w = threading.Thread(target=watch, daemon=True)
    w.start()
    report = router.rolling_update(new_tree, version=2,
                                   retry_timeout_s=120.0)
    watching.set()
    w.join(10)
    mid = [_rest_of_stream(h, f) for h, f in zip(heads, frames)]
    versions = [s.engine.weight_version for s in servers]
    if (report["failed"] or versions != [2] * len(servers)
            or low[0] < len(servers) - 1
            or any(r != "length" or len(t) != c["max_new_tokens"]
                   for (t, r), (_, c) in zip(mid, requests))):
        raise AssertionError(f"fleet phase: rolling update {report}, "
                             f"versions {versions}, at least {low[0]} "
                             f"routable, streams "
                             f"{[(len(t), r) for t, r in mid]}")
    greedy = [(p, c) for p, c in requests if c.get("temperature", 0.0) == 0]
    after = [t for t, _ in _wire_streams(np, cl, greedy)]
    _, fresh, _ = serve(torch, np, dk, new, greedy, **kw)
    _differ(torch, np, new, greedy, after, fresh,
            "greedy after a rolling update vs an engine on the new weights",
            phase="fleet phase")
    res["rolling_update"] = {
        "version": report["version"], "updated": report["updated"],
        "swap_ms": report["swap_ms"], "min_routable": low[0],
        "streams_across": len(mid), "after_greedy_equal": True}
    cl.close()
    _stop_router(router)
    for s in servers:
        _stop_server(s)

    # (3) a prefill -> decode migration
    servers = [start_server(dk, make(), role="prefill", prefill_chunk=None,
                            **kw),
               start_server(dk, make(), role="decode", **kw)]
    router = fleet_router(dk, servers, disagg_prompt_tokens=64)
    cl = _client(dk, router)
    got = [t for t, _ in _wire_streams(np, cl, greedy)]
    want = [r for (p, c), r in zip(requests, refs)
            if c.get("temperature", 0.0) == 0]
    _differ(torch, np, model, greedy, got, want,
            "streams served from migrated KV vs generate()",
            phase="fleet phase")
    mig = {s["labels"]["outcome"]: int(s["value"]) for s in router.metrics()[
        "serving_kv_migrations_total"]["series"]}
    if mig.get("ok", 0) < 1:
        raise AssertionError(f"fleet phase: no KV migration ({mig})")
    res["disagg"] = {"migrations": mig, "streams_equal": True}
    cl.close()
    _stop_router(router)
    for s in servers:
        _stop_server(s)

    # (4) the Autoscaler: one 1-slot replica under queue pressure, a
    # fresh server spawned on the card, then a drain-and-retire
    active = start_server(dk, make(), slots=1, **kw)
    router = fleet_router(dk, [active], **probe)
    spawned = []

    def spawn():
        spawned.append(start_server(dk, make(), slots=1, **kw))
        return ("127.0.0.1", spawned[-1].port, f"r{len(spawned)}")

    retired = []
    auto = dk["Autoscaler"](router, spawn=spawn, retire=retired.append,
                            registry=tel.MetricRegistry(),
                            tracer=tel.Tracer(), min_replicas=1,
                            max_replicas=2, queue_high=2.0, queue_low=0.5,
                            up_consecutive=2, down_consecutive=2,
                            cooldown_s=0.5, rebalance=False)
    cl = _client(dk, router)
    rids = [cl.generate(p, **c) for p, c in requests]
    now, acts = 0.0, []
    for phase_ in ("scale_up", "scale_down"):
        for _ in range(40):
            router.manager.probe_all()
            a = auto.step(now=now)
            now += 1.0
            if a:
                acts.append(a)
                break
            if phase_ == "scale_down":
                time.sleep(0.05)
        if phase_ == "scale_up":
            got = [cl.result(r) for r in rids]
            _differ(torch, np, model, requests, [t for t, _ in got], refs,
                    "streams through the autoscaled fleet",
                    phase="fleet phase")
    kinds = [a["action"] for a in acts]
    replay_ok = auto.replay() == auto.decisions()
    if (kinds != ["scale_up", "scale_down"] or not all(a["ok"] for a in acts)
            or not replay_ok or not retired
            or len(router.manager.routable()) != 1):
        raise AssertionError(f"fleet phase: autoscaler acted {acts}, "
                             f"replay exact {replay_ok}, retired {retired}")
    res["autoscaler"] = {"actions": kinds, "replay_exact": True,
                         "retired": retired, "polls": len(auto.signal_log)}
    cl.close()
    _stop_router(router)
    for s in [active] + spawned:
        _stop_server(s)
    res["kernel_launches"] = _launches(pa, sp)[0] - before
    if res["kernel_launches"] == 0:
        raise AssertionError("fleet phase (15b) ran without its kernel")
    del model, new
    _free(torch)
    return res


def fleet_phase(torch, np, dk, pa, sp, phase3, direct, server14=None):
    """Phase 15: 15a then 15b, every thread's exceptions collected (any
    fails the phase), the replicas, router and clients under the
    lock-order detector (a cycle fails the phase)."""
    with _ThreadErrors() as errs, lock_order() as det:
        flagship, launches = fleet_flagship(torch, np, dk, pa, sp, phase3,
                                            direct, server14)
        exact = fleet_exact(torch, np, dk, pa, sp)
    if errs.seen:
        raise AssertionError(f"fleet phase: threads raised {errs.seen}")
    return {"15a": flagship, "15b": exact, "thread_errors": 0,
            "lock_order": lock_order_result("fleet phase", det)}, launches



# -- phase 16: a tensor-parallel engine behind LMServer ---------------------


def _yard(serving, chunked, tp12b=None, server14a=None):
    """Phase 16's yardsticks: phase 3's streams and tok/s by layout, and
    phase 12b's (rank 0's) and 14a's tok/s where the run has them."""
    def rates(phase, first=False):
        if phase is None:
            return None
        return {lay: {"tok_per_s": (phase[lay]["tok_per_s"][0] if first
                                    else phase[lay]["tok_per_s"])}
                for lay in ("paged", "slot")}

    return {"phase3_streams": chunked, "phase3": rates(serving),
            "12b": rates(tp12b, first=True), "14a": rates(server14a)}


def tp_server_phase(torch, np, dk, here, yard, cards=None, python=None):
    """Phase 16: two tp ranks (``chip_smoke.py --phase16-worker``, one
    card each over NCCL with two cards or more, else both on one card
    over gloo; gloo CPU ranks when ``DEV`` is the CPU) each build the
    same tp=2 engine and ``LMServer``; rank 0 serves the wire, rank 1
    follows. This process plays the clients (16a, then 16b) and signals
    each server's end through files; ``yard`` holds phase 3's results
    and, where the run has them, phase 12b's and 14a's. A rank's own
    failure (it names the rank) is preferred over what the clients saw
    of it."""
    if cards is None:
        cards = torch.cuda.device_count() if DEV == "cuda" else 1
    backend = "nccl" if DEV == "cuda" and cards >= 2 else "gloo"
    cfg = {"out": tempfile.mkdtemp(prefix="dk_phase16_"),
           "port": _free_port(), "device": DEV, "backend": backend,
           "cards": min(cards, TP) if DEV == "cuda" else 0,
           "flagship": FLAGSHIP, "system_prefix": SYSTEM_PREFIX,
           "prompt_lens": PROMPT_LENS, "exact": EXACT,
           "watchdog_s": FLAGSHIP_WATCHDOG_S, "stop_s": SERVER_STOP_S,
           "wait_s": TP_SERVER_WAIT_S, "t0": time.time()}
    from distkeras_torch.parallel.ranks import Ranks

    run = Ranks("16", os.path.join(here, "chip_smoke.py"),
                "--phase16-worker", cfg, TP, python)
    try:
        with _ThreadErrors() as errs:
            try:
                # 16a's push payload, made while the ranks start
                t0 = time.perf_counter()
                model = dk["get_model"]("transformer_lm",
                                        dtype=torch.bfloat16, device=DEV,
                                        seed=0, **FLAGSHIP)
                payload = dk["serialize_weights"](
                    dk["bridge"].params_to_jax(model))
                del model
                _free(torch)
                made_s = time.perf_counter() - t0
                a = tp_server_flagship(torch, np, dk, run, cfg, yard,
                                       payload)
                a["paged"]["push"]["payload_s"] = made_s
                del payload
                b = tp_server_exact(torch, np, dk, run, cfg)
            except BaseException as e:
                err = run.failure(grace=30.0)
                if err is not None:
                    raise err from e
                raise
        if errs.seen:
            raise AssertionError(f"16: threads raised {errs.seen}")
        ranks = run.wait(TP_SERVER_WAIT_S)
        wall = run.seconds()
    finally:
        run.close()
    return tp_server_check(np, ranks, cfg, a, b, wall)


def _param_sums(eng):
    """Each served parameter's sum in f64, read once: equal lists mean
    the same weights (a push of the same tree leaves them unchanged)."""
    return [float(p.double().sum()) for p in eng._served.parameters()]


def tp_server_ops(np, client, rid):
    """16a's telemetry ops: each answers with content (events after a
    drain and an undrain)."""
    client.drain()
    client.undrain()
    got = {"stats": len(client.stats()),
           "metrics": len(client.metrics()),
           "flight": len(client.flight()["ticks"]),
           "events": len(client.events()["events"]),
           "chrome_trace": len(client.chrome_trace(
               trace=client.trace_of(rid))["traceEvents"]),
           "alerts": len(client.alerts())}
    empty = [k for k, v in got.items() if not v and k != "alerts"]
    if empty:
        raise AssertionError(f"16a: ops {empty} answered empty ({got})")
    return got


def tp_server_flagship(torch, np, dk, run, cfg, yard, payload):
    """16a, the clients' side: phase 3's mix from ``SERVER_CLIENTS``
    clients through the tp=2 server on each layout; on the paged one,
    then, one push of the flagship's own weights as version 2
    (``payload``: them, serialized)."""
    wait = cfg["wait_s"]
    V = FLAGSHIP["vocab_size"]
    requests = dk["serving_requests"](V, SYSTEM_PREFIX, PROMPT_LENS)
    out = {}
    for layout in ("paged", "slot"):
        t_wait = time.perf_counter()
        port = run.await_file(f"16a_{layout}.port", wait)["port"]
        t_layout = time.perf_counter()
        got, wall, cl = drive_clients(torch, np, dk, port, requests, V,
                                      f"16a ({layout})")
        ttft, itl = client_latency(np, got)
        st = cl.stats()
        summary = {
            "requests": len(requests), "clients": SERVER_CLIENTS,
            "tokens": st["tokens_generated"], "wall_s": wall,
            "tok_per_s": st["tokens_generated"] / wall,
            "ticks": st["ticks"],
            "ms_per_tick": wall * 1e3 / max(st["ticks"], 1),
            "client_ttft_ms": ttft, "client_itl_ms": itl,
            "control_record_ms": st["lockstep"]["record_ms_mean"],
            "control_records": st["lockstep"]["records"],
            "greedy_match_vs_phase3": greedy_match(
                requests, [o[0] for o in got],
                yard["phase3_streams"][layout]),
            # the same mix: phase 3's direct engine, 12b's direct tp=2
            # engine and 14a's one-card server (None where this run did
            # not have them)
            "yardstick_tok_per_s": {
                k: (yard[k][layout]["tok_per_s"] if yard.get(k) else None)
                for k in ("phase3", "12b", "14a")},
            "rids": [o[4] for o in got], "streams": [o[0] for o in got]}
        summary["ops"] = tp_server_ops(np, cl, got[0][4])
        if layout == "paged":
            t0 = time.perf_counter()
            # frames of 12 MiB (the server takes up to 16)
            ack = cl.push_weights(payload=payload, version=2,
                                  chunk_bytes=12 << 20)
            push_s = time.perf_counter() - t0
            last = cl.stats()["lockstep"]["last_op"]
            if ack["version"] != 2 or last["op"] != "update_weights":
                raise AssertionError(f"16a: the push answered {ack}, the "
                                     f"leader's last op {last}")
            summary["push"] = {"ack": ack, "wall_s": push_s,
                               "bytes": last["bytes"],
                               "broadcast_ms": last["broadcast_ms"],
                               "swap_ms": last["apply_ms"]}
        cl.close()
        run.post(f"16a_{layout}.stop")
        summary["port_wait_s"] = t_layout - t_wait
        summary["seconds"] = time.perf_counter() - t_layout
        out[layout] = summary
    return out


def _beside(here, there):
    """``here()`` in this thread while ``there()`` runs in another:
    ``(here's result, there's)``."""
    import threading

    box = {}

    def run():
        try:
            box["val"] = there()
        except BaseException as e:  # re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    got = here()
    t.join()
    if "err" in box:
        raise box["err"]
    return got, box["val"]


def _seq(client, requests):
    """``requests`` through ``client`` one at a time (each alone in the
    engine, whatever the server: the same plan on every server), as
    ``(tokens, reason)`` and the request ids."""
    outs, rids = [], []
    for p, c in requests:
        rids.append(client.generate(p, **c))
        outs.append(client.result(rids[-1]))
    return outs, rids


def tp_server_exact(torch, np, dk, run, cfg):
    """16b, the clients' side: phase 4's f32 model on the tp=2 server
    against tp=1 servers in this process, each layout — phase 4's first
    greedy and first sampled requests one at a time, equal token for
    token; on the paged layout again after a push of new weights, a
    reconfigure and a drain (against a server built on the new weights),
    then through a
    ``Router(disagg_prompt_tokens=...)`` whose prefill replica is the
    tp=2 server and whose decode replica is a tp=1 one (tp=2 -> tp=1
    migrations), and through an ``export_kv`` from a tp=1 server into
    the tp=2 one (tp=1 -> tp=2)."""
    wait = cfg["wait_s"]

    def make(seed):
        return dk["get_model"]("transformer_lm", dtype=torch.float32,
                               device=DEV, seed=seed, **EXACT)

    V = EXACT["vocab_size"]
    # phase 4's first greedy and first sampled request
    requests = [exact_requests(np, V)[i] for i in (0, 2)]
    new_tree = dk["bridge"].params_to_jax(make(8))
    res = {}
    for layout in ("paged", "slot"):
        lkw = dict(paged=layout == "paged", block_size=16)
        port = run.await_file(f"16b_{layout}.port", wait)["port"]
        t_layout = time.perf_counter()
        c2 = dk["ServingClient"]("127.0.0.1", port, timeout=300.0,
                                 request_timeout=300.0)
        one = start_server(dk, make(3), **lkw)
        c1 = _client(dk, one)
        r = {"rids": []}

        def check(what, reqs, got, want, model):
            bad = [i for i, (t, reason) in enumerate(got)
                   if reason != "length"]
            if bad:
                raise AssertionError(f"16b ({layout}): {what}: requests "
                                     f"{bad} did not end 'length'")
            _differ(torch, np, model, reqs, [t for t, _ in got],
                    [t for t, _ in want], f"{layout} {what}", phase="16b")

        # each tp=1 reference pass runs beside its tp=2 pass (each server
        # still sees its requests one at a time)
        (got, rids), (want, _) = _beside(lambda: _seq(c2, requests),
                                         lambda: _seq(c1, requests))
        r["rids"] += rids
        check("tp=2 server vs tp=1 server", requests, got, want, make(3))
        servers = [(c1, one)]
        if layout == "paged":
            ack = c2.push_weights(new_tree, version=2)
            role = c2.reconfigure("prefill")
            c2.drain()
            try:
                c2.generate(requests[0][0], max_new_tokens=2)
                refused = False
            except dk["DrainingError"]:
                refused = True
            c2.undrain()
            fresh = start_server(dk, make(8), **lkw)
            cf = _client(dk, fresh)
            servers.append((cf, fresh))
            (got, rids), (want, _) = _beside(lambda: _seq(c2, requests),
                                             lambda: _seq(cf, requests))
            r["rids"] += rids
            check("after a push, a reconfigure and a drain vs a server "
                  "built on the new weights", requests, got, want, make(8))
            r.update(push=ack, role=role, drain_refused=refused)
            r["migrate"] = tp_server_migrate(torch, np, dk, requests, want,
                                             port, c2, cf, lkw, make)
            r["rids"] += r["migrate"].pop("rids")
        r["streams_equal"] = True
        for c, srv in servers:
            c.close()
            _stop_server(srv)
        c2.close()
        run.post(f"16b_{layout}.stop")
        r["seconds"] = time.perf_counter() - t_layout
        res[layout] = r
    return res


def tp_server_migrate(torch, np, dk, requests, want, port, c2, cf, lkw,
                      make):
    """16b's migrations: tp=2 -> tp=1 through the router (the tp=2
    server as the prefill replica, a fresh tp=1 server on the new
    weights as the decode replica), then tp=1 -> tp=2 by hand."""
    tel = dk["telemetry"]
    dec = start_server(dk, make(8), role="decode", **lkw)
    router = dk["Router"](
        [("127.0.0.1", port, "tp2"), ("127.0.0.1", dec.port, "tp1")],
        block_size=16, poll_interval=0.1,
        disagg_prompt_tokens=TP_SERVER_DISAGG_TOKENS,
        registry=tel.MetricRegistry(), tracer=tel.Tracer()).start()
    try:
        deadline = time.monotonic() + 60
        while len(router.manager.routable()) < 2:
            if time.monotonic() > deadline:
                raise AssertionError("16b: the replicas never routable")
            router.manager.probe_all()
            time.sleep(0.02)
        cr = dk["ServingClient"]("127.0.0.1", router.port, timeout=300.0,
                                 request_timeout=300.0)
        got, _ = _seq(cr, requests)
        _differ(torch, np, make(8), requests, [t for t, _ in got],
                [t for t, _ in want], "streams decoded from tp=2 KV on a "
                "tp=1 replica vs a tp=1 server", phase="16b")
        mig = {x["labels"]["outcome"]: int(x["value"]) for x in cr.metrics()[
            "serving_kv_migrations_total"]["series"]}
        # once the decode replica holds the shared prefix, the router
        # sends it the rest by affinity: at least one migration, none
        # failed
        if mig.get("ok", 0) < 1 or set(mig) != {"ok"}:
            raise AssertionError(f"16b: KV migrations {mig}")
        cr.close()
    finally:
        _stop_router(router)
        _stop_server(dec)
    # tp=1 -> tp=2: a prompt the tp=2 server never saw
    prompt = np.random.default_rng(16).integers(
        0, EXACT["vocab_size"], size=80).astype(np.int32)
    cf.result(cf.generate(prompt, max_new_tokens=1))
    exp = cf.export_kv(prompt)
    imp = c2.import_kv(prompt, exp["blocks"])
    before = c2.stats()["prefix_hit_tokens"]
    rid = c2.generate(prompt, max_new_tokens=16)
    toks, _ = c2.result(rid)
    hit = c2.stats()["prefix_hit_tokens"] - before
    one, _ = cf.result(cf.generate(prompt, max_new_tokens=16))
    if toks != one or imp["tokens"] == 0 or hit != imp["tokens"]:
        raise AssertionError(f"16b: tp=1 -> tp=2: import {imp}, hit {hit}, "
                             f"streams equal {toks == one}")
    return {"routed": len(requests), "tp2_to_tp1": mig,
            "tp1_to_tp2": {"imported": imp["tokens"], "hit": hit},
            "streams_equal": True, "rids": [rid]}


def tp_server_check(np, ranks, cfg, a, b, wall):
    """Phase 16's cross-rank checks and its line: each rank's loops
    ended with the leader's stop, its ticks, kept streams, launches and
    pushed weights as the leader's; the rates beside the yardsticks."""
    L = FLAGSHIP["num_layers"]
    lead, fol = ranks[0], ranks[1]
    for part in ("16a", "16b"):
        for layout in ("paged", "slot"):
            for r, x in enumerate(ranks):
                got = x[part][layout]
                if not got["loop_ended"] or got["loop_error"]:
                    raise AssertionError(
                        f"{part} ({layout}): rank {r}'s loop "
                        f"{'failed: ' + got['loop_error'] if got['loop_error'] else 'did not end'}")
            if fol[part][layout]["ticks"] != lead[part][layout]["ticks"]:
                raise AssertionError(
                    f"{part} ({layout}): rank 1 ticked "
                    f"{fol[part][layout]['ticks']} times, the leader "
                    f"{lead[part][layout]['ticks']}")
    for layout, key, count in (("paged", "paged_attention", "ticks"),
                               ("slot", "splash_prefill", "chunk_ticks")):
        s = a[layout]
        kept = fol["16a"][layout]["streams"]
        for rid, toks in zip(s.pop("rids"), s.pop("streams")):
            if kept.get(str(rid)) != toks:
                raise AssertionError(f"16a ({layout}): rank 1's stream of "
                                     f"request {rid} differs from the "
                                     f"leader's")
        for r, x in enumerate(ranks):
            got = x["16a"][layout]
            want = got[count] * L if got["kernel_selected"] else 0
            n = got["launches"][key]
            if (n < want or (want == 0) != (n == 0)
                    or any(not BF16_ROUTE.fullmatch(k)
                           for k in got["routes"])):
                raise AssertionError(
                    f"16a ({layout}): rank {r} launched {key} {n} times "
                    f"({got['routes']}); its {got[count]} {count} x {L} "
                    f"layers predict {want}")
        s["launches_per_rank"] = [x["16a"][layout]["launches"]
                                  for x in ranks]
        s["routes_per_rank"] = [x["16a"][layout]["routes"] for x in ranks]
        s["tick_ms_per_rank"] = [x["16a"][layout]["tick_ms"] for x in ranks]
        s["stop_s"] = lead["16a"][layout]["stop_s"]
        s["streams_bit_identical_across_ranks"] = True
    for r, x in enumerate(ranks):
        got = x["16a"]["paged"]
        if (got["weight_version"] != 2 or got["weight_swaps"] != 1
                or not got["sums_equal"]):
            raise AssertionError(f"16a: the push did not land on rank {r} "
                                 f"(version {got['weight_version']}, "
                                 f"swaps {got['weight_swaps']}, weights "
                                 f"unchanged {got['sums_equal']})")
        last = got["lockstep"]["last_op"]
        a["paged"]["push"][f"rank{r}"] = {
            k: last[k] for k in ("broadcast_ms", "apply_ms", "bytes")}
    for layout in ("paged", "slot"):
        kept = fol["16b"][layout]["streams"]
        missing = [rid for rid in b[layout].pop("rids")
                   if str(rid) not in kept]
        if missing:
            raise AssertionError(f"16b ({layout}): rank 1 kept no stream "
                                 f"of requests {missing}")
        for r, x in enumerate(ranks):
            got = x["16b"][layout]
            if (layout == "paged" and (got["weight_version"] != 2
                                       or got["role"] != "prefill")
                    or got["draining"]):
                raise AssertionError(f"16b ({layout}): rank {r} ended at "
                                     f"{got}")
        b[layout]["follower_streams_kept"] = True
    label = {"backend": lead["backend"], "cards": cfg["cards"],
             "processes": TP}
    if cfg["cards"] == 1:
        label["note"] = ("both ranks share one card over gloo: not a tp "
                         "speed")
    # seconds from the ranks' start to each mark, on rank 0
    return {"phase": "16", **label, "16a": a, "16b": b, "wall_s": wall,
            "rank_timeline_s": lead["timeline"]}


def _tp_server_rank_state(eng, srv, rank):
    st = eng.stats()
    out = {"loop_ended": not srv._loop.is_alive(),
           "loop_error": (f"{type(srv.loop_error).__name__}: "
                          f"{srv.loop_error}" if srv.loop_error else None),
           "ticks": eng.ticks, "weight_version": eng.weight_version,
           "weight_swaps": eng.weight_swaps, "role": eng.role,
           "draining": eng.draining, "lockstep": st["lockstep"]}
    if rank:
        out["streams"] = {str(rid): toks
                          for rid, toks, _ in eng.lockstep_streams}
    return out


def _tp_server(dk, eng, rank, cfg, name, **kw):
    """Start this rank's server of step ``name``; the leader posts its
    port, waits for the parent's stop and stops it; a follower waits
    for the leader. A loop that failed fails the rank (its error names
    it). Returns the server and the leader's stop() seconds (None on a
    follower)."""
    from distkeras_torch.parallel.ranks import await_posted, post

    srv = dk["LMServer"](eng, **kw).start()
    stop_s = None
    if rank:
        srv.join()
    else:
        post(cfg["out"], f"{name}.port", {"port": srv.port})
        await_posted(cfg["out"], f"{name}.stop", cfg["wait_s"],
               alive=srv._loop.is_alive)
        t0 = time.perf_counter()
        srv.stop(timeout=cfg["stop_s"])
        stop_s = time.perf_counter() - t0
    if srv.loop_error is not None:
        raise AssertionError(f"{name}: rank {rank}'s loop failed") from (
            srv.loop_error)
    return srv, stop_s


def tp_server_flagship_rank(torch, np, dk, pa, sp, mesh, cfg, rank):
    """16a on one rank: after a short warm-up on a tp engine driven
    directly (before the paged layout: the slot layout finds the process
    warm), the launch counts are zeroed and the counted server serves
    until the leader's stop; on the paged layout the parameter sums are
    read before and after (the push brings the same tree)."""
    tel = dk["telemetry"]
    model = dk["get_model"]("transformer_lm", dtype=torch.bfloat16,
                            device=DEV, seed=0, **cfg["flagship"])
    L, hd = model.num_layers, model.d_model // model.num_heads
    requests = dk["serving_requests"](model.vocab_size,
                                      cfg["system_prefix"],
                                      tuple(cfg["prompt_lens"]))
    out = {}
    _mark(cfg, "model")
    for layout in ("paged", "slot"):
        kw = dict(paged=layout == "paged", block_size=16, slots=8,
                  prefill_chunk=64)
        if layout == "paged":
            # warm: the first request's prompt (both chunk shapes) and a
            # decode step
            p, c = requests[0]
            serve(torch, np, dk, model, [(p, dict(c, max_new_tokens=2))],
                  mesh=mesh, **kw)
            _mark(cfg, "warm")
        _zero_counts(pa, sp)
        eng = dk["ServingEngine"](model, mesh=mesh,
                                  registry=tel.MetricRegistry(),
                                  tracer=tel.Tracer(), **kw)
        sums = _param_sums(eng)
        _mark(cfg, f"engine_{layout}")
        skw = {} if rank else dict(
            slo=tel.SloMonitor(tel.default_serving_rules(),
                               registry=eng.registry, tracer=eng.tracer),
            watchdog_timeout_s=cfg["watchdog_s"])
        srv, stop_s = _tp_server(dk, eng, rank, cfg, f"16a_{layout}", **skw)
        st = _tp_server_rank_state(eng, srv, rank)
        ticks = [x["tick_ms"] for x in eng.flight.snapshots()
                 if x.get("kind") == "tick"]
        st.update(
            stop_s=stop_s, L=L,
            chunk_ticks=sum(1 for rec in eng.metrics.records
                            if rec.get("prefill_tokens", 0) > 0),
            launches={"paged_attention": pa.paged_attention.launches,
                      "splash_prefill": sp.splash_prefill_attention
                      .launches},
            routes=dict(pa.paged_attention.routes if layout == "paged"
                        else sp.splash_prefill_attention.routes),
            kernel_selected=bool(
                pa.preferred(hd, 16, DEV) if layout == "paged"
                else sp.preferred(64, hd, model.max_len, DEV)),
            tick_ms=float(np.mean(ticks)) if ticks else None,
            sums_equal=_param_sums(eng) == sums)
        out[layout] = st
        del eng, srv
        _free(torch)
    del model
    _free(torch)
    return out


def _mark(cfg, name):
    """Seconds since the parent started the ranks, at ``name``, in this
    rank's timeline."""
    cfg.setdefault("timeline", {})[name] = round(time.time() - cfg["t0"],
                                                 3)


def tp_server_exact_rank(torch, np, dk, mesh, cfg, rank):
    """16b on one rank: phase 4's f32 model on the tp=2 server of each
    layout, until the leader's stop."""
    tel = dk["telemetry"]
    out = {}
    for layout in ("paged", "slot"):
        model = dk["get_model"]("transformer_lm", dtype=torch.float32,
                                device=DEV, seed=3, **cfg["exact"])
        eng = dk["ServingEngine"](model, mesh=mesh, slots=8,
                                  prefill_chunk=64, paged=layout == "paged",
                                  block_size=16,
                                  registry=tel.MetricRegistry(),
                                  tracer=tel.Tracer())
        srv, stop_s = _tp_server(dk, eng, rank, cfg, f"16b_{layout}")
        out[layout] = dict(_tp_server_rank_state(eng, srv, rank),
                           stop_s=stop_s)
        del eng, srv, model
        _free(torch)
    return out


def tp_server_worker(cfg_path: str, rank: int) -> int:
    """One rank of phase 16 (``chip_smoke.py --phase16-worker <cfg>
    <rank>``): join the two-rank world, serve 16a and 16b, write this
    rank's results."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    global DEV
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distkeras_torch import telemetry
    from distkeras_torch.bench import serving_requests
    from distkeras_torch.kernels import build
    from distkeras_torch.parallel.ranks import rank_threads
    from distkeras_torch.models import get_model
    from distkeras_torch.ops import paged_attention as pa
    from distkeras_torch.ops import splash_prefill as sp
    from distkeras_torch.parallel.mesh import make_mesh
    from distkeras_torch.serving import LMServer, ServingEngine

    cfg = json.load(open(cfg_path))
    _mark(cfg, "imports")
    DEV = cfg["device"]
    if DEV == "cuda":
        torch.cuda.set_device(rank if cfg["backend"] == "nccl" else 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.load()
    _mark(cfg, "kernels")
    torch.set_num_threads(rank_threads(TP))
    dist.init_process_group(cfg["backend"],
                            init_method=f"tcp://127.0.0.1:{cfg['port']}",
                            rank=rank, world_size=TP,
                            timeout=datetime.timedelta(seconds=300))
    dk = {"get_model": get_model, "ServingEngine": ServingEngine,
          "LMServer": LMServer, "telemetry": telemetry,
          "serving_requests": serving_requests}
    try:
        mesh = make_mesh({"model": TP})
        _mark(cfg, "world")
        res = {"rank": rank, "backend": dist.get_backend()}
        res["16a"] = tp_server_flagship_rank(torch, np, dk, pa, sp, mesh,
                                             cfg, rank)
        res["16b"] = tp_server_exact_rank(torch, np, dk, mesh, cfg, rank)
        _mark(cfg, "done")
        res["timeline"] = cfg["timeline"]
        with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        dist.destroy_process_group()
    return 0


# -- phase 18: the examples ------------------------------------------------


def examples_lm_phase(torch, np, fa, pp, pa, sp, lm):
    """18a: ``lm_training`` on one card through its stages (flags
    ``LM18``): the training launches counted around ``train``, the
    sample's around ``decode``."""
    from distkeras_torch.utils.device import resolve_device

    rows = LM18[LM18.index("--batch-size") + 1]
    args = lm.parse_args(LM18 + ["--n", rows, "--epochs", str(LM18_STEPS),
                                 "--sample", str(LM18_SAMPLE), "--device",
                                 DEV])
    device = resolve_device(args.device)
    axes = lm.mesh_axes(args, 1)
    ds, tokens, _ = lm.load_data(args)
    model = lm.build_model(args, axes, device)
    zero_training_counts(fa, pp)
    sync(torch)
    t0 = time.perf_counter()
    trainer, trained = lm.train(args, model, ds, axes, len(tokens))
    sync(torch)
    wall = time.perf_counter() - t0
    launches = training_counts(fa, pp)
    losses = [float(h["loss"]) for h in trainer.history]
    if len(losses) != LM18_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"18a: losses {losses}: want {LM18_STEPS} "
                             f"finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"18a: the loss did not fall: {losses}")
    want = {n: 0 for n in launches}
    want.update({n: args.layers * LM18_STEPS for n in CAUSAL_NAMES})
    if launches != want:
        raise AssertionError(f"18a: training launches {launches}, not "
                             f"{want} (once a layer a step)")
    Tp = min(16, args.seq_len - LM18_SAMPLE)
    _zero_counts(pa, sp)
    t0 = time.perf_counter()
    rows = lm.decode(args, trained, tokens[:2, :Tp], LM18_SAMPLE)
    sync(torch)
    sample_s = time.perf_counter() - t0
    if rows.shape != (2, Tp + LM18_SAMPLE):
        raise AssertionError(f"18a: sample shape {rows.shape}")
    paged, splash = _launches(pa, sp)
    routes = {"paged_attention": dict(pa.paged_attention.routes),
              "splash_prefill": dict(sp.splash_prefill_attention.routes)}
    steps = len(losses)
    out = {"flags": LM18, "steps": steps, "losses": losses, "train_s": wall,
           "ms_per_step": wall / steps * 1e3,
           "tok_s": steps * args.batch_size * args.seq_len / wall,
           "note": "the window's wall time, first use of each kernel and "
                   "library in the process included",
           "launches": launches,
           "sample": {"rows": 2, "prompt": Tp, "new": LM18_SAMPLE,
                      "seconds": sample_s,
                      "launches": {"paged_attention": paged,
                                   "splash_prefill": splash},
                      "route": routes if paged or splash else "plain",
                      "tokens": rows[:, Tp:].tolist()}}
    del trainer, trained, model
    _free(torch)
    return out


def examples_sp_phase(torch, np, here, cards=None, python=None):
    """18b: ``lm_training --sp 2`` on two ranks
    (``chip_smoke.py --phase18-worker``), each given the ``DK_TPU_*``
    environment of a two-process ``Job``."""
    if cards is None:
        cards = torch.cuda.device_count() if DEV == "cuda" else 1
    n = LM18_SP["sp"]
    out = tempfile.mkdtemp(prefix="dk_phase18_")
    cfg = {"out": out, "device": DEV, "port": _free_port(),
           "ps_port": _free_port(), "world": n, "argv": LM18,
           "sp": LM18_SP, "batch": int(LM18[LM18.index("--batch-size") + 1])}
    ranks, wall = run_ranks("18", cfg, n, P18_TIMEOUT_S, here, python)
    L, W = LM18_SP["layers"], LM18_SP["steps"]
    per_layer = pair_per_layer(n)
    for r, res in enumerate(ranks):
        if DEV == "cuda" and not res["kernel_selected"]:
            raise AssertionError(f"18b: rank {r}'s ring did not select the "
                                 f"pair kernels")
        want = {k: 0 for k in res["launches"]}
        want.update({k: (v * L * W if res["kernel_selected"] else 0)
                     for k, v in per_layer.items()})
        _launch_check("18b", r, res["launches"], want)
        if not np.isfinite(res["losses"]).all():
            raise AssertionError(f"18b: rank {r}'s losses {res['losses']}")
    if len({res["params_sha256"] for res in ranks}) != 1:
        raise AssertionError("18b: the two ranks' parameters differ")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"18b: the ranks' losses differ: "
                             f"{[x['losses'] for x in ranks]}")
    return {"processes": n, "backend": ranks[0]["backend"],
            "layers": L, "steps": W,
            "cut": "2 layers, 2 steps (one batch of rows, two epochs)",
            "losses": ranks[0]["losses"],
            "ms_per_step": [x["seconds"] / W * 1e3 for x in ranks],
            "launches_per_rank": [x["launches"] for x in ranks],
            "params_bit_identical": True, "wall_s": wall}


def examples_sp_worker(cfg_path: str, rank: int) -> int:
    """One rank of 18b (``chip_smoke.py --phase18-worker <cfg> <rank>``):
    the environment a ``Job`` of ``world`` local processes gives rank
    ``rank``, then the example's own ``run`` over it."""
    import torch
    import torch.distributed as dist

    global DEV
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distkeras_torch.examples import lm_training as lm
    from distkeras_torch.job_deployment import Job
    from distkeras_torch.kernels import build
    from distkeras_torch.ops import pallas_attention as fa
    from distkeras_torch.ops import pallas_pair as pp
    from distkeras_torch.ops.ring_attention import _pair_kernel_block
    from distkeras_torch.parallel.ranks import rank_threads

    cfg = json.load(open(cfg_path))
    DEV = cfg["device"]
    if DEV == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.load()
    torch.set_num_threads(rank_threads(cfg["world"]))
    os.environ.update(Job(
        "-m", hosts=["local"] * cfg["world"],
        coordinator_port=cfg["port"],
        ps_port=cfg["ps_port"]).environment_for(rank))
    sp_cfg = cfg["sp"]
    argv = list(cfg["argv"])
    argv[argv.index("--layers") + 1] = str(sp_cfg["layers"])
    # one batch of rows, one step an epoch: the second step's loss is
    # the first batch's again, after one update on it
    args = lm.parse_args(argv + ["--sp", str(sp_cfg["sp"]), "--n",
                                 str(cfg["batch"]), "--epochs",
                                 str(sp_cfg["steps"]), "--device", DEV])
    hd = args.d_model // args.heads
    C = args.seq_len // sp_cfg["sp"] // 2
    try:
        zero_training_counts(fa, pp)
        res = lm.run(args)
        out = {"rank": rank, "backend": dist.get_backend(),
               "losses": res["losses"], "seconds": res["seconds"],
               "params_sha256": res["params_sha256"],
               "launches": training_counts(fa, pp),
               "kernel_selected": _pair_kernel_block(
                   C, hd, torch.bfloat16, DEV) is not None}
        with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def examples_dk_phase(torch, np, ex):
    """18c: the four dist-keras examples with ``EXAMPLES18``'s flags."""
    import contextlib
    import io

    out = {}
    for name, argv in EXAMPLES18.items():
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = getattr(ex, name).main(list(argv) + ["--device", DEV])
        sync(torch)
        if not np.isfinite(res.get("losses", [])).all():
            raise AssertionError(f"18c: {name}'s losses are not finite")
        out[name] = {k: v for k, v in res.items() if k != "losses"} | {
            "seconds_total": time.perf_counter() - t0,
            "printed": buf.getvalue().strip().splitlines()[-3:]}
    mnist = out["mnist_workflow"]["trainers"]
    for name, r in mnist.items():
        if not np.isfinite(r["losses"]).all():
            raise AssertionError(f"18c: MNIST {name}'s losses not finite")
        floor = MNIST_MIN_ACCURACY if name in MNIST18_STRICT else 0.1
        if not r["accuracy"] > floor - (name in MNIST18_STRICT) * 1e-12:
            raise AssertionError(f"18c: MNIST {name}'s accuracy "
                                 f"{r['accuracy']} under {floor}")
        r.pop("losses")
    return out


def examples_serving_phase(torch, pa, sp, ex):
    """18d: ``lm_serving`` in each mode of ``SERVING18`` (its own checks:
    every stream equal to ``generate()``), the serving launches zeroed
    before each."""
    import contextlib
    import io

    out = {}
    for name, argv in SERVING18.items():
        _zero_counts(pa, sp)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = ex.lm_serving.main(list(argv) + ["--device", DEV])
        paged, splash = _launches(pa, sp)
        routes = {"paged_attention": dict(pa.paged_attention.routes),
                  "splash_prefill": dict(sp.splash_prefill_attention.routes)}
        out[name] = {"flags": argv, "tok_s": res["tok_s"],
                     "tokens": res["tokens"],
                     "seconds": time.perf_counter() - t0,
                     "launches": {"paged_attention": paged,
                                  "splash_prefill": splash},
                     "route": routes if paged or splash else "plain",
                     "streams_equal_generate": True}
    return out


def examples_phase(torch, np, fa, pp, pa, sp, here, python=None):
    """Phase 18: 18a-18d, each line printed as it ends."""
    from distkeras_torch import examples as ex
    from distkeras_torch.examples import (bigdata_pipeline,  # noqa: F401
                                          cifar10_training, lm_serving,
                                          lm_training, mnist_workflow,
                                          streaming_inference)

    t0 = time.perf_counter()
    res = {"18a": examples_lm_phase(torch, np, fa, pp, pa, sp, lm_training)}
    _emit({"examples_lm": res["18a"]})
    res["18b"] = examples_sp_phase(torch, np, here, python=python)
    _emit({"examples_lm_sp2": res["18b"]})
    res["18c"] = examples_dk_phase(torch, np, ex)
    _emit({"examples_dist_keras": res["18c"]})
    res["18d"] = examples_serving_phase(torch, pa, sp, ex)
    _emit({"examples_lm_serving": res["18d"]})
    res["seconds"] = time.perf_counter() - t0
    _emit({"examples_phase": {"seconds": res["seconds"]}})
    return res


def main(phase12_only: bool = False, phase13_only: bool = False,
         phase14_only: bool = False, phase15_only: bool = False,
         phase16_only: bool = False, phase17_only: bool = False,
         phase18_only: bool = False) -> int:
    """The smoke (every phase), or with ``phase12_only`` phase 12 alone
    after phase 3, its yardstick (``chip_smoke.py --phase12``: the
    tensor-parallel ranks over NCCL on a host of several cards), with
    ``phase13_only`` phase 13 alone after phases 6 and 6b, its yardsticks
    (``chip_smoke.py --phase13``: over NCCL on several cards), or with
    ``phase14_only`` phase 14 alone after phase 3, its yardstick
    (``chip_smoke.py --phase14``), with ``phase15_only`` phase 15
    alone after phase 3, its yardstick (``chip_smoke.py --phase15``), or
    with ``phase16_only`` phase 16 alone after phase 3, its yardstick
    (``chip_smoke.py --phase16``: over NCCL on several cards), or with
    ``phase17_only`` phase 17 alone after phase 2's cases at its shapes
    (``chip_smoke.py --phase17``), or with ``phase18_only`` phase 18 alone
    after phase 1 (``chip_smoke.py --phase18``)."""
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
        from distkeras_torch.parallel.mesh import default_mesh, make_mesh
        from distkeras_torch.parallel.spmd import (make_dp_train_step,
                                                   make_lm_train_step,
                                                   make_moe_lm_train_step)
        from distkeras_torch.serving import (Autoscaler, DrainingError,
                                             LMServer, Router,
                                             ServingClient, ServingEngine,
                                             serialize_weights)
        from distkeras_torch.telemetry import report
        from distkeras_torch.trainers import LMTrainer
        from distkeras_torch.utils.losses import get_loss, get_optimizer
        from distkeras_torch.workers import make_train_step, make_window_step
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
        from distkeras_torch import serve_bench
    except ImportError as e:
        return _fail(f"run from a checkout of the repository ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dk = {"telemetry": telemetry, "get_model": get_model, "bridge": bridge,
          "generate": generate, "ServingEngine": ServingEngine,
          "LMServer": LMServer, "ServingClient": ServingClient,
          "Router": Router, "Autoscaler": Autoscaler, "report": report,
          "serving_requests": serving_requests,
          "DrainingError": DrainingError,
          "serialize_weights": serialize_weights,
          "make_lm_train_step": make_lm_train_step,
          "make_moe_lm_train_step": make_moe_lm_train_step,
          "get_optimizer": get_optimizer, "lm_step_flops": lm_step_flops,
          "peak_flops": peak_flops, "LMTrainer": LMTrainer,
          "PartitionedDataset": PartitionedDataset, "make_mesh": make_mesh,
          "pair_kernel_block": _pair_kernel_block, "bench": bench,
          "get_loss": get_loss, "make_window_step": make_window_step,
          "make_train_step": make_train_step, "default_mesh": default_mesh,
          "make_dp_train_step": make_dp_train_step,
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
    if phase13_only:
        training = training_phase(torch, np, dk, fa, pp)
        _emit({"training_phase": training})
        ring = ring_training_phase(torch, np, dk, fa, pp, training)
        _emit({"ring_training_phase": ring})
        phase13(torch, np, F, dk, fa, pp, here, training, ring)
        print(smi, flush=True)
        _emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    if phase18_only:
        examples_phase(torch, np, fa, pp, pa, sp, here)
        print(smi, flush=True)
        _emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    if phase17_only:
        t0 = time.perf_counter()
        paged17, splash17 = serve_bench_kernel_cases(torch, F, pa, sp)
        paged4 = exact_kernel_cases(torch, F, pa)
        _emit({"kernel_phase": {"paged_attention_serve_bench": paged17,
                                "splash_prefill_serve_bench": splash17,
                                "paged_attention_exact_decode": paged4,
                                "seconds": time.perf_counter() - t0}})
        t0 = time.perf_counter()
        p17 = serve_bench_phase(torch, pa, sp, serve_bench)
        _emit({"serve_bench_phase": {
            "launches": p17["launches"],
            "seconds": time.perf_counter() - t0}})
        print(smi, flush=True)
        _emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    if phase14_only:
        t0 = time.perf_counter()
        serving, _, _, chunked = serving_phase(torch, np, dk, pa, sp)
        serving["seconds"] = time.perf_counter() - t0
        _emit({"serving_phase": serving})
        t0 = time.perf_counter()
        server, _ = server_phase(torch, np, dk, pa, sp, serving, chunked)
        server["seconds"] = time.perf_counter() - t0
        _emit({"server_phase": server})
        print(smi, flush=True)
        _emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    if phase15_only:
        t0 = time.perf_counter()
        serving, _, _, chunked = serving_phase(torch, np, dk, pa, sp)
        serving["seconds"] = time.perf_counter() - t0
        _emit({"serving_phase": serving})
        t0 = time.perf_counter()
        fleet, _ = fleet_phase(torch, np, dk, pa, sp, serving, chunked)
        fleet["seconds"] = time.perf_counter() - t0
        _emit({"fleet_phase": fleet})
        print(smi, flush=True)
        _emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    if phase16_only:
        t0 = time.perf_counter()
        serving, _, _, chunked = serving_phase(torch, np, dk, pa, sp)
        serving["seconds"] = time.perf_counter() - t0
        _emit({"serving_phase": serving})
        _free(torch)
        t0 = time.perf_counter()
        p16 = tp_server_phase(torch, np, dk, here, _yard(
            serving, chunked))
        p16["seconds"] = time.perf_counter() - t0
        _emit(p16)
        print(smi, flush=True)
        _emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    if phase12_only:
        t0 = time.perf_counter()
        serving, _, _, chunked = serving_phase(torch, np, dk, pa, sp)
        serving["seconds"] = time.perf_counter() - t0
        _emit({"serving_phase": serving})
        _free(torch)
        _emit(tp_phase(torch, np, here, {
            "streams": chunked,
            "launches": {k: serving[k]["launches"]
                         for k in ("paged", "slot")}}))
        print(smi, flush=True)
        _emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    t0 = time.perf_counter()
    paged = paged_cases(torch, F, pa)
    splash = splash_cases(torch, F, sp)
    edges = edge_cases(torch, pa, sp)
    # one tp=2 rank's heads (phase 12): H/2 query heads over Hk/2
    paged_tp = paged_cases(torch, F, pa, PAGED_TP)
    # values at std 0.5, as the edge cases: the depth-0 row's queries
    # average 1-5 value rows, and bf16's own rounding of |O| in [4, 8) is
    # 0.0156, over the 1e-2 tolerance (each case reports the exact
    # result's rounding, out_rounding, beside its error)
    splash_tp = splash_cases(torch, F, sp, SPLASH_TP, (), v_std=0.5)
    # phase 17's f32 shapes (serve_bench's engine modes)
    paged17, splash17 = serve_bench_kernel_cases(torch, F, pa, sp)
    # phase 4's decode (the exact f32 model's int8 pages)
    paged4 = exact_kernel_cases(torch, F, pa)
    _emit({"kernel_phase": {"paged_attention": paged,
                            "splash_prefill": splash, "edges": edges,
                            "paged_attention_tp2_shard": paged_tp,
                            "splash_prefill_tp2_shard": splash_tp,
                            "paged_attention_serve_bench": paged17,
                            "splash_prefill_serve_bench": splash17,
                            "paged_attention_exact_decode": paged4,
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
    server, server_launches = server_phase(torch, np, dk, pa, sp, serving,
                                           chunked)
    server["seconds"] = time.perf_counter() - t0
    _emit({"server_phase": server})

    t0 = time.perf_counter()
    fleet, fleet_launches = fleet_phase(torch, np, dk, pa, sp, serving,
                                        chunked, server["14a"]["paged"])
    fleet["seconds"] = time.perf_counter() - t0
    _emit({"fleet_phase": fleet})

    t0 = time.perf_counter()
    causal = causal_cases(torch, F, fa)
    causal_tp = causal_cases(torch, F, fa, CAUSAL_TP)
    _emit({"training_kernel_phase": {"causal_attention": causal,
                                     "causal_attention_tp2_shard": causal_tp,
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
    dp_step = dp_step_phase(torch, np, dk, smi)
    dp_step["seconds"] = time.perf_counter() - t0
    _emit({"dp_step_phase": dp_step})

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

    t0 = time.perf_counter()
    p17 = serve_bench_phase(torch, pa, sp, serve_bench)
    _emit({"serve_bench_phase": {"launches": p17["launches"],
                                 "seconds": time.perf_counter() - t0}})

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

    _free(torch)
    tp = tp_phase(torch, np, here, {
        "streams": chunked,
        "launches": {k: serving[k]["launches"] for k in ("paged", "slot")}})
    _emit(tp)

    t0 = time.perf_counter()
    p16 = tp_server_phase(torch, np, dk, here, _yard(
        serving, chunked, tp["12b"], server["14a"]))
    p16["seconds"] = time.perf_counter() - t0
    _emit(p16)

    moe, p13, p13_shapes = phase13(torch, np, F, dk, fa, pp, here,
                                   training, ring)

    _free(torch)
    p18 = examples_phase(torch, np, fa, pp, pa, sp, here)

    main_paged = next(c for c in paged if c["T"] == 64 and c["pool"] == "int8")
    main_splash = next(c for c in splash if c["dtype"] == "bf16")
    timed = ("T", "H", "Hk", "hd", "pool", "dtype", "starts", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for name, src, rep, case, cases, layout in (
            ("paged_attention", "distkeras_torch/csrc/paged_attention.cu",
             "distkeras_tpu/ops/paged_attention.py:166", main_paged,
             paged + paged_tp + paged17 + paged4
             + [c for c in edges if c["kernel"] == "paged"], "paged"),
            ("splash_prefill", "distkeras_torch/csrc/splash_prefill.cu",
             "distkeras_tpu/ops/splash_prefill.py:163", main_splash,
             splash + splash_tp + splash17
             + [c for c in edges if c["kernel"] == "splash"], "slot")):
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            # the main path's launches by what each ran (launch_route)
            "kernels_run": routes[name],
            "launches": launches[name],
            # phase 14a: the same mix behind an LMServer on this layout
            "server_launches": server_launches[name],
            # phase 15a: the same mix through the router over three paged
            # replicas, then the disaggregated fleet (paged row only: no
            # slot replica runs there)
            **({"fleet_launches": fleet_launches}
               if name == "paged_attention" else {}),
            # phase 17: serve_bench's seven engine modes, all together
            "serve_bench_launches": p17["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"],
            # every timed shape of the main path (the row's own numbers
            # are the first one's): decode, chunk, verify, monolithic in
            # each pool and dtype (bf16, int8, f32, int8-f32), one tp=2
            # rank's heads (H=4, Hk=1), phase 17's f32 shapes and phase
            # 4's f32 decode (H=4, Hk=2, int8-f32)
            "shapes": [{k: c[k] for k in timed if k in c}
                       for c in cases if "ms" in c],
            # phase 12's flagship run, each rank's launches
            "tp2_launches_per_rank": [
                n[name] for n in tp["12b"][layout]["launches_per_rank"]],
            # phase 16a: the same mix behind the tp=2 server, each rank's
            "tp_server_launches_per_rank": [
                n[name] for n in p16["16a"][layout]["launches_per_rank"]],
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
            "max_abs_err": max(
                c[k] for c in causal + causal_tp
                + p13_shapes["causal_attention_pp_microbatch"]
                for k in err_keys),
            "ms": main_causal[f"{kern}_ms"],
            "plain_ms": main_causal[f"{kern}_plain_ms"],
            "bound_ms": main_causal[f"{kern}_bound_ms"],
            "bound_by": main_causal[f"{kern}_bound_by"],
            "library_ms": lib,
            # one tp=2 rank's heads, and phase 12's launches per rank
            "tp2_shard": {k: causal_tp[0][f"{kern}_{k}"] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")} | {
                "shape": [CAUSAL["B"], CAUSAL_TP["T"][0], CAUSAL_TP["H"],
                          CAUSAL["hd"]],
                "library_ms": (causal_tp[0]["fwd_library_ms"]
                               if kern == "fwd" else None)},
            "tp2_launches_per_rank": [
                n[name] for n in tp["12a"]["launches_per_rank"]],
        })
        if kern != "fwd":
            rows[-1]["tp2_shard"]["bwd_ms"] = causal_tp[0]["bwd_ms"]
            rows[-1]["tp2_shard"]["bwd_library_ms"] = causal_tp[0][
                "bwd_library_ms"]
        # phase 13: one pp microbatch, each pp rank's launches, and the
        # MoE flagship's launches
        mb = p13_shapes["causal_attention_pp_microbatch"][0]
        rows[-1]["pp_microbatch"] = {k: mb[f"{kern}_{k}"] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")} | {
            "shape": [CAUSAL_PP["B"], CAUSAL_PP["T"][0], CAUSAL["H"],
                      CAUSAL["hd"]],
            "library_ms": mb["fwd_library_ms"] if kern == "fwd" else None}
        if kern != "fwd":
            rows[-1]["pp_microbatch"]["bwd_ms"] = mb["bwd_ms"]
            rows[-1]["pp_microbatch"]["bwd_library_ms"] = mb[
                "bwd_library_ms"]
        rows[-1]["pp_launches_per_rank"] = [
            n[name] for n in p13["13a"]["launches_per_rank"]]
        rows[-1]["moe_launches"] = moe["launches"][name]
        # phase 18a: lm_training at the flagship's widths
        rows[-1]["example_launches"] = p18["18a"]["launches"][name]
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
                "max_abs_err": max(
                    c[k] for c in pair + p13_shapes["pair_attention_sp2_chunk"]
                    if c["variant"] == variant for k in err_keys),
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
            # phase 13c: one sp=2 rank's chunk, and each rank's launches
            ch = next(c for c in p13_shapes["pair_attention_sp2_chunk"]
                      if c["variant"] == variant)
            rows[-1]["sp2_chunk"] = {k: ch[f"{kern}_{k}"] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")} | {
                "shape": [PAIR["B"], PAIR_SP2["C"][0], PAIR["H"],
                          PAIR["hd"]],
                "library_ms": ch[lib] if lib else None}
            if kern != "fwd":
                rows[-1]["sp2_chunk"]["bwd_ms"] = ch["bwd_ms"]
                rows[-1]["sp2_chunk"]["bwd_library_ms"] = ch[
                    "bwd_library_ms"]
            rows[-1]["sp2_launches_per_rank"] = [
                n[name] for n in p13["13c"]["launches_per_rank"]]
            # phase 18b: lm_training --sp 2
            rows[-1]["example_sp2_launches_per_rank"] = [
                n[name] for n in p18["18b"]["launches_per_rank"]]
    print(smi, flush=True)
    _emit({"kernels": rows})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--phase11f-worker":
        sys.exit(job_worker(sys.argv[2]))
    if len(sys.argv) == 4 and sys.argv[1] == "--phase12-worker":
        sys.exit(tp_worker(sys.argv[2], int(sys.argv[3])))
    if len(sys.argv) == 4 and sys.argv[1] == "--phase13-worker":
        sys.exit(p13_worker(sys.argv[2], int(sys.argv[3])))
    if len(sys.argv) == 4 and sys.argv[1] == "--phase16-worker":
        sys.exit(tp_server_worker(sys.argv[2], int(sys.argv[3])))
    if len(sys.argv) == 4 and sys.argv[1] == "--phase18-worker":
        sys.exit(examples_sp_worker(sys.argv[2], int(sys.argv[3])))
    sys.exit(main(phase12_only=sys.argv[1:] == ["--phase12"],
                  phase13_only=sys.argv[1:] == ["--phase13"],
                  phase14_only=sys.argv[1:] == ["--phase14"],
                  phase15_only=sys.argv[1:] == ["--phase15"],
                  phase16_only=sys.argv[1:] == ["--phase16"],
                  phase17_only=sys.argv[1:] == ["--phase17"],
                  phase18_only=sys.argv[1:] == ["--phase18"]))
