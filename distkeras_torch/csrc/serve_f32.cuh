// The f32 attention core of the two serving kernels (paged_attention.cu,
// splash_prefill.cu): split-K over the cache (flash-decoding), then a
// merge, in full f32 on the CUDA cores. It replaces the f32 path of the
// Pallas TPU kernels distkeras_tpu/ops/paged_attention.py:
// paged_attention (body _kernel) and distkeras_tpu/ops/splash_prefill.py:
// splash_prefill_attention (body _kernel); bf16 queries take the
// tensor-core core of serve_mma.cuh. The tensor cores round their
// operands to bf16 (or TF32's 10-bit mantissa), and the f32 route is held
// to 1e-5: every product here is an FFMA.
//
// The function: query row r = t * G + g of KV head h is query head
// h * G + g at absolute position starts[b] + t and sees keys <= that
// position; scores (q . k) * scale in f32, masked with -1e30 as the TPU
// kernels mask; an online softmax in f32; output acc / max(l, 1e-30) in
// f32. int8 pages are dequantized in shared memory to f32, value x scale
// in f32, as the plain version's dequantize_int8 does it.
//
// What bounds it on the H100 at the f32 serving shapes (serve_bench's
// modes: 8 rows, 4 heads of 64, no GQA, 18-page rows or a 1056-key slot
// cache): a decode tick reads ~2.2 MB of f32 pages for ~1 MFLOP, so
// bytes (0.65 us at 3.35 TB/s); a 64-token chunk does ~0.1 GFLOP, under
// 2 us of FFMA at 67 TFLOP/s. At both the kernel sits far above its
// bound, held back by how few blocks fill the card, how little of each
// load is hidden and the launches themselves (the split kernel, then the
// merge). What each part of the design does about that:
//
// - Split-K over the cache: grid (row tile, KV head, batch row x split),
//   the splits chosen by the host from shapes alone
//   (splash_prefill.split_plan: never from seq_lens / starts, which live
//   on the device) to bring the grid to ~2 blocks per SM. Each split
//   walks `per` 64-key stages of the cache and writes an f32 partial
//   (m, l, acc) to scratch the wrapper allocates; merge_partials combines
//   them in split order (no atomics: the same bits every run). A split
//   wholly past its row tile's last query position exits at once with a
//   neutral partial (m = -inf, l = 0). With one split the block writes
//   the output itself and no merge runs.
// - GQA rides the row axis: one block takes BM query rows of one (b, h),
//   BM = 16 when T * G <= 16, else 64, and reads each K/V key once for
//   all of them.
// - Pipelined loads: a block stages its own block-table entries in shared
//   memory, then copies K/V global -> shared with 16-byte cp.async into a
//   ring of two steps, so step i+1 is in flight while step i computes.
//   A step is SK = 4096 / HD keys (a whole 64-key stage at hd 64; a half
//   and a quarter at hd 128 and 256, where two 64-key stages of f32 K and
//   V, 128 KB each at hd 256, would not fit in shared memory): the ring
//   holds 2 x 16 KB of K and V a slot at every head dim. int8 pages are
//   copied as int8 (the bytes the bound counts) with their scales, then
//   dequantized once per step into f32 tiles. Steps wholly past the
//   block's last query position are never loaded.
// - Register-tiled FFMA: the NT threads form TR = NT / 16 row groups of
//   16 lanes. In q k^T a thread computes RT = BM / TR rows x KT = SK / 16
//   keys of scores (keys tk, tk + 16, ...: conflict-free float4 reads of
//   rows padded by 4 floats), each score one sequential FFMA chain over
//   the head dim; the row's max and sum are butterflies over its 16
//   lanes. In P V the same thread owns the same RT rows x HD / 16
//   channels (float4 groups tk, tk + 16, ...), P read as float4 over four
//   keys from shared memory. A warp whose rows all lie past T * G skips
//   both products (at decode, T * G = 1: three warps of four).
//
// Register budget (accumulators, 32-bit registers a thread): NT = 128 but
// 256 for BM = 64 at hd 256, so that no instance holds more than 64
// accumulators beside its 32 or fewer scores:
//
//   BM x hd      NT   RT  KT  acc  scores
//   16 x 64     128    2   4    8       8
//   16 x 128    128    2   2   16       4
//   16 x 256    128    2   1   32       2
//   64 x 64     128    8   4   32      32
//   64 x 128    128    8   2   64      16
//   64 x 256    256    4   1   64       4
//
// Exactness invariants, by construction: a row's arithmetic never depends
// on which thread or row slot computes it, nor on the other rows of its
// launch. Every score is one thread's chain over the channels in order,
// every (row, channel) accumulator one thread's chain over the keys in
// order, the row reductions the same butterfly for every row, the splits
// a function of (B, Hk, whether T * G <= 16, keys) alone. So a decode
// (T = 1) and a verify window (T = 5) give a row the same bits, as do
// pipelined and sync ticks and k-step and 1-step ticks; and the paged
// and the splash kernel give a row the same bits over the same keys (the
// splash kernel's int8 view is dequantized by the same f32 product). The
// keys a block walks past a row's position add exact zeros to it (p = 0,
// correction exp(0) = 1), and a split the row sees nothing of gets merge
// weight 0 whether it was walked (m = -1e30) or skipped (m = -inf).

#pragma once

#include "flash_mma.cuh"  // cp.async

namespace sf {

constexpr int kPage = 16;          // keys per page
constexpr int kStageKeys = 64;     // the split plan's unit: four pages
constexpr int kLanes = 16;         // lanes of a row group
constexpr int kStepElems = 4096;   // keys x hd of one step of K (or V)
constexpr int kMergeWarps = 4;
constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value

// The geometry of one instantiation (shared-memory sizes in bytes).
template <typename KVT, int HD, int BM>
struct Geo {
  static constexpr bool kQuant = sizeof(KVT) == 1;
  static constexpr int SK = kStepElems / HD;     // keys per step
  static constexpr int NT = (BM == 64 && HD == 256) ? 256 : 128;
  static constexpr int TR = NT / kLanes;         // row groups
  static constexpr int RT = BM / TR;             // rows per thread
  static constexpr int KT = SK / kLanes;         // keys per thread (q k^T)
  static constexpr int CT = HD / (4 * kLanes);   // float4 channel groups
  static constexpr int LD = HD + 4;              // f32 rows, floats
  // P rows: an odd multiple of 16 floats, so the two row groups of a warp
  // store into disjoint banks
  static constexpr int LDP = SK % 32 == 0 ? SK + 16 : SK;
  static constexpr int LDR = kQuant ? HD : LD;   // ring rows, elements
  // the two products' loops unrolled twice at hd 256, where q k^T is
  // bound by shared-memory loads and the second iteration's loads hide
  // under the first's FFMAs (PERF.md, section 6); not at all elsewhere,
  // where unrolling made ptxas spill (up to 88 bytes at 64 rows of hd
  // 128) and bought nothing at hd 64
  static constexpr int kUnroll = HD == 256 ? 2 : 1;
  static constexpr int kQ = BM * LD * 4;
  static constexpr int kKV = SK * LDR * (int)sizeof(KVT);  // K or V
  static constexpr int kSlot = 2 * kKV + (kQuant ? 2 * SK * 4 : 0);
  static constexpr int kDeq = kQuant ? 2 * SK * LD * 4 : 0;
  static constexpr int kP = BM * LDP * 4;
  static_assert(SK % kLanes == 0 && kStageKeys % SK == 0, "step keys");
  static_assert(HD % (4 * kLanes) == 0 && RT >= 1, "tiling");
};

// dynamic shared memory of one launch: q rows, the two-step ring, the
// dequantized K and V (int8), P, the split's block-table entries
template <typename KVT, int HD, int BM>
inline size_t smem_bytes(int per, bool paged) {
  using GE = Geo<KVT, HD, BM>;
  return (size_t)GE::kQ + 2 * GE::kSlot + GE::kDeq + GE::kP +
         (paged ? (size_t)per * (kStageKeys / kPage) * 4 : 0);
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// every lane of the group ends with the same bits (a + b == b + a)
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// byte `i` of a packed word of int8 values, as f32 (exact)
__device__ __forceinline__ float i8(int raw, int i) {
  return (float)(int8_t)(raw >> (8 * i));
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float4& a, float p, const float4& v) {
  a.x = fmaf(p, v.x, a.x);
  a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z);
  a.w = fmaf(p, v.w, a.w);
}

// One block: query rows [rt * BM, +BM) of (b, h), split `split` of the
// cache. PAGED: key j of row b is slot j % 16 of page
// tables[b * ntab + j / 16] in a [P, 16, Hk, HD] pool; otherwise key j of
// a contiguous [B, ntab * 16, Hk, HD] view. `part` is null when the
// launch has one split (the block writes `out` itself), else the f32
// scratch [splits * B * Hk * T * G] x (HD acc + m + l).
template <typename KVT, int HD, int BM, bool PAGED>
__device__ __forceinline__ void split_attn(
    const float* __restrict__ q, const KVT* __restrict__ kc,
    const KVT* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ starts, float* __restrict__ out,
    float* __restrict__ part, int T, int H, int Hk, int ntab, float scale,
    int splits, int per) {
  using GE = Geo<KVT, HD, BM>;
  constexpr bool QUANT = GE::kQuant;
  constexpr int SK = GE::SK, NT = GE::NT, TR = GE::TR, RT = GE::RT;
  constexpr int KT = GE::KT, CT = GE::CT;
  constexpr int LD = GE::LD, LDP = GE::LDP, LDR = GE::LDR;
  constexpr int PPS = kStageKeys / kPage;  // pages per stage
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + GE::kQ;
  float* sDeq = reinterpret_cast<float*>(ring + 2 * GE::kSlot);
  float* sP = reinterpret_cast<float*>(ring + 2 * GE::kSlot + GE::kDeq);
  int* sTbl = reinterpret_cast<int*>(ring + 2 * GE::kSlot + GE::kDeq +
                                     GE::kP);

  const int rt = blockIdx.x, h = blockIdx.y;
  const int split = blockIdx.z % splits, b = blockIdx.z / splits;
  const int B = gridDim.z / splits;
  const int G = H / Hk, TG = T * G;
  const int nkeys = ntab * kPage;
  const int start = starts[b];
  const int r_first = rt * BM;
  const int last_pos = start + (min(r_first + BM, TG) - 1) / G;
  const int nst = (nkeys + kStageKeys - 1) / kStageKeys;
  const int s0 = split * per;
  // the causal bound of the whole row tile: stages wholly past its last
  // query position are never loaded
  const int s1 = min(min(s0 + per, nst), last_pos / kStageKeys + 1);
  const size_t nrows = (size_t)splits * B * Hk * TG;
  const size_t prow = ((size_t)(split * B + b) * Hk + h) * TG;
  float* pm = part ? part + nrows * HD : nullptr;
  float* pl = part ? pm + nrows : nullptr;
  const int tid = threadIdx.x;

  if (s0 >= s1) {  // never with one split: stage 0 holds key 0
    for (int i = tid; i < BM; i += NT)
      if (r_first + i < TG) {
        pm[prow + r_first + i] = -INFINITY;
        pl[prow + r_first + i] = 0.f;
      }
    return;
  }
  if constexpr (PAGED) {  // this split's block-table entries, ahead of use
    const int p0 = s0 * PPS, np = min(s1 * PPS, ntab) - p0;
    for (int i = tid; i < np; i += NT)
      sTbl[i] = tables[(size_t)b * ntab + p0 + i];
    __syncthreads();
  }

  const int k_first = s0 * kStageKeys;
  // keys past the block's last query position are never loaded
  const int k_end = min(min(s1 * kStageKeys, nkeys), last_pos + 1);
  const int n_steps = (k_end - k_first + SK - 1) / SK;
  // key j's token slot: page * 16 + offset in the pool, or b * nkeys + j
  // in the contiguous view (its row of head h starts at slot * Hk * HD +
  // h * HD, its scale at slot * Hk + h)
  auto key_slot = [&](int j) -> size_t {
    return PAGED ? (size_t)sTbl[j / kPage - s0 * PPS] * kPage + j % kPage
                 : (size_t)b * nkeys + j;
  };
  // step `st` (SK keys) of K, V (and their scales) into ring slot `buf`;
  // keys past the cache are zero-filled and masked
  auto load_step = [&](int st, int buf) {
    unsigned char* base = ring + buf * GE::kSlot;
    KVT* dK = reinterpret_cast<KVT*>(base);
    KVT* dV = reinterpret_cast<KVT*>(base + GE::kKV);
    constexpr int EPV = 16 / sizeof(KVT);  // elements per 16-byte copy
    constexpr int CPR = HD / EPV;
    const int key0 = k_first + st * SK;
    for (int c = tid; c < SK * CPR; c += NT) {
      const int i = c / CPR, col = (c % CPR) * EPV;
      const int j = key0 + i;
      const bool in = j < nkeys;
      const size_t off = in ? (key_slot(j) * Hk + h) * HD : 0;
      ca::cp_async16(dK + i * LDR + col, kc + off + col, in);
      ca::cp_async16(dV + i * LDR + col, vc + off + col, in);
    }
    if constexpr (QUANT) {
      float* dS = reinterpret_cast<float*>(base + 2 * GE::kKV);
      for (int i = tid; i < 2 * SK; i += NT) {
        const int j = key0 + i % SK;
        const bool in = j < nkeys;
        const size_t sci = in ? key_slot(j) * Hk + h : 0;
        ca::cp_async4(dS + i, (i < SK ? ksc : vsc) + sci, in);
      }
    }
  };

  {  // the block's query rows (rows past T * G zero-filled)
    constexpr int CPR = HD / 4;
    for (int c = tid; c < BM * CPR; c += NT) {
      const int i = c / CPR, col = (c % CPR) * 4;
      const int r = r_first + i;
      const bool in = r < TG;
      const int t = in ? r / G : 0, g = in ? r - t * G : 0;
      ca::cp_async16(sQ + i * LD + col,
                     q + ((size_t)(b * T + t) * H + h * G + g) * HD + col,
                     in);
    }
  }
  load_step(0, 0);
  ca::cp_async_commit();

  const int tk = tid % kLanes, tr = tid / kLanes;
  // warp-uniform: a warp's first row group holds its lowest row
  const bool live = r_first + (tid / 32) * (32 / kLanes) < TG;
  int qpos[RT];
  float m[RT], l[RT];
  float4 acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    qpos[i] = start + (r_first + tr + TR * i) / G;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < CT; ++g) acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int it = 0; it < n_steps; ++it) {
    if (it + 1 < n_steps) load_step(it + 1, (it + 1) % 2);
    ca::cp_async_commit();  // possibly empty: one group per iteration
    ca::cp_async_wait<1>();  // this step (and q) have landed
    __syncthreads();
    const unsigned char* base = ring + (it % 2) * GE::kSlot;
    const float* tK;
    const float* tV;
    if constexpr (QUANT) {  // value x scale in f32, four values a thread
      const int* rK = reinterpret_cast<const int*>(base);
      const int* rV = reinterpret_cast<const int*>(base + GE::kKV);
      const float* rS = reinterpret_cast<const float*>(base + 2 * GE::kKV);
      constexpr int CPR = HD / 4, NC = SK * CPR;
      for (int c = tid; c < 2 * NC; c += NT) {
        const int kv = c / NC, i = (c % NC) / CPR, col = (c % CPR) * 4;
        const int raw = (kv ? rV : rK)[(i * HD + col) / 4];
        const float s = rS[kv * SK + i];
        *reinterpret_cast<float4*>(sDeq + (kv * SK + i) * LD + col) =
            make_float4(i8(raw, 0) * s, i8(raw, 1) * s, i8(raw, 2) * s,
                        i8(raw, 3) * s);
      }
      __syncthreads();
      tK = sDeq;
      tV = sDeq + SK * LD;
    } else {
      tK = reinterpret_cast<const float*>(base);
      tV = reinterpret_cast<const float*>(base + GE::kKV);
    }

    if (live) {  // scores, the online softmax, P into shared memory
      float s[RT][KT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < KT; ++j) s[i][j] = 0.f;
#pragma unroll (GE::kUnroll)
      for (int c = 0; c < HD; c += 4) {
        float4 kv[KT];
#pragma unroll
        for (int j = 0; j < KT; ++j)
          kv[j] = *reinterpret_cast<const float4*>(
              tK + (tk + kLanes * j) * LD + c);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(sQ + (tr + TR * i) * LD + c);
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
          }
        }
      }
      const int key0 = k_first + it * SK;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const int kpos = key0 + tk + kLanes * j;
          s[i][j] = (kpos <= qpos[i] && kpos < nkeys) ? s[i][j] * scale
                                                      : kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
        mx = group_max(mx);
        const float corr = expf(m[i] - mx);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          s[i][j] = expf(s[i][j] - mx);
          rs += s[i][j];
        }
        l[i] = l[i] * corr + group_sum(rs);
        m[i] = mx;
#pragma unroll
        for (int g = 0; g < CT; ++g) {
          acc[i][g].x *= corr;
          acc[i][g].y *= corr;
          acc[i][g].z *= corr;
          acc[i][g].w *= corr;
        }
#pragma unroll
        for (int j = 0; j < KT; ++j)
          sP[(tr + TR * i) * LDP + tk + kLanes * j] = s[i][j];
      }
    }
    __syncthreads();
    if (live) {  // acc += P V, four keys at a time
#pragma unroll (GE::kUnroll)
      for (int k = 0; k < SK; k += 4) {
        float4 p[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          p[i] = *reinterpret_cast<const float4*>(sP + (tr + TR * i) * LDP +
                                                  k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int g = 0; g < CT; ++g) {
            const float4 v = *reinterpret_cast<const float4*>(
                tV + (k + kk) * LD + 4 * (tk + kLanes * g));
#pragma unroll
            for (int i = 0; i < RT; ++i) fma4(acc[i][g], lane_of(p[i], kk), v);
          }
      }
    }
    __syncthreads();  // every warp is done with this ring slot, P, deq
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = r_first + tr + TR * i;
    if (r >= TG) continue;
    if (part == nullptr) {
      const int t = r / G, g = r - t * G;
      const float ls = fmaxf(l[i], 1e-30f);
      float* o = out + ((size_t)(b * T + t) * H + h * G + g) * HD;
#pragma unroll
      for (int c = 0; c < CT; ++c)
        *reinterpret_cast<float4*>(o + 4 * (tk + kLanes * c)) =
            make_float4(acc[i][c].x / ls, acc[i][c].y / ls, acc[i][c].z / ls,
                        acc[i][c].w / ls);
    } else {
      float* a = part + (prow + r) * HD;
#pragma unroll
      for (int c = 0; c < CT; ++c)
        *reinterpret_cast<float4*>(a + 4 * (tk + kLanes * c)) = acc[i][c];
      if (tk == 0) {
        pm[prow + r] = m[i];
        pl[prow + r] = l[i];
      }
    }
  }
}

// The merge: one warp per output row (b, t, query head), the splits'
// partials combined in split order. A neutral partial (m = -inf) and a
// row that saw no key of a split (m = -1e30 against a real maximum) get
// weight 0, and their acc is never read.
template <int HD>
__device__ __forceinline__ void merge_partials(const float* __restrict__ part,
                                               float* __restrict__ out, int B,
                                               int T, int H, int Hk,
                                               int splits) {
  constexpr int VPL = HD / 32;  // channels per lane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= B * T * H) return;
  const int hq = row % H, bt = row / H, t = bt % T, b = bt / T;
  const int G = H / Hk, h = hq / G, g = hq - h * G, TG = T * G;
  const size_t nrows = (size_t)splits * B * Hk * TG;
  const float* pm = part + nrows * HD;
  const float* pl = pm + nrows;
  const size_t r0 = ((size_t)b * Hk + h) * TG + t * G + g;
  const size_t step = (size_t)B * Hk * TG;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, pm[r0 + s * step]);
  float a[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) a[i] = 0.f;
  float L = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t rs = r0 + s * step;
    const float ms = pm[rs];
    const float w = ms == -INFINITY ? 0.f : expf(ms - M);
    if (w > 0.f) {  // warp-uniform
      L += w * pl[rs];
      const float* src = part + rs * HD + lane * VPL;
#pragma unroll
      for (int i = 0; i < VPL; i += 2) {
        const float2 v = *reinterpret_cast<const float2*>(src + i);
        a[i] += w * v.x;
        a[i + 1] += w * v.y;
      }
    }
  }
  const float ls = fmaxf(L, 1e-30f);
  float* o = out + (size_t)row * HD + lane * VPL;
#pragma unroll
  for (int i = 0; i < VPL; i += 2)
    *reinterpret_cast<float2*>(o + i) = make_float2(a[i] / ls, a[i + 1] / ls);
}

}  // namespace sf
