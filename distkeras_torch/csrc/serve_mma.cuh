// The tensor-core attention core of the two serving kernels
// (paged_attention.cu, splash_prefill.cu) for bf16 queries: split-K over
// the cache (flash-decoding), then a merge. It replaces the bf16 path of
// the Pallas TPU kernels distkeras_tpu/ops/paged_attention.py:
// paged_attention (body _kernel) and distkeras_tpu/ops/splash_prefill.py:
// splash_prefill_attention (body _kernel); f32 queries take the
// FFMA core of serve_f32.cuh.
//
// The function: query row r = t * G + g of KV head h is query head
// h * G + g at absolute position starts[b] + t and sees keys <= that
// position; scores q k^T * scale in f32, masked with -1e30 as the TPU
// kernels mask; an online softmax in f32; P rounded to bf16 before P V;
// output acc / max(l, 1e-30) in bf16. int8 pages are exact in bf16, so
// each key's f32 scale multiplies its f32 score column after q k^T, and
// each value's scale multiplies P's (bf16-rounded) column, carried as a
// bf16 hi + lo pair so that the scale keeps f32 precision.
//
// What bounds it on the H100 at the serving shapes (8 rows, H=8, Hk=2,
// hd=256, 16-token int8 pages, contexts up to 2048): a decode tick
// (T=1) reads ~7 MB of pages for ~8 MFLOP, so bytes; a 64-token chunk
// does ~4 GFLOP over the same bytes, so operations (the tensor cores).
// Either way the old kernel ran 200-400x its bound, held back by too few
// blocks, scalar FMAs and loads that nothing overlapped. What each part
// of the design does about that:
//
// - Both products on the tensor cores: mma.sync m16n8k16, bf16 in, f32
//   accumulate, the softmax in registers between them (the S fragment is
//   re-packed as P V's A operand), the fragment loaders and cp.async of
//   flash_mma.cuh.
// - GQA rides the M axis: one block takes BM query rows (r = t * G + g)
//   of one (b, h) and reads each K/V tile once for all of them. At chunk
//   size BM = 64, four warps of 16 rows, each warp over all 64 keys of a
//   stage. At decode (T * G <= 16) BM = 16: one m16 tile of rows, and
//   the four warps split each 64-key stage into four 16-key pages, each
//   with its own softmax state, merged at the end through shared memory.
// - Split-K over the cache: grid (row tile, KV head, batch row x split).
//   A split walks a fixed range of `per` 64-key stages. The host picks
//   the splits from shapes alone (never from seq_lens / starts, which
//   live on the device). Each block writes an f32 partial (m, l, acc) to
//   scratch the wrapper allocates; merge_partials combines them in split
//   order (no atomics: the same bits every run). A split wholly past its
//   row tile's last query position exits at once with a neutral partial
//   (m = -inf, l = 0, acc never read). With one split the block writes
//   the output itself and no merge runs.
// - Pipelined loads: a block stages its own block-table entries in
//   shared memory, then copies each 64-key stage (four pages) global ->
//   shared with 16-byte cp.async into a ring of two stages, so stage j+1
//   is in flight while stage j computes. int8 pages are copied as int8
//   (the bytes the bound counts) and converted to bf16 in shared memory:
//   once per stage into bf16 tiles where all four warps read the whole
//   stage (BM = 64), else on the way into the fragments (each decode
//   warp reads only its own page). Rows are padded by 16 bytes so
//   fragment loads do not conflict.
//
// No wgmma, TMA or warp specialisation yet; times sit beside the bounds
// in PERF.md.

#pragma once

#include <type_traits>

#include "flash_mma.cuh"

namespace sv {

using ca::bf16;

constexpr int kThreads = 128;   // four warps
constexpr int kWarps = 4;
constexpr int kPage = 16;       // keys per page (and per splash key tile)
constexpr int kStageKeys = 64;  // keys per pipeline stage: four pages
constexpr int kStages = 2;      // the cp.async ring
constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value

// Shared-memory geometry of one instantiation (bytes unless noted).
template <typename KVT, int HD>
struct Tile {
  static constexpr bool kQuant = sizeof(KVT) == 1;
  static constexpr int LDQ = HD + 8;  // bf16 q rows, elements
  static constexpr int LDK = kQuant ? HD + 16 : HD + 8;  // K/V rows, elements
  static constexpr int LDA = HD + 8;  // f32 epilogue rows, elements
  static constexpr int kKV = kStageKeys * LDK * (int)sizeof(KVT);  // K or V
  static constexpr int kStage = 2 * kKV + (kQuant ? 2 * kStageKeys * 4 : 0);
  static constexpr int kEpi = kWarps * 16 * LDA * 4;  // every warp's acc
  static constexpr int kArea = kStages * kStage > kEpi ? kStages * kStage
                                                       : kEpi;
  // int8 pages read by all four warps of a 64-row block are converted to
  // bf16 once per stage, into K and V tiles of bf16 rows
  static constexpr int kConv = 2 * kStageKeys * LDQ * 2;
};

// whether a block converts each int8 stage to bf16 in shared memory
// first: only where its four warps all read the whole stage (BM = 64)
template <typename KVT, int BM>
__host__ __device__ constexpr bool converts() {
  return sizeof(KVT) == 1 && BM == 16 * kWarps;
}

// dynamic shared memory of one launch: q rows, the stage ring (reused by
// the epilogue), per-warp m and l, the split's block-table entries
template <typename KVT, int HD, int BM>
inline size_t smem_bytes(int per, bool paged) {
  using TL = Tile<KVT, HD>;
  return (size_t)BM * TL::LDQ * 2 + TL::kArea +
         (converts<KVT, BM>() ? TL::kConv : 0) + 2 * kWarps * 16 * 4 +
         (paged ? (size_t)per * (kStageKeys / kPage) * 4 : 0);
}

__device__ __forceinline__ uint32_t i8x2(int8_t lo, int8_t hi) {
  // int8 values are exact in bf16
  return ca::pack_bf16(__float2bfloat16((float)lo),
                       __float2bfloat16((float)hi));
}

// Two probabilities rounded to bf16 (P's cast), times their values'
// f32 scales, each product split into bf16 hi + lo terms (packed pairs)
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo,
                                           float p0, float p1, float w0,
                                           float w1) {
  const float x0 = __bfloat162float(__float2bfloat16(p0)) * w0;
  const float x1 = __bfloat162float(__float2bfloat16(p1)) * w1;
  const bf16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  hi = ca::pack_bf16(h0, h1);
  lo = ca::pack_f32(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

// B fragment of q k^T from a K tile (rows = keys): flash_mma's frag_b_nk,
// and its int8 twin converting on the way
template <int LD>
__device__ __forceinline__ void frag_k(uint32_t& b0, uint32_t& b1,
                                       const bf16* t, int n0, int k0,
                                       int lane) {
  ca::frag_b_nk<LD>(b0, b1, t, n0, k0, lane);
}
template <int LD>
__device__ __forceinline__ void frag_k(uint32_t& b0, uint32_t& b1,
                                       const int8_t* t, int n0, int k0,
                                       int lane) {
  const int8_t* p = t + (n0 + (lane >> 2)) * LD + k0 + (lane & 3) * 2;
  b0 = i8x2(p[0], p[1]);
  b1 = i8x2(p[8], p[9]);
}

// B fragment of P V from a V tile (rows = keys, the contraction)
template <int LD>
__device__ __forceinline__ void frag_v(uint32_t& b0, uint32_t& b1,
                                       const bf16* t, int k0, int n0,
                                       int lane) {
  ca::frag_b_kn<LD>(b0, b1, t, k0, n0, lane);
}
template <int LD>
__device__ __forceinline__ void frag_v(uint32_t& b0, uint32_t& b1,
                                       const int8_t* t, int k0, int n0,
                                       int lane) {
  const int8_t* p = t + (k0 + (lane & 3) * 2) * LD + n0 + (lane >> 2);
  b0 = i8x2(p[0], p[LD]);
  b1 = i8x2(p[8 * LD], p[9 * LD]);
}

// One block: query rows [rt * BM, +BM) of (b, h), split `split` of the
// cache. PAGED: key j of row b is slot j % 16 of page
// tables[b * ntab + j / 16] in a [P, 16, Hk, HD] pool; otherwise key j of
// a contiguous [B, ntab * 16, Hk, HD] view. `part` is null when the
// launch has one split (the block writes `out` itself), else the f32
// scratch [splits * B * Hk * T * G] x (HD acc + m + l).
template <typename KVT, int HD, int BM, bool PAGED>
__device__ __forceinline__ void split_attn(
    const bf16* __restrict__ q, const KVT* __restrict__ kc,
    const KVT* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ starts, bf16* __restrict__ out,
    float* __restrict__ part, int T, int H, int Hk, int ntab, float scale,
    int splits, int per) {
  using TL = Tile<KVT, HD>;
  constexpr bool QUANT = TL::kQuant;
  constexpr int WR = BM / 16;           // warps along the rows
  constexpr int WK = kWarps / WR;       // warps along a stage's keys
  constexpr int KW = kStageKeys / WK;   // keys of a stage per warp
  constexpr int NS = KW / 8, NO = HD / 8;
  constexpr int LDQ = TL::LDQ, LDK = TL::LDK, LDA = TL::LDA;
  constexpr int PPS = kStageKeys / kPage;  // pages per stage
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  unsigned char* area = smem + BM * LDQ * 2;
  constexpr bool CONV = converts<KVT, BM>();
  // what the fragment loaders read: the ring's K/V, or their bf16
  // conversions
  using FT = typename std::conditional<CONV, bf16, KVT>::type;
  constexpr int LDF = CONV ? LDQ : LDK;
  bf16* sKb = reinterpret_cast<bf16*>(area + TL::kArea);
  bf16* sVb = sKb + kStageKeys * LDQ;
  float* sM = reinterpret_cast<float*>(area + TL::kArea +
                                       (CONV ? TL::kConv : 0));
  float* sL = sM + kWarps * 16;
  int* sTbl = reinterpret_cast<int*>(sL + kWarps * 16);

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
  float* pm = part + nrows * HD;
  float* pl = pm + nrows;

  if (s0 >= s1) {  // never with one split: stage 0 holds key 0
    for (int i = threadIdx.x; i < BM; i += kThreads)
      if (r_first + i < TG) {
        pm[prow + r_first + i] = -INFINITY;
        pl[prow + r_first + i] = 0.f;
      }
    return;
  }
  if constexpr (PAGED) {  // this split's block-table entries, ahead of use
    const int p0 = s0 * PPS, np = min(s1 * PPS, ntab) - p0;
    for (int i = threadIdx.x; i < np; i += kThreads)
      sTbl[i] = tables[(size_t)b * ntab + p0 + i];
    __syncthreads();
  }

  const size_t kstride = (size_t)Hk * HD;
  // element offset of key j's row of head h; `sci` its scale's index
  auto key_row = [&](int j, size_t& sci) -> size_t {
    const size_t slot =
        PAGED ? (size_t)sTbl[j / kPage - s0 * PPS] * kPage + j % kPage
              : (size_t)b * nkeys + j;
    sci = slot * Hk + h;
    return slot * kstride + (size_t)h * HD;
  };
  // stage `st` (64 keys) of K, V (and their scales) into ring slot `buf`;
  // keys past the cache are zero-filled and masked
  auto load_stage = [&](int st, int buf) {
    unsigned char* base = area + buf * TL::kStage;
    KVT* dK = reinterpret_cast<KVT*>(base);
    KVT* dV = reinterpret_cast<KVT*>(base + TL::kKV);
    constexpr int EPV = 16 / sizeof(KVT);  // elements per 16-byte copy
    constexpr int CPR = HD / EPV;
    for (int c = threadIdx.x; c < kStageKeys * CPR; c += kThreads) {
      const int i = c / CPR, col = (c % CPR) * EPV;
      const int j = st * kStageKeys + i;
      const bool in = j < nkeys;
      size_t sci;
      const size_t off = in ? key_row(j, sci) : 0;
      ca::cp_async16(dK + i * LDK + col, kc + off + col, in);
      ca::cp_async16(dV + i * LDK + col, vc + off + col, in);
    }
    if constexpr (QUANT) {
      float* dS = reinterpret_cast<float*>(base + 2 * TL::kKV);
      for (int i = threadIdx.x; i < 2 * kStageKeys; i += kThreads) {
        const int j = st * kStageKeys + i % kStageKeys;
        const bool in = j < nkeys;
        size_t sci = 0;
        if (in) key_row(j, sci);
        ca::cp_async4(dS + i, (i < kStageKeys ? ksc : vsc) + sci, in);
      }
    }
  };

  {  // the block's query rows (rows past T * G zero-filled)
    constexpr int CPR = HD / 8;
    for (int c = threadIdx.x; c < BM * CPR; c += kThreads) {
      const int i = c / CPR, col = (c % CPR) * 8;
      const int r = r_first + i;
      const bool in = r < TG;
      const int t = in ? r / G : 0, g = in ? r - t * G : 0;
      ca::cp_async16(sQ + i * LDQ + col,
                     q + ((size_t)(b * T + t) * H + h * G + g) * HD + col,
                     in);
    }
  }
  load_stage(s0, 0);
  ca::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c2 = (lane & 3) * 2;
  const int wr = warp % WR, wk = warp / WR;
  const int row_a = r_first + wr * 16 + (lane >> 2);  // and row_a + 8
  const int qpos0 = start + row_a / G, qpos1 = start + (row_a + 8) / G;
  const int kw0 = wk * KW;  // this warp's first key within a stage

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int n_st = s1 - s0;
  for (int it = 0; it < n_st; ++it) {
    if (it + 1 < n_st) load_stage(s0 + it + 1, (it + 1) % kStages);
    ca::cp_async_commit();  // possibly empty: one group per iteration
    ca::cp_async_wait<1>();  // this stage (and q) have landed
    __syncthreads();
    const unsigned char* base = area + (it % kStages) * TL::kStage;
    const KVT* tK = reinterpret_cast<const KVT*>(base);
    const KVT* tV = reinterpret_cast<const KVT*>(base + TL::kKV);
    const float* tS = reinterpret_cast<const float*>(base + 2 * TL::kKV);
    if constexpr (CONV) {  // int8 -> bf16 (exact), 16 values per step
      constexpr int CPR = HD / 16, NC = kStageKeys * CPR;
      for (int c = threadIdx.x; c < 2 * NC; c += kThreads) {
        const int kv = c / NC, i = (c % NC) / CPR, col = (c % CPR) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            reinterpret_cast<const int8_t*>(kv ? tV : tK) + i * LDK + col);
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
        uint4* dst = reinterpret_cast<uint4*>((kv ? sVb : sKb) + i * LDQ + col);
        dst[0] = make_uint4(i8x2(e[0], e[1]), i8x2(e[2], e[3]),
                            i8x2(e[4], e[5]), i8x2(e[6], e[7]));
        dst[1] = make_uint4(i8x2(e[8], e[9]), i8x2(e[10], e[11]),
                            i8x2(e[12], e[13]), i8x2(e[14], e[15]));
      }
      __syncthreads();
    }
    const FT* fK = reinterpret_cast<const FT*>(
        CONV ? static_cast<const void*>(sKb) : static_cast<const void*>(tK));
    const FT* fV = reinterpret_cast<const FT*>(
        CONV ? static_cast<const void*>(sVb) : static_cast<const void*>(tV));

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a4[4];
      ca::frag_a<LDQ>(a4, sQ, wr * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t b0, b1;
        frag_k<LDF>(b0, b1, fK, kw0 + n * 8, kk * 16, lane);
        ca::mma16816(s[n], a4, b0, b1);
      }
    }
    const int key0 = (s0 + it) * kStageKeys + kw0;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = n * 8 + c2 + (e & 1);
        const int kpos = key0 + kl;
        float v = s[n][e] * scale;
        if constexpr (QUANT) v *= tS[kw0 + kl];
        s[n][e] = (kpos <= (e < 2 ? qpos0 : qpos1) && kpos < nkeys) ? v
                                                                    : kNegInf;
      }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = ca::quad_max(mx0);
    mx1 = ca::quad_max(mx1);
    const float corr0 = expf(m0 - mx0), corr1 = expf(m1 - mx1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = expf(s[n][0] - mx0);
      s[n][1] = expf(s[n][1] - mx0);
      s[n][2] = expf(s[n][2] - mx1);
      s[n][3] = expf(s[n][3] - mx1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = l0 * corr0 + ca::quad_sum(rs0);
    l1 = l1 * corr1 + ca::quad_sum(rs1);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }
    // P (rounded to bf16) V. For int8 pages each P column is first
    // multiplied by its value's f32 scale, and the product is carried as
    // two bf16 terms (hi + lo, two products): the scale stays at f32
    // precision, as an f32 dequantization would keep it, where one bf16
    // rounding of it costs up to |v| * 2^-9 on top of the output's own
    // (chip_smoke.py's int8 case missed its 1e-2 that way).
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      uint32_t a4[4];
      if constexpr (QUANT) {
        const float* vs = tS + kStageKeys + kw0 + kk * 16 + c2;
        uint32_t lo[4];
        split_bf16(a4[0], lo[0], s[2 * kk][0], s[2 * kk][1], vs[0], vs[1]);
        split_bf16(a4[1], lo[1], s[2 * kk][2], s[2 * kk][3], vs[0], vs[1]);
        split_bf16(a4[2], lo[2], s[2 * kk + 1][0], s[2 * kk + 1][1], vs[8],
                   vs[9]);
        split_bf16(a4[3], lo[3], s[2 * kk + 1][2], s[2 * kk + 1][3], vs[8],
                   vs[9]);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t b0, b1;
          frag_v<LDF>(b0, b1, fV, kw0 + kk * 16, n * 8, lane);
          ca::mma16816(acc[n], a4, b0, b1);
          ca::mma16816(acc[n], lo, b0, b1);
        }
      } else {
        a4[0] = ca::pack_f32(s[2 * kk][0], s[2 * kk][1]);
        a4[1] = ca::pack_f32(s[2 * kk][2], s[2 * kk][3]);
        a4[2] = ca::pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a4[3] = ca::pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t b0, b1;
          frag_v<LDF>(b0, b1, fV, kw0 + kk * 16, n * 8, lane);
          ca::mma16816(acc[n], a4, b0, b1);
        }
      }
    }
    __syncthreads();  // every warp is done with this ring slot
  }

  // epilogue: each warp's (m, l, acc) into shared memory (the ring is
  // free), then the WK key-warps of each row merged and written out
  float* sA = reinterpret_cast<float*>(area);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = wk * BM + wr * 16 + (lane >> 2) + half * 8;
    float* dst = sA + row * LDA;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(dst + n * 8 + c2) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    if ((lane & 3) == 0) {
      sM[row] = half ? m1 : m0;
      sL[row] = half ? l1 : l0;
    }
  }
  __syncthreads();
  constexpr int C4 = HD / 4;
  for (int c = threadIdx.x; c < BM * C4; c += kThreads) {
    const int i = c / C4, col = (c % C4) * 4;
    const int r = r_first + i;
    if (r >= TG) continue;
    float M = sM[i];
#pragma unroll
    for (int w = 1; w < WK; ++w) M = fmaxf(M, sM[w * BM + i]);
    float L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      const float wt = WK == 1 ? 1.f : expf(sM[w * BM + i] - M);
      const float4 v =
          *reinterpret_cast<const float4*>(sA + (w * BM + i) * LDA + col);
      L += wt * sL[w * BM + i];
      A.x += wt * v.x;
      A.y += wt * v.y;
      A.z += wt * v.z;
      A.w += wt * v.w;
    }
    if (part == nullptr) {
      const int t = r / G, g = r - t * G;
      const float ls = fmaxf(L, 1e-30f);
      bf16* o = out + ((size_t)(b * T + t) * H + h * G + g) * HD + col;
      *reinterpret_cast<uint2*>(o) = make_uint2(
          ca::pack_f32(A.x / ls, A.y / ls), ca::pack_f32(A.z / ls, A.w / ls));
    } else {
      *reinterpret_cast<float4*>(part + (prow + r) * HD + col) = A;
      if (col == 0) {
        pm[prow + r] = M;
        pl[prow + r] = L;
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
                                               bf16* __restrict__ out, int B,
                                               int T, int H, int Hk,
                                               int splits) {
  constexpr int VPL = HD / 32;  // channels per lane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
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
  bf16* o = out + (size_t)row * HD + lane * VPL;
#pragma unroll
  for (int i = 0; i < VPL; i += 2)
    *reinterpret_cast<uint32_t*>(o + i) =
        ca::pack_f32(a[i] / ls, a[i + 1] / ls);
}

}  // namespace sv
