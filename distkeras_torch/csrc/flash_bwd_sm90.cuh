// The training attention backward written for Hopper (sm_90a): a dq
// kernel and a dk/dv kernel with every product on wgmma, tiles brought in
// by TMA through mbarrier rings that one producer thread keeps full, and
// two consumer warpgroups per block, built from the forward's pieces in
// flash_fwd_sm90.cuh (barriers, copies, descriptors, wgmma shapes, the
// persistent item order), and a prep pass they share. Templated, as the
// forward is, on <HD, CAUSAL, PAIR>, compile-time flags (a wgmma under a
// runtime branch made ptxas serialize every one), and instantiated as
// ca::sm90::launch_dq and ca::sm90::launch_dkv by
//   causal_attention.cu  <HD, true, false>: causal self-attention, q
//                        scaled on the card, lse [B, H, T];
//   pair_attention.cu    <HD, CAUSAL, true>: one chunk pair of the zigzag
//                        ring, q arriving pre-scaled, lse [B, Tq, H] and
//                        its cotangent dlse; the causal wedge (a chunk
//                        against itself, Tq == Tk, local positions) or
//                        the full rectangle (any Tq and Tk, no mask).
//
// Replaces the backward Pallas TPU kernels:
//   distkeras_tpu/ops/pallas_attention.py  _dq_kernel :193 (pallas_call
//                                          :305), _dkv_kernel :240 (:333)
//   distkeras_tpu/ops/pallas_pair.py       _bwd_impl :403: _dq_kernel_tri
//                                          :301 (pallas_call :420),
//                                          _dkv_kernel_tri :380 (:444),
//                                          _dq_kernel :281 (:492),
//                                          _dkv_kernel :359 (:510)
// Same function and roundings as they compute: P = exp(s - lse) is
// recomputed from s = q k^T, with q scaled and rounded to bf16 first
// (!PAIR) or as given (PAIR); masked scores are -1e30 (P = 0); dS = P *
// (dP - delta) with delta = rowsum(dO * O) in f32; P is rounded to bf16
// before dV and dS before dQ and dK; dQ is multiplied by the scale at the
// end (1 for a pair, so exact) and dK is left unscaled (the q it
// multiplies was scaled). With PAIR the lse cotangent enters as
// dS = P * (dP - delta + dlse); the prep pass folds it into delta, and the
// kernels compute P * (dP - delta') with delta' = delta - dlse, as the
// reference says ("the lse cotangent folded into delta",
// pallas_pair.py:242). In f32, dP - (delta - dlse) differs from
// (dP - delta) + dlse only by the rounding of one subtraction, an ulp.
// exp runs as ex2 with log2(e) folded in. No atomics and a fixed order:
// two launches give equal bits.
//
// What bounds them on the H100: operations. At the flagship shape
// [8, 2048, 8, 256] the causal dq does three products over the causal
// wedge (206 GFLOP) and dk/dv four (275 GFLOP), against 403 and 470 MB of
// traffic: ~510 and ~585 FLOPs a byte, above the card's ~295 bf16 ridge
// point. The ring's rectangle at [8, 1024, 8, 256] is ~500 FLOPs a byte;
// its wedge does half the products over the same bytes, near the ridge.
// So the design keeps the tensor cores fed: wgmma for every product,
// copies by TMA that cost the consumers no instructions, two consumers
// whose products fill the tensor cores while the other computes, and the
// per-row work (q's scaling, delta) done once, outside both kernels.
//
// The prep pass (one warp a row) writes delta once per row, in lse's
// layout, into scratch the caller allocates: rowsum(dO * O) (!PAIR, which
// also writes q * scale rounded to bf16, contiguous) or rowsum(dO * O) -
// dlse (PAIR, whose q is read through its own strides). So no work item
// re-reads O or rescales q. The dq launcher runs it; the dk/dv launcher of
// the same backward reads what it wrote, and runs it itself only when
// called alone. At the causal flagship shape it takes ~0.086 ms (268 MB).
//
// dq (one work item = 128 query rows of one (batch, head), 64 rows a
// consumer warpgroup; 64-key tiles):
// - The producer loads each consumer's Q (scaled) and dO rows on one barrier
//   and streams K and V tiles through two rings: K in two stages, as K
//   serves S = Q K^T early in step i and dQ += dS K late in it; V in two
//   stages below hd 256 and one at hd 256, where it is freed as soon as
//   dP = dO V^T is read (shared memory: Q and dO of both consumers 128
//   KB, K 64 KB, V 32 KB).
// - Step i issues S(i) and dP(i) (SS, K-major) right behind dQ(i - 1)
//   (RS: dS re-packed from the accumulator, K as an MN-major B with the
//   transpose bit), waits for all three, computes dS(i) and issues dQ(i).
//   The other consumer's products fill the tensor cores while one
//   computes; every wgmma is issued in straight-line code.
// - Each thread reads the lse and delta of its two rows while Q lands
//   (with PAIR at stride H floats, lse's [B, Tq, H] layout: gathers).
// - CAUSAL walks the key tiles up to the diagonal and masks keys past each
//   row; the rectangle walks all ceil(Tk / 64) of them, and masks keys at
//   or past Tk on the last one: TMA zero-fills rows past Tk, so s = 0 there
//   and exp(-lse) would not be 0 (the causal mask hides this, as a live
//   row's keys lie below T).
// - Registers at hd 256: dQ 128 + S 32 + dP 32 + packed dS 16 a thread,
//   under the 240 that setmaxnreg gives the consumers. Overlapping dS(i)
//   with dQ(i - 1) as the forward overlaps its softmax spilled (372 bytes)
//   at this budget; tile addresses are made opaque inside the loops so
//   ptxas does not keep every wgmma descriptor live across them.
// - 32-key tiles at hd 256 with deeper rings (four K and two V stages)
//   measured 15-40% slower than 64-key tiles with one V stage: the
//   halved products re-read Q and dO from shared memory twice as often.
//
// dk/dv (one work item = 64 keys of one (batch, head); 64-query steps
// from the diagonal to the end with CAUSAL, over all ceil(Tq / 64) query
// tiles from 0 for the rectangle, where queries at or past Tq are the only
// mask; keys at or past Tk compute rows of dK and dV that are never
// stored):
// - The item's K and V arrive once, the steps' q (scaled) and dO tiles
//   through a two-stage ring; lse and delta are read per step like lse
//   in dq.
// - Each consumer computes S^T = K q^T and dP^T = V dO^T for its 32 of
//   the step's 64 queries (SS, m64n32), then P^T and dS^T, which it
//   writes as bf16 swizzled tiles to shared memory (double-buffered).
// - Then dV += P^T dO and dK += dS^T q as SS wgmma with dO and q as
//   MN-major B operands. At hd 256 dK and dV of 64 keys would need 256
//   registers a thread, so the two consumers split hd: each owns 128
//   channels of both (128 registers) and reads both halves of P^T and
//   dS^T (one named barrier a step). Below hd 256 each consumer keeps
//   dK and dV over all of hd for its own 32 queries, reads only the
//   columns it wrote (no barrier between the consumers), and the two
//   partial sums are added in a fixed order at the end of the item.
// - Step i issues dV/dK(i - 1) before S^T(i) and dP^T(i), so step i - 1's
//   q and dO stage is freed as soon as dV/dK(i - 1) complete and the load
//   two steps ahead has most of a step to land. Issuing them after S^T
//   and dP^T instead, to overlap P^T(i) with dV/dK(i - 1), freed the
//   stage at the end of the step, and the next load showed every step
//   (11% slower at the flagship shape).
// - Shared memory at hd 256: K and V 32 KB each, two stages of q and dO
//   128 KB, two buffers of P^T and dS^T 32 KB.
//
// Both kernels are persistent (at most one block per SM) and walk their
// items heaviest first inside groups of heads whose streamed operands fit
// in L2, as the forward does. The rectangle's items are all equal.
//
// PAIR changes nothing inside dq and dk/dv: it selects the prep pass's
// delta' and q's map (the caller's strided q, not the scaled copy), and
// names the instantiation apart from the causal one. The wedge is the
// causal kernel on local positions.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "flash_fwd_sm90.cuh"

namespace ca {
namespace sm90 {

constexpr int kBwdKeys = 64;  // keys of a dq K/V tile and of a dk/dv item
constexpr int kBwdRows = 64;  // queries of a dk/dv step

template <int HD>
struct DqTiles {
  static constexpr int NB = HD / 64;               // 128-byte column blocks
  static constexpr int BC = kBwdKeys;              // keys of a K/V tile
  static constexpr int KST = 2;                    // K ring stages
  static constexpr int VST = HD == 256 ? 1 : 2;    // V ring stages
  static constexpr int Q_BYTES = kRows * HD * 2;   // Q (or dO) of an item
  static constexpr int KV_BYTES = BC * HD * 2;
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + KST * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + VST * KV_BYTES;
  // Q full and empty per consumer; K full, K empty per stage; V likewise
  static constexpr int BAR_BYTES = (4 + 2 * KST + 2 * VST) * 8;
  static constexpr size_t SMEM = BAR_OFF + BAR_BYTES + 1024;
};

template <int HD>
struct DkvTiles {
  // hd 256: the consumers split hd; below it they split the queries
  static constexpr bool SPLIT_HD = HD == 256;
  static constexpr int NB = HD / 64;
  static constexpr int N = SPLIT_HD ? HD / 2 : HD;  // dK/dV columns a consumer
  static constexpr int KV_BYTES = kBwdKeys * HD * 2;  // the item's K or V
  static constexpr int QS_BYTES = kBwdRows * HD * 2;  // a step's q or dO
  static constexpr int PT_BYTES = kBwdKeys * kBwdRows * 2;  // P^T or dS^T
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;  // stage s: q, then dO
  static constexpr int P_OFF = Q_OFF + kStages * 2 * QS_BYTES;  // buffer u:
  static constexpr int RED_OFF = P_OFF + 2 * 2 * PT_BYTES;      // P^T, dS^T
  // the second consumer's partial dK and dV (query split only)
  static constexpr int RED_BYTES = SPLIT_HD ? 0 : 2 * kBwdKeys * HD * 4;
  static constexpr int BAR_OFF = RED_OFF + RED_BYTES;
  // K/V full, K/V empty; q full and empty per stage
  static constexpr int BAR_BYTES = (2 + 2 * kStages) * 8;
  static constexpr size_t SMEM = BAR_OFF + BAR_BYTES + 1024;
};

// -- the wgmma shapes the backward adds ------------------------------------

#define DKB_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define DKB_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define DKB_D64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define DKB_F8(i)                                              \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]),        \
      "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), "+f"(d[(i) + 5]),    \
      "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define DKB_O8(i)                                              \
  "=f"(d[(i) + 0]), "=f"(d[(i) + 1]), "=f"(d[(i) + 2]),        \
      "=f"(d[(i) + 3]), "=f"(d[(i) + 4]), "=f"(d[(i) + 5]),    \
      "=f"(d[(i) + 6]), "=f"(d[(i) + 7])
#define DKB_F32(i) DKB_F8(i), DKB_F8((i) + 8), DKB_F8((i) + 16), DKB_F8((i) + 24)

// S^T and dP^T: D (64 x 32, f32) = A (64 x 16, shared, K-major) B (16 x
// 32, shared, K-major), overwritten (first) or accumulated
template <>
struct WgSS<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " DKB_D16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : DKB_F8(0), DKB_F8(8)
        : "l"(a), "l"(b), "r"(1));
  }
  __device__ __forceinline__ static void first(float (&d)[16], uint64_t a,
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " DKB_D16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : DKB_O8(0), DKB_O8(8)
        : "l"(a), "l"(b), "r"(0));
  }
};

// dV and dK: D (64 x N, f32) += A (64 x 16, shared, K-major) B (16 x N,
// shared, MN-major: the transpose bit)
template <int N>
struct WgSST;

template <>
struct WgSST<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DKB_D32
        ", %32, %33, p, 1, 1, 0, 1;\n}\n"
        : DKB_F32(0)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgSST<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DKB_D64
        ", %64, %65, p, 1, 1, 0, 1;\n}\n"
        : DKB_F32(0), DKB_F32(32)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef DKB_D16
#undef DKB_D32
#undef DKB_D64
#undef DKB_F8
#undef DKB_O8
#undef DKB_F32

// -- shared steps -----------------------------------------------------------

// x, which the compiler can no longer see through: a tile address made
// opaque inside a loop keeps ptxas from hoisting the many descriptors
// derived from it into registers across the loop
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// D (64 x 32) = A B^T over HD: A the item's K or V tile (64 rows a column
// block), B 32 rows of the step's q or dO tile (64 rows a column block),
// both K-major; issued and committed as one group
template <int HD>
__device__ __forceinline__ void issue_st(float (&d)[16], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;  // inside a swizzle atom
    const uint64_t da = sw128_desc(a + (kk >> 2) * kBwdKeys * 128 + col, 16);
    const uint64_t db = sw128_desc(b + (kk >> 2) * kBwdRows * 128 + col, 16);
    if (kk == 0)
      WgSS<32>::first(d, da, db);
    else
      WgSS<32>::mma(d, da, db);
  }
}

// dV += P^T dO and dK += dS^T q for one step, as one group: P^T and dS^T
// from buffer `pt` (K-major), dO and q of the step's stage (MN-major).
// With the hd split, warpgroup w takes all 64 queries and its half of the
// columns; otherwise its own 32 queries and all columns.
template <int HD>
__device__ __forceinline__ void issue_dkv(float (&dk)[DkvTiles<HD>::N / 2],
                                          float (&dv)[DkvTiles<HD>::N / 2],
                                          uint32_t pt, uint32_t qs,
                                          uint32_t dos, int w) {
  using T = DkvTiles<HD>;
  constexpr int KS = T::SPLIT_HD ? kBwdRows / 16 : kBwdRows / 32;
  const uint32_t a0 = T::SPLIT_HD ? pt : pt + w * 64;
  const uint32_t b0 =
      T::SPLIT_HD ? w * (T::NB / 2) * kBwdRows * 128 : w * 32 * 128;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t a = a0 + kk * 32, b = b0 + kk * 16 * 128;
    WgSST<T::N>::mma(dv, sw128_desc(a, 16),
                     sw128_desc(dos + b, kBwdRows * 128));
    WgSST<T::N>::mma(dk, sw128_desc(a + T::PT_BYTES, 16),
                     sw128_desc(qs + b, kBwdRows * 128));
  }
  wg_commit();
}

// -- the prep pass -----------------------------------------------------------

// delta = rowsum(dO * O) in f32 through lse's strides ([B, H, T] causal,
// [B, Tq, H] for a pair) and, without PAIR, q * scale rounded to bf16 (qs,
// contiguous [B, T, H, HD]); with PAIR, delta' = delta - dlse and no qs.
// One warp a row, rows in (b, t, h) order.
template <int HD, bool PAIR>
__global__ void __launch_bounds__(256)
    prep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ o,
                const bf16* __restrict__ dout, const float* __restrict__ dlse,
                bf16* __restrict__ qs, float* __restrict__ delta,
                const Shape a, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int h = row % a.H, t = (row / a.H) % a.Tq, b = row / (a.H * a.Tq);
  const bf16* qrow = q + (long long)b * a.qsb + (long long)t * a.qst +
                     (long long)h * HD;
  const long long at = (long long)row * HD;
  // lane l takes elements 8l..8l+7 (and 256 further on); the lanes'
  // partial sums are added in a fixed butterfly
  float part = 0.f;
#pragma unroll
  for (int d = lane * 8; d < HD; d += 256) {
    if (!PAIR) {
      uint4 v = *reinterpret_cast<const uint4*>(qrow + d);
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = __float2bfloat16(__bfloat162float(e[i]) * a.scale);
      *reinterpret_cast<uint4*>(qs + at + d) = v;
    }
    const uint4 x = *reinterpret_cast<const uint4*>(dout + at + d);
    const uint4 y = *reinterpret_cast<const uint4*>(o + at + d);
    const bf16* xe = reinterpret_cast<const bf16*>(&x);
    const bf16* ye = reinterpret_cast<const bf16*>(&y);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      part = fmaf(__bfloat162float(xe[i]), __bfloat162float(ye[i]), part);
  }
  const float dl = warp_sum(part);
  if (lane == 0) {
    const long long l = lse_at(a, b, h, t);
    delta[l] = PAIR ? dl - dlse[l] : dl;
  }
}

// -- dq ----------------------------------------------------------------------

// dS of tile kt in place of S (f32): P = exp(s - lse) with the causal
// diagonal (CAUSAL) or the keys at or past Tk masked, times dP - delta.
// l0/l1 are the rows' lse * log2(e), d0/d1 their delta.
template <int BC, bool CAUSAL>
__device__ __forceinline__ void ds_tile(float (&s)[BC / 2],
                                        const float (&dp)[BC / 2], int kt,
                                        int row0w, int rowt, int c2, int Tk,
                                        float l0, float l1, float d0,
                                        float d1) {
  const bool edge = CAUSAL ? kt * BC + BC - 1 > row0w : kt * BC + BC > Tk;
#pragma unroll
  for (int n = 0; n < BC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hi = e >> 1;
      const int kpos = kt * BC + n * 8 + c2 + (e & 1);
      const bool masked = CAUSAL ? kpos > rowt + hi * 8 : kpos >= Tk;
      const float p = (edge && masked)
                          ? 0.f
                          : ex2(fmaf(s[4 * n + e], kLog2e, -(hi ? l1 : l0)));
      s[4 * n + e] = p * (dp[4 * n + e] - (hi ? d1 : d0));
    }
}

template <int HD, bool CAUSAL, bool PAIR>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, const Shape a, int BH, int group) {
  using T = DqTiles<HD>;
  constexpr int BC = T::BC;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle-atom aligned
  const uint32_t bar_q = base + T::BAR_OFF;  // full +8w, empty +16+8w
  const uint32_t bar_k = bar_q + 32;
  const uint32_t bar_v = bar_k + 16 * T::KST;
  auto kbar = [&](int empty, int c) {
    return bar_k + 8 * (empty * T::KST + c % T::KST);
  };
  auto vbar = [&](int empty, int c) {
    return bar_v + 8 * (empty * T::VST + c % T::VST);
  };
  const int nq = (a.Tq + kRows - 1) / kRows, items = BH * nq;

  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) {
      mbar_init(bar_q + 8 * w, 1);
      mbar_init(bar_q + 16 + 8 * w, 4);  // the warpgroup's warps
    }
    for (int s = 0; s < T::KST; ++s) {
      mbar_init(kbar(0, s), 1);
      mbar_init(kbar(1, s), kConsumerWarps);
    }
    for (int s = 0; s < T::VST; ++s) {
      mbar_init(vbar(0, s), 1);
      mbar_init(vbar(1, s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      prefetch_map(&tq);
      prefetch_map(&tdo);
      prefetch_map(&tk);
      prefetch_map(&tv);
      int c = 0, qn0 = 0, qn1 = 0;
      for (int k = 0;; ++k) {
        const int L = block_item(k);
        if (L >= items) break;
        int qt, bh;
        item_tile(L, nq, BH, group, qt, bh);
        const int b = bh / a.H, h = bh % a.H;
        const int nkt = key_tiles<CAUSAL, kRows, BC>(a, qt);
        for (int w = 0; w < 2; ++w) {
          const int r0 = qt * kRows + w * kWgRows;
          if (r0 >= a.Tq) continue;  // that consumer has no live row
          const int n = w ? qn1++ : qn0++;
          if (n >= 1)  // the consumer is done with its previous Q and dO
            mbar_wait(bar_q + 16 + 8 * w, (n - 1) & 1);
          const uint32_t qbar = bar_q + 8 * w;
          mbar_expect_tx(qbar, 2 * kWgRows * HD * 2);
#pragma unroll
          for (int j = 0; j < T::NB; ++j) {
            const uint32_t off = j * kRows * 128 + w * kWgRows * 128;
            tma_load(base + off, &tq, qbar, 64 * j, h, r0, b);
            tma_load(base + T::DO_OFF + off, &tdo, qbar, 64 * j, h, r0, b);
          }
        }
        for (int kt = 0; kt < nkt; ++kt) {
          const int cc = c + kt;
          if (cc >= T::KST)  // both consumers are done with its last use
            mbar_wait(kbar(1, cc), (cc / T::KST - 1) & 1);
          mbar_expect_tx(kbar(0, cc), T::KV_BYTES);
          const uint32_t kd = base + T::K_OFF + (cc % T::KST) * T::KV_BYTES;
#pragma unroll
          for (int j = 0; j < T::NB; ++j)
            tma_load(kd + j * BC * 128, &tk, kbar(0, cc), 64 * j, h, kt * BC,
                     b);
          if (cc >= T::VST) mbar_wait(vbar(1, cc), (cc / T::VST - 1) & 1);
          mbar_expect_tx(vbar(0, cc), T::KV_BYTES);
          const uint32_t vd = base + T::V_OFF + (cc % T::VST) * T::KV_BYTES;
#pragma unroll
          for (int j = 0; j < T::NB; ++j)
            tma_load(vd + j * BC * 128, &tv, vbar(0, cc), 64 * j, h, kt * BC,
                     b);
        }
        c += nkt;
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    const uint32_t q_me = base + w * kWgRows * 128;
    const uint32_t do_me = base + T::DO_OFF + w * kWgRows * 128;
    int c = 0, qn = 0;  // the rings' position, this warpgroup's Q uses
    auto k_at = [&](int cc) {
      return base + T::K_OFF + (cc % T::KST) * T::KV_BYTES;
    };
    auto v_at = [&](int cc) {
      return base + T::V_OFF + (cc % T::VST) * T::KV_BYTES;
    };
    auto arrive = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    for (int k = 0;; ++k) {
      const int L = block_item(k);
      if (L >= items) break;
      int qt, bh;
      item_tile(L, nq, BH, group, qt, bh);
      const int b = bh / a.H, h = bh % a.H;
      const int nkt = key_tiles<CAUSAL, kRows, BC>(a, qt);
      const int row0w = qt * kRows + w * kWgRows;  // the warpgroup's first
      const int rowt = row0w + warp * 16 + g;      // this thread's: +0, +8
      // tiles this warpgroup computes (none if all its rows lie past Tq)
      const int nkt_me = row0w >= a.Tq ? 0
                         : CAUSAL ? (min(a.Tk, row0w + kWgRows) - 1) / BC + 1
                                  : nkt;
      const long long ost = (long long)a.H * HD;
      const long long obase = (long long)b * a.Tq * ost + (long long)h * HD;

      float acc[HD / 2];  // dQ: 64 x HD over the warpgroup
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

      if (nkt_me > 0) {
        // the rows' lse (log2-scaled) and delta, while Q and dO land
        const bool in0 = rowt < a.Tq, in1 = rowt + 8 < a.Tq;
        const long long at0 = lse_at(a, b, h, in0 ? rowt : 0);
        const long long at1 = lse_at(a, b, h, in1 ? rowt + 8 : 0);
        const float l0 = in0 ? lse[at0] * kLog2e : 0.f;
        const float l1 = in1 ? lse[at1] * kLog2e : 0.f;
        const float d0 = in0 ? delta[at0] : 0.f;
        const float d1 = in1 ? delta[at1] : 0.f;
        mbar_wait(bar_q + 8 * w, qn & 1);

        float s[BC / 2], dp[BC / 2];  // S (then dS in f32) and dP: 64 x BC
        uint32_t dsp[BC / 16][4] = {};  // dS in bf16, the A operand of dS K
        auto release_q = [&]() { arrive(bar_q + 16 + 8 * w); };
        // Step i issues S(i) and dP(i) right behind dQ(i - 1), which the
        // step before left on the tensor cores, and waits for all three;
        // then it computes dS(i) and issues dQ(i). The other consumer's
        // products keep the tensor cores busy while this one computes.
        // Every wgmma is issued in straight-line code.
        for (int i = 0; i < nkt_me; ++i) {
          const int cc = c + i;
          mbar_wait(kbar(0, cc), (cc / T::KST) & 1);
          mbar_wait(vbar(0, cc), (cc / T::VST) & 1);
          issue_s<HD, BC>(s, opaque(q_me), opaque(k_at(cc)));
          issue_s<HD, BC>(dp, opaque(do_me), opaque(v_at(cc)));
          wg_wait_all();
          reg_fence(s);
          reg_fence(dp);
          reg_fence(acc);
          reg_fence(dsp);
          arrive(vbar(1, cc));                  // V(i) is read
          if (i >= 1) arrive(kbar(1, cc - 1));  // so is K(i - 1)
          if (i == nkt_me - 1) release_q();     // the item's last S and dP
          ds_tile<BC, CAUSAL>(s, dp, i, row0w, rowt, c2, a.Tk, l0, l1, d0,
                              d1);
          pack_p<BC>(dsp, s);
          issue_pv<HD, BC>(acc, dsp, opaque(k_at(cc)));
        }
        wg_wait_all();
        reg_fence(acc);
        arrive(kbar(1, c + nkt_me - 1));
        ++qn;
      }
      // tiles only the other warpgroup needs: keep the rings turning
      for (int kt = nkt_me; kt < nkt; ++kt) {
        mbar_wait(kbar(0, c + kt), ((c + kt) / T::KST) & 1);
        arrive(kbar(1, c + kt));
        mbar_wait(vbar(0, c + kt), ((c + kt) / T::VST) & 1);
        arrive(vbar(1, c + kt));
      }
      c += nkt;

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rowt + half * 8;
        if (nkt_me == 0 || row >= a.Tq) continue;
        bf16* drow = dq + obase + (long long)row * ost;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<uint32_t*>(drow + n * 8 + c2) =
              pack_f32(acc[4 * n + 2 * half] * a.scale,
                       acc[4 * n + 2 * half + 1] * a.scale);
      }
    }
  }
}

// -- dk/dv -------------------------------------------------------------------

template <int HD, bool CAUSAL, bool PAIR>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, const Shape a,
               int BH, int group) {
  using T = DkvTiles<HD>;
  constexpr int BQ = kBwdRows;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle-atom aligned
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + T::BAR_OFF;  // full, then empty
  auto qbar = [&](int empty, int c) {  // a stage's full or empty barrier
    return bar_kv + 16 + 8 * (empty * kStages + c % kStages);
  };
  auto q_at = [&](int c) {  // a stage's q tile; its dO tile follows
    return base + T::Q_OFF + (c % kStages) * 2 * T::QS_BYTES;
  };
  const int nk = (a.Tk + kBwdKeys - 1) / kBwdKeys, items = BH * nk;
  const int nqt = (a.Tq + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_kv + 8, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(qbar(0, s), 1);
      mbar_init(qbar(1, s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      prefetch_map(&tq);
      prefetch_map(&tdo);
      prefetch_map(&tk);
      prefetch_map(&tv);
      int c = 0;  // the q/dO ring's position
      for (int k = 0;; ++k) {
        const int L = block_item(k);
        if (L >= items) break;
        int x, bh;
        item_tile(L, nk, BH, group, x, bh);
        const int kt = nk - 1 - x;  // the heaviest (first) key tiles first
        const int q0 = CAUSAL ? kt : 0;  // the first query tile it sees
        const int b = bh / a.H, h = bh % a.H;
        if (k >= 1)  // both consumers are done with the last item's K, V
          mbar_wait(bar_kv + 8, (k - 1) & 1);
        mbar_expect_tx(bar_kv, 2 * T::KV_BYTES);
#pragma unroll
        for (int j = 0; j < T::NB; ++j) {
          const uint32_t off = j * kBwdKeys * 128;
          tma_load(base + T::K_OFF + off, &tk, bar_kv, 64 * j, h,
                   kt * kBwdKeys, b);
          tma_load(base + T::V_OFF + off, &tv, bar_kv, 64 * j, h,
                   kt * kBwdKeys, b);
        }
        const int nst = nqt - q0;  // query steps (CAUSAL: from the diagonal)
        for (int s = 0; s < nst; ++s) {
          const int cc = c + s;
          if (cc >= kStages) mbar_wait(qbar(1, cc), (cc / kStages - 1) & 1);
          mbar_expect_tx(qbar(0, cc), 2 * T::QS_BYTES);
#pragma unroll
          for (int j = 0; j < T::NB; ++j) {
            const uint32_t off = j * BQ * 128;
            tma_load(q_at(cc) + off, &tq, qbar(0, cc), 64 * j, h,
                     (q0 + s) * BQ, b);
            tma_load(q_at(cc) + T::QS_BYTES + off, &tdo, qbar(0, cc), 64 * j,
                     h, (q0 + s) * BQ, b);
          }
        }
        c += nst;
      }
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    float* red = reinterpret_cast<float*>(smem + T::RED_OFF);
    auto arrive = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // the P^T / dS^T tiles of step cc are visible to the wgmma that read
    // them: this warpgroup's (query split) or both (hd split)
    auto publish = [&]() {
      fence_proxy_async();
      if (T::SPLIT_HD)
        named_sync(3, 256);
      else
        named_sync(1 + w, 128);
    };
    int c = 0;  // the q/dO ring's position (and the P^T buffers')

    for (int k = 0;; ++k) {
      const int L = block_item(k);
      if (L >= items) break;
      int x, bh;
      item_tile(L, nk, BH, group, x, bh);
      const int kt = nk - 1 - x;
      const int q0 = CAUSAL ? kt : 0;
      const int b = bh / a.H, h = bh % a.H;
      const int nst = nqt - q0;
      const int key0 = kt * kBwdKeys + warp * 16 + g;  // this thread's: +0, +8

      float dka[T::N / 2], dva[T::N / 2];
#pragma unroll
      for (int i = 0; i < T::N / 2; ++i) dka[i] = dva[i] = 0.f;
      float st[16], dpt[16];   // S^T, dP^T: 64 keys x 32 queries
      float lq[8], dl[8];      // lse * log2(e) and delta of its 8 queries

      // the lse and delta of this thread's query columns in step s
      auto load_rows = [&](int s) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int qp = (q0 + s) * BQ + w * 32 + n * 8 + c2 + j;
            const long long at = lse_at(a, b, h, qp < a.Tq ? qp : 0);
            lq[2 * n + j] = qp < a.Tq ? lse[at] * kLog2e : 0.f;
            dl[2 * n + j] = qp < a.Tq ? delta[at] : 0.f;
          }
      };
      // P^T and dS^T of step s from S^T and dP^T, rounded to bf16 into the
      // swizzled tiles of buffer cc % 2 (keys are rows, queries columns)
      auto p_ds = [&](int s, int cc) {
        unsigned char* pt = smem + T::P_OFF + (cc & 1) * 2 * T::PT_BYTES;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int r = warp * 16 + g + hi * 8;  // the key's tile row
            const int key = key0 + hi * 8;
            const int col = w * 32 + n * 8 + c2;
            float p[2], ds[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int qp = (q0 + s) * BQ + col + j;
              p[j] = (CAUSAL ? qp >= key && qp < a.Tq : qp < a.Tq)
                         ? ex2(fmaf(st[4 * n + 2 * hi + j], kLog2e,
                                    -lq[2 * n + j]))
                         : 0.f;
              ds[j] = p[j] * (dpt[4 * n + 2 * hi + j] - dl[2 * n + j]);
            }
            const int off = r * 128 + ((((col >> 3) ^ (r & 7))) << 4) + c2 * 2;
            *reinterpret_cast<uint32_t*>(pt + off) = pack_f32(p[0], p[1]);
            *reinterpret_cast<uint32_t*>(pt + T::PT_BYTES + off) =
                pack_f32(ds[0], ds[1]);
          }
      };
      auto pt_at = [&](int cc) {
        return base + T::P_OFF + (cc & 1) * 2 * T::PT_BYTES;
      };
      const uint32_t kt_s = base + T::K_OFF, vt_s = base + T::V_OFF;
      const uint32_t mine = w * 32 * 128;  // this warpgroup's 32 queries

      mbar_wait(bar_kv, k & 1);
      // Step s issues dV/dK(s - 1), then S^T(s) and dP^T(s); once the
      // first group is done, step s - 1's q and dO stage is freed, so its
      // next load has the rest of the step to land; then P^T(s) and
      // dS^T(s) are computed. The first and last steps are peeled: every
      // wgmma is issued in straight-line code.
      load_rows(0);
      mbar_wait(qbar(0, c), (c / kStages) & 1);
      wg_fence();
      issue_st<HD>(st, opaque(kt_s), opaque(q_at(c) + mine));
      issue_st<HD>(dpt, opaque(vt_s), opaque(q_at(c) + T::QS_BYTES + mine));
      wg_commit();
      wg_wait_all();
      reg_fence(st);
      reg_fence(dpt);
      if (nst == 1) arrive(bar_kv + 8);  // K and V are read
      p_ds(0, c);
      publish();
      for (int s = 1; s < nst; ++s) {
        const int cc = c + s;
        issue_dkv<HD>(dka, dva, opaque(pt_at(cc - 1)), opaque(q_at(cc - 1)),
                      opaque(q_at(cc - 1) + T::QS_BYTES), w);
        load_rows(s);
        mbar_wait(qbar(0, cc), (cc / kStages) & 1);
        wg_fence();
        issue_st<HD>(st, opaque(kt_s), opaque(q_at(cc) + mine));
        issue_st<HD>(dpt, opaque(vt_s),
                     opaque(q_at(cc) + T::QS_BYTES + mine));
        wg_commit();
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        reg_fence(dka);
        reg_fence(dva);
        arrive(qbar(1, cc - 1));  // step s - 1's q and dO are read
        wg_wait_all();
        reg_fence(st);
        reg_fence(dpt);
        if (s == nst - 1) arrive(bar_kv + 8);  // K and V are read
        p_ds(s, cc);
        publish();
      }
      issue_dkv<HD>(dka, dva, opaque(pt_at(c + nst - 1)),
                    opaque(q_at(c + nst - 1)),
                    opaque(q_at(c + nst - 1) + T::QS_BYTES), w);
      wg_wait_all();
      reg_fence(dka);
      reg_fence(dva);
      arrive(qbar(1, c + nst - 1));
      c += nst;

      // the epilogue: dK, dV rows of this thread's keys, columns n * 8 +
      // c2 (+1) of the warpgroup's N
      const long long ost = (long long)a.H * HD;
      const long long kobase = (long long)b * a.Tk * ost + (long long)h * HD;
      auto store = [&](int col0) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int key = key0 + hi * 8;
          if (key >= a.Tk) continue;
          bf16* krow = dk + kobase + (long long)key * ost + col0;
          bf16* vrow = dv + kobase + (long long)key * ost + col0;
#pragma unroll
          for (int n = 0; n < T::N / 8; ++n) {
            *reinterpret_cast<uint32_t*>(krow + n * 8 + c2) =
                pack_f32(dka[4 * n + 2 * hi], dka[4 * n + 2 * hi + 1]);
            *reinterpret_cast<uint32_t*>(vrow + n * 8 + c2) =
                pack_f32(dva[4 * n + 2 * hi], dva[4 * n + 2 * hi + 1]);
          }
        }
      };
      if (T::SPLIT_HD) {
        store(w * (HD / 2));
      } else if (w == 1) {
        // the second warpgroup's partial sums go to shared memory (once
        // the first has read the last item's) ...
        if (k >= 1) named_sync(5, 256);
#pragma unroll
        for (int i = 0; i < T::N / 2; ++i) {
          red[i * 128 + t] = dka[i];
          red[(T::N / 2 + i) * 128 + t] = dva[i];
        }
        asm volatile("bar.arrive 4, 256;\n" ::: "memory");
      } else {
        // ... and the first adds them to its own, in this order, and
        // stores both
        named_sync(4, 256);
#pragma unroll
        for (int i = 0; i < T::N / 2; ++i) {
          dka[i] += red[i * 128 + t];
          dva[i] += red[(T::N / 2 + i) * 128 + t];
        }
        if (block_item(k + 1) < items)
          asm volatile("bar.arrive 5, 256;\n" ::: "memory");
        store(0);
      }
    }
  }
}

// -- host side ---------------------------------------------------------------

// The prep kernel into the caller's scratch: delta with lse's layout and,
// without PAIR, qs [B, T, H, HD] bf16 (with PAIR qs is unused and may be
// null). The dq launcher runs it; the dk/dv launcher runs it only when
// `prep` is set (called without the same backward's dq).
template <int HD, bool PAIR>
static int launch_prep(const Attn& a, int B, bf16* qs, float* delta,
                       cudaStream_t stream) {
  const int rows = B * a.s.Tq * a.s.H;
  prep_kernel<HD, PAIR><<<(rows + 7) / 8, 256, 0, stream>>>(
      a.q, a.o, a.dout, a.dlse, qs, delta, a.s, rows);
  return (int)cudaGetLastError();
}

// The maps both kernels read, q and dO in boxes of `qrows`: q as the
// scaled copy (qs, contiguous [B, T, H, HD]) or, with PAIR, the caller's
// pre-scaled q through its own strides; dO contiguous; k and v through
// their own strides, in boxes of kBwdKeys
template <int HD, bool PAIR>
static int bwd_maps(const Attn& a, int B, const bf16* qs, int qrows,
                    CUtensorMap* mq, CUtensorMap* mdo, CUtensorMap* mk,
                    CUtensorMap* mv) {
  const long long ost = (long long)a.s.H * HD;
  int err = PAIR ? make_map(mq, a.q, HD, a.s.H, a.s.Tq, B, a.s.qsb,
                            a.s.qst, qrows)
                 : make_map(mq, qs, HD, a.s.H, a.s.Tq, B, a.s.Tq * ost, ost,
                            qrows);
  if (err == 0)
    err = make_map(mdo, a.dout, HD, a.s.H, a.s.Tq, B, a.s.Tq * ost, ost,
                   qrows);
  if (err == 0)
    err = make_map(mk, a.k, HD, a.s.H, a.s.Tk, B, a.s.ksb, a.s.kst,
                   kBwdKeys);
  if (err == 0)
    err = make_map(mv, a.v, HD, a.s.H, a.s.Tk, B, a.s.ksb, a.s.kst,
                   kBwdKeys);
  return err;
}

// dq: the prep pass, then a persistent grid over the B * H * ceil(Tq /
// 128) items
template <int HD, bool CAUSAL, bool PAIR>
static int launch_dq(const Attn& a, int B, bf16* qs, float* delta,
                     cudaStream_t stream) {
  using T = DqTiles<HD>;
  // runtime calls first: they bind the device's context to this thread
  // (autograd's backward thread may have none yet), which
  // cuTensorMapEncodeTiled needs
  int sms = 0;
  int err = sm_count(&sms);
  if (err == 0) err = (int)prepare(dq_kernel<HD, CAUSAL, PAIR>, T::SMEM);
  if (err == 0) err = launch_prep<HD, PAIR>(a, B, qs, delta, stream);
  CUtensorMap mq, mdo, mk, mv;
  if (err == 0)
    err = bwd_maps<HD, PAIR>(a, B, qs, kWgRows, &mq, &mdo, &mk, &mv);
  if (err != 0) return err;
  const int BH = B * a.s.H, nq = (a.s.Tq + kRows - 1) / kRows;
  dq_kernel<HD, CAUSAL, PAIR>
      <<<std::min(BH * nq, sms), kThreads, T::SMEM, stream>>>(
          mq, mdo, mk, mv, a.lse, delta, a.dq, a.s, BH,
          head_group(BH, 4LL * a.s.Tk * HD));
  return (int)cudaGetLastError();
}

// dk/dv: the prep pass (when `prep`), then a persistent grid over the
// B * H * ceil(Tk / 64) items
template <int HD, bool CAUSAL, bool PAIR>
static int launch_dkv(const Attn& a, int B, bf16* qs, float* delta, int prep,
                      cudaStream_t stream) {
  using T = DkvTiles<HD>;
  int sms = 0;
  int err = sm_count(&sms);
  if (err == 0) err = (int)prepare(dkv_kernel<HD, CAUSAL, PAIR>, T::SMEM);
  if (err == 0 && prep) err = launch_prep<HD, PAIR>(a, B, qs, delta, stream);
  CUtensorMap mq, mdo, mk, mv;
  if (err == 0)
    err = bwd_maps<HD, PAIR>(a, B, qs, kBwdRows, &mq, &mdo, &mk, &mv);
  if (err != 0) return err;
  const int BH = B * a.s.H, nk = (a.s.Tk + kBwdKeys - 1) / kBwdKeys;
  dkv_kernel<HD, CAUSAL, PAIR>
      <<<std::min(BH * nk, sms), kThreads, T::SMEM, stream>>>(
          mq, mdo, mk, mv, a.lse, delta, a.dk, a.dv, a.s, BH,
          head_group(BH, 4LL * a.s.Tq * HD));
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace ca
