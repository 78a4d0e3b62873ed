// Causal flash attention for training: a forward kernel, a dq kernel and
// a dk/dv kernel, on bf16 [B, T, H, hd] tensors with f32 accumulation.
//
// Replaces the Pallas TPU kernels of distkeras_tpu/ops/pallas_attention.py:
//   causal_fwd_kernel  <- _fwd :150 (_fwd_kernel :100)
//   causal_dq_kernel   <- _bwd :295 (_dq_kernel :193)
//   causal_dkv_kernel  <- _bwd :295 (_dkv_kernel :240)
// Same function and the same roundings: q is scaled in f32 and cast back
// to bf16 before q k^T; the forward keeps an f32 online softmax and
// writes O and the per-row logsumexp lse = m + log(max(l, 1e-30)); the
// backward is the Dao recompute (P = exp(s - lse)), with
// delta = rowsum(dO * O) in f32 recomputed in-kernel, P cast to bf16
// before dV, dS cast to bf16 before dQ and dK, dQ scaled at the end and
// dK unscaled because q was pre-scaled. Keys past a query's position are
// masked with -1e30, as the TPU kernels mask them.
//
// What bounds it on the H100: operations. At the flagship shape (B=8,
// H=8, T=2048, hd=256) the exact causal work is 137 / 206 / 275 GFLOP
// for the three kernels against 268-470 MB of traffic — about 500
// FLOPs per byte, above the card's ~295 bf16 ridge point. So the design
// puts the matrix products on the tensor cores: mma.sync m16n8k16 (bf16
// in, f32 accumulate), each warp owning 16 rows of a product, operand
// tiles staged in shared memory (rows padded by 16 bytes so fragment
// loads do not conflict), and the softmax in registers between the two
// products (the S fragment is re-packed as the A operand of P V without
// touching shared memory).
//
// The TPU carries the softmax state across a sequential grid axis. Here
// each block loops inside itself: the forward and dq kernels take one
// block per (b*h, 64-row query tile i) and walk key tiles j <= i; the
// dk/dv kernel takes one block per (b*h, 64-key tile j) and walks query
// tiles i >= j. dq and dk/dv stay two kernels, as on the TPU, so no
// atomics are needed and the gradients are the same from run to run.
// The causal wedge makes blocks unequal, so the heavy tiles take the low
// block indices and start first.
//
// Layout: q, k, v are read through their batch and token strides (the
// head stride is hd and the last axis is contiguous), so the views of a
// fused qkv projection need no copy; O, dO and the gradients are
// contiguous [B, T, H, hd]; lse is [B*H, T] f32. Any T is taken: rows
// and keys past T are zero-filled in shared memory, masked, and never
// written.
//
// Registers at hd=256: the forward and dq accumulators are 16 x 256 f32
// per warp (128 per lane). dk/dv would need two such accumulators, so
// its block (8 warps, 64 keys) splits the output by head dimension: each
// warp owns 16 keys x 128 channels of both dK and dV (128 per lane), and
// the eight warps first compute P^T and dS^T for the 64 keys x 32
// queries of a step together, through shared memory. Every key tile
// re-reads q, dO and O for the queries at and past it, so wider key
// tiles mean less traffic: 4 warps over 32 keys, which fit two blocks
// per SM, measured 1.35x slower than this layout. At ~230 registers a
// lane only one such block fits an SM, so the kernel double-buffers its
// per-step tiles: cp.async copies step i+1's q, dO, O and lse into
// shared memory while step i computes (180 KB of shared memory).
//
// Otherwise simple rather than fast: the forward and dq kernels load
// their tiles synchronously (two blocks per SM overlap them), no wgmma,
// accurate expf. Times sit beside the bounds in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ca {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// two f32 values rounded to bf16 (round to nearest even, like a cast)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Fragments of mma.m16n8k16 from row-major shared-memory tiles with
// leading dimension LD (elements). Lane l holds group g = l / 4 and
// column pair c = 2 * (l % 4).
//
// A (16 x 16) at rows r0.., columns k0..: a0 (g, c), a1 (g + 8, c),
// a2 (g, c + 8), a3 (g + 8, c + 8), each two adjacent bf16.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int r0, int k0, int lane) {
  const bf16* p = t + (r0 + (lane >> 2)) * LD + k0 + (lane & 3) * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B (16 x 8) with B[k][n] = t[n0 + n][k0 + k]: the tile's rows are the
// product's columns (K for q k^T). b0 (k = c, c + 1; n = g), b1 (k + 8).
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t& b0, uint32_t& b1,
                                          const bf16* t, int n0, int k0,
                                          int lane) {
  const bf16* p = t + (n0 + (lane >> 2)) * LD + k0 + (lane & 3) * 2;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B (16 x 8) with B[k][n] = t[k0 + k][n0 + n]: the tile's rows are the
// contraction (V for P V). The two values of a register sit in two rows.
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t& b0, uint32_t& b1,
                                          const bf16* t, int k0, int n0,
                                          int lane) {
  const bf16* p = t + (k0 + (lane & 3) * 2) * LD + n0 + (lane >> 2);
  b0 = pack_bf16(p[0], p[LD]);
  b1 = pack_bf16(p[8 * LD], p[9 * LD]);
}

// Stage rows [row0, row0 + ROWS) of a [T, HD] operand (rows `stride`
// elements apart) into shared memory with leading dimension HD + 8, in
// 16-byte vectors; rows at or past T are zero. SCALE multiplies each
// value by `scale` in f32 and rounds back to bf16 (the TPU's q scaling).
template <int HD, int ROWS, int NT, bool SCALE>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int row0, int T,
                                          float scale) {
  constexpr int LD = HD + 8;
  constexpr int CPR = HD / 8;
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) {
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride +
                                          col);
      if (SCALE) {
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + col) = v;
  }
}

// cp.async (sm_80 and later): global -> shared without a register round
// trip; with `full` false the destination is zero-filled and nothing is
// read. Completion is per thread, by commit group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// load_rows without the scaling, as cp.async copies (rows past T
// zero-filled); the caller commits and waits.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                long long stride, int row0,
                                                int T) {
  constexpr int LD = HD + 8;
  constexpr int CPR = HD / 8;
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    const bool in = row0 + r < T;
    cp_async16(dst + r * LD + col,
               src + (long long)(in ? row0 + r : 0) * stride + col, in);
  }
}

// load_rows' q scaling applied in shared memory after load_rows_async:
// each thread rescales the vectors it copied itself, so its own
// cp_async_wait is enough before, and a barrier is needed after.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void scale_rows(bf16* t, float scale) {
  constexpr int LD = HD + 8;
  constexpr int CPR = HD / 8;
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    uint4* p = reinterpret_cast<uint4*>(t + (c / CPR) * LD + (c % CPR) * 8);
    uint4 v = *p;
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
    *p = v;
  }
}

// delta = rowsum(dO * O) in f32 for the first `rows` rows of a tile (the
// rest are set to 0): dO from its staged tile, O rows `ost` elements
// apart (device memory or a staged tile); one warp per row at a time.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void row_delta(float* delta, const bf16* sdo,
                                          const bf16* o, long long ost,
                                          int rows) {
  constexpr int LD = HD + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < ROWS; r += NT / 32) {
    float part = 0.f;
    if (r < rows) {
      const bf16* orow = o + (long long)r * ost;
      for (int d = lane; d < HD; d += 32)
        part += __bfloat162float(sdo[r * LD + d]) * __bfloat162float(orow[d]);
    }
    part = warp_sum(part);
    if (lane == 0) delta[r] = part;
  }
}

// ---------------------------------------------------------------------------
// forward: block = (b*h, 64-row query tile), 4 warps x 16 rows, 64-key tiles
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 64, kFwdKeys = 64, kFwdThreads = 128;

template <int HD>
__global__ void __launch_bounds__(kFwdThreads)
    causal_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int T, int H, long long sb,
                      long long st, float scale) {
  constexpr int LD = HD + 8, BR = kFwdRows, BC = kFwdKeys;
  constexpr int NO = HD / 8, NS = BC / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BR * LD;
  bf16* sV = sK + BC * LD;

  const int nq = (T + BR - 1) / BR;
  const int qt = nq - 1 - blockIdx.y;  // heavy (late) query tiles first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const long long base = (long long)b * sb + (long long)h * HD;
  const long long ost = (long long)H * HD;
  const long long obase = (long long)b * T * ost + (long long)h * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int row0 = qt * BR + warp * 16 + g;  // and row0 + 8

  load_rows<HD, BR, kFwdThreads, true>(sQ, q + base, st, qt * BR, T, scale);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int nkt = (min(T, (qt + 1) * BR) - 1) / BC + 1;
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<HD, BC, kFwdThreads, false>(sK, k + base, st, kt * BC, T, 0.f);
    load_rows<HD, BC, kFwdThreads, false>(sV, v + base, st, kt * BC, T, 0.f);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      frag_a<LD>(a, sQ, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t b0, b1;
        frag_b_nk<LD>(b0, b1, sK, n * 8, kk * 16, lane);
        mma16816(s[n], a, b0, b1);
      }
    }
    // only a tile that reaches past this warp's first row needs the mask
    if (kt * BC + BC - 1 > qt * BR + warp * 16) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kt * BC + n * 8 + c2 + (e & 1);
          if (kpos > row0 + (e >> 1) * 8) s[n][e] = kNegInf;
        }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
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
    l0 = l0 * corr0 + quad_sum(rs0);
    l1 = l1 * corr1 + quad_sum(rs1);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }
    // P (bf16) V: the S accumulator re-packed as A fragments
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b0, b1;
        frag_b_kn<LD>(b0, b1, sV, kk * 16, n * 8, lane);
        mma16816(acc[n], a, b0, b1);
      }
    }
  }

  const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + half * 8;
    if (row >= T) continue;
    const float ls = half ? ls1 : ls0;
    bf16* orow = o + obase + (long long)row * ost;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + c2) =
          pack_f32(acc[n][2 * half] / ls, acc[n][2 * half + 1] / ls);
    if ((lane & 3) == 0)
      lse[(long long)bh * T + row] = (half ? m1 : m0) + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// dq: block = (b*h, 64-row query tile), 4 warps x 16 rows, 32-key tiles
// ---------------------------------------------------------------------------

constexpr int kDqRows = 64, kDqKeys = 32, kDqThreads = 128;

template <int HD>
__global__ void __launch_bounds__(kDqThreads)
    causal_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse, bf16* __restrict__ dq,
                     int T, int H, long long sb, long long st, float scale) {
  constexpr int LD = HD + 8, BR = kDqRows, BC = kDqKeys;
  constexpr int NO = HD / 8, NS = BC / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + BR * LD;
  bf16* sK = sDO + BR * LD;
  bf16* sV = sK + BC * LD;
  float* sL = reinterpret_cast<float*>(sV + BC * LD);
  float* sD = sL + BR;

  const int nq = (T + BR - 1) / BR;
  const int qt = nq - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const long long base = (long long)b * sb + (long long)h * HD;
  const long long ost = (long long)H * HD;
  const long long obase = (long long)b * T * ost + (long long)h * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int lr0 = warp * 16 + g;  // local rows lr0, lr0 + 8
  const int row0 = qt * BR + lr0;

  load_rows<HD, BR, kDqThreads, true>(sQ, q + base, st, qt * BR, T, scale);
  load_rows<HD, BR, kDqThreads, false>(sDO, dout + obase, ost, qt * BR, T,
                                       0.f);
  for (int r = threadIdx.x; r < BR; r += kDqThreads)
    sL[r] = qt * BR + r < T ? lse[(long long)bh * T + qt * BR + r] : 0.f;
  __syncthreads();
  row_delta<HD, BR, kDqThreads>(sD, sDO, o + obase + (long long)qt * BR * ost,
                                ost, T - qt * BR);
  __syncthreads();
  const float lse0 = sL[lr0], lse1 = sL[lr0 + 8];
  const float dl0 = sD[lr0], dl1 = sD[lr0 + 8];

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int nkt = (min(T, (qt + 1) * BR) - 1) / BC + 1;
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_rows<HD, BC, kDqThreads, false>(sK, k + base, st, kt * BC, T, 0.f);
    load_rows<HD, BC, kDqThreads, false>(sV, v + base, st, kt * BC, T, 0.f);
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], ad[4];
      frag_a<LD>(a, sQ, warp * 16, kk * 16, lane);
      frag_a<LD>(ad, sDO, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t b0, b1;
        frag_b_nk<LD>(b0, b1, sK, n * 8, kk * 16, lane);
        mma16816(s[n], a, b0, b1);
        frag_b_nk<LD>(b0, b1, sV, n * 8, kk * 16, lane);
        mma16816(dp[n], ad, b0, b1);
      }
    }
    const bool diag = kt * BC + BC - 1 > qt * BR + warp * 16;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        float sv = s[n][e];
        if (diag && kt * BC + n * 8 + c2 + (e & 1) > row0 + hi * 8)
          sv = kNegInf;
        const float p = expf(sv - (hi ? lse1 : lse0));
        s[n][e] = p * (dp[n][e] - (hi ? dl1 : dl0));  // dS
      }
    // dQ += dS (bf16) K
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b0, b1;
        frag_b_kn<LD>(b0, b1, sK, kk * 16, n * 8, lane);
        mma16816(acc[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + half * 8;
    if (row >= T) continue;
    bf16* drow = dq + obase + (long long)row * ost;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8 + c2) = pack_f32(
          acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// dk/dv: block = (b*h, 64-key tile), 8 warps, 32-query steps
// ---------------------------------------------------------------------------

constexpr int kDkvKeys = 64, kDkvRows = 32, kDkvThreads = 256;
// phase A tiles the keys by 16 and the queries in two halves; phase B the
// keys by 16 and the channels in two halves: one warp per tile
static_assert(kDkvThreads == 32 * (kDkvKeys / 16) * 2 && kDkvRows == 32,
              "dk/dv warp layout");

template <int HD>
__global__ void __launch_bounds__(kDkvThreads)
    causal_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int T, int H, long long sb,
                      long long st, float scale) {
  constexpr int LD = HD + 8, BC = kDkvKeys, BQ = kDkvRows;
  constexpr int LP = BQ + 8;      // leading dimension of the P^T / dS^T tiles
  constexpr int NH = HD / 16;     // 8-channel tiles in a warp's half of HD
  constexpr int NT = kDkvThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BC * LD;
  bf16* sQ2 = sV + BC * LD;       // two buffers each of q, dO, O and lse:
  bf16* sDO2 = sQ2 + 2 * BQ * LD; // one step's tiles land while the
  bf16* sO2 = sDO2 + 2 * BQ * LD; // previous step's are in use
  bf16* sP = sO2 + 2 * BQ * LD;
  bf16* sDS = sP + BC * LP;
  float* sL2 = reinterpret_cast<float*>(sDS + BC * LP);
  float* sD = sL2 + 2 * BQ;

  const int kt = blockIdx.y;  // early key tiles see the most queries: first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const long long base = (long long)b * sb + (long long)h * HD;
  const long long ost = (long long)H * HD;
  const long long obase = (long long)b * T * ost + (long long)h * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int kg = warp % (BC / 16);  // keys kg*16.. of the tile (both phases)
  const int hw = warp / (BC / 16);  // phase A: queries hw*16..; B: channels

  // the copies of query step `it`'s q (unscaled), dO, O rows and lse into
  // buffer `buf`
  auto issue = [&](int it, int buf) {
    load_rows_async<HD, BQ, NT>(sQ2 + buf * BQ * LD, q + base, st, it * BQ, T);
    load_rows_async<HD, BQ, NT>(sDO2 + buf * BQ * LD, dout + obase, ost,
                                it * BQ, T);
    load_rows_async<HD, BQ, NT>(sO2 + buf * BQ * LD, o + obase, ost, it * BQ,
                                T);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool in = it * BQ + r < T;
      cp_async4(sL2 + buf * BQ + r,
                lse + (long long)bh * T + (in ? it * BQ + r : 0), in);
    }
  };

  const int it0 = (kt * BC) / BQ, nqt = (T + BQ - 1) / BQ;
  load_rows_async<HD, BC, NT>(sK, k + base, st, kt * BC, T);
  load_rows_async<HD, BC, NT>(sV, v + base, st, kt * BC, T);
  issue(it0, 0);
  cp_async_commit();

  float dka[NH][4], dva[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = it0; it < nqt; ++it) {
    const int buf = (it - it0) & 1;
    bf16* sQ = sQ2 + buf * BQ * LD;
    bf16* sDO = sDO2 + buf * BQ * LD;
    const float* sL = sL2 + buf * BQ;
    // the next step's tiles go into the other buffer, free since the
    // barrier that closed the previous step
    if (it + 1 < nqt) issue(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this step's copies (and K, V) have landed
    scale_rows<HD, BQ, NT>(sQ, scale);
    __syncthreads();
    row_delta<HD, BQ, NT>(sD, sDO, sO2 + buf * BQ * LD, LD, T - it * BQ);
    __syncthreads();

    // phase A: S^T = K q^T and dP^T = V dO^T for 16 keys x 16 queries
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ak[4], av[4];
      frag_a<LD>(ak, sK, kg * 16, kk * 16, lane);
      frag_a<LD>(av, sV, kg * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t b0, b1;
        frag_b_nk<LD>(b0, b1, sQ, hw * 16 + n * 8, kk * 16, lane);
        mma16816(s[n], ak, b0, b1);
        frag_b_nk<LD>(b0, b1, sDO, hw * 16 + n * 8, kk * 16, lane);
        mma16816(dp[n], av, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = kt * BC + kg * 16 + g + half * 8;
        float p[2], ds[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ql = hw * 16 + n * 8 + c2 + j;
          const int qpos = it * BQ + ql;
          const float sv = qpos >= key ? s[n][2 * half + j] : kNegInf;
          p[j] = qpos < T ? expf(sv - sL[ql]) : 0.f;
          ds[j] = p[j] * (dp[n][2 * half + j] - sD[ql]);
        }
        const int off = (kg * 16 + g + half * 8) * LP + hw * 16 + n * 8 + c2;
        *reinterpret_cast<uint32_t*>(sP + off) = pack_f32(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(sDS + off) = pack_f32(ds[0], ds[1]);
      }
    }
    __syncthreads();

    // phase B: dV += P^T dO and dK += dS^T q_scaled over this warp's
    // 16 keys x HD/2 channels
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], ads[4];
      frag_a<LP>(ap, sP, kg * 16, kk * 16, lane);
      frag_a<LP>(ads, sDS, kg * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int c0 = hw * (HD / 2) + n * 8;
        uint32_t b0, b1;
        frag_b_kn<LD>(b0, b1, sDO, kk * 16, c0, lane);
        mma16816(dva[n], ap, b0, b1);
        frag_b_kn<LD>(b0, b1, sQ, kk * 16, c0, lane);
        mma16816(dka[n], ads, b0, b1);
      }
    }
    __syncthreads();  // buffer `buf` and sP/sDS are free for the next step
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = kt * BC + kg * 16 + g + half * 8;
    if (key >= T) continue;
    bf16* krow = dk + obase + (long long)key * ost;
    bf16* vrow = dv + obase + (long long)key * ost;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const int c0 = hw * (HD / 2) + n * 8 + c2;
      *reinterpret_cast<uint32_t*>(krow + c0) =
          pack_f32(dka[n][2 * half], dka[n][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(vrow + c0) =
          pack_f32(dva[n][2 * half], dva[n][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
static cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int HD>
static int fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int T, int H, long long sb, long long st,
               float scale, cudaStream_t stream) {
  constexpr int LD = HD + 8;
  const size_t smem = (size_t)(kFwdRows + 2 * kFwdKeys) * LD * sizeof(bf16);
  cudaError_t err = prepare(causal_fwd_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (T + kFwdRows - 1) / kFwdRows);
  causal_fwd_kernel<HD><<<grid, kFwdThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      T, H, sb, st, scale);
  return (int)cudaGetLastError();
}

template <int HD>
static int dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* dqp, int B, int T,
              int H, long long sb, long long st, float scale,
              cudaStream_t stream) {
  constexpr int LD = HD + 8;
  const size_t smem = (size_t)(2 * kDqRows + 2 * kDqKeys) * LD * sizeof(bf16) +
                      2 * kDqRows * sizeof(float);
  cudaError_t err = prepare(causal_dq_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (T + kDqRows - 1) / kDqRows);
  causal_dq_kernel<HD><<<grid, kDqThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
      (const bf16*)dout, (const float*)lse, (bf16*)dqp, T, H, sb, st, scale);
  return (int)cudaGetLastError();
}

template <int HD>
static int dkv(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* dkp, void* dvp, int B,
               int T, int H, long long sb, long long st, float scale,
               cudaStream_t stream) {
  constexpr int LD = HD + 8, LP = kDkvRows + 8;
  // K, V; two buffers of q, dO, O; P^T, dS^T; two of lse, one of delta
  const size_t smem =
      (size_t)(2 * kDkvKeys + 6 * kDkvRows) * LD * sizeof(bf16) +
      (size_t)2 * kDkvKeys * LP * sizeof(bf16) + 3 * kDkvRows * sizeof(float);
  cudaError_t err = prepare(causal_dkv_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (T + kDkvKeys - 1) / kDkvKeys);
  causal_dkv_kernel<HD><<<grid, kDkvThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
      (const bf16*)dout, (const float*)lse, (bf16*)dkp, (bf16*)dvp, T, H, sb,
      st, scale);
  return (int)cudaGetLastError();
}

}  // namespace ca

// one instantiation per head dimension the kernels are compiled for
#define CA_DISPATCH(FN, ...)                        \
  switch (hd) {                                     \
    case 64: return ca::FN<64>(__VA_ARGS__);        \
    case 128: return ca::FN<128>(__VA_ARGS__);      \
    case 256: return ca::FN<256>(__VA_ARGS__);      \
    default: return (int)cudaErrorInvalidValue;     \
  }

extern "C" int dk_causal_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int T, int H, int hd,
                                       long long sb, long long st, float scale,
                                       void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  CA_DISPATCH(fwd, q, k, v, o, lse, B, T, H, sb, st, scale, s)
}

extern "C" int dk_causal_attention_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* dq, int B, int T, int H, int hd,
                                      long long sb, long long st, float scale,
                                      void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  CA_DISPATCH(dq, q, k, v, o, dout, lse, dq, B, T, H, sb, st, scale, s)
}

extern "C" int dk_causal_attention_dkv(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* dk, void* dv, int B, int T,
                                       int H, int hd, long long sb,
                                       long long st, float scale,
                                       void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  CA_DISPATCH(dkv, q, k, v, o, dout, lse, dk, dv, B, T, H, sb, st, scale, s)
}
