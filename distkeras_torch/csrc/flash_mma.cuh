// Flash attention on the tensor cores for training: a forward kernel, a dq
// kernel and a dk/dv kernel, bf16 operands with f32 accumulation, shared by
// two sources that instantiate them:
//
//   causal_attention.cu  CAUSAL, !PAIR: causal self-attention over
//                        [B, T, H, hd]; q is scaled in-kernel.
//   pair_attention.cu    PAIR, CAUSAL or not: one chunk pair of the zigzag
//                        ring, q arriving pre-scaled, Tq x Tk (the causal
//                        wedge needs Tq == Tk), lse cotangent folded in.
//
// The three kernels are the Dao recompute split as the TPU kernels split
// it: the forward keeps an f32 online softmax and writes O and the per-row
// logsumexp lse = m + log(max(l, 1e-30)); the backward recomputes
// P = exp(s - lse), with delta = rowsum(dO * O) in f32 recomputed in-kernel,
// P cast to bf16 before dV, dS cast to bf16 before dQ and dK. Without PAIR,
// q is scaled in f32 and cast back to bf16 before q k^T, and dQ is scaled
// at the end; with PAIR, q is used as given and dQ is the gradient of the
// pre-scaled q. dK is unscaled either way. With PAIR, the lse is a public
// output whose cotangent dlse enters as dS = P * (dP - delta + dlse). Keys
// past a query's position (CAUSAL) or past Tk are masked with -1e30, as
// the TPU kernels mask them.
//
// What bounds them on the H100: operations, at the flagship shapes (about
// 500 FLOPs per byte for the causal [8, 2048, 8, 256] kernels, more for
// the rectangle pairs), above the card's ~295 bf16 ridge point. So every
// product runs on the tensor cores: mma.sync m16n8k16 (bf16 in, f32
// accumulate), each warp owning 16 rows of a product, operand tiles staged
// in shared memory (rows padded by 16 bytes so fragment loads do not
// conflict), and the softmax in registers between the two products (the S
// fragment is re-packed as the A operand of P V without touching shared
// memory).
//
// The TPU carries the softmax state across a sequential grid axis. Here
// each block loops inside itself: the forward and dq kernels take one
// block per (b*h, 64-row query tile i) and walk key tiles (j <= i when
// CAUSAL, all of Tk otherwise); the dk/dv kernel takes one block per
// (b*h, 64-key tile j) and walks query tiles (i >= j when CAUSAL). The TPU's
// pruned wedge enumeration (_tri_rows / _tri_cols) becomes these loop
// bounds: what it prunes is never visited. dq and dk/dv stay two kernels,
// as on the TPU, so no atomics are needed and the gradients are the same
// from run to run. The causal wedge makes blocks unequal, so the heavy
// tiles take the low block indices and start first.
//
// Layout: q is read through its own batch and token strides, k and v
// through theirs (the head stride is hd and the last axis is contiguous),
// so views of a fused qkv projection, or of a chunk of one, need no copy;
// O, dO and dQ are contiguous [B, Tq, H, hd], dK and dV [B, Tk, H, hd]; lse
// (and dlse) are f32, addressed by (batch, head, token) strides: [B, H, T]
// for causal self-attention, [B, Tq, H] for a pair. Any Tq and Tk are
// taken: rows and keys past them are zero-filled in shared memory, masked,
// and never written.
//
// Registers at hd=256: the forward and dq accumulators are 16 x 256 f32
// per warp (128 per lane). dk/dv would need two such accumulators, so its
// block (8 warps, 64 keys) splits the output by head dimension: each warp
// owns 16 keys x 128 channels of both dK and dV (128 per lane), and the
// eight warps first compute P^T and dS^T for the 64 keys x 32 queries of a
// step together, through shared memory. Every key tile re-reads q, dO and
// O for its queries, so wider key tiles mean less traffic. At ~230
// registers a lane only one such block fits an SM, so the kernel
// double-buffers its per-step tiles: cp.async copies step i+1's q, dO, O,
// lse (and dlse) into shared memory while step i computes (180 KB of
// shared memory).
//
// Otherwise simple rather than fast: the forward and dq kernels load their
// tiles synchronously (two blocks per SM overlap them), no wgmma, accurate
// expf. Times sit beside the bounds in PERF.md.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ca {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value

// The sizes and strides of one launch.
struct Shape {
  int Tq, Tk, H;
  long long qsb, qst;       // q's batch and token strides (elements)
  long long ksb, kst;       // k's and v's
  long long lsb, lsh, lst;  // lse / dlse: batch, head and token strides
  float scale;              // q's scale (unused with PAIR)
};

// The operands of one launch (unused pointers null), unpacked by the
// launchers: the kernels take the pointers as parameters of their own.
// Passed inside one struct parameter, they made the forward kernel about
// twice as slow on the H100 (PERF.md, PR 3).
struct Attn {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;     // the forward's output (backward)
  const bf16* dout;  // dO (backward)
  const float* lse;  // the forward's lse (backward)
  const float* dlse; // the lse cotangent (PAIR backward)
  bf16* out;         // forward outputs
  float* lse_out;
  bf16* dq;          // backward outputs
  bf16* dk;
  bf16* dv;
  Shape s;
};

__device__ __forceinline__ long long lse_at(const Shape& a, int b, int h,
                                            int row) {
  return (long long)b * a.lsb + (long long)h * a.lsh + (long long)row * a.lst;
}

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

// key tiles of width BC that query tile qt (rows of width BR) visits
template <bool CAUSAL, int BR, int BC>
__device__ __forceinline__ int key_tiles(const Shape& a, int qt) {
  return CAUSAL ? (min(a.Tk, (qt + 1) * BR) - 1) / BC + 1
                : (a.Tk + BC - 1) / BC;
}

// ---------------------------------------------------------------------------
// forward: block = (b*h, 64-row query tile), 4 warps x 16 rows, 64-key tiles
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 64, kFwdKeys = 64, kFwdThreads = 128;

template <int HD, bool CAUSAL, bool PAIR>
__global__ void __launch_bounds__(kFwdThreads)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse_out, const Shape a) {
  constexpr int LD = HD + 8, BR = kFwdRows, BC = kFwdKeys;
  constexpr int NO = HD / 8, NS = BC / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BR * LD;
  bf16* sV = sK + BC * LD;

  const int nq = (a.Tq + BR - 1) / BR;
  const int qt = nq - 1 - blockIdx.y;  // heavy (late) query tiles first
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const long long qbase = (long long)b * a.qsb + (long long)h * HD;
  const long long kbase = (long long)b * a.ksb + (long long)h * HD;
  const long long ost = (long long)a.H * HD;
  const long long obase = (long long)b * a.Tq * ost + (long long)h * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int row0 = qt * BR + warp * 16 + g;  // and row0 + 8

  load_rows<HD, BR, kFwdThreads, !PAIR>(sQ, q + qbase, a.qst, qt * BR, a.Tq,
                                        a.scale);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int nkt = key_tiles<CAUSAL, BR, BC>(a, qt);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<HD, BC, kFwdThreads, false>(sK, k + kbase, a.kst, kt * BC,
                                          a.Tk, 0.f);
    load_rows<HD, BC, kFwdThreads, false>(sV, v + kbase, a.kst, kt * BC,
                                          a.Tk, 0.f);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a4[4];
      frag_a<LD>(a4, sQ, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t b0, b1;
        frag_b_nk<LD>(b0, b1, sK, n * 8, kk * 16, lane);
        mma16816(s[n], a4, b0, b1);
      }
    }
    // causal: only a tile that reaches past this warp's first row needs
    // the mask; otherwise only a ragged last tile (keys past Tk)
    if (CAUSAL ? kt * BC + BC - 1 > qt * BR + warp * 16
               : kt * BC + BC > a.Tk) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kt * BC + n * 8 + c2 + (e & 1);
          if (CAUSAL ? kpos > row0 + (e >> 1) * 8 : kpos >= a.Tk)
            s[n][e] = kNegInf;
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
      uint32_t a4[4];
      a4[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      a4[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      a4[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a4[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b0, b1;
        frag_b_kn<LD>(b0, b1, sV, kk * 16, n * 8, lane);
        mma16816(acc[n], a4, b0, b1);
      }
    }
  }

  const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + half * 8;
    if (row >= a.Tq) continue;
    const float ls = half ? ls1 : ls0;
    bf16* orow = out + obase + (long long)row * ost;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + c2) =
          pack_f32(acc[n][2 * half] / ls, acc[n][2 * half + 1] / ls);
    if ((lane & 3) == 0)
      lse_out[lse_at(a, b, h, row)] = (half ? m1 : m0) + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// dq: block = (b*h, 64-row query tile), 4 warps x 16 rows, 32-key tiles
// ---------------------------------------------------------------------------

constexpr int kDqRows = 64, kDqKeys = 32, kDqThreads = 128;

template <int HD, bool CAUSAL, bool PAIR>
__global__ void __launch_bounds__(kDqThreads)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ o,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ dlse, bf16* __restrict__ dq,
              const Shape a) {
  constexpr int LD = HD + 8, BR = kDqRows, BC = kDqKeys;
  constexpr int NO = HD / 8, NS = BC / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + BR * LD;
  bf16* sK = sDO + BR * LD;
  bf16* sV = sK + BC * LD;
  float* sL = reinterpret_cast<float*>(sV + BC * LD);
  float* sD = sL + BR;
  float* sG = sD + BR;  // dlse (PAIR)

  const int nq = (a.Tq + BR - 1) / BR;
  const int qt = nq - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const long long qbase = (long long)b * a.qsb + (long long)h * HD;
  const long long kbase = (long long)b * a.ksb + (long long)h * HD;
  const long long ost = (long long)a.H * HD;
  const long long obase = (long long)b * a.Tq * ost + (long long)h * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int lr0 = warp * 16 + g;  // local rows lr0, lr0 + 8
  const int row0 = qt * BR + lr0;

  load_rows<HD, BR, kDqThreads, !PAIR>(sQ, q + qbase, a.qst, qt * BR, a.Tq,
                                       a.scale);
  load_rows<HD, BR, kDqThreads, false>(sDO, dout + obase, ost, qt * BR,
                                       a.Tq, 0.f);
  for (int r = threadIdx.x; r < BR; r += kDqThreads) {
    const bool in = qt * BR + r < a.Tq;
    sL[r] = in ? lse[lse_at(a, b, h, qt * BR + r)] : 0.f;
    if (PAIR) sG[r] = in ? dlse[lse_at(a, b, h, qt * BR + r)] : 0.f;
  }
  __syncthreads();
  row_delta<HD, BR, kDqThreads>(sD, sDO, o + obase + (long long)qt * BR * ost,
                                ost, a.Tq - qt * BR);
  __syncthreads();
  const float lse0 = sL[lr0], lse1 = sL[lr0 + 8];
  const float dl0 = sD[lr0], dl1 = sD[lr0 + 8];
  const float dg0 = PAIR ? sG[lr0] : 0.f, dg1 = PAIR ? sG[lr0 + 8] : 0.f;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int nkt = key_tiles<CAUSAL, BR, BC>(a, qt);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_rows<HD, BC, kDqThreads, false>(sK, k + kbase, a.kst, kt * BC,
                                         a.Tk, 0.f);
    load_rows<HD, BC, kDqThreads, false>(sV, v + kbase, a.kst, kt * BC,
                                         a.Tk, 0.f);
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a4[4], ad[4];
      frag_a<LD>(a4, sQ, warp * 16, kk * 16, lane);
      frag_a<LD>(ad, sDO, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t b0, b1;
        frag_b_nk<LD>(b0, b1, sK, n * 8, kk * 16, lane);
        mma16816(s[n], a4, b0, b1);
        frag_b_nk<LD>(b0, b1, sV, n * 8, kk * 16, lane);
        mma16816(dp[n], ad, b0, b1);
      }
    }
    const bool edge = CAUSAL ? kt * BC + BC - 1 > qt * BR + warp * 16
                             : kt * BC + BC > a.Tk;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const int kpos = kt * BC + n * 8 + c2 + (e & 1);
        float sv = s[n][e];
        if (edge && (CAUSAL ? kpos > row0 + hi * 8 : kpos >= a.Tk))
          sv = kNegInf;
        const float p = expf(sv - (hi ? lse1 : lse0));
        // dS; with PAIR the lse cotangent rides the softmax-weighted path
        s[n][e] = PAIR ? p * (dp[n][e] - (hi ? dl1 : dl0) + (hi ? dg1 : dg0))
                       : p * (dp[n][e] - (hi ? dl1 : dl0));
      }
    // dQ += dS (bf16) K
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t a4[4];
      a4[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      a4[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      a4[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a4[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b0, b1;
        frag_b_kn<LD>(b0, b1, sK, kk * 16, n * 8, lane);
        mma16816(acc[n], a4, b0, b1);
      }
    }
  }

  // with PAIR q arrived pre-scaled, so the sum IS d/d(pre-scaled q)
  const float out_scale = PAIR ? 1.f : a.scale;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + half * 8;
    if (row >= a.Tq) continue;
    bf16* drow = dq + obase + (long long)row * ost;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8 + c2) = pack_f32(
          acc[n][2 * half] * out_scale, acc[n][2 * half + 1] * out_scale);
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

template <int HD, bool CAUSAL, bool PAIR>
__global__ void __launch_bounds__(kDkvThreads)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ o,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ dlse, bf16* __restrict__ dk,
               bf16* __restrict__ dv, const Shape a) {
  constexpr int LD = HD + 8, BC = kDkvKeys, BQ = kDkvRows;
  constexpr int LP = BQ + 8;      // leading dimension of the P^T / dS^T tiles
  constexpr int NH = HD / 16;     // 8-channel tiles in a warp's half of HD
  constexpr int NT = kDkvThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BC * LD;
  bf16* sQ2 = sV + BC * LD;       // two buffers each of q, dO, O, lse and
  bf16* sDO2 = sQ2 + 2 * BQ * LD; // dlse: one step's tiles land while the
  bf16* sO2 = sDO2 + 2 * BQ * LD; // previous step's are in use
  bf16* sP = sO2 + 2 * BQ * LD;
  bf16* sDS = sP + BC * LP;
  float* sL2 = reinterpret_cast<float*>(sDS + BC * LP);
  float* sD = sL2 + 2 * BQ;
  float* sG2 = sD + BQ;  // dlse (PAIR)

  const int kt = blockIdx.y;  // early key tiles see the most queries: first
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const long long qbase = (long long)b * a.qsb + (long long)h * HD;
  const long long kbase = (long long)b * a.ksb + (long long)h * HD;
  const long long ost = (long long)a.H * HD;
  const long long obase = (long long)b * a.Tq * ost + (long long)h * HD;
  const long long kobase = (long long)b * a.Tk * ost + (long long)h * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int kg = warp % (BC / 16);  // keys kg*16.. of the tile (both phases)
  const int hw = warp / (BC / 16);  // phase A: queries hw*16..; B: channels

  // the copies of query step `it`'s q (unscaled), dO, O rows, lse and
  // dlse into buffer `buf`
  auto issue = [&](int it, int buf) {
    load_rows_async<HD, BQ, NT>(sQ2 + buf * BQ * LD, q + qbase, a.qst,
                                it * BQ, a.Tq);
    load_rows_async<HD, BQ, NT>(sDO2 + buf * BQ * LD, dout + obase, ost,
                                it * BQ, a.Tq);
    load_rows_async<HD, BQ, NT>(sO2 + buf * BQ * LD, o + obase, ost,
                                it * BQ, a.Tq);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool in = it * BQ + r < a.Tq;
      const long long at = lse_at(a, b, h, in ? it * BQ + r : 0);
      cp_async4(sL2 + buf * BQ + r, lse + at, in);
      if (PAIR) cp_async4(sG2 + buf * BQ + r, dlse + at, in);
    }
  };

  const int it0 = CAUSAL ? (kt * BC) / BQ : 0, nqt = (a.Tq + BQ - 1) / BQ;
  load_rows_async<HD, BC, NT>(sK, k + kbase, a.kst, kt * BC, a.Tk);
  load_rows_async<HD, BC, NT>(sV, v + kbase, a.kst, kt * BC, a.Tk);
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
    const float* sG = sG2 + buf * BQ;
    // the next step's tiles go into the other buffer, free since the
    // barrier that closed the previous step
    if (it + 1 < nqt) issue(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this step's copies (and K, V) have landed
    if (!PAIR) scale_rows<HD, BQ, NT>(sQ, a.scale);
    __syncthreads();
    row_delta<HD, BQ, NT>(sD, sDO, sO2 + buf * BQ * LD, LD, a.Tq - it * BQ);
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
          const float sv =
              (!CAUSAL || qpos >= key) ? s[n][2 * half + j] : kNegInf;
          p[j] = qpos < a.Tq ? expf(sv - sL[ql]) : 0.f;
          ds[j] = PAIR ? p[j] * (dp[n][2 * half + j] - sD[ql] + sG[ql])
                       : p[j] * (dp[n][2 * half + j] - sD[ql]);
        }
        const int off = (kg * 16 + g + half * 8) * LP + hw * 16 + n * 8 + c2;
        *reinterpret_cast<uint32_t*>(sP + off) = pack_f32(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(sDS + off) = pack_f32(ds[0], ds[1]);
      }
    }
    __syncthreads();

    // phase B: dV += P^T dO and dK += dS^T q (scaled) over this warp's
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
    if (key >= a.Tk) continue;
    bf16* krow = dk + kobase + (long long)key * ost;
    bf16* vrow = dv + kobase + (long long)key * ost;
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
// launchers: B * H blocks along x, query (forward, dq) or key (dk/dv)
// tiles along y
// ---------------------------------------------------------------------------

template <typename K>
static cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int HD, bool CAUSAL, bool PAIR>
static int launch_fwd(const Attn& a, int B, cudaStream_t stream) {
  constexpr int LD = HD + 8;
  const size_t smem = (size_t)(kFwdRows + 2 * kFwdKeys) * LD * sizeof(bf16);
  cudaError_t err = prepare(fwd_kernel<HD, CAUSAL, PAIR>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * a.s.H, (a.s.Tq + kFwdRows - 1) / kFwdRows);
  fwd_kernel<HD, CAUSAL, PAIR><<<grid, kFwdThreads, smem, stream>>>(
      a.q, a.k, a.v, a.out, a.lse_out, a.s);
  return (int)cudaGetLastError();
}

template <int HD, bool CAUSAL, bool PAIR>
static int launch_dq(const Attn& a, int B, cudaStream_t stream) {
  constexpr int LD = HD + 8;
  // q, dO, K, V; lse, delta (and dlse with PAIR)
  const size_t smem = (size_t)(2 * kDqRows + 2 * kDqKeys) * LD * sizeof(bf16) +
                      (PAIR ? 3 : 2) * kDqRows * sizeof(float);
  cudaError_t err = prepare(dq_kernel<HD, CAUSAL, PAIR>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * a.s.H, (a.s.Tq + kDqRows - 1) / kDqRows);
  dq_kernel<HD, CAUSAL, PAIR><<<grid, kDqThreads, smem, stream>>>(
      a.q, a.k, a.v, a.o, a.dout, a.lse, a.dlse, a.dq, a.s);
  return (int)cudaGetLastError();
}

template <int HD, bool CAUSAL, bool PAIR>
static int launch_dkv(const Attn& a, int B, cudaStream_t stream) {
  constexpr int LD = HD + 8, LP = kDkvRows + 8;
  // K, V; two buffers of q, dO, O; P^T, dS^T; two of lse, one of delta
  // (and two of dlse with PAIR)
  const size_t smem =
      (size_t)(2 * kDkvKeys + 6 * kDkvRows) * LD * sizeof(bf16) +
      (size_t)2 * kDkvKeys * LP * sizeof(bf16) +
      (PAIR ? 5 : 3) * kDkvRows * sizeof(float);
  cudaError_t err = prepare(dkv_kernel<HD, CAUSAL, PAIR>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * a.s.H, (a.s.Tk + kDkvKeys - 1) / kDkvKeys);
  dkv_kernel<HD, CAUSAL, PAIR><<<grid, kDkvThreads, smem, stream>>>(
      a.q, a.k, a.v, a.o, a.dout, a.lse, a.dlse, a.dk, a.dv, a.s);
  return (int)cudaGetLastError();
}

}  // namespace ca
