// The structs and device helpers the attention sources share: the
// sizes and strides of a launch (Shape) and its operands (Attn), the lse
// addressing (lse_at), bf16 packing, quad and warp reductions, mma.sync
// m16n8k16 with its fragment loaders from padded shared-memory tiles,
// cp.async, the key-tile count of a query tile (key_tiles) and the dynamic
// shared memory attribute (prepare).
//
// Included by flash_fwd_sm90.cuh, and through it by flash_bwd_sm90.cuh:
// the training kernels (forward, dq, dk/dv, causal and pair), all on wgmma
// and TMA, take Shape, Attn, lse_at, the packing and the reductions. And by
// serve_mma.cuh, the serving kernels' tensor-core core, which runs on
// mma.sync and cp.async. No kernel is defined here.

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
  float scale;              // q's scale (1 with PAIR)
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

// key tiles of width BC that query tile qt (rows of width BR) visits
template <bool CAUSAL, int BR, int BC>
__device__ __forceinline__ int key_tiles(const Shape& a, int qt) {
  return CAUSAL ? (min(a.Tk, (qt + 1) * BR) - 1) / BC + 1
                : (a.Tk + BC - 1) / BC;
}

// the dynamic shared memory a kernel may take, beyond the default 48 KB
template <typename K>
static cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace ca
