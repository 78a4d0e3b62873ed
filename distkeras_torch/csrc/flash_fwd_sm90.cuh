// The training attention forward written for Hopper (sm_90a): both
// products on wgmma, K/V tiles brought in by TMA through an mbarrier ring
// that one producer warp keeps full, two consumer warpgroups per block.
// Instantiated as ca::launch_fwd by causal_attention.cu (CAUSAL, !PAIR)
// and pair_attention.cu (PAIR: the causal wedge or the rectangle); the
// backward is flash_bwd_sm90.cuh, built from the pieces defined here.
//
// Replaces the forward Pallas TPU kernels:
//   distkeras_tpu/ops/pallas_attention.py  _fwd_kernel :100 (causal)
//   distkeras_tpu/ops/pallas_pair.py       _fwd_kernel_tri :148 (wedge),
//                                          _fwd_kernel :128 (rectangle)
// Same function and roundings as they compute: without PAIR q is scaled
// in f32 and rounded back to bf16 before q k^T; with PAIR q arrives
// pre-scaled. The online softmax state is f32; P is the unnormalized
// exp(s - m), rounded to bf16 before P V; O = acc / max(l, 1e-30) in bf16
// and lse = m + log(max(l, 1e-30)) in f32, addressed through ca::Shape's
// strides ([B, H, T] causal, [B, Tq, H] for a pair). Scores of keys past
// the query's position (CAUSAL) or at or past Tk are -1e30. exp runs as
// ex2 with log2(e) folded in. No atomics, a fixed order: two launches
// give equal bits.
//
// What bounds it on the H100: operations. At the flagship shapes the
// causal [8, 2048, 8, 256] forward is 137 GFLOP over 268 MB (~510 FLOPs
// a byte) and the rectangle pair [8, 1024, 8, 256] 69 GFLOP over 134 MB,
// above the card's ~295 bf16 ridge point; the wedge at that shape moves
// as many bytes for half the work and sits near the ridge. Inside the SM
// shared memory is nearly as tight: a 64-key tile costs the two consumer
// warpgroups 128 KB of S operand reads, 64 KB of V reads and 64 KB of TMA
// writes, 256 KB at 128 bytes a clock, as long as its 2048 clocks of
// tensor-core work.
//
// Design:
// - A block has three warpgroups: warpgroup 0 is the producer
//   (setmaxnreg down to 24 registers; one thread issues every copy),
//   warpgroups 1 and 2 consume 64 query rows each (setmaxnreg up to 240).
// - Persistent: at most one block per SM (224 KB of shared memory at hd
//   256), each walking work items of 128 query rows of one (batch, head).
//   Items are ordered by head group (as many heads as keep their K/V in
//   20 MB of L2), heaviest query tile first inside a group, and dealt to
//   the blocks in snaking rounds. The order is fixed and no atomics are
//   used. The producer loads the next item's Q as soon as a consumer has
//   issued its last S of the current one, so loads overlap the epilogue.
// - Copies: 4-D TMA tensor maps (hd, H, T, B) over the strided q/k/v
//   views, made per call on the host (cuTensorMapEncodeTiled through
//   cudaGetDriverEntryPoint, so nothing new is linked) and passed as
//   __grid_constant__ parameters. Boxes are 64 elements on hd with the
//   128-byte swizzle, so a [rows, hd] tile lands as hd/64 column blocks of
//   [rows, 64], each a stack of 1024-byte swizzle atoms. Q has a full and
//   an empty barrier per consumer; K and V each have a two-stage ring of
//   full barriers (the copy's bytes) and empty barriers (one arrival from
//   each of the 8 consumer warps). K runs one tile ahead of V.
// - S = Q K^T: wgmma m64nBCk16 with both operands in shared memory,
//   K-major (descriptors: SBO 1024 bytes between 8-row groups; the start
//   address steps 32 bytes per k16 inside a swizzle atom, and a column
//   block every four steps). O += P V: wgmma m64nHDk16 with P in
//   registers (the S accumulator re-packed to bf16: the register layouts
//   match) and V as an MN-major B operand with the transpose bit (LBO =
//   BC * 128 bytes between column blocks along hd, SBO 1024 bytes between
//   8-key groups).
// - Inside a consumer, step i issues S(i) and P V(i - 1) back to back and
//   waits for the first, so the softmax of tile i runs while P V(i - 1)
//   is on the tensor cores; O is rescaled once P V(i - 1) has landed.
//   The two consumers are not ordered against each other: a ping-pong
//   between them (named barriers) measured slower.
// - Key tile BC per head dim, from the register and shared-memory budget:
//   hd 256 -> 64 (O 128 + S 32 + P 16 registers a thread; Q 64 KB + 2 x
//   64 KB of K/V = 192 KB), hd 128 and 64 -> 128 (160 KB and 80 KB).
// - Without PAIR each consumer warpgroup rescales its own 64 landed Q rows
//   in place (elementwise, so the swizzle does not matter), then
//   fence.proxy.async and a named barrier before its first wgmma reads
//   them.
// - The epilogue multiplies O by 1 / max(l, 1e-30) and stores bf16 pairs
//   straight from the accumulator registers.
//
// Where trouble lay:
// - TMA zero-fills rows past T: a zero key scores 0, not -1e30, so keys
//   at or past Tk are masked explicitly, as is the causal diagonal. Rows
//   past Tq are computed and never stored (neither O nor lse). A consumer
//   whose 64 rows all lie past Tq gets no Q and only keeps the rings
//   turning.
// - The descriptors differ between the K-major (Q, K) and MN-major (V)
//   operands; at hd 64 one column block covers V, so only hd 128 and 256
//   exercise V's LBO (the card tests cover all three).
// - A wgmma issued under a branch made ptxas wait for each wgmma before
//   the next (WARPGROUP.DEPBAR after every HGMMA, no warning printed): the
//   first and last steps are peeled so the loop is straight-line code.
// - With one K/V barrier pair per stage, a stage was freed only once
//   P V(i - 1) had run, late in step i, and the next load's latency
//   showed every step: K and V have separate rings, and K is freed as
//   soon as S is read.
// - wgmma.fence after the rescale of O in ordinary registers and before
//   the next wgmma accumulates into it; wait_group before a stage's empty
//   barrier is arrived at; the ring's phase parity is the use count of
//   the stage, (tile count) / stages, modulo 2. A consumer with nothing to
//   do for a tile still waits for it before arriving, so an empty phase
//   never completes on early arrivals.
// - Registers: 80-key tiles at hd 256 (fewer S operand reads) spilled
//   at 240 registers and lost; a block with one producer warp
//   (248 registers for the consumers) hung in setmaxnreg on the card.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "flash_mma.cuh"


namespace ca {
namespace sm90 {

constexpr int kRows = 128;     // query rows of a block
constexpr int kWgRows = 64;    // query rows of a consumer warpgroup
constexpr int kThreads = 384;  // the producer warpgroup + two consumers
constexpr int kStages = 2;     // depth of the K/V ring
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;
// K/V bytes of the heads whose items run together (see item_tile): 20 MB
// of the H100's 50 MB L2 ran fastest at the flagship shapes (10 and 40
// MB were slower)
constexpr long long kL2GroupBytes = 20LL << 20;

template <int HD>
struct Tiles {
  static constexpr int BC = HD == 256 ? 64 : 128;  // keys of a K/V tile
  static constexpr int NB = HD / 64;               // 128-byte column blocks
  static constexpr int Q_BYTES = kRows * HD * 2;
  static constexpr int KV_BYTES = BC * HD * 2;     // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_BYTES;
  // barriers: Q full and empty per consumer; K full, V full, K empty,
  // V empty per stage
  static constexpr int BAR_BYTES = (4 + 4 * kStages) * 8;
  // + slack to align the base to a swizzle atom
  static constexpr size_t SMEM = BAR_OFF + BAR_BYTES + 1024;
};

// -- PTX: barriers, copies, wgmma ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also announces `bytes` of copies to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* m) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)m) : "memory");
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* m,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)m), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of a wgmma operand across this
// point
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (MN-major: between 64-element column
// blocks; unused K-major), stride byte offset 1024 (between 8-row groups),
// layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define DK_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define DK_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define DK_D128                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "      \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "      \
  "%122, %123, %124, %125, %126, %127}"
#define DK_F8(i)                                                     \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]),              \
      "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), "+f"(d[(i) + 5]),          \
      "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define DK_F32(i) DK_F8(i), DK_F8((i) + 8), DK_F8((i) + 16), DK_F8((i) + 24)
#define DK_O8(i)                                                     \
  "=f"(d[(i) + 0]), "=f"(d[(i) + 1]), "=f"(d[(i) + 2]),              \
      "=f"(d[(i) + 3]), "=f"(d[(i) + 4]), "=f"(d[(i) + 5]),          \
      "=f"(d[(i) + 6]), "=f"(d[(i) + 7])
#define DK_O32(i) DK_O8(i), DK_O8((i) + 8), DK_O8((i) + 16), DK_O8((i) + 24)
#define DK_F64(i) DK_F32(i), DK_F32((i) + 32)

// D (64 x N, f32) += A (64 x 16, shared, K-major) B (16 x N, shared,
// K-major); first() overwrites D (scale-d 0)
template <int N>
struct WgSS;

template <>
struct WgSS<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DK_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : DK_F32(0)
        : "l"(a), "l"(b), "r"(1));
  }
  // the first of a product: D is overwritten, never read
  __device__ __forceinline__ static void first(float (&d)[32], uint64_t a,
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DK_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : DK_O32(0)
        : "l"(a), "l"(b), "r"(0));
  }
};

template <>
struct WgSS<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DK_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : DK_F64(0)
        : "l"(a), "l"(b), "r"(1));
  }
  __device__ __forceinline__ static void first(float (&d)[64], uint64_t a,
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DK_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : DK_O32(0), DK_O32(32)
        : "l"(a), "l"(b), "r"(0));
  }
};

// D (64 x N, f32) += A (64 x 16, bf16 registers) B (16 x N, shared,
// MN-major: the transpose bit); scale-d is a predicate operand, always set
template <int N>
struct WgRS;

template <>
struct WgRS<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DK_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : DK_F32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgRS<128> {
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DK_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : DK_F64(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgRS<256> {
  __device__ __forceinline__ static void mma(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " DK_D128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : DK_F64(0), DK_F64(64)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef DK_D32
#undef DK_D64
#undef DK_D128
#undef DK_F8
#undef DK_F32
#undef DK_F64
#undef DK_O8
#undef DK_O32

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// -- the consumers' steps ---------------------------------------------------

// S = Q K^T for the warpgroup's 64 rows against one BC-key tile, issued
// and committed as one group
template <int HD, int BC>
__device__ __forceinline__ void issue_s(float (&s)[BC / 2], uint32_t q_me,
                                        uint32_t ks) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;  // inside a swizzle atom
    const uint64_t da = sw128_desc(q_me + (kk >> 2) * kRows * 128 + col, 16);
    const uint64_t db = sw128_desc(ks + (kk >> 2) * BC * 128 + col, 16);
    if (kk == 0)
      WgSS<BC>::first(s, da, db);
    else
      WgSS<BC>::mma(s, da, db);
  }
  wg_commit();
}

// O += P V for one tile, issued and committed as one group
template <int HD, int BC>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&p)[BC / 16][4],
                                         uint32_t vs) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk)
    WgRS<HD>::mma(o, p[kk], sw128_desc(vs + kk * 16 * 128, BC * 128));
  wg_commit();
}

// The row state of this thread's two rows (rowt and rowt + 8): running
// max m, this thread's share of the running sum l (the quad's shares are
// summed at the end) and the factor the last tile rescales O by.
struct Rows {
  float m0, m1, l0, l1, corr0, corr1;
};

// Masks of tile kt (the causal diagonal; keys at or past Tk, which TMA
// zero-filled) and the online softmax in f32, exp as ex2 of
// log2(e)-scaled scores: S becomes the unnormalized P.
template <int BC, bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&s)[BC / 2], Rows& r,
                                             int kt, int row0w, int rowt,
                                             int c2, int Tk) {
  if ((CAUSAL && kt * BC + BC - 1 > row0w) || kt * BC + BC > Tk) {
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kt * BC + n * 8 + c2 + (e & 1);
        if ((CAUSAL && kpos > rowt + (e >> 1) * 8) || kpos >= Tk)
          s[4 * n + e] = kNegInf;
      }
  }
  float mx0 = r.m0, mx1 = r.m1;
#pragma unroll
  for (int n = 0; n < BC / 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float ml0 = mx0 * kLog2e, ml1 = mx1 * kLog2e;
  r.corr0 = ex2(fmaf(r.m0, kLog2e, -ml0));
  r.corr1 = ex2(fmaf(r.m1, kLog2e, -ml1));
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < BC / 8; ++n) {
    s[4 * n] = ex2(fmaf(s[4 * n], kLog2e, -ml0));
    s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], kLog2e, -ml0));
    s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], kLog2e, -ml1));
    s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], kLog2e, -ml1));
    rs0 += s[4 * n] + s[4 * n + 1];
    rs1 += s[4 * n + 2] + s[4 * n + 3];
  }
  r.l0 = r.l0 * r.corr0 + rs0;
  r.l1 = r.l1 * r.corr1 + rs1;
  r.m0 = mx0;
  r.m1 = mx1;
}

// P rounded to bf16 in the A-fragment layout of m64k16, which is the
// accumulator's: k16 slice kk holds the accumulator's n8 tiles 2kk, 2kk+1
template <int BC>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BC / 16][4],
                                       const float (&s)[BC / 2]) {
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) {
    p[kk][0] = pack_f32(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2], const Rows& r) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    o[4 * n] *= r.corr0;
    o[4 * n + 1] *= r.corr0;
    o[4 * n + 2] *= r.corr1;
    o[4 * n + 3] *= r.corr1;
  }
}

// -- the kernel ------------------------------------------------------------

// Work item L (one 128-row query tile of one (batch, head)): heads in
// groups of `group` (sized on the host so a group's K/V stay in L2 while
// its items run), and inside a group the heaviest query tiles first, one
// per head in turn.
__device__ __forceinline__ void item_tile(int L, int nq, int BH, int group,
                                          int& qt, int& bh) {
  const int g0 = L / (group * nq);
  const int r = L - g0 * group * nq;
  const int heads = min(group, BH - g0 * group);
  qt = nq - 1 - r / heads;
  bh = g0 * group + r % heads;
}

// The k-th item of this block: the grid walks the items in rounds of
// gridDim.x, snaking (even rounds left to right, odd ones right to left)
// so the heavy-first order spreads over the blocks evenly.
__device__ __forceinline__ int block_item(int k) {
  const int G = gridDim.x;
  return k * G + ((k & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

template <int HD, bool CAUSAL, bool PAIR>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               bf16* __restrict__ out, float* __restrict__ lse_out,
               const Shape a, int BH, int group) {
  using T = Tiles<HD>;
  constexpr int BC = T::BC;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle-atom aligned
  unsigned char* smem = smem_raw + (base - raw);
  // barriers: Q full (2), Q empty (2), then per stage K full, V full,
  // K empty, V empty
  const uint32_t bar_q = base + T::BAR_OFF;
  auto bar = [&](int kind, int c) {  // kind: 0 K full, 1 V full, 2, 3 empty
    return bar_q + 32 + 8 * (kind * kStages + c % kStages);
  };
  const int nq = (a.Tq + kRows - 1) / kRows, items = BH * nq;

  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) {
      mbar_init(bar_q + 8 * w, 1);
      mbar_init(bar_q + 16 + 8 * w, 4);  // the warpgroup's warps
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(0, s), 1);
      mbar_init(bar(1, s), 1);
      mbar_init(bar(2, s), kConsumerWarps);
      mbar_init(bar(3, s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      // the K/V tiles loaded so far (the ring's position), each consumer's
      // Q loads so far
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
          if (n >= 1)  // the consumer is done with its previous Q
            mbar_wait(bar_q + 16 + 8 * w, (n - 1) & 1);
          const uint32_t qbar = bar_q + 8 * w;
          mbar_expect_tx(qbar, kWgRows * HD * 2);
#pragma unroll
          for (int j = 0; j < T::NB; ++j)
            tma_load(base + j * kRows * 128 + w * kWgRows * 128, &tq, qbar,
                     64 * j, h, r0, b);
        }
        // K runs one tile ahead of V: S(kt) needs K(kt) a step before
        // P V(kt) needs V(kt)
        auto load = [&](int kind, const CUtensorMap* m, int kt) {
          const int cc = c + kt;
          if (cc >= kStages)  // both consumers are done with its last use
            mbar_wait(bar(2 + kind, cc), (cc / kStages - 1) & 1);
          const uint32_t full = bar(kind, cc);
          mbar_expect_tx(full, T::KV_BYTES);
          const uint32_t dst = base + (kind ? T::V_OFF : T::K_OFF) +
                               (cc % kStages) * T::KV_BYTES;
#pragma unroll
          for (int j = 0; j < T::NB; ++j)
            tma_load(dst + j * BC * 128, m, full, 64 * j, h, kt * BC, b);
        };
        for (int kt = 0; kt <= nkt; ++kt) {
          if (kt < nkt) load(0, &tk, kt);
          if (kt >= 1) load(1, &tv, kt - 1);
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
    int c = 0, qn = 0;  // the ring's position, this warpgroup's Q uses
    auto k_at = [&](int cc) {
      return base + T::K_OFF + (cc % kStages) * T::KV_BYTES;
    };
    auto v_at = [&](int cc) {
      return base + T::V_OFF + (cc % kStages) * T::KV_BYTES;
    };
    auto full_wait = [&](int kind, int cc) {  // K (0) or V (1) of tile cc
      mbar_wait(bar(kind, cc), (cc / kStages) & 1);
    };
    auto release = [&](int kind, int cc) {  // its stage is free
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(2 + kind, cc));
    };

    for (int k = 0;; ++k) {
      const int L = block_item(k);
      if (L >= items) break;
      int qt, bh;
      item_tile(L, nq, BH, group, qt, bh);
      const int nkt = key_tiles<CAUSAL, kRows, BC>(a, qt);
      const int row0w = qt * kRows + w * kWgRows;  // the warpgroup's first
      const int rowt = row0w + warp * 16 + g;      // this thread's: +0, +8
      // tiles this warpgroup computes (none if all its rows lie past Tq)
      const int nkt_me = row0w >= a.Tq ? 0
                         : CAUSAL ? (min(a.Tk, row0w + kWgRows) - 1) / BC + 1
                                  : nkt;

      float o[HD / 2];         // O: 64 x HD over the warpgroup
      float s[BC / 2];         // S, then P in f32: 64 x BC
      uint32_t p[BC / 16][4];  // P in bf16, the A operand of P V
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      Rows r = {kNegInf, kNegInf, 0.f, 0.f, 0.f, 0.f};

      if (nkt_me > 0) {
        mbar_wait(bar_q + 8 * w, qn & 1);
        if (!PAIR) {
          // q * scale in f32, rounded back to bf16, in place: the rows of
          // this warpgroup, 64 x 128 contiguous bytes in each column block
          for (int i = t; i < T::NB * kWgRows * 8; i += 128) {
            const int j = i / (kWgRows * 8), rr = i % (kWgRows * 8);
            uint4* q = reinterpret_cast<uint4*>(
                smem + j * kRows * 128 + w * kWgRows * 128 + rr * 16);
            uint4 v = *q;
            bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
            for (int x = 0; x < 8; ++x)
              e[x] = __float2bfloat16(__bfloat162float(e[x]) * a.scale);
            *q = v;
          }
          fence_proxy_async();  // the generic writes, before wgmma reads
          named_sync(1 + w, 128);
        }
        // Step i issues S(i) and P V(i - 1) back to back and waits for
        // the first, so the softmax of tile i runs while P V(i - 1) is on
        // the tensor cores. The first and last steps are peeled so that
        // the loop issues its wgmma in straight-line code (a wgmma under
        // a branch makes ptxas wait for each one before the next).
        auto release_q = [&]() {  // Q may take the next item's rows
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_q + 16 + 8 * w);
        };
        full_wait(0, c);
        issue_s<HD, BC>(s, q_me, k_at(c));
        wg_wait_all();
        reg_fence(s);
        release(0, c);
        if (nkt_me == 1) release_q();
        softmax_tile<BC, CAUSAL>(s, r, 0, row0w, rowt, c2, a.Tk);
        pack_p<BC>(p, s);  // O is still 0: nothing to rescale
        for (int i = 1; i < nkt_me; ++i) {
          full_wait(0, c + i);
          full_wait(1, c + i - 1);
          issue_s<HD, BC>(s, q_me, k_at(c + i));
          issue_pv<HD, BC>(o, p, v_at(c + i - 1));
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          reg_fence(s);
          release(0, c + i);  // K(i) is read
          if (i == nkt_me - 1) release_q();  // the item's last S is done
          softmax_tile<BC, CAUSAL>(s, r, i, row0w, rowt, c2, a.Tk);
          wg_wait_all();
          reg_fence(o);
          reg_fence(p);
          release(1, c + i - 1);  // V(i - 1) is read
          rescale<HD>(o, r);      // O holds P V up to tile i - 1
          pack_p<BC>(p, s);
        }
        full_wait(1, c + nkt_me - 1);
        issue_pv<HD, BC>(o, p, v_at(c + nkt_me - 1));
        wg_wait_all();
        reg_fence(o);
        release(1, c + nkt_me - 1);
        ++qn;
      }
      // tiles only the other warpgroup needs: keep the ring turning
      for (int kt = nkt_me; kt < nkt; ++kt) {
        full_wait(0, c + kt);
        release(0, c + kt);
        full_wait(1, c + kt);
        release(1, c + kt);
      }
      c += nkt;

      const float ls0 = fmaxf(quad_sum(r.l0), 1e-30f);
      const float ls1 = fmaxf(quad_sum(r.l1), 1e-30f);
      const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;
      const int b = bh / a.H, h = bh % a.H;
      const long long ost = (long long)a.H * HD;
      const long long obase = (long long)b * a.Tq * ost + (long long)h * HD;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rowt + half * 8;
        if (nkt_me == 0 || row >= a.Tq) continue;
        const float ls = half ? ls1 : ls0, inv = half ? inv1 : inv0;
        bf16* orow = out + obase + (long long)row * ost;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + n * 8 + c2) = pack_f32(
              o[4 * n + 2 * half] * inv, o[4 * n + 2 * half + 1] * inv);
        if ((lane & 3) == 0)
          lse_out[lse_at(a, b, h, row)] = (half ? r.m1 : r.m0) + logf(ls);
      }
    }
  }
}

// -- host side: tensor maps and the launch ---------------------------------

// heads per group: as many as keep `per_head` bytes each within
// kL2GroupBytes
static int head_group(int BH, long long per_head) {
  return (int)std::max(
      1LL, std::min((long long)BH, kL2GroupBytes / std::max(per_head, 1LL)));
}

static int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a [B, T, H, HD] bf16 view (token and batch strides in
// elements, head stride HD) as (hd, H, T, B), boxes of 64 x 1 x rows x 1
// with the 128-byte swizzle; rows past T read as zeros. The stride of an
// axis of size 1 is never stepped and is replaced by the packed one.
static int make_map(CUtensorMap* m, const void* base, int HD, int H, int T,
                    int B, long long sb, long long st, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  if (T == 1) st = (long long)H * HD;
  if (B == 1) sb = (long long)T * st;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace sm90

// A persistent grid: at most one block per SM, each walking its share of
// the B * H * ceil(Tq / 128) items.
template <int HD, bool CAUSAL, bool PAIR>
static int launch_fwd(const Attn& a, int B, cudaStream_t stream) {
  using T = sm90::Tiles<HD>;
  // runtime calls first: they bind the device's context to this thread
  // (a backward thread that recomputes a forward may have none yet),
  // which cuTensorMapEncodeTiled needs
  int sms = 0;
  int err = sm90::sm_count(&sms);
  if (err == 0)
    err = (int)prepare(sm90::fwd_kernel<HD, CAUSAL, PAIR>, T::SMEM);
  CUtensorMap mq, mk, mv;
  if (err == 0)
    err = sm90::make_map(&mq, a.q, HD, a.s.H, a.s.Tq, B, a.s.qsb, a.s.qst,
                         sm90::kWgRows);
  if (err == 0)
    err = sm90::make_map(&mk, a.k, HD, a.s.H, a.s.Tk, B, a.s.ksb, a.s.kst,
                         T::BC);
  if (err == 0)
    err = sm90::make_map(&mv, a.v, HD, a.s.H, a.s.Tk, B, a.s.ksb, a.s.kst,
                         T::BC);
  if (err != 0) return err;
  const int BH = B * a.s.H, nq = (a.s.Tq + sm90::kRows - 1) / sm90::kRows;
  // heads per group: as many as keep their K/V in L2
  sm90::fwd_kernel<HD, CAUSAL, PAIR>
      <<<std::min(BH * nq, sms), sm90::kThreads, T::SMEM, stream>>>(
          mq, mk, mv, a.out, a.lse_out, a.s, BH,
          sm90::head_group(BH, 4LL * a.s.Tk * HD));
  return (int)cudaGetLastError();
}

}  // namespace ca
