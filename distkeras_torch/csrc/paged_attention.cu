// Paged causal attention over the serving engine's block-pooled KV cache.
//
// Replaces the Pallas TPU kernel distkeras_tpu/ops/paged_attention.py:
// paged_attention (kernel body _kernel). Same function: T queries per
// row attend that row's block-table pages, positions <= seq_lens[b] + t,
// int8 pages dequantized in-tile with per-token f32 scales, online
// softmax in f32.
//
// What bounds it on the H100, at the main path's shapes (B=8 rows,
// H=8, Hk=2, hd=256, 16-token int8 pages, up to 2048-token contexts):
// a decode tick (T=1) reads ~7 MB of int8 pages and scales for ~8 MFLOP
// — bytes (3.35 TB/s); a 64-token chunk does ~4 GFLOP over the same
// bytes — operations (989 TFLOP/s bf16 on the tensor cores).
//
// Dispatch on the query dtype, explicitly. Both routes split the cache
// the same way (the host's shape-only plan: rows per block, splits, 64-key
// stages per split) and merge f32 partials in split order:
//
// - bf16 queries take the tensor-core split-K core of serve_mma.cuh
//   (paged_split_kernel, then paged_merge_kernel when the launch has
//   more than one split): mma.sync m16n8k16 for q k^T and P V, GQA on
//   the M axis, pages copied as int8 with cp.async into a two-stage ring
//   and converted on the way into the fragments. The source note of
//   serve_mma.cuh says what each choice does about the bound.
// - f32 queries take the FFMA split-K core of serve_f32.cuh
//   (paged_f32_split_kernel, then paged_f32_merge_kernel): register-tiled
//   f32 FMAs on the CUDA cores, since the tensor cores round to bf16 or
//   TF32 and cannot meet f32's 1e-5; int8 pages dequantized to f32 in
//   shared memory. Its source note says what bounds it and why.
//
// A launch the kernel cannot take returns a CUDA error code, which the
// wrapper raises.

#include "serve_f32.cuh"
#include "serve_mma.cuh"

template <typename KVT, int HD, int BM>
__global__ void __launch_bounds__(sv::kThreads)
    paged_split_kernel(const sv::bf16* __restrict__ q,
                       const KVT* __restrict__ kp, const KVT* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens, sv::bf16* __restrict__ out,
                       float* __restrict__ part, int T, int H, int Hk, int MB,
                       float scale, int splits, int per) {
  sv::split_attn<KVT, HD, BM, true>(q, kp, vp, ks, vs, tables, lens, out,
                                    part, T, H, Hk, MB, scale, splits, per);
}

template <int HD>
__global__ void __launch_bounds__(sv::kThreads)
    paged_merge_kernel(const float* __restrict__ part,
                       sv::bf16* __restrict__ out, int B, int T, int H,
                       int Hk, int splits) {
  sv::merge_partials<HD>(part, out, B, T, H, Hk, splits);
}

template <typename KVT, int HD, int BM>
static int launch_tc(const void* q, const void* kp, const void* vp,
                     const void* ks, const void* vs, const void* tables,
                     const void* lens, void* out, void* part, int B, int T,
                     int H, int Hk, int MB, float scale, int splits, int per,
                     cudaStream_t st) {
  const size_t smem = sv::smem_bytes<KVT, HD, BM>(per, true);
  auto kern = paged_split_kernel<KVT, HD, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int TG = T * (H / Hk);
  const dim3 grid((TG + BM - 1) / BM, Hk, B * splits);
  kern<<<grid, sv::kThreads, smem, st>>>(
      (const sv::bf16*)q, (const KVT*)kp, (const KVT*)vp, (const float*)ks,
      (const float*)vs, (const int*)tables, (const int*)lens,
      (sv::bf16*)out, splits > 1 ? (float*)part : nullptr, T, H, Hk, MB,
      scale, splits, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  paged_merge_kernel<HD><<<(B * T * H + sv::kWarps - 1) / sv::kWarps,
                           sv::kThreads, 0, st>>>(
      (const float*)part, (sv::bf16*)out, B, T, H, Hk, splits);
  return (int)cudaGetLastError();
}

template <typename KVT, int HD>
static int launch_bm(const void* q, const void* kp, const void* vp,
                     const void* ks, const void* vs, const void* tables,
                     const void* lens, void* out, void* part, int B, int T,
                     int H, int Hk, int MB, float scale, int bm, int splits,
                     int per, cudaStream_t st) {
  if (bm == 16)
    return launch_tc<KVT, HD, 16>(q, kp, vp, ks, vs, tables, lens, out, part,
                                  B, T, H, Hk, MB, scale, splits, per, st);
  if (bm == 64)
    return launch_tc<KVT, HD, 64>(q, kp, vp, ks, vs, tables, lens, out, part,
                                  B, T, H, Hk, MB, scale, splits, per, st);
  return (int)cudaErrorInvalidValue;
}

template <typename KVT>
static int launch_bf16(const void* q, const void* kp, const void* vp,
                       const void* ks, const void* vs, const void* tables,
                       const void* lens, void* out, void* part, int B, int T,
                       int H, int Hk, int hd, int MB, float scale, int bm,
                       int splits, int per, cudaStream_t st) {
#define DK_TC(HD)                                                          \
  return launch_bm<KVT, HD>(q, kp, vp, ks, vs, tables, lens, out, part, B, \
                            T, H, Hk, MB, scale, bm, splits, per, st)
  switch (hd) {
    case 64: DK_TC(64);
    case 128: DK_TC(128);
    case 256: DK_TC(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DK_TC
}

template <typename KVT, int HD, int BM>
__global__ void __launch_bounds__(sf::Geo<KVT, HD, BM>::NT)
    paged_f32_split_kernel(const float* __restrict__ q,
                           const KVT* __restrict__ kp,
                           const KVT* __restrict__ vp,
                           const float* __restrict__ ks,
                           const float* __restrict__ vs,
                           const int* __restrict__ tables,
                           const int* __restrict__ lens,
                           float* __restrict__ out, float* __restrict__ part,
                           int T, int H, int Hk, int MB, float scale,
                           int splits, int per) {
  sf::split_attn<KVT, HD, BM, true>(q, kp, vp, ks, vs, tables, lens, out,
                                    part, T, H, Hk, MB, scale, splits, per);
}

template <int HD>
__global__ void __launch_bounds__(sf::kMergeWarps * 32)
    paged_f32_merge_kernel(const float* __restrict__ part,
                           float* __restrict__ out, int B, int T, int H,
                           int Hk, int splits) {
  sf::merge_partials<HD>(part, out, B, T, H, Hk, splits);
}

template <typename KVT, int HD, int BM>
static int launch_ffma(const void* q, const void* kp, const void* vp,
                       const void* ks, const void* vs, const void* tables,
                       const void* lens, void* out, void* part, int B, int T,
                       int H, int Hk, int MB, float scale, int splits,
                       int per, cudaStream_t st) {
  const size_t smem = sf::smem_bytes<KVT, HD, BM>(per, true);
  auto kern = paged_f32_split_kernel<KVT, HD, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int TG = T * (H / Hk);
  const dim3 grid((TG + BM - 1) / BM, Hk, B * splits);
  kern<<<grid, sf::Geo<KVT, HD, BM>::NT, smem, st>>>(
      (const float*)q, (const KVT*)kp, (const KVT*)vp, (const float*)ks,
      (const float*)vs, (const int*)tables, (const int*)lens, (float*)out,
      splits > 1 ? (float*)part : nullptr, T, H, Hk, MB, scale, splits, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  paged_f32_merge_kernel<HD>
      <<<(B * T * H + sf::kMergeWarps - 1) / sf::kMergeWarps,
         sf::kMergeWarps * 32, 0, st>>>((const float*)part, (float*)out, B,
                                        T, H, Hk, splits);
  return (int)cudaGetLastError();
}

template <typename KVT>
static int launch_f32(const void* q, const void* kp, const void* vp,
                      const void* ks, const void* vs, const void* tables,
                      const void* lens, void* out, void* part, int B, int T,
                      int H, int Hk, int hd, int MB, float scale, int bm,
                      int splits, int per, cudaStream_t st) {
#define DK_FFMA(HD, BM)                                                    \
  return launch_ffma<KVT, HD, BM>(q, kp, vp, ks, vs, tables, lens, out,    \
                                  part, B, T, H, Hk, MB, scale, splits, per, \
                                  st)
  if (bm != 16 && bm != 64) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      if (bm == 16) DK_FFMA(64, 16);
      DK_FFMA(64, 64);
    case 128:
      if (bm == 16) DK_FFMA(128, 16);
      DK_FFMA(128, 64);
    case 256:
      if (bm == 16) DK_FFMA(256, 16);
      DK_FFMA(256, 64);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DK_FFMA
}

// `part`, `bm`, `splits` and `per` are the launch's plan, for either
// dtype: the f32 scratch the wrapper sized for `splits` partials (null
// with one split), rows per block (16 or 64) and 64-key stages per split.
extern "C" int dk_paged_attention(const void* q, const void* kp,
                                  const void* vp, const void* ks,
                                  const void* vs, const void* tables,
                                  const void* lens, void* out, int B, int T,
                                  int H, int Hk, int hd, int bs, int MB,
                                  int is_bf16, int quant, float scale,
                                  void* stream, void* part, int bm,
                                  int splits, int per) {
  if (bs != sv::kPage || H % Hk != 0 || (quant && (!ks || !vs)))
    return (int)cudaErrorInvalidValue;
  const int nst = (MB * bs + sv::kStageKeys - 1) / sv::kStageKeys;
  if (splits < 1 || per < 1 || (splits - 1) * per >= nst ||
      splits * per < nst || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    if (quant)
      return launch_bf16<int8_t>(q, kp, vp, ks, vs, tables, lens, out, part,
                                 B, T, H, Hk, hd, MB, scale, bm, splits, per,
                                 st);
    return launch_bf16<sv::bf16>(q, kp, vp, nullptr, nullptr, tables, lens,
                                 out, part, B, T, H, Hk, hd, MB, scale, bm,
                                 splits, per, st);
  }
  if (quant)
    return launch_f32<int8_t>(q, kp, vp, ks, vs, tables, lens, out, part, B,
                              T, H, Hk, hd, MB, scale, bm, splits, per, st);
  return launch_f32<float>(q, kp, vp, nullptr, nullptr, tables, lens, out,
                           part, B, T, H, Hk, hd, MB, scale, bm, splits, per,
                           st);
}

extern "C" const char* dk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
