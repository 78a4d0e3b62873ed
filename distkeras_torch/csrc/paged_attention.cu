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
// Dispatch on the query dtype, explicitly:
//
// - bf16 queries take the tensor-core split-K core of serve_mma.cuh
//   (paged_split_kernel, then paged_merge_kernel when the launch has
//   more than one split): mma.sync m16n8k16 for q k^T and P V, GQA on
//   the M axis, pages copied as int8 with cp.async into a two-stage ring
//   and converted on the way into the fragments, the split count chosen
//   by the host from shapes alone. The source note of serve_mma.cuh says
//   what each choice does about the bound.
// - f32 queries keep the scalar kernel of attn_common.cuh: the tensor
//   cores round to bf16 and cannot meet f32's 1e-5.
//
// A launch the kernel cannot take returns a CUDA error code, which the
// wrapper raises.

#include "attn_common.cuh"
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

template <typename KVT>
static int launch_f32(const void* q, const void* kp, const void* vp,
                      const void* ks, const void* vs, const void* tables,
                      const void* lens, void* out, int B, int T, int H,
                      int Hk, int hd, int MB, float scale, cudaStream_t st) {
  const dim3 grid = dk::grid_for(B, T, H, Hk);
#define DK_PAGED(HD)                                                        \
  dk::attn_kernel<KVT, HD, true><<<grid, dk::kThreads, 0, st>>>(     \
      (const float*)q, (const KVT*)kp, (const KVT*)vp, (const float*)ks,    \
      (const float*)vs, (const int*)tables, (const int*)lens, (float*)out, \
      T, H, Hk, MB, scale)
  switch (hd) {
    case 64: DK_PAGED(64); break;
    case 128: DK_PAGED(128); break;
    case 256: DK_PAGED(256); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DK_PAGED
  return (int)cudaGetLastError();
}

// `part`, `bm`, `splits` and `per` serve bf16 queries: the f32 scratch
// the wrapper sized for `splits` partials (null with one split), rows per
// block (16 or 64) and 64-key stages per split. f32 queries ignore them.
extern "C" int dk_paged_attention(const void* q, const void* kp,
                                  const void* vp, const void* ks,
                                  const void* vs, const void* tables,
                                  const void* lens, void* out, int B, int T,
                                  int H, int Hk, int hd, int bs, int MB,
                                  int is_bf16, int quant, float scale,
                                  void* stream, void* part, int bm,
                                  int splits, int per) {
  if (bs != dk::kTile || H % Hk != 0 || (quant && (!ks || !vs)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    const int nst = (MB * bs + sv::kStageKeys - 1) / sv::kStageKeys;
    if (splits < 1 || per < 1 || (splits - 1) * per >= nst ||
        splits * per < nst || (splits > 1 && !part))
      return (int)cudaErrorInvalidValue;
    if (quant)
      return launch_bf16<int8_t>(q, kp, vp, ks, vs, tables, lens, out, part,
                                 B, T, H, Hk, hd, MB, scale, bm, splits, per,
                                 st);
    return launch_bf16<sv::bf16>(q, kp, vp, nullptr, nullptr, tables, lens,
                                 out, part, B, T, H, Hk, hd, MB, scale, bm,
                                 splits, per, st);
  }
  if (quant)
    return launch_f32<int8_t>(q, kp, vp, ks, vs, tables, lens, out, B, T, H,
                              Hk, hd, MB, scale, st);
  return launch_f32<float>(q, kp, vp, nullptr, nullptr, tables, lens, out, B,
                           T, H, Hk, hd, MB, scale, st);
}

extern "C" const char* dk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
