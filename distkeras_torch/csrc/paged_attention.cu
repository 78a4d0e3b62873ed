// Paged causal attention over the serving engine's block-pooled KV cache.
//
// Replaces the Pallas TPU kernel distkeras_tpu/ops/paged_attention.py:
// paged_attention (kernel body _kernel). Same function: T queries per
// row attend that row's block-table pages, positions <= seq_lens[b] + t,
// int8 pages dequantized in-tile with per-token f32 scales, online
// softmax in f32.
//
// What bounds it on the H100, at the main path's shapes (B=8 rows,
// H=8, Hk=2, hd=256, 16-token int8 pages, ~1k-token contexts):
// a decode tick (T=1) moves ~0.5 MB of pages per row and does ~1 MFLOP
// per row — bytes-bound (3.35 TB/s). A 64-token prefill chunk does
// 64 x 8 x ~1k x 256 x 4 = ~0.5 GFLOP per row over the same bytes —
// operations-bound against the 989 TFLOP/s bf16 tensor-core peak.
//
// This first version is simple and right rather than fast: scalar f32
// FMAs and warp shuffles (no mma/wgmma, no TMA), one block per (row,
// KV head, 16 query rows), the 16-key page staged in shared memory as
// f32 so the dequantized K/V never exists in device memory and each
// page is read once per block. Pages past the block's last query
// position are never loaded. chip_smoke.py reports its time beside the
// bound; tensor cores and split-K over pages for decode are later work.

#include "attn_common.cuh"

template <typename QT, typename KVT>
static int launch(const void* q, const void* kp, const void* vp,
                  const void* ks, const void* vs, const void* tables,
                  const void* lens, void* out, int B, int T, int H, int Hk,
                  int hd, int MB, float scale, cudaStream_t st) {
  const dim3 grid = dk::grid_for(B, T, H, Hk);
#define DK_PAGED(HD)                                                       \
  dk::attn_kernel<QT, KVT, HD, true><<<grid, dk::kThreads, 0, st>>>(       \
      (const QT*)q, (const KVT*)kp, (const KVT*)vp, (const float*)ks,      \
      (const float*)vs, (const int*)tables, (const int*)lens, (QT*)out, T, \
      H, Hk, MB, scale)
  switch (hd) {
    case 64: DK_PAGED(64); break;
    case 128: DK_PAGED(128); break;
    case 256: DK_PAGED(256); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DK_PAGED
  return (int)cudaGetLastError();
}

extern "C" int dk_paged_attention(const void* q, const void* kp,
                                  const void* vp, const void* ks,
                                  const void* vs, const void* tables,
                                  const void* lens, void* out, int B, int T,
                                  int H, int Hk, int hd, int bs, int MB,
                                  int is_bf16, int quant, float scale,
                                  void* stream) {
  if (bs != dk::kTile || H % Hk != 0 || (quant && (!ks || !vs)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    if (quant)
      return launch<__nv_bfloat16, int8_t>(q, kp, vp, ks, vs, tables, lens,
                                           out, B, T, H, Hk, hd, MB, scale,
                                           st);
    return launch<__nv_bfloat16, __nv_bfloat16>(q, kp, vp, nullptr, nullptr,
                                                tables, lens, out, B, T, H,
                                                Hk, hd, MB, scale, st);
  }
  if (quant)
    return launch<float, int8_t>(q, kp, vp, ks, vs, tables, lens, out, B, T,
                                 H, Hk, hd, MB, scale, st);
  return launch<float, float>(q, kp, vp, nullptr, nullptr, tables, lens, out,
                              B, T, H, Hk, hd, MB, scale, st);
}

extern "C" const char* dk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
