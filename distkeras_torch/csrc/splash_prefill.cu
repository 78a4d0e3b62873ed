// Splash-style chunked-prefill causal attention over a contiguous
// per-row K/V view (the slot cache, or the paged path's gathered view).
//
// Replaces the Pallas TPU kernel distkeras_tpu/ops/splash_prefill.py:
// splash_prefill_attention (kernel body _kernel). Same function: a
// T-token chunk per row attends keys at positions <= starts[b] + t,
// KV tiles past the diagonal skipped outright, GQA grouped natively,
// online softmax in f32.
//
// What bounds it on the H100, at the main path's shapes (B=8 rows,
// T=64, H=8, Hk=2, hd=256, L=2048, bf16): the dense reference reads
// 8 x 2048 x 2 x 256 x 2 B x 2 = 33.5 MB, but the causal work is only
// the keys up to each row's diagonal — ~64 x 8 x (start + 64) x 256 x 4
// FLOPs per row, 0.5-4 GFLOP per row for 1-2k-token contexts, which
// puts it on the 989 TFLOP/s bf16 tensor-core peak rather than on the
// 3.35 TB/s memory rate.
//
// This first version is simple and right rather than fast: scalar f32
// FMAs and warp shuffles (no mma/wgmma, no TMA), one block per (row,
// KV head, 16 query rows), each 16-key tile staged once per block in
// shared memory, tiles past the block's last query position never
// loaded (the splash skip). chip_smoke.py reports its time beside the
// bound; tensor cores are later work.

#include "attn_common.cuh"

template <typename QT>
static int launch(const void* q, const void* k, const void* v,
                  const void* starts, void* out, int B, int T, int H, int Hk,
                  int hd, int L, float scale, cudaStream_t st) {
  const dim3 grid = dk::grid_for(B, T, H, Hk);
  const int ntab = L / dk::kTile;
#define DK_SPLASH(HD)                                                      \
  dk::attn_kernel<QT, QT, HD, false><<<grid, dk::kThreads, 0, st>>>(       \
      (const QT*)q, (const QT*)k, (const QT*)v, nullptr, nullptr, nullptr, \
      (const int*)starts, (QT*)out, T, H, Hk, ntab, scale)
  switch (hd) {
    case 64: DK_SPLASH(64); break;
    case 128: DK_SPLASH(128); break;
    case 256: DK_SPLASH(256); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DK_SPLASH
  return (int)cudaGetLastError();
}

extern "C" int dk_splash_prefill(const void* q, const void* k, const void* v,
                                 const void* starts, void* out, int B, int T,
                                 int H, int Hk, int hd, int L, int is_bf16,
                                 float scale, void* stream) {
  if (L % dk::kTile != 0 || H % Hk != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, starts, out, B, T, H, Hk, hd, L,
                                 scale, st);
  return launch<float>(q, k, v, starts, out, B, T, H, Hk, hd, L, scale, st);
}

extern "C" const char* dk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
