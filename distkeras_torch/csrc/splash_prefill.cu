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
// T=64, H=8, Hk=2, hd=256, L=2048, bf16): the causal work is only the
// keys up to each row's diagonal — ~4 GFLOP for rows from depth 0 to
// 1984, about 4 us of tensor-core time — over ~19 MB of K/V up to the
// diagonals, about 6 us of memory time: both tiny, so the kernel is held
// back by how well its blocks fill the card and overlap loads with
// products, and by the deepest row's serial walk.
//
// Dispatch on the query dtype, explicitly. Both routes split the key axis
// the same way (the host's shape-only plan) and merge f32 partials in
// split order:
//
// - bf16 queries take the tensor-core split-K core of serve_mma.cuh
//   (splash_split_kernel, then splash_merge_kernel when the launch has
//   more than one split): 64 query rows of one (row, KV head) per block
//   read each 64-key tile once, the key range split so the deepest row
//   no longer sets the kernel's length alone, tiles past a block's last
//   query position never loaded (the splash skip), cp.async stages in a
//   two-deep ring. The source note of serve_mma.cuh says what each
//   choice does about the bound.
// - f32 queries take the FFMA split-K core of serve_f32.cuh
//   (splash_f32_split_kernel, then splash_f32_merge_kernel): the same
//   plan, skip and ring, with register-tiled f32 FMAs on the CUDA cores,
//   since the tensor cores round to bf16 or TF32 and cannot meet f32's
//   1e-5. Its source note says what bounds it and why.
//
// A launch the kernel cannot take returns a CUDA error code, which the
// wrapper raises.

#include "serve_f32.cuh"
#include "serve_mma.cuh"

template <int HD, int BM>
__global__ void __launch_bounds__(sv::kThreads)
    splash_split_kernel(const sv::bf16* __restrict__ q,
                        const sv::bf16* __restrict__ k,
                        const sv::bf16* __restrict__ v,
                        const int* __restrict__ starts,
                        sv::bf16* __restrict__ out, float* __restrict__ part,
                        int T, int H, int Hk, int ntab, float scale,
                        int splits, int per) {
  sv::split_attn<sv::bf16, HD, BM, false>(q, k, v, nullptr, nullptr, nullptr,
                                          starts, out, part, T, H, Hk, ntab,
                                          scale, splits, per);
}

template <int HD>
__global__ void __launch_bounds__(sv::kThreads)
    splash_merge_kernel(const float* __restrict__ part,
                        sv::bf16* __restrict__ out, int B, int T, int H,
                        int Hk, int splits) {
  sv::merge_partials<HD>(part, out, B, T, H, Hk, splits);
}

template <int HD, int BM>
static int launch_tc(const void* q, const void* k, const void* v,
                     const void* starts, void* out, void* part, int B, int T,
                     int H, int Hk, int ntab, float scale, int splits,
                     int per, cudaStream_t st) {
  const size_t smem = sv::smem_bytes<sv::bf16, HD, BM>(per, false);
  auto kern = splash_split_kernel<HD, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int TG = T * (H / Hk);
  const dim3 grid((TG + BM - 1) / BM, Hk, B * splits);
  kern<<<grid, sv::kThreads, smem, st>>>(
      (const sv::bf16*)q, (const sv::bf16*)k, (const sv::bf16*)v,
      (const int*)starts, (sv::bf16*)out,
      splits > 1 ? (float*)part : nullptr, T, H, Hk, ntab, scale, splits,
      per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  splash_merge_kernel<HD><<<(B * T * H + sv::kWarps - 1) / sv::kWarps,
                            sv::kThreads, 0, st>>>(
      (const float*)part, (sv::bf16*)out, B, T, H, Hk, splits);
  return (int)cudaGetLastError();
}

template <int HD>
static int launch_bm(const void* q, const void* k, const void* v,
                     const void* starts, void* out, void* part, int B, int T,
                     int H, int Hk, int ntab, float scale, int bm, int splits,
                     int per, cudaStream_t st) {
  if (bm == 16)
    return launch_tc<HD, 16>(q, k, v, starts, out, part, B, T, H, Hk, ntab,
                             scale, splits, per, st);
  if (bm == 64)
    return launch_tc<HD, 64>(q, k, v, starts, out, part, B, T, H, Hk, ntab,
                             scale, splits, per, st);
  return (int)cudaErrorInvalidValue;
}

template <int HD, int BM>
__global__ void __launch_bounds__(sf::Geo<float, HD, BM>::NT)
    splash_f32_split_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const int* __restrict__ starts,
                            float* __restrict__ out, float* __restrict__ part,
                            int T, int H, int Hk, int ntab, float scale,
                            int splits, int per) {
  sf::split_attn<float, HD, BM, false>(q, k, v, nullptr, nullptr, nullptr,
                                       starts, out, part, T, H, Hk, ntab,
                                       scale, splits, per);
}

template <int HD>
__global__ void __launch_bounds__(sf::kMergeWarps * 32)
    splash_f32_merge_kernel(const float* __restrict__ part,
                            float* __restrict__ out, int B, int T, int H,
                            int Hk, int splits) {
  sf::merge_partials<HD>(part, out, B, T, H, Hk, splits);
}

template <int HD, int BM>
static int launch_ffma(const void* q, const void* k, const void* v,
                       const void* starts, void* out, void* part, int B,
                       int T, int H, int Hk, int ntab, float scale,
                       int splits, int per, cudaStream_t st) {
  const size_t smem = sf::smem_bytes<float, HD, BM>(per, false);
  auto kern = splash_f32_split_kernel<HD, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int TG = T * (H / Hk);
  const dim3 grid((TG + BM - 1) / BM, Hk, B * splits);
  kern<<<grid, sf::Geo<float, HD, BM>::NT, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)starts,
      (float*)out, splits > 1 ? (float*)part : nullptr, T, H, Hk, ntab,
      scale, splits, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  splash_f32_merge_kernel<HD>
      <<<(B * T * H + sf::kMergeWarps - 1) / sf::kMergeWarps,
         sf::kMergeWarps * 32, 0, st>>>((const float*)part, (float*)out, B,
                                        T, H, Hk, splits);
  return (int)cudaGetLastError();
}

static int launch_f32(const void* q, const void* k, const void* v,
                      const void* starts, void* out, void* part, int B,
                      int T, int H, int Hk, int hd, int ntab, float scale,
                      int bm, int splits, int per, cudaStream_t st) {
#define DK_FFMA(HD, BM)                                                  \
  return launch_ffma<HD, BM>(q, k, v, starts, out, part, B, T, H, Hk, ntab, \
                             scale, splits, per, st)
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
extern "C" int dk_splash_prefill(const void* q, const void* k, const void* v,
                                 const void* starts, void* out, int B, int T,
                                 int H, int Hk, int hd, int L, int is_bf16,
                                 float scale, void* stream, void* part,
                                 int bm, int splits, int per) {
  if (L % sv::kPage != 0 || H % Hk != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ntab = L / sv::kPage;
  const int nst = (L + sv::kStageKeys - 1) / sv::kStageKeys;
  if (splits < 1 || per < 1 || (splits - 1) * per >= nst ||
      splits * per < nst || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  if (!is_bf16)
    return launch_f32(q, k, v, starts, out, part, B, T, H, Hk, hd, ntab,
                      scale, bm, splits, per, st);
  switch (hd) {
    case 64:
      return launch_bm<64>(q, k, v, starts, out, part, B, T, H, Hk, ntab,
                           scale, bm, splits, per, st);
    case 128:
      return launch_bm<128>(q, k, v, starts, out, part, B, T, H, Hk, ntab,
                            scale, bm, splits, per, st);
    case 256:
      return launch_bm<256>(q, k, v, starts, out, part, B, T, H, Hk, ntab,
                            scale, bm, splits, per, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
