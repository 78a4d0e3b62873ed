// Shared device code of the two serving attention kernels
// (paged_attention.cu, splash_prefill.cu) for f32 queries — bf16 queries
// take the tensor-core core of serve_mma.cuh, since the tensor cores
// round to bf16 and the f32 path is held to 1e-5: one block per (batch
// row b, KV head h, tile of kRows query rows), a loop inside the block
// over kTile-key tiles of K/V, f32 online softmax, scalar FMAs.
//
// Query row r of KV head h is query head h * G + g at absolute position
// starts[b] + t, where r = t * G + g (the GQA group rides the row axis,
// so K/V is never repeated). Each warp owns kRowsPerWarp rows; each lane
// owns HD / 32 channels of every row (interleaved in vectors of up to 4
// floats so shared-memory reads are conflict-free). A score is one
// warp-wide butterfly sum, which leaves the identical value in every
// lane, so the softmax state (m, l) is replicated per lane and every
// branch on it is warp-uniform.
//
// The K/V tile is staged in shared memory as f32 (int8 pages are
// dequantized there with their per-token f32 scales and kept in f32).
// Scores, the running max/sum, the accumulator and the output
// acc / max(l, 1e-30) are f32. Keys past a row's
// position are masked; tiles past the block's last query position are
// skipped; rows past T * G are neither read nor written.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dk {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTile = 16;                     // keys per K/V tile
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// channel owned by `lane` in slot j (vectors of VW floats, interleaved
// across the warp: lane l holds [c * 32 * VW + l * VW, ... + VW))
template <int HD>
struct Lanes {
  static constexpr int DPL = HD / 32;
  static constexpr int VW = DPL < 4 ? DPL : 4;
  __device__ __forceinline__ static int chan(int lane, int j) {
    return (j / VW) * 32 * VW + lane * VW + (j % VW);
  }
};

// Stage one kTile x HD tile of K or V into shared memory as f32.
// `base` points at key 0, channel 0 of this KV head; keys are
// `key_stride` elements apart. With `scales` (int8 pages) each key's
// values are multiplied by its f32 scale.
template <typename KVT, int HD>
__device__ __forceinline__ void load_tile(float (*dst)[HD],
                                          const KVT* __restrict__ base,
                                          size_t key_stride,
                                          const float* __restrict__ scales,
                                          size_t scale_stride) {
  constexpr int VEC = 16 / sizeof(KVT);  // one 16-byte load
  constexpr int NV = kTile * HD / VEC;
  for (int v = threadIdx.x; v < NV; v += kThreads) {
    const int key = (v * VEC) / HD;
    const int d0 = (v * VEC) % HD;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(base + key * key_stride + d0);
    const KVT* e = reinterpret_cast<const KVT*>(&raw);
    if (scales != nullptr) {
      const float s = scales[key * scale_stride];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        dst[key][d0 + i] = to_f32(e[i]) * s;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[key][d0 + i] = to_f32(e[i]);
    }
  }
}

// PAGED: tile j of row b is physical page tables[b * ntab + j] of a
// [P, kTile, Hk, HD] pool. Otherwise tile j is keys [j * kTile, +kTile)
// of a contiguous [B, L, Hk, HD] view (ntab = L / kTile).
template <typename KVT, int HD, bool PAGED>
__global__ void __launch_bounds__(kThreads)
    attn_kernel(const float* __restrict__ q, const KVT* __restrict__ kc,
                const KVT* __restrict__ vc, const float* __restrict__ ksc,
                const float* __restrict__ vsc,
                const int* __restrict__ tables,
                const int* __restrict__ starts, float* __restrict__ out,
                int T, int H, int Hk, int ntab, float scale) {
  using LN = Lanes<HD>;
  constexpr int DPL = LN::DPL;
  __shared__ __align__(16) float ks[kTile][HD];
  __shared__ __align__(16) float vs[kTile][HD];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / Hk;
  const int TG = T * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int start = starts[b];
  const int r_first = blockIdx.z * kRows;
  const int r_last = min(r_first + kRows, TG) - 1;
  // the causal bound of the whole block: tiles wholly past its last
  // query position contribute nothing and are never loaded
  const int last_pos = start + r_last / G;
  const int ntiles = min(ntab, last_pos / kTile + 1);

  float qv[kRowsPerWarp][DPL];
  float acc[kRowsPerWarp][DPL];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  int qpos[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r_first + warp * kRowsPerWarp + i;
    live[i] = r < TG;
    const int t = live[i] ? r / G : 0;
    const int g = live[i] ? r - t * G : 0;
    qpos[i] = start + t;
    m[i] = -INFINITY;
    l[i] = 0.f;
    const float* qr = q + ((size_t)(b * T + t) * H + h * G + g) * HD;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      qv[i][j] = live[i] ? qr[LN::chan(lane, j)] : 0.f;
      acc[i][j] = 0.f;
    }
  }

  const size_t key_stride = (size_t)Hk * HD;
  for (int j = 0; j < ntiles; ++j) {
    size_t kv_off, sc_off = 0;
    if (PAGED) {
      const size_t page = (size_t)tables[(size_t)b * ntab + j];
      kv_off = page * kTile * key_stride + (size_t)h * HD;
      sc_off = page * kTile * Hk + h;
    } else {
      kv_off = ((size_t)b * ntab * kTile + (size_t)j * kTile) * key_stride +
               (size_t)h * HD;
    }
    __syncthreads();  // every warp is done with the previous tile
    load_tile<KVT, HD>(ks, kc + kv_off, key_stride,
                       ksc ? ksc + sc_off : nullptr, Hk);
    load_tile<KVT, HD>(vs, vc + kv_off, key_stride,
                       vsc ? vsc + sc_off : nullptr, Hk);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (!live[i]) continue;  // warp-uniform: rows belong to warps
      float s[kTile];
      float mx = m[i];
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        float part = 0.f;
#pragma unroll
        for (int jj = 0; jj < DPL; ++jj)
          part += qv[i][jj] * ks[k][LN::chan(lane, jj)];
        part = warp_sum(part);
        s[k] = (j * kTile + k <= qpos[i]) ? part * scale : -INFINITY;
        mx = fmaxf(mx, s[k]);
      }
      if (mx == -INFINITY) continue;  // nothing visible to this row yet
      const float corr = expf(m[i] - mx);  // 0 on the row's first tile
      l[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < DPL; ++jj) acc[i][jj] *= corr;
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const float p = expf(s[k] - mx);  // masked keys: exp(-inf) = 0
        l[i] += p;
#pragma unroll
        for (int jj = 0; jj < DPL; ++jj)
          acc[i][jj] += p * vs[k][LN::chan(lane, jj)];
      }
      m[i] = mx;
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (!live[i]) continue;
    const int r = r_first + warp * kRowsPerWarp + i;
    const int t = r / G;
    const int g = r - t * G;
    float* orow = out + ((size_t)(b * T + t) * H + h * G + g) * HD;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DPL; ++jj)
      orow[LN::chan(lane, jj)] = acc[i][jj] / denom;
  }
}

// grid of one launch: (B, Hk, ceil(T * G / kRows)) blocks of kThreads
inline dim3 grid_for(int B, int T, int H, int Hk) {
  const int TG = T * (H / Hk);
  return dim3(B, Hk, (TG + kRows - 1) / kRows);
}

}  // namespace dk
