// Causal flash attention for training: a forward kernel, a dq kernel and
// a dk/dv kernel, on bf16 [B, T, H, hd] tensors with f32 accumulation.
// The kernels are the CAUSAL, non-PAIR instantiations of flash_mma.cuh,
// which sets out their design.
//
// Replaces the Pallas TPU kernels of distkeras_tpu/ops/pallas_attention.py:
//   dk_causal_attention_fwd <- _fwd :150 (_fwd_kernel :100)
//   dk_causal_attention_dq  <- _bwd :295 (_dq_kernel :193)
//   dk_causal_attention_dkv <- _bwd :295 (_dkv_kernel :240)
// Same function and the same roundings: q is scaled in f32 and cast back
// to bf16 before q k^T, dQ is scaled at the end and dK is unscaled
// because q was pre-scaled; lse is stored [B*H, T].
//
// What bounds it on the H100: operations. At the flagship shape (B=8,
// H=8, T=2048, hd=256) the exact causal work is 137 / 206 / 275 GFLOP
// for the three kernels against 268-470 MB of traffic — about 500
// FLOPs per byte, above the card's ~295 bf16 ridge point.

#include "flash_mma.cuh"

// causal self-attention: q scaled in-kernel, lse stored [B, H, T]
static ca::Attn causal_args(const void* q, const void* k, const void* v,
                            int T, int H, long long sb, long long st,
                            float scale) {
  ca::Attn a = {};
  a.q = (const ca::bf16*)q;
  a.k = (const ca::bf16*)k;
  a.v = (const ca::bf16*)v;
  a.s.Tq = a.s.Tk = T;
  a.s.H = H;
  a.s.qsb = a.s.ksb = sb;
  a.s.qst = a.s.kst = st;
  a.s.lsb = (long long)H * T;
  a.s.lsh = T;
  a.s.lst = 1;
  a.s.scale = scale;
  return a;
}

// one instantiation per head dimension the kernels are compiled for
#define CA_DISPATCH(FN)                                              \
  switch (hd) {                                                      \
    case 64: return ca::FN<64, true, false>(a, B, (cudaStream_t)stream);   \
    case 128: return ca::FN<128, true, false>(a, B, (cudaStream_t)stream); \
    case 256: return ca::FN<256, true, false>(a, B, (cudaStream_t)stream); \
    default: return (int)cudaErrorInvalidValue;                      \
  }

extern "C" int dk_causal_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int T, int H, int hd,
                                       long long sb, long long st, float scale,
                                       void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  ca::Attn a = causal_args(q, k, v, T, H, sb, st, scale);
  a.out = (ca::bf16*)o;
  a.lse_out = (float*)lse;
  CA_DISPATCH(launch_fwd)
}

extern "C" int dk_causal_attention_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* dq, int B, int T, int H, int hd,
                                      long long sb, long long st, float scale,
                                      void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  ca::Attn a = causal_args(q, k, v, T, H, sb, st, scale);
  a.o = (const ca::bf16*)o;
  a.dout = (const ca::bf16*)dout;
  a.lse = (const float*)lse;
  a.dq = (ca::bf16*)dq;
  CA_DISPATCH(launch_dq)
}

extern "C" int dk_causal_attention_dkv(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* dk, void* dv, int B, int T,
                                       int H, int hd, long long sb,
                                       long long st, float scale,
                                       void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  ca::Attn a = causal_args(q, k, v, T, H, sb, st, scale);
  a.o = (const ca::bf16*)o;
  a.dout = (const ca::bf16*)dout;
  a.lse = (const float*)lse;
  a.dk = (ca::bf16*)dk;
  a.dv = (ca::bf16*)dv;
  CA_DISPATCH(launch_dkv)
}
