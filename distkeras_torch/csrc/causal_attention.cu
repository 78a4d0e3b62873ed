// Causal flash attention for training: a forward kernel, a dq kernel and
// a dk/dv kernel, on bf16 [B, T, H, hd] tensors with f32 accumulation.
// The kernels are the causal instantiations (<HD, true, false>) of
// flash_fwd_sm90.cuh (the forward) and flash_bwd_sm90.cuh (dq, dk/dv), all
// three on wgmma with TMA copies and warp specialization, whose notes set
// out their designs; pair_attention.cu instantiates the same templates
// with PAIR.
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

#include "flash_bwd_sm90.cuh"
#include "flash_fwd_sm90.cuh"

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
#define CA_DISPATCH(CALL)                          \
  switch (hd) {                                    \
    case 64: return CALL(64);                      \
    case 128: return CALL(128);                    \
    case 256: return CALL(256);                    \
    default: return (int)cudaErrorInvalidValue;    \
  }
#define CA_FWD(HD) ca::launch_fwd<HD, true, false>(a, B, (cudaStream_t)stream)
#define CA_DQ(HD)                                                          \
  ca::sm90::launch_dq<HD, true, false>(a, B, (ca::bf16*)qs, (float*)delta, \
                                       (cudaStream_t)stream)
#define CA_DKV(HD)                                                       \
  ca::sm90::launch_dkv<HD, true, false>(a, B, (ca::bf16*)qs,             \
                                        (float*)delta, prep,             \
                                        (cudaStream_t)stream)

extern "C" int dk_causal_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int T, int H, int hd,
                                       long long sb, long long st, float scale,
                                       void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  ca::Attn a = causal_args(q, k, v, T, H, sb, st, scale);
  a.out = (ca::bf16*)o;
  a.lse_out = (float*)lse;
  CA_DISPATCH(CA_FWD)
}

// qs ([B, T, H, hd] bf16) and delta ([B, H, T] f32) are scratch the
// caller allocates: the prep kernel first writes q * scale and
// rowsum(dO * O) there, for this launch and the same backward's dk/dv.
extern "C" int dk_causal_attention_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* dq, void* qs, void* delta, int B,
                                      int T, int H, int hd,
                                      long long sb, long long st, float scale,
                                      void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  ca::Attn a = causal_args(q, k, v, T, H, sb, st, scale);
  a.o = (const ca::bf16*)o;
  a.dout = (const ca::bf16*)dout;
  a.lse = (const float*)lse;
  a.dq = (ca::bf16*)dq;
  CA_DISPATCH(CA_DQ)
}

// qs and delta as for dk_causal_attention_dq: with `prep` set the prep
// kernel fills them first, without it they hold what the same backward's
// dq launch wrote
extern "C" int dk_causal_attention_dkv(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* dk, void* dv, void* qs,
                                       void* delta, int prep, int B, int T,
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
  CA_DISPATCH(CA_DKV)
}

// The dynamic shared memory a launch requests at head dim hd (nvcc's
// report gives registers and spills, not this): kernel 0 the forward, 1
// dq, 2 dk/dv; -1 for a head dim the kernels are not compiled for. The
// pair instantiations request the same (the tiles depend on hd alone).
template <int HD>
static int smem_of(int kernel) {
  switch (kernel) {
    case 0: return (int)ca::sm90::Tiles<HD>::SMEM;
    case 1: return (int)ca::sm90::DqTiles<HD>::SMEM;
    case 2: return (int)ca::sm90::DkvTiles<HD>::SMEM;
    default: return -1;
  }
}

extern "C" int dk_attention_smem(int hd, int kernel) {
  switch (hd) {
    case 64: return smem_of<64>(kernel);
    case 128: return smem_of<128>(kernel);
    case 256: return smem_of<256>(kernel);
    default: return -1;
  }
}
