// Pair attention of the zigzag ring: a forward kernel, a dq kernel and a
// dk/dv kernel over one chunk pair, q [B, Tq, H, hd] (arriving pre-scaled)
// against k, v [B, Tk, H, hd], bf16 with f32 accumulation, in two
// variants: the causal wedge (a chunk against itself, local positions
// q_pos >= k_pos, Tq == Tk) and the full rectangle. The kernels are the
// PAIR instantiations (<HD, CAUSAL, true>) of flash_fwd_sm90.cuh (the
// forward) and flash_bwd_sm90.cuh (dq, dk/dv and their prep pass), the
// templates causal self-attention also instantiates (causal_attention.cu):
// wgmma for every product, TMA through mbarrier rings, a producer and two
// consumer warpgroups, persistent grids. Their notes set out the designs.
//
// Replaces the Pallas TPU kernels of distkeras_tpu/ops/pallas_pair.py:
//   dk_pair_attention_fwd  <- _fwd :171 (_fwd_kernel_tri :148 wedge,
//                                        _fwd_kernel :128 rectangle)
//   dk_pair_attention_dq   <- _bwd_impl :403 (_dq_kernel_tri :301,
//                                             _dq_kernel :281)
//   dk_pair_attention_dkv  <- _bwd_impl :403 (_dkv_kernel_tri :380,
//                                             _dkv_kernel :359)
// Same function and the same roundings: o normalized within the pair and
// lse = m + log(max(l, 1e-30)) returned [B, Tq, H] f32 (not
// lane-replicated); q used as given, so dQ is the gradient of the
// pre-scaled q and is not rescaled; the lse cotangent folded into delta
// by the backward's prep pass, dS = P * (dP - (delta - dlse)); P cast to
// bf16 before P V and dV, dS before dQ and dK.
//
// What bounds it on the H100: operations for the rectangle (at the
// flagship's ring chunk, [8, 1024, 8, 256], ~500 FLOPs per byte), bytes
// for the wedge at that shape (half the products over the same traffic).
// The TPU enumerates the wedge's (i, j) tiles into scalar-prefetched
// index vectors; here a work item's loop bounds skip the upper triangle.

#include "flash_bwd_sm90.cuh"
#include "flash_fwd_sm90.cuh"

// a pair: q pre-scaled, its own strides; k and v share theirs; lse and
// dlse [B, Tq, H]
static ca::Attn pair_args(const void* q, const void* k, const void* v,
                          int Tq, int Tk, int H, long long qsb, long long qst,
                          long long ksb, long long kst) {
  ca::Attn a = {};
  a.q = (const ca::bf16*)q;
  a.k = (const ca::bf16*)k;
  a.v = (const ca::bf16*)v;
  a.s.Tq = Tq;
  a.s.Tk = Tk;
  a.s.H = H;
  a.s.qsb = qsb;
  a.s.qst = qst;
  a.s.ksb = ksb;
  a.s.kst = kst;
  a.s.lsb = (long long)Tq * H;
  a.s.lsh = 1;
  a.s.lst = H;
  a.s.scale = 1.f;
  return a;
}

static bool bad_shape(int B, int Tq, int Tk, int H, int causal) {
  return B < 1 || Tq < 1 || Tk < 1 || H < 1 || (causal && Tq != Tk);
}

// one instantiation per head dimension and variant
#define PAIR_DISPATCH(CALL)                                         \
  switch (hd) {                                                     \
    case 64: return causal ? CALL(64, true) : CALL(64, false);      \
    case 128: return causal ? CALL(128, true) : CALL(128, false);   \
    case 256: return causal ? CALL(256, true) : CALL(256, false);   \
    default: return (int)cudaErrorInvalidValue;                     \
  }
#define PAIR_FWD(HD, C) \
  ca::launch_fwd<HD, C, true>(a, B, (cudaStream_t)stream)
#define PAIR_DQ(HD, C)                                            \
  ca::sm90::launch_dq<HD, C, true>(a, B, nullptr, (float*)delta,  \
                                   (cudaStream_t)stream)
#define PAIR_DKV(HD, C)                                                  \
  ca::sm90::launch_dkv<HD, C, true>(a, B, nullptr, (float*)delta, prep,  \
                                    (cudaStream_t)stream)

extern "C" int dk_pair_attention_fwd(const void* q, const void* k,
                                     const void* v, void* o, void* lse, int B,
                                     int Tq, int Tk, int H, int hd, int causal,
                                     long long qsb, long long qst,
                                     long long ksb, long long kst,
                                     void* stream) {
  if (bad_shape(B, Tq, Tk, H, causal)) return (int)cudaErrorInvalidValue;
  ca::Attn a = pair_args(q, k, v, Tq, Tk, H, qsb, qst, ksb, kst);
  a.out = (ca::bf16*)o;
  a.lse_out = (float*)lse;
  PAIR_DISPATCH(PAIR_FWD)
}

// delta ([B, Tq, H] f32) is scratch the caller allocates: the prep kernel
// first writes rowsum(dO * O) - dlse there, for this launch and the same
// backward's dk/dv.
extern "C" int dk_pair_attention_dq(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const void* lse,
                                    const void* dlse, void* dq, void* delta,
                                    int B, int Tq, int Tk, int H, int hd,
                                    int causal, long long qsb, long long qst,
                                    long long ksb, long long kst,
                                    void* stream) {
  if (bad_shape(B, Tq, Tk, H, causal)) return (int)cudaErrorInvalidValue;
  ca::Attn a = pair_args(q, k, v, Tq, Tk, H, qsb, qst, ksb, kst);
  a.o = (const ca::bf16*)o;
  a.dout = (const ca::bf16*)dout;
  a.lse = (const float*)lse;
  a.dlse = (const float*)dlse;
  a.dq = (ca::bf16*)dq;
  PAIR_DISPATCH(PAIR_DQ)
}

// delta as for dk_pair_attention_dq: with `prep` set the prep kernel fills
// it first, without it it holds what the same backward's dq launch wrote
// (from the same o, dO and dlse)
extern "C" int dk_pair_attention_dkv(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* lse,
                                     const void* dlse, void* dk, void* dv,
                                     void* delta, int prep, int B, int Tq,
                                     int Tk, int H, int hd, int causal,
                                     long long qsb, long long qst,
                                     long long ksb, long long kst,
                                     void* stream) {
  if (bad_shape(B, Tq, Tk, H, causal)) return (int)cudaErrorInvalidValue;
  ca::Attn a = pair_args(q, k, v, Tq, Tk, H, qsb, qst, ksb, kst);
  a.o = (const ca::bf16*)o;
  a.dout = (const ca::bf16*)dout;
  a.lse = (const float*)lse;
  a.dlse = (const float*)dlse;
  a.dk = (ca::bf16*)dk;
  a.dv = (ca::bf16*)dv;
  PAIR_DISPATCH(PAIR_DKV)
}
