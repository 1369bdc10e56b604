// Flash attention backward for Hopper (sm_90a): dq, dk and dv of the forward
// in flash_attention.cu from q, k, v, its output o, its row log-sum-exp lse
// and the output's cotangent do, the attention gradient of the LM training
// path.
//
// Replaces no TPU kernel: the JAX package trains through jnp attention
// (src/repro/models/layers.py, blockwise_sdpa above 2048 tokens), whose
// gradient XLA derives; its Pallas kernel (flash_attention.py:123) has no
// backward.  This kernel computes that gradient of the same function (GQA,
// causal, sliding window, tanh softcap, the kv tail masked), recomputing
// P tile by tile from lse, so that no (Sq, Skv) score matrix is ever held:
// its memory is that of its inputs and outputs, as the reference's
// blockwise path bounds it.
//
// The FlashAttention-2 split, written for this card (nothing carried over
// from a TPU block structure):
//  * D = rowsum(do * o) in float32, one warp a row (fa_bwd_delta).
//  * dk and dv (fa_bwd_dkdv_*): one CTA per (kv tile, kv head, batch row).
//    It loops over the G query heads of its group and, for each, over the
//    q tiles the mask lets reach the tile (causal from the diagonal down, a
//    window up to key + window - 1, all of them without either).  A step
//    recomputes S = q.k^T * scale (softcap: cap * tanh(s / cap)), forms
//    P = exp(S - lse) with 0 at masked entries and past Sq or Skv, adds
//    P^T.do to dv, forms dP = do.v^T and dS = P * (dP - D) (times
//    1 - tanh^2 under a softcap) and adds dS^T.q * scale to dk.  The G
//    heads' sums stay in the CTA's registers.
//  * dq (fa_bwd_dq_*): one CTA per (q tile, head, batch row), heavy causal
//    tiles first, looping over the kv tiles of the forward's range; it
//    recomputes S, P, dP and dS the same way and adds dS.k * scale to dq.
//  * Deterministic: every sum is taken in one fixed order in one CTA; no
//    atomics, so two calls give the same bits.
//  * Head dims: each CTA accumulates one slice of columns [c0, c0 + SW),
//    SW at most 128 (dk and dv of a warp's 16 rows take SW floats a
//    thread: 256 columns, with S and dP, would not fit in 255 registers;
//    at 128 the dk/dv kernel takes 240, the build's log); q.k^T and do.v^T
//    reduce over the full head dim, in chunks of SW columns staged through
//    shared memory, zero past hd.  A head dim of one slice (32, 64, 128)
//    keeps k and v (dk/dv) or q and do (dq) in shared memory for the CTA's
//    life and double-buffers the tiles it loops over by cp.async; a wider
//    one (256; any multiple of 32 above it) is launched once per slice of
//    a built width (128, 64, 32), each stage loaded synchronously.
//
// What bounds it on this card: 10 * hd FLOPs a kept (q, k) pair (S, dP,
// dV, dK and dQ, 2 a multiply-add; S and dP are computed twice, once in
// each pass) against q, k, v, o, do read and dq, dk, dv written: at the
// internlm2-1.8b shape (B=8, H=16, KV=8, S=4096, hd=128, causal) 1.37e12
// FLOPs against 0.6 GB, so the tensor-core rate bounds it (1.39 ms at
// 989 TFLOP/s bf16).
//
// bfloat16: the tensor cores, mma.sync.m16n8k16 (bf16 in, float32
// accumulate), 4 warps of 16 rows (kv rows in dk/dv, q rows in dq),
// fragments by ldmatrix from 16-B padded rows (fa_common.cuh).  Two
// roundings to bf16, both in registers as the next product's A fragment:
// P before P^T.do (dv), and dS before dS^T.q (dk) and dS.k (dq); every sum
// is float32, and S and dP are float32 from the products.  D takes the
// bf16 output o, as FlashAttention-2 does.
// float32: the CUDA cores in full float32 (no TF32), 256 threads as a
// 16 x 16 grid of 4 x 4 register tiles out of shared memory, q pre-scaled
// in shared memory, P and dS staged through shared memory.

#include "fa_common.cuh"

namespace {

using fa::kLog2e;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                     // (B, H, Sq), natural log
  float* delta;                         // (B, H, Sq): rowsum(do * o)
  void* dq;
  void* dk;
  void* dv;
  int H, KV, Sq, Skv;
  int hd, c0, nch;                      // full head dim; this launch's
                                        // columns [c0, c0 + SW); q.k and
                                        // do.v chunks of SW columns
  // strides of (b, h, s) in elements
  int64_t qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  float scale, softcap;
  int causal, window;                   // window <= 0: no window
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// whether the mask keeps (q row i, key j)
__device__ __forceinline__ bool kept(const BwdArgs& a, int i, int j) {
  return i < a.Sq && j < a.Skv && (!a.causal || j <= i)
         && (a.window <= 0 || i - j < a.window);
}

// q tiles [begin, end) of `bq` rows that reach kv tile [k0, k0 + bk)
__device__ __forceinline__ void q_range(const BwdArgs& a, int k0, int bk,
                                        int bq, int* begin, int* end) {
  const int nq = (a.Sq + bq - 1) / bq;
  *begin = a.causal ? min(nq, k0 / bq) : 0;
  *end = a.window > 0 ? min(nq, (k0 + bk - 1 + a.window - 1) / bq + 1) : nq;
}

// D = rowsum(do * o), one warp a (b, h, i) row
template <typename T>
__global__ void __launch_bounds__(128)
fa_bwd_delta(const BwdArgs a, int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int i = row % a.Sq, bh = row / a.Sq, h = bh % a.H, b = bh / a.H;
  const T* o = static_cast<const T*>(a.o) + b * a.os[0] + h * a.os[1]
               + i * a.os[2];
  const T* d = static_cast<const T*>(a.dout) + b * a.dos[0] + h * a.dos[1]
               + i * a.dos[2];
  float acc = 0.f;
  for (int c = lane; c < a.hd; c += 32)
    acc = fmaf(to_f(o[c]), to_f(d[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

// -- float32: CUDA cores -------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kB = 64;             // q and kv rows of a tile
constexpr int kPLD = kB + 1;       // P and dS row stride

template <int SW>
constexpr int smem_bytes() {
  return (4 * kB * (SW + 1) + 2 * kB * kPLD + 2 * kB) * (int)sizeof(float);
}

// rows [r_0, r_0 + kB) and columns [col, col + SW) of a (b, h) slab, zero
// past `rows` and hd; times `mul`
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int64_t stride, int r_0, int rows,
                                          int col, int hd, int sw, float mul) {
  for (int e = threadIdx.x; e < kB * sw; e += kThreads) {
    const int r = e / sw, d = e % sw;
    dst[r * ld + d] = r_0 + r < rows && col + d < hd
                          ? src[(r_0 + r) * stride + col + d] * mul : 0.f;
  }
}

template <int SW>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_f32(const BwdArgs a) {
  constexpr int LD = SW + 1, CJ = SW / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                 // kB x LD
  float* Vs = Ks + kB * LD;
  float* Qs = Vs + kB * LD;         // q * scale
  float* dOs = Qs + kB * LD;
  float* Ps = dOs + kB * LD;        // kB x kPLD: P^T, kv rows
  float* dSs = Ps + kB * kPLD;      // dS^T
  float* Ls = dSs + kB * kPLD;      // lse
  float* Ds = Ls + kB;              // D

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kB, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  int qt_begin, qt_end;
  q_range(a, k0, kB, kB, &qt_begin, &qt_end);
  const int nqt = max(0, qt_end - qt_begin);
  const int nsteps = G * nqt;
  const float* kp = static_cast<const float*>(a.k) + b * a.ks[0]
                    + kvh * a.ks[1];
  const float* vp = static_cast<const float*>(a.v) + b * a.vs[0]
                    + kvh * a.vs[1];

  auto load_q = [&](int s, int col) {
    const int h = kvh * G + s / nqt, q0 = (qt_begin + s % nqt) * kB;
    load_tile(Qs, LD, static_cast<const float*>(a.q) + b * a.qs[0]
              + h * a.qs[1], a.qs[2], q0, a.Sq, col, a.hd, SW, a.scale);
    load_tile(dOs, LD, static_cast<const float*>(a.dout) + b * a.dos[0]
              + h * a.dos[1], a.dos[2], q0, a.Sq, col, a.hd, SW, 1.f);
    const int64_t base = ((int64_t)b * a.H + h) * a.Sq;
    for (int i = tid; i < kB; i += kThreads) {
      Ls[i] = q0 + i < a.Sq ? a.lse[base + q0 + i] : 0.f;
      Ds[i] = q0 + i < a.Sq ? a.delta[base + q0 + i] : 0.f;
    }
  };
  auto load_kv = [&](int col) {
    load_tile(Ks, LD, kp, a.ks[2], k0, a.Skv, col, a.hd, SW, 1.f);
    load_tile(Vs, LD, vp, a.vs[2], k0, a.Skv, col, a.hd, SW, 1.f);
  };

  float dk[4][CJ], dv[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) dk[i][c] = dv[i][c] = 0.f;

  const bool one = a.nch == 1;
  if (one) load_kv(0);
  for (int s = 0; s < nsteps; ++s) {
    const int q0 = (qt_begin + s % nqt) * kB;
    float sT[4][4], pT[4][4];        // kv rows ty + 16 i, q cols tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sT[i][j] = pT[i][j] = 0.f;
    for (int ch = 0; ch < (one ? 1 : a.nch); ++ch) {
      __syncthreads();              // the last step's (chunk's) reads done
      if (!one) load_kv(ch * SW);
      load_q(s, ch * SW);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < SW; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * LD + d];
          vv[i] = Vs[(ty + 16 * i) * LD + d];
          qv[i] = Qs[(tx + 16 * i) * LD + d];
          ov[i] = dOs[(tx + 16 * i) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sT[i][j] = fmaf(kv[i], qv[j], sT[i][j]);
            pT[i][j] = fmaf(vv[i], ov[j], pT[i][j]);
          }
      }
    }
    if (!one) {                     // the slice's q and do for dk and dv
      __syncthreads();
      load_q(s, a.c0);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + ty + 16 * i, il = tx + 16 * j;
        float x = sT[i][j], f = 1.f;
        if (a.softcap > 0.f) {
          const float th = tanhf(x / a.softcap);
          x = th * a.softcap;
          f = 1.f - th * th;
        }
        const float p = kept(a, q0 + il, kj) ? expf(x - Ls[il]) : 0.f;
        Ps[(ty + 16 * i) * kPLD + il] = p;
        dSs[(ty + 16 * i) * kPLD + il] = p * (pT[i][j] - Ds[il]) * f;
      }
    __syncthreads();
#pragma unroll 4
    for (int il = 0; il < kB; ++il) {
      float pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(ty + 16 * i) * kPLD + il];
        sv[i] = dSs[(ty + 16 * i) * kPLD + il];
      }
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const float o = dOs[il * LD + tx + 16 * c];
        const float q = Qs[il * LD + tx + 16 * c];       // q * scale
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][c] = fmaf(pv[i], o, dv[i][c]);
          dk[i][c] = fmaf(sv[i], q, dk[i][c]);
        }
      }
    }
  }

  float* dkp = static_cast<float*>(a.dk) + b * a.dks[0] + kvh * a.dks[1]
               + a.c0;
  float* dvp = static_cast<float*>(a.dv) + b * a.dvs[0] + kvh * a.dvs[1]
               + a.c0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= a.Skv) continue;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      dkp[kj * a.dks[2] + tx + 16 * c] = dk[i][c];
      dvp[kj * a.dvs[2] + tx + 16 * c] = dv[i][c];
    }
  }
}

template <int SW>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_f32(const BwdArgs a) {
  constexpr int LD = SW + 1, CJ = SW / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // kB x LD: q * scale
  float* dOs = Qs + kB * LD;
  float* Ks = dOs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* dSs = Vs + kB * LD;        // kB x kPLD
  float* Ls = dSs + kB * kPLD;
  float* Ds = Ls + kB;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;     // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qt * kB;
  const float* qp = static_cast<const float*>(a.q) + b * a.qs[0]
                    + h * a.qs[1];
  const float* op = static_cast<const float*>(a.dout) + b * a.dos[0]
                    + h * a.dos[1];
  const float* kp = static_cast<const float*>(a.k) + b * a.ks[0]
                    + kvh * a.ks[1];
  const float* vp = static_cast<const float*>(a.v) + b * a.vs[0]
                    + kvh * a.vs[1];
  auto load_q = [&](int col) {
    load_tile(Qs, LD, qp, a.qs[2], q0, a.Sq, col, a.hd, SW, a.scale);
    load_tile(dOs, LD, op, a.dos[2], q0, a.Sq, col, a.hd, SW, 1.f);
  };
  auto load_kv = [&](int k0, int col) {
    load_tile(Ks, LD, kp, a.ks[2], k0, a.Skv, col, a.hd, SW, 1.f);
    load_tile(Vs, LD, vp, a.vs[2], k0, a.Skv, col, a.hd, SW, 1.f);
  };
  const int64_t base = ((int64_t)b * a.H + h) * a.Sq;
  for (int i = tid; i < kB; i += kThreads) {
    Ls[i] = q0 + i < a.Sq ? a.lse[base + q0 + i] : 0.f;
    Ds[i] = q0 + i < a.Sq ? a.delta[base + q0 + i] : 0.f;
  }
  int kt_begin, kt_end;
  fa::kv_range(a.Sq, a.Skv, a.causal, a.window, q0, kB, kB, &kt_begin,
               &kt_end);

  float dq[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) dq[i][c] = 0.f;

  const bool one = a.nch == 1;
  if (one) load_q(0);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kB;
    float s[4][4], dp[4][4];         // q rows ty + 16 i, kv cols tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int ch = 0; ch < (one ? 1 : a.nch); ++ch) {
      __syncthreads();              // the last tile's (chunk's) reads done
      if (!one) load_q(ch * SW);
      load_kv(k0, one ? 0 : ch * SW);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < SW; ++d) {
        float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = Qs[(ty + 16 * i) * LD + d];
          ov[i] = dOs[(ty + 16 * i) * LD + d];
          kv[i] = Ks[(tx + 16 * i) * LD + d];
          vv[i] = Vs[(tx + 16 * i) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }
    }
    if (!one) {                     // k's slice for dq
      __syncthreads();
      load_tile(Ks, LD, kp, a.ks[2], k0, a.Skv, a.c0, a.hd, SW, 1.f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int il = ty + 16 * i, kj = k0 + tx + 16 * j;
        float x = s[i][j], f = 1.f;
        if (a.softcap > 0.f) {
          const float th = tanhf(x / a.softcap);
          x = th * a.softcap;
          f = 1.f - th * th;
        }
        const float p = kept(a, q0 + il, kj) ? expf(x - Ls[il]) : 0.f;
        dSs[il * kPLD + tx + 16 * j] = p * (dp[i][j] - Ds[il]) * f;
      }
    __syncthreads();
#pragma unroll 4
    for (int jl = 0; jl < kB; ++jl) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * kPLD + jl];
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const float kk = Ks[jl * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(sv[i], kk, dq[i][c]);
      }
    }
  }

  float* dqp = static_cast<float*>(a.dq) + b * a.dqs[0] + h * a.dqs[1]
               + a.c0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < CJ; ++c)
      dqp[qi * a.dqs[2] + tx + 16 * c] = dq[i][c] * a.scale;
  }
}

template <int SW>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<SW>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv_f32<SW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      fa_bwd_dq_f32<SW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dkdv_f32<SW><<<dim3((a.Skv + kB - 1) / kB, a.KV, B), kThreads, smem,
                        stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dq_f32<SW><<<dim3((a.Sq + kB - 1) / kB, a.H, B), kThreads, smem,
                      stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace f32

// -- bfloat16: tensor cores (mma.sync m16n8k16) ---------------------------------

namespace bf16 {

using bf16_t = __nv_bfloat16;
using fa::c_to_a;
using fa::cp_async_16;
using fa::cp_async_commit;
using fa::cp_async_wait;
using fa::ex2;
using fa::ldsm_x4;
using fa::ldsm_x4_trans;
using fa::mma;
using fa::pack;
using fa::smem_u32;

constexpr int kThreads = 128;      // 4 warps of 16 rows

// dk/dv: 64 kv rows a CTA; q tiles of BQ rows, double-buffered
template <int SW>
struct KvTile {
  static constexpr int BKV = 64;
  static constexpr int BQ = SW == 128 ? 32 : 64;
  static constexpr int LDS = SW + 8;               // padded row, in bf16
  static constexpr int smem_bytes =
      (2 * BKV + 4 * BQ) * LDS * (int)sizeof(bf16_t)
      + 4 * BQ * (int)sizeof(float);
};

// dq: 64 q rows a CTA; kv tiles of BK rows, double-buffered
template <int SW>
struct QTile {
  static constexpr int BQ = 64;
  static constexpr int BK = SW == 128 ? 32 : 64;
  static constexpr int LDS = SW + 8;
  static constexpr int smem_bytes =
      (2 * BQ + 4 * BK) * LDS * (int)sizeof(bf16_t)
      + 2 * BQ * (int)sizeof(float);
};

// s' = s * scale * log2(e) (softcap: tanh(s * scale / cap) * cap * log2(e),
// f = 1 - tanh^2), the forward's log2-unit score
template <bool CAP>
__device__ __forceinline__ float score2(const BwdArgs& a, float s, float* f) {
  if constexpr (CAP) {
    const float th = tanhf(s * a.scale / a.softcap);
    *f = 1.f - th * th;
    return th * a.softcap * kLog2e;
  } else {
    *f = 1.f;
    return s * (a.scale * kLog2e);
  }
}

template <int SW, bool CAP>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_bf16(const BwdArgs a) {
  using T = KvTile<SW>;
  constexpr int BKV = T::BKV, BQ = T::BQ, LDS = T::LDS;
  constexpr int ROW = LDS * (int)sizeof(bf16_t);   // bytes a smem row
  constexpr int NQ = BQ / 8;        // n8 tiles of a step's q rows
  constexpr int DT = SW / 8;        // n8 tiles of the slice
  constexpr int CH = SW / 8;        // 16-B chunks in a row
  constexpr int RP = kThreads / CH;
  static_assert(BKV % RP == 0 && BQ % RP == 0, "");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* Ks = reinterpret_cast<bf16_t*>(smem_raw);   // BKV x LDS
  bf16_t* Vs = Ks + BKV * LDS;                        // BKV x LDS
  bf16_t* Qs = Vs + BKV * LDS;                        // 2 x BQ x LDS
  bf16_t* dOs = Qs + 2 * BQ * LDS;                    // 2 x BQ x LDS
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * LDS);  // 2 x BQ:
  float* Ds = Ls + 2 * BQ;                            // lse log2(e); D

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BKV, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  int qt_begin, qt_end;
  q_range(a, k0, BKV, BQ, &qt_begin, &qt_end);
  const int nqt = max(0, qt_end - qt_begin);
  const int nsteps = G * nqt;       // (head, q tile) pairs, head-major
  const bf16_t* kp = static_cast<const bf16_t*>(a.k) + b * a.ks[0]
                     + kvh * a.ks[1];
  const bf16_t* vp = static_cast<const bf16_t*>(a.v) + b * a.vs[0]
                     + kvh * a.vs[1];
  const int r0 = tid / CH, cc = tid % CH;

  // K's and V's columns [col, col + SW), zero past Skv and hd
  auto load_kv = [&](int col) {
    const bool in = col + cc * 8 < a.hd;
    for (int r = r0; r < BKV; r += RP) {
      const bool ok = in && k0 + r < a.Skv;
      const int64_t row = k0 + r;
      cp_async_16(smem_u32(Ks + r * LDS + cc * 8),
                  kp + (ok ? row * a.ks[2] + col : 0) + cc * 8, ok);
      cp_async_16(smem_u32(Vs + r * LDS + cc * 8),
                  vp + (ok ? row * a.vs[2] + col : 0) + cc * 8, ok);
    }
  };
  // step s's q and do columns [col, col + SW) and its lse and D, stage st
  auto load_q = [&](int s, int st, int col) {
    const int h = kvh * G + s / nqt, q0 = (qt_begin + s % nqt) * BQ;
    const bf16_t* qp = static_cast<const bf16_t*>(a.q) + b * a.qs[0]
                       + h * a.qs[1];
    const bf16_t* op = static_cast<const bf16_t*>(a.dout) + b * a.dos[0]
                       + h * a.dos[1];
    const bool in = col + cc * 8 < a.hd;
    for (int r = r0; r < BQ; r += RP) {
      const bool ok = in && q0 + r < a.Sq;
      const int64_t row = q0 + r;
      const int at = (st * BQ + r) * LDS + cc * 8;
      cp_async_16(smem_u32(Qs + at),
                  qp + (ok ? row * a.qs[2] + col : 0) + cc * 8, ok);
      cp_async_16(smem_u32(dOs + at),
                  op + (ok ? row * a.dos[2] + col : 0) + cc * 8, ok);
    }
    const int64_t base = ((int64_t)b * a.H + h) * a.Sq;
    for (int i = tid; i < BQ; i += kThreads) {
      const bool ok = q0 + i < a.Sq;
      Ls[st * BQ + i] = ok ? a.lse[base + q0 + i] * kLog2e : 0.f;
      Ds[st * BQ + i] = ok ? a.delta[base + q0 + i] : 0.f;
    }
  };

  // K and V as A (the warp's 16 kv rows); q and do as B of S^T and dP^T
  // (n = q rows), and as B of dK and dV (k = q rows, transposed)
  const uint32_t k_a = fa::lane_a(Ks + 16 * w * LDS, LDS, lane);
  const uint32_t v_a = fa::lane_a(Vs + 16 * w * LDS, LDS, lane);
  const uint32_t q_b = fa::lane_b(Qs, LDS, lane);
  const uint32_t o_b = fa::lane_b(dOs, LDS, lane);
  const uint32_t q_t = fa::lane_t(Qs, LDS, lane);
  const uint32_t o_t = fa::lane_t(dOs, LDS, lane);

  // S^T += K.Q^T and dP^T += V.dO^T over the SW columns in shared memory
  auto sdp = [&](float (&sT)[NQ][4], float (&pT)[NQ][4], uint32_t so) {
#pragma unroll
    for (int kk = 0; kk < SW / 16; ++kk) {
      uint32_t kf[4], vf[4];
      ldsm_x4(kf, k_a + kk * 32);
      ldsm_x4(vf, v_a + kk * 32);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t x[4];
        ldsm_x4(x, q_b + so + np * 16 * ROW + kk * 32);
        mma(sT[2 * np], kf, x[0], x[1]);
        mma(sT[2 * np + 1], kf, x[2], x[3]);
        ldsm_x4(x, o_b + so + np * 16 * ROW + kk * 32);
        mma(pT[2 * np], vf, x[0], x[1]);
        mma(pT[2 * np + 1], vf, x[2], x[3]);
      }
    }
  };

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[d][c] = dv[d][c] = 0.f;

  const bool one = a.nch == 1;
  if (one && nsteps > 0) {
    load_kv(0);
    load_q(0, 0, 0);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    const int st = one ? (s & 1) : 0;
    const uint32_t so = st * BQ * ROW;
    float sT[NQ][4], pT[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) sT[n][c] = pT[n][c] = 0.f;
    if (one) {
      if (s + 1 < nsteps) {
        load_q(s + 1, st ^ 1, 0);    // stage st ^ 1: read by step s - 1,
        cp_async_commit();           // synced below
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      sdp(sT, pT, so);
    } else {
      for (int ch = 0; ch < a.nch; ++ch) {
        __syncthreads();             // the last chunk (or step) is consumed
        load_kv(ch * SW);
        load_q(s, 0, ch * SW);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        sdp(sT, pT, 0);
      }
      __syncthreads();               // q and do's slice for dk and dv
      load_q(s, 0, a.c0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }

    // P^T = exp2(s' - lse'), masked to 0; dS^T = P^T (dP^T - D) f
    const int q0 = (qt_begin + s % nqt) * BQ;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + 16 * w + g + 8 * (c >> 1);
        const int il = 8 * n + 2 * t + (c & 1);
        float f;
        const float x = score2<CAP>(a, sT[n][c], &f);
        const float p = kept(a, q0 + il, kj)
                            ? ex2(x - Ls[st * BQ + il]) : 0.f;
        sT[n][c] = p;
        pT[n][c] = p * (pT[n][c] - Ds[st * BQ + il]) * f;
      }

    // dV += P^T.dO, dK += dS^T.Q: P and dS rounded to bf16 as A fragments
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t pa[4], da[4];
      c_to_a(pa, sT[2 * kq], sT[2 * kq + 1]);
      c_to_a(da, pT[2 * kq], pT[2 * kq + 1]);
#pragma unroll
      for (int dp = 0; dp < SW / 16; ++dp) {
        uint32_t x[4];
        ldsm_x4_trans(x, o_t + so + kq * 16 * ROW + dp * 32);
        mma(dv[2 * dp], pa, x[0], x[1]);
        mma(dv[2 * dp + 1], pa, x[2], x[3]);
        ldsm_x4_trans(x, q_t + so + kq * 16 * ROW + dp * 32);
        mma(dk[2 * dp], da, x[0], x[1]);
        mma(dk[2 * dp + 1], da, x[2], x[3]);
      }
    }
    __syncthreads();                 // stage st is free for step s + 2
  }
  cp_async_wait<0>();

  // epilogue: dk * scale and dv in bf16, rows < Skv, columns c0 + ...
  bf16_t* dkp = static_cast<bf16_t*>(a.dk) + b * a.dks[0] + kvh * a.dks[1]
                + a.c0;
  bf16_t* dvp = static_cast<bf16_t*>(a.dv) + b * a.dvs[0] + kvh * a.dvs[1]
                + a.c0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + 16 * w + g + 8 * r;
    if (kj >= a.Skv) continue;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<uint32_t*>(dkp + kj * a.dks[2] + 8 * d + 2 * t) =
          pack(dk[d][2 * r] * a.scale, dk[d][2 * r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvp + kj * a.dvs[2] + 8 * d + 2 * t) =
          pack(dv[d][2 * r], dv[d][2 * r + 1]);
    }
  }
}

template <int SW, bool CAP>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_bf16(const BwdArgs a) {
  using T = QTile<SW>;
  constexpr int BQ = T::BQ, BK = T::BK, LDS = T::LDS;
  constexpr int ROW = LDS * (int)sizeof(bf16_t);
  constexpr int NT = BK / 8;        // n8 tiles of a kv tile
  constexpr int DT = SW / 8;
  constexpr int CH = SW / 8;
  constexpr int RP = kThreads / CH;
  static_assert(BK % RP == 0 && BQ % RP == 0, "");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* Qs = reinterpret_cast<bf16_t*>(smem_raw);   // BQ x LDS
  bf16_t* dOs = Qs + BQ * LDS;                        // BQ x LDS
  bf16_t* Ks = dOs + BQ * LDS;                        // 2 x BK x LDS
  bf16_t* Vs = Ks + 2 * BK * LDS;                     // 2 x BK x LDS
  float* Ls = reinterpret_cast<float*>(Vs + 2 * BK * LDS);   // BQ
  float* Ds = Ls + BQ;                                // BQ

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;     // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qt * BQ;
  const bf16_t* qp = static_cast<const bf16_t*>(a.q) + b * a.qs[0]
                     + h * a.qs[1];
  const bf16_t* op = static_cast<const bf16_t*>(a.dout) + b * a.dos[0]
                     + h * a.dos[1];
  const bf16_t* kp = static_cast<const bf16_t*>(a.k) + b * a.ks[0]
                     + kvh * a.ks[1];
  const bf16_t* vp = static_cast<const bf16_t*>(a.v) + b * a.vs[0]
                     + kvh * a.vs[1];
  const int r0 = tid / CH, cc = tid % CH;

  auto load_q = [&](int col) {
    const bool in = col + cc * 8 < a.hd;
    for (int r = r0; r < BQ; r += RP) {
      const bool ok = in && q0 + r < a.Sq;
      const int64_t row = q0 + r;
      cp_async_16(smem_u32(Qs + r * LDS + cc * 8),
                  qp + (ok ? row * a.qs[2] + col : 0) + cc * 8, ok);
      cp_async_16(smem_u32(dOs + r * LDS + cc * 8),
                  op + (ok ? row * a.dos[2] + col : 0) + cc * 8, ok);
    }
  };
  auto load_kv = [&](int kt, int st, int col) {
    const int k0 = kt * BK;
    const bool in = col + cc * 8 < a.hd;
    for (int r = r0; r < BK; r += RP) {
      const bool ok = in && k0 + r < a.Skv;
      const int64_t row = k0 + r;
      const int at = (st * BK + r) * LDS + cc * 8;
      cp_async_16(smem_u32(Ks + at),
                  kp + (ok ? row * a.ks[2] + col : 0) + cc * 8, ok);
      cp_async_16(smem_u32(Vs + at),
                  vp + (ok ? row * a.vs[2] + col : 0) + cc * 8, ok);
    }
  };

  int kt_begin, kt_end;
  fa::kv_range(a.Sq, a.Skv, a.causal, a.window, q0, BQ, BK, &kt_begin,
               &kt_end);
  const int64_t base = ((int64_t)b * a.H + h) * a.Sq;
  for (int i = tid; i < BQ; i += kThreads) {
    const bool ok = q0 + i < a.Sq;
    Ls[i] = ok ? a.lse[base + q0 + i] * kLog2e : 0.f;
    Ds[i] = ok ? a.delta[base + q0 + i] : 0.f;
  }
  const bool one = a.nch == 1;
  if (one) {
    load_q(0);
    if (kt_begin < kt_end) load_kv(kt_begin, 0, 0);
    cp_async_commit();
  }
  __syncthreads();
  float lr[2], dr[2];               // rows g and g + 8 of the warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lr[r] = Ls[16 * w + g + 8 * r];
    dr[r] = Ds[16 * w + g + 8 * r];
  }

  // Q and dO as A (the warp's 16 rows); K and V as B of S and dP (n = kv
  // rows); K as B of dQ (k = kv rows, transposed)
  const uint32_t q_a = fa::lane_a(Qs + 16 * w * LDS, LDS, lane);
  const uint32_t o_a = fa::lane_a(dOs + 16 * w * LDS, LDS, lane);
  const uint32_t k_b = fa::lane_b(Ks, LDS, lane);
  const uint32_t v_b = fa::lane_b(Vs, LDS, lane);
  const uint32_t k_t = fa::lane_t(Ks, LDS, lane);

  auto sdp = [&](float (&s)[NT][4], float (&dp)[NT][4], uint32_t so) {
#pragma unroll
    for (int kk = 0; kk < SW / 16; ++kk) {
      uint32_t qf[4], of[4];
      ldsm_x4(qf, q_a + kk * 32);
      ldsm_x4(of, o_a + kk * 32);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t x[4];
        ldsm_x4(x, k_b + so + np * 16 * ROW + kk * 32);
        mma(s[2 * np], qf, x[0], x[1]);
        mma(s[2 * np + 1], qf, x[2], x[3]);
        ldsm_x4(x, v_b + so + np * 16 * ROW + kk * 32);
        mma(dp[2 * np], of, x[0], x[1]);
        mma(dp[2 * np + 1], of, x[2], x[3]);
      }
    }
  };

  float dq[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[d][c] = 0.f;

  int st = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt, st ^= 1) {
    const int k0 = kt * BK;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
    uint32_t so;
    if (one) {
      if (kt + 1 < kt_end) {
        load_kv(kt + 1, st ^ 1, 0);  // read by the last tile, synced below
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      so = st * BK * ROW;
      sdp(s, dp, so);
    } else {
      for (int ch = 0; ch < a.nch; ++ch) {
        __syncthreads();             // the last chunk (or tile) is consumed
        load_q(ch * SW);
        load_kv(kt, 0, ch * SW);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        sdp(s, dp, 0);
      }
      __syncthreads();               // k's slice for dq
      load_kv(kt, 0, a.c0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      so = 0;
    }

    // P = exp2(s' - lse'), masked to 0; dS = P (dP - D) f
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        const int qi = q0 + 16 * w + g + 8 * r;
        const int kj = k0 + 8 * n + 2 * t + (c & 1);
        float f;
        const float x = score2<CAP>(a, s[n][c], &f);
        const float p = kept(a, qi, kj) ? ex2(x - lr[r]) : 0.f;
        dp[n][c] = p * (dp[n][c] - dr[r]) * f;
      }

    // dQ += dS.K: dS rounded to bf16 as the A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < SW / 16; ++d2) {
        uint32_t x[4];
        ldsm_x4_trans(x, k_t + so + kk * 16 * ROW + d2 * 32);
        mma(dq[2 * d2], da, x[0], x[1]);
        mma(dq[2 * d2 + 1], da, x[2], x[3]);
      }
    }
    __syncthreads();                 // stage st is free for tile kt + 2
  }
  cp_async_wait<0>();

  bf16_t* dqp = static_cast<bf16_t*>(a.dq) + b * a.dqs[0] + h * a.dqs[1]
                + a.c0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 16 * w + g + 8 * r;
    if (qi >= a.Sq) continue;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<uint32_t*>(dqp + qi * a.dqs[2] + 8 * d + 2 * t) =
          pack(dq[d][2 * r] * a.scale, dq[d][2 * r + 1] * a.scale);
  }
}

template <int SW, bool CAP>
int launch_cap(const BwdArgs& a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv_bf16<SW, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KvTile<SW>::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      fa_bwd_dq_bf16<SW, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      QTile<SW>::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dkdv_bf16<SW, CAP>
      <<<dim3((a.Skv + KvTile<SW>::BKV - 1) / KvTile<SW>::BKV, a.KV, B),
         kThreads, KvTile<SW>::smem_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dq_bf16<SW, CAP>
      <<<dim3((a.Sq + QTile<SW>::BQ - 1) / QTile<SW>::BQ, a.H, B), kThreads,
         QTile<SW>::smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int SW>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  return a.softcap > 0.f ? launch_cap<SW, true>(a, B, stream)
                         : launch_cap<SW, false>(a, B, stream);
}

}  // namespace bf16

template <int SW>
int launch(const BwdArgs& a, int dtype, int B, cudaStream_t stream) {
  if (dtype == 0) return f32::launch<SW>(a, B, stream);
  if (dtype == 1) return bf16::launch<SW>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

// the widest slice a backward launch accumulates (see the header)
constexpr int kMaxBwdSlice = 128;

}  // namespace

extern "C" {

// q (B, H, Sq, hd), k/v (B, KV, Skv, hd), o and dout (B, H, Sq, hd), dq
// (B, H, Sq, hd), dk/dv (B, KV, Skv, hd), all of one type (dtype 0:
// float32, CUDA-core kernels; 1: bfloat16, tensor-core kernels), hd
// contiguous; hd 32, 64, 128, 256, or above 256 a multiple of 32.  lse:
// the forward's float32 (B, H, Sq), contiguous; delta: float32 scratch of
// B * H * Sq.  strides: 24 int64, the (b, h, s) strides of q, k, v, o,
// dout, dq, dk and dv in elements; for bfloat16 every pointer 16-B aligned
// and every stride a multiple of 8.  window <= 0: none; softcap <= 0: none.
// Returns the first launch error, else cudaGetLastError() after the last.
int fa_backward(const void* q, const void* k, const void* v, const void* o,
                const float* lse, const void* dout, void* dq, void* dk,
                void* dv, float* delta, int dtype, int B, int H, int KV,
                int Sq, int Skv, int hd, const int64_t* strides, float scale,
                int causal, int window, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0) return (int)cudaSuccess;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (hd <= 0 || hd % 32 || (hd < 256 && (hd & (hd - 1))))
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.lse = lse;
  a.delta = delta; a.dq = dq; a.dk = dk; a.dv = dv;
  a.H = H; a.KV = KV; a.Sq = Sq; a.Skv = Skv; a.hd = hd;
  int64_t* dst[8] = {a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, a.dks, a.dvs};
  for (int m = 0; m < 8; ++m)
    for (int i = 0; i < 3; ++i) dst[m][i] = strides[3 * m + i];
  a.scale = scale; a.softcap = softcap; a.causal = causal; a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const int rows = B * H * Sq;
  if (dtype == 0)
    fa_bwd_delta<float><<<(rows + 3) / 4, 128, 0, s>>>(a, rows);
  else
    fa_bwd_delta<__nv_bfloat16><<<(rows + 3) / 4, 128, 0, s>>>(a, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int c0 = 0; c0 < hd;) {
    const int w = fa::next_slice(hd - c0, kMaxBwdSlice);
    a.c0 = c0;
    a.nch = (hd + w - 1) / w;
    int e;
    switch (w) {
      case 32: e = launch<32>(a, dtype, B, s); break;
      case 64: e = launch<64>(a, dtype, B, s); break;
      default: e = launch<128>(a, dtype, B, s); break;
    }
    if (e) return e;
    c0 += w;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
