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
// its memory is that of its inputs and outputs and a float32 dq sum.
//
// What bounds it on this card: 10 * hd FLOPs a kept (q, k) pair (S, dP,
// dV, dK and dQ, 2 a multiply-add) against q, k, v, o, do read and dq, dk,
// dv written: at the internlm2-1.8b shape (B=8, H=16, KV=8, S=4096,
// hd=128, causal) 1.37e12 FLOPs against 0.6 GB, so the tensor-core rate
// bounds it (1.39 ms at 989 TFLOP/s bf16), and only wgmma reaches that
// rate.  Its design follows from that: each pair's S and dP computed once,
// every product a wgmma fed by TMA, and dq, which every kv tile adds to,
// summed without serialising the CTAs in a fixed order.
//
// bfloat16, head dims 32 (run at 64), 64, 128 and 256: three launches.
//  * fa_bwd_prep: lse * log2(e) and D = rowsum(do * o) (the bf16 output,
//    as FlashAttention-2) in float32, padded to whole 64-row q tiles; the
//    dq counters zeroed.
//  * fa_bwd_fused: persistent CTAs (one an SM, 256 threads: two
//    warpgroups, up to 255 registers a thread) claim kv tiles from a
//    counter in global memory, every chain's (b, kv head) tile j before
//    any tile j + 1, so progress never depends on the hardware's dispatch
//    order.  The second warpgroup's thread 0 also issues the copies: K
//    and V once a tile, and for each (head of the group, q tile) that
//    reaches it Q, dO, lse' and D
//    into a ring of 64-row stages (3 at hd 64, else 2), a stage refilled
//    as soon as both warpgroups are past it, by TMA (4-D tensor maps of the
//    (B, S, heads, hd) buffers' strided views, 128-B swizzle, zero past S
//    and hd, so no stale value meets a P of 0) completing on mbarriers.
//    A step (one q stage) computes S = Q.K^T and dP = dO.V^T once by wgmma
//    from shared memory, P = exp2(s' - lse') (softcap and mask as the
//    forward; the mask only where the block is not kept whole) and
//    dS = P (dP - D) f in registers, both rounded to bf16 into shared
//    memory, dV += P^T.dO and dK += dS^T.Q by wgmma (A transposed from
//    shared memory; the sums stay in registers over the group's heads),
//    and dq's share dS.K by wgmma.  Up to hd 128 a kv tile has 128 rows,
//    64 a warpgroup, which holds dK and dV for them; at 256 a tile has 64
//    rows and each warpgroup holds 128 of dK's and dV's columns and
//    computes S and dP for 32 of its kv columns.
//  * dq without order-dependent sums: each CTA adds its float32 share of
//    a (b, h, q tile) into a float32 sum in global memory (tile-contiguous,
//    in accumulator-fragment order) after every lower kv tile that reaches
//    that q tile has added, behind a counter a q tile (the first adder
//    stores).  Up to hd 128 the share is staged in shared memory and
//    thread 0 adds it a step late in one bulk reduce, completes it a step
//    later and releases its counter, the counter read as the share was
//    staged: no wait meets an add issued in the same step.  At hd 256
//    (no shared memory left to stage in) each thread adds its share with
//    vector atomics, every thread fencing before the one release.  Every
//    call sums in ascending kv-tile order and gives the same bits; no CTA
//    waits on a tile claimed after it.
//  * fa_bwd_dq_out: dq = sum * scale in bf16, 0 where no tile added.
// Roundings to bf16: P before P^T.dO (dv), dS before dS^T.q (dk) and dS.k
// (dq); every sum is float32, S and dP float32 from the products.
//
// bfloat16 above 256 (multiples of 32): the FlashAttention-2 split on
// mma.sync m16n8k16, launched once per slice of 128, 64 or 32 columns
// (fa_common.cuh), each recomputing S and dP over the full head dim; only
// the 320 and 512 checks reach it.
// float32: the CUDA cores in full float32 (no TF32), the same split, 256
// threads as a 16 x 16 grid of 4 x 4 register tiles out of shared memory,
// q pre-scaled in shared memory, P and dS staged through shared memory.

#include <cuda.h>

#include <type_traits>

#include "../../csrc/hopper.cuh"
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

// -- bfloat16, head dims above 256: slices on mma.sync m16n8k16 ----------------

namespace sliced {

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

// dk/dv: 64 kv rows a CTA; q tiles of BQ rows
template <int SW>
struct KvTile {
  static constexpr int BKV = 64;
  static constexpr int BQ = SW == 128 ? 32 : 64;
  static constexpr int LDS = SW + 8;               // padded row, in bf16
  static constexpr int smem_bytes =
      (2 * BKV + 2 * BQ) * LDS * (int)sizeof(bf16_t)
      + 2 * BQ * (int)sizeof(float);
};

// dq: 64 q rows a CTA; kv tiles of BK rows
template <int SW>
struct QTile {
  static constexpr int BQ = 64;
  static constexpr int BK = SW == 128 ? 32 : 64;
  static constexpr int LDS = SW + 8;
  static constexpr int smem_bytes =
      (2 * BQ + 2 * BK) * LDS * (int)sizeof(bf16_t)
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

template <int SW>
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
  bf16_t* Qs = Vs + BKV * LDS;                        // BQ x LDS
  bf16_t* dOs = Qs + BQ * LDS;                        // BQ x LDS
  float* Ls = reinterpret_cast<float*>(dOs + BQ * LDS);  // BQ: lse log2(e)
  float* Ds = Ls + BQ;                                // BQ: D

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
  // step s's q and do columns [col, col + SW) and its lse and D
  auto load_q = [&](int s, int col) {
    const int h = kvh * G + s / nqt, q0 = (qt_begin + s % nqt) * BQ;
    const bf16_t* qp = static_cast<const bf16_t*>(a.q) + b * a.qs[0]
                       + h * a.qs[1];
    const bf16_t* op = static_cast<const bf16_t*>(a.dout) + b * a.dos[0]
                       + h * a.dos[1];
    const bool in = col + cc * 8 < a.hd;
    for (int r = r0; r < BQ; r += RP) {
      const bool ok = in && q0 + r < a.Sq;
      const int64_t row = q0 + r;
      const int at = r * LDS + cc * 8;
      cp_async_16(smem_u32(Qs + at),
                  qp + (ok ? row * a.qs[2] + col : 0) + cc * 8, ok);
      cp_async_16(smem_u32(dOs + at),
                  op + (ok ? row * a.dos[2] + col : 0) + cc * 8, ok);
    }
    const int64_t base = ((int64_t)b * a.H + h) * a.Sq;
    for (int i = tid; i < BQ; i += kThreads) {
      const bool ok = q0 + i < a.Sq;
      Ls[i] = ok ? a.lse[base + q0 + i] * kLog2e : 0.f;
      Ds[i] = ok ? a.delta[base + q0 + i] : 0.f;
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
  auto sdp = [&](float (&sT)[NQ][4], float (&pT)[NQ][4]) {
#pragma unroll
    for (int kk = 0; kk < SW / 16; ++kk) {
      uint32_t kf[4], vf[4];
      ldsm_x4(kf, k_a + kk * 32);
      ldsm_x4(vf, v_a + kk * 32);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t x[4];
        ldsm_x4(x, q_b + np * 16 * ROW + kk * 32);
        mma(sT[2 * np], kf, x[0], x[1]);
        mma(sT[2 * np + 1], kf, x[2], x[3]);
        ldsm_x4(x, o_b + np * 16 * ROW + kk * 32);
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

  for (int s = 0; s < nsteps; ++s) {
    float sT[NQ][4], pT[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) sT[n][c] = pT[n][c] = 0.f;
    for (int ch = 0; ch < a.nch; ++ch) {
      __syncthreads();               // the last chunk (or step) is consumed
      load_kv(ch * SW);
      load_q(s, ch * SW);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      sdp(sT, pT);
    }
    __syncthreads();                 // q and do's slice for dk and dv
    load_q(s, a.c0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // P^T = exp2(s' - lse'), masked to 0; dS^T = P^T (dP^T - D) f
    const int q0 = (qt_begin + s % nqt) * BQ;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + 16 * w + g + 8 * (c >> 1);
        const int il = 8 * n + 2 * t + (c & 1);
        float f;
        const float x = a.softcap > 0.f ? score2<true>(a, sT[n][c], &f)
                                        : score2<false>(a, sT[n][c], &f);
        const float p = kept(a, q0 + il, kj) ? ex2(x - Ls[il]) : 0.f;
        sT[n][c] = p;
        pT[n][c] = p * (pT[n][c] - Ds[il]) * f;
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
        ldsm_x4_trans(x, o_t + kq * 16 * ROW + dp * 32);
        mma(dv[2 * dp], pa, x[0], x[1]);
        mma(dv[2 * dp + 1], pa, x[2], x[3]);
        ldsm_x4_trans(x, q_t + kq * 16 * ROW + dp * 32);
        mma(dk[2 * dp], da, x[0], x[1]);
        mma(dk[2 * dp + 1], da, x[2], x[3]);
      }
    }
  }

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

template <int SW>
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
  bf16_t* Ks = dOs + BQ * LDS;                        // BK x LDS
  bf16_t* Vs = Ks + BK * LDS;                         // BK x LDS
  float* Ls = reinterpret_cast<float*>(Vs + BK * LDS);       // BQ
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
  auto load_kv = [&](int kt, int col) {
    const int k0 = kt * BK;
    const bool in = col + cc * 8 < a.hd;
    for (int r = r0; r < BK; r += RP) {
      const bool ok = in && k0 + r < a.Skv;
      const int64_t row = k0 + r;
      const int at = r * LDS + cc * 8;
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

  auto sdp = [&](float (&s)[NT][4], float (&dp)[NT][4]) {
#pragma unroll
    for (int kk = 0; kk < SW / 16; ++kk) {
      uint32_t qf[4], of[4];
      ldsm_x4(qf, q_a + kk * 32);
      ldsm_x4(of, o_a + kk * 32);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t x[4];
        ldsm_x4(x, k_b + np * 16 * ROW + kk * 32);
        mma(s[2 * np], qf, x[0], x[1]);
        mma(s[2 * np + 1], qf, x[2], x[3]);
        ldsm_x4(x, v_b + np * 16 * ROW + kk * 32);
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

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
    for (int ch = 0; ch < a.nch; ++ch) {
      __syncthreads();               // the last chunk (or tile) is consumed
      load_q(ch * SW);
      load_kv(kt, ch * SW);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      sdp(s, dp);
    }
    __syncthreads();                 // k's slice for dq
    load_kv(kt, a.c0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // P = exp2(s' - lse'), masked to 0; dS = P (dP - D) f
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        const int qi = q0 + 16 * w + g + 8 * r;
        const int kj = k0 + 8 * n + 2 * t + (c & 1);
        float f;
        const float x = a.softcap > 0.f ? score2<true>(a, s[n][c], &f)
                                        : score2<false>(a, s[n][c], &f);
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
        ldsm_x4_trans(x, k_t + kk * 16 * ROW + d2 * 32);
        mma(dq[2 * d2], da, x[0], x[1]);
        mma(dq[2 * d2 + 1], da, x[2], x[3]);
      }
    }
  }

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

template <int SW>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv_bf16<SW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KvTile<SW>::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      fa_bwd_dq_bf16<SW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      QTile<SW>::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dkdv_bf16<SW>
      <<<dim3((a.Skv + KvTile<SW>::BKV - 1) / KvTile<SW>::BKV, a.KV, B),
         kThreads, KvTile<SW>::smem_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dq_bf16<SW>
      <<<dim3((a.Sq + QTile<SW>::BQ - 1) / QTile<SW>::BQ, a.H, B), kThreads,
         QTile<SW>::smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace sliced

// -- bfloat16, head dims up to 256: one fused wgmma/TMA kernel -----------------

namespace fused {

using bf16_t = __nv_bfloat16;
using fa::ex2;
using fa::pack;

constexpr int kBQ = 64;            // q rows a ring stage
constexpr int kBlk = kBQ * 128;    // bytes of a 64-column block of 64 rows
constexpr int kMaxHd = 256;        // the widest head dim it takes
// two warpgroups; thread 0 of the second also issues the copies, thread 0
// of the first the tile claims and the dq adds
constexpr int kThreads = 256;
constexpr int kLoader = 128;

// HD (64, 128, 256) the head dim padded to whole 64-column blocks (hd 32
// runs at 64, TMA zero-filling columns 32..63).  Up to 128 the two
// warpgroups split a 128-row kv tile (64 rows each, all columns of dK and
// dV); at 256 they split dK's and dV's columns over a 64-row tile (128
// each) and S's and dP's kv columns (32 each).  Shared memory: K, V, the
// ring (Q, dO, lse', D a stage), P and dS, dq's staged shares, barriers.
template <int HD>
struct Cfg {
  static constexpr bool KSPLIT = HD <= 128;
  static constexpr int BKV = KSPLIT ? 128 : 64;
  static constexpr int NB = HD / 64;                 // 64-column blocks
  static constexpr int NST = HD == 64 ? 3 : 2;       // ring stages
  static constexpr int KV_BLK = BKV * 128;           // bytes a K block
  static constexpr int Q_BLK = kBQ * 128;            // bytes a Q block
  static constexpr int K_BYTES = NB * KV_BLK;
  static constexpr int Q_BYTES = NB * Q_BLK;
  static constexpr int DS_BYTES = BKV * kBQ * 2;     // P or dS [q][kv]
  // P and dS: double-buffered at 256; up to 128 once (the step's second
  // barrier orders reuse), beside dq's share staged twice for its bulk add
  static constexpr int N_DS = KSPLIT ? 2 : 4;
  static constexpr int DQ_BYTES = KSPLIT ? kBQ * HD * 4 : 0;
  static constexpr int OFF_V = K_BYTES;
  static constexpr int OFF_Q = 2 * K_BYTES;          // stage: Q, then dO
  static constexpr int OFF_DS = OFF_Q + NST * 2 * Q_BYTES;
  static constexpr int OFF_DQ = OFF_DS + N_DS * DS_BYTES;
  static constexpr int OFF_LD = OFF_DQ + 2 * DQ_BYTES;  // stage: L, D
  static constexpr int OFF_BAR = OFF_LD + NST * 2 * kBQ * 4;
  static constexpr int N_BAR = NST + 1;
  static constexpr int SMEM = OFF_BAR + 8 * N_BAR + 16 + 1024;  // + align
  static_assert(SMEM <= 232448, "shared memory");
};

struct Params {
  const float* ld;     // (B * H, 2, Sq_pad): lse * log2(e), then D
  float* acc;          // (B, H, nqt, 64, HD): dq's float32 sums
  int* counters;       // [0]: kv tiles claimed; [1 + (b H + h) nqt + qt]:
                       // the kv tiles that have added to that dq tile
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int64_t dks[3], dvs[3];
  int B, H, KV, Sq, Skv, hd, nqt, ntiles;
  float scale, softcap;
  int causal, window;  // window <= 0: none
};

__device__ __forceinline__ bool kept(const Params& p, int i, int j) {
  return i < p.Sq && j < p.Skv && (!p.causal || j <= i)
         && (p.window <= 0 || i - j < p.window);
}

// the forward's log2-unit score and the softcap's 1 - tanh^2
template <bool CAP>
__device__ __forceinline__ float score2(const Params& p, float s, float* f) {
  if constexpr (CAP) {
    const float th = tanhf(s * p.scale / p.softcap);
    *f = 1.f - th * th;
    return th * p.softcap * kLog2e;
  } else {
    *f = 1.f;
    return s * (p.scale * kLog2e);
  }
}

// kv tile t of the claim order: every chain's (b, kv head) tile j before
// any tile j + 1, so a tile's lower kv tiles are claimed before it (heavy
// causal tiles first)
struct Tile {
  int j, b, kvh, k0, qt_begin, nqt, nsteps;
};

template <int BKV>
__device__ __forceinline__ Tile tile_of(const Params& p, int t) {
  Tile x;
  const int chains = p.B * p.KV;
  x.j = t / chains;
  x.b = (t % chains) / p.KV;
  x.kvh = t % p.KV;
  x.k0 = x.j * BKV;
  // q tiles [begin, end) that reach the kv tile, as q_range
  const int begin = p.causal ? min(p.nqt, x.k0 / kBQ) : 0;
  const int end = p.window > 0
      ? min(p.nqt, (x.k0 + BKV - 1 + p.window - 1) / kBQ + 1) : p.nqt;
  x.qt_begin = begin;
  x.nqt = max(0, end - begin);
  x.nsteps = (p.H / p.KV) * x.nqt;
  return x;
}

// the lowest kv tile that reaches q tile qt: kv tiles [first, j) add to
// dq tile qt before tile j does
template <int BKV>
__device__ __forceinline__ int first_adder(const Params& p, int qt) {
  if (p.window <= 0) return 0;
  const int num = qt * kBQ - BKV - p.window + 2;
  return num <= 0 ? 0 : (num + BKV - 1) / BKV;
}

// A dq tile's float32 sum (64 rows x HD) is kept in fragment order, so
// that a warp's writes are contiguous: column block cb (64 columns) of
// warp w's 16 rows, register pair e (0..15) of its m64n64 accumulator,
// lane l at float2 ((cb * 4 + w) * 16 + e) * 32 + l.
__device__ __forceinline__ int frag2(int cb, int warp, int e, int lane) {
  return ((cb * 4 + warp) * 16 + e) * 32 + lane;
}

// Up to hd 128 (the bulk route) thread 0 adds each step's staged dq
// share one step late: at step m, while the step's first products run,
// the add issued at step m - 1 completes and its counter `rel` is
// released, then the share staged at step m - 1 (dq tile `add`, its
// target, staging buffer `src`) is added once the lower kv tiles have, in
// one bulk reduce (the first adder stores).  No add waits on anything
// issued in the same step.  `seen` is the add's counter as loaded
// (relaxed) when its share was staged, so that the load's latency is
// hidden: a lower count is waited on.  The lower kv tiles' adds were
// complete before their counts were released, so a count that reaches
// the target orders this add after them.
template <int HD>
__device__ __forceinline__ void bulk_step(const Params& p, int rel, int add,
                                          int target, int seen,
                                          const void* src) {
  if (rel >= 0) {
    hop::bulk_wait();
    hop::fence_proxy_global();
    hop::red_release(p.counters + rel, 1);
  }
  if (add >= 0) {
    if (seen < target) hop::wait_count(p.counters + add, target);
    hop::fence_proxy_global();
    float* dst = p.acc + static_cast<int64_t>(add - 1) * kBQ * HD;
    if (target == 0)
      hop::bulk_store(dst, src, kBQ * HD * 4);
    else
      hop::bulk_reduce_add(dst, src, kBQ * HD * 4);
  }
}

// at hd 256 (the atomic route): every thread's adds to counter `c` done,
// then one release add
__device__ __forceinline__ void release_atomic(const Params& p, int c,
                                               int ct) {
  hop::fence_gpu();
  hop::named_sync(2, kThreads);
  if (ct == 0) hop::red_release(p.counters + c, 1);
  __syncwarp();
}

// the atomic route: this warpgroup's 64 x 64 share (column block cb) of
// dq tile c added after the lower kv tiles' adds (counter == target, when
// `wait`); the first adder stores
__device__ __forceinline__ void add_dq(const Params& p, const float (&dq)[32],
                                       int c, int target, int cb, int HD,
                                       int wt, int wg, bool wait) {
  const int warp = wt >> 5, lane = wt & 31;
  if (wait && target > 0) {
    if (wt == 0) hop::wait_count(p.counters + c, target);
    __syncwarp();
    hop::named_sync(3 + wg, 128);
  }
  float2* tile = reinterpret_cast<float2*>(
      p.acc + static_cast<int64_t>(c - 1) * kBQ * HD);
  if (target == 0) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      tile[frag2(cb, warp, e, lane)] = make_float2(dq[2 * e], dq[2 * e + 1]);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      atomicAdd(tile + frag2(cb, warp, e, lane),
                make_float2(dq[2 * e], dq[2 * e + 1]));
  }
}

// dk * scale and dv of rows [row0, row0 + 64) in bf16, columns col0 + ...,
// rows < Skv and columns < hd
template <int R>
__device__ __forceinline__ void store_dkdv(const Params& p, const Tile& x,
                                           const float (&dk)[R],
                                           const float (&dv)[R], int row0,
                                           int col0, int wt) {
  const int warp = wt >> 5, lane = wt & 31;
  bf16_t* dkp = p.dk + x.b * p.dks[0] + x.kvh * p.dks[1];
  bf16_t* dvp = p.dv + x.b * p.dvs[0] + x.kvh * p.dvs[1];
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const int kj = x.k0 + row0 + 16 * warp + (lane >> 2) + 8 * ((i & 3) >> 1);
    const int col = col0 + 8 * (i >> 2) + 2 * (lane & 3);
    if (kj >= p.Skv || col >= p.hd) continue;
    *reinterpret_cast<uint32_t*>(dkp + kj * p.dks[2] + col) =
        pack(dk[i] * p.scale, dk[i + 1] * p.scale);
    *reinterpret_cast<uint32_t*>(dvp + kj * p.dvs[2] + col) =
        pack(dv[i], dv[i + 1]);
  }
}

// 16-B chunk `chunk` of row r of a swizzled 128-B-row tile, + 4 t bytes
__device__ __forceinline__ uint32_t swz(int r, int chunk, int t) {
  return r * 128 + ((chunk ^ (r & 7)) << 4) + 4 * t;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_fused(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo, const Params p) {
  using C = Cfg<HD>;
  constexpr int BKV = C::BKV;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = sm;
  unsigned char* Vs = sm + C::OFF_V;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* kv_full = full + C::NST;
  volatile int* tile_slot = reinterpret_cast<volatile int*>(kv_full + 1);
  auto q_at = [&](int st) { return sm + C::OFF_Q + st * 2 * C::Q_BYTES; };
  auto ld_at = [&](int st) {
    return reinterpret_cast<float*>(sm + C::OFF_LD + st * 2 * kBQ * 4);
  };

  const int ct = threadIdx.x;              // 0 .. 255
  if (ct == 0) {
    for (int s = 0; s < C::NST; ++s) hop::mbar_init(full + s, 1);
    hop::mbar_init(kv_full, 1);
    hop::mbar_init_fence();
  }
  __syncthreads();
  const int G = p.H / p.KV;
  const int wg = ct >> 7;                  // warpgroup
  const int wt = ct & 127;
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t4 = lane & 3;
  // S's and dP's kv columns of this warpgroup: up to hd 128 its 64 rows
  // of the kv tile, at 256 32 of the tile's 64; its columns of dK and dV
  constexpr int NS = C::KSPLIT ? 64 : 32;
  constexpr int NKV = C::KSPLIT ? HD : 128;
  const int kv_off = wg * NS;
  const int col_off = C::KSPLIT ? 0 : wg * 128;
  const uint64_t k_km = hop::desc(hop::smem(Ks), 16, 1024);
  const uint64_t v_km = hop::desc(hop::smem(Vs), 16, 1024);
  const uint64_t k_mn = hop::desc(hop::smem(Ks), C::KV_BLK, 1024);
  // the dq tile whose add is pending (atomic route: its release; bulk
  // route: its issue, with its target), and the bulk add to release
  int step = 0, pending = -1, pending_target = 0, rel = -1, seen = 0;
  uint32_t phases = 0, kv_phase = 0;       // a parity bit a ring stage

  for (;;) {
    // claim the next kv tile (thread 0, then all of the CTA: the last
    // tile's reads of K, V and the ring are done)
    if (ct == 0) *tile_slot = atomicAdd(p.counters, 1);
    __syncwarp();
    __syncthreads();
    const int t = *tile_slot;
    if (t >= p.ntiles) break;
    const Tile x = tile_of<BKV>(p, t);
    // step s's Q, dO, lse' and D into stage s % NST (the loader thread)
    auto load_step = [&](int s) {
      const int st = s % C::NST;
      const int h = x.kvh * G + s / x.nqt;
      const int q0 = (x.qt_begin + s % x.nqt) * kBQ;
      hop::mbar_expect_tx(full + st, 2 * C::Q_BYTES + 2 * kBQ * 4);
      unsigned char* qs = q_at(st);
      for (int c = 0; c < C::NB; ++c) {
        hop::tma_load_4d(qs + c * C::Q_BLK, &tq, full + st, 64 * c, q0, h,
                         x.b);
        hop::tma_load_4d(qs + C::Q_BYTES + c * C::Q_BLK, &tdo, full + st,
                         64 * c, q0, h, x.b);
      }
      const int64_t row = (static_cast<int64_t>(x.b) * p.H + h) * 2
                          * (p.nqt * kBQ) + q0;
      hop::bulk_load(ld_at(st), p.ld + row, kBQ * 4, full + st);
      hop::bulk_load(ld_at(st) + kBQ, p.ld + row + p.nqt * kBQ, kBQ * 4,
                     full + st);
    };
    if (ct == kLoader) {
      hop::mbar_expect_tx(kv_full, 2 * C::K_BYTES);
      for (int c = 0; c < C::NB; ++c) {
        hop::tma_load_4d(Ks + c * C::KV_BLK, &tk, kv_full, 64 * c, x.k0,
                         x.kvh, x.b);
        hop::tma_load_4d(Vs + c * C::KV_BLK, &tv, kv_full, 64 * c, x.k0,
                         x.kvh, x.b);
      }
      for (int s = 0; s < min(C::NST, x.nsteps); ++s) load_step(s);
    }
    __syncwarp();
    hop::mbar_wait_warp(kv_full, kv_phase);
    kv_phase ^= 1;

    float dk[NKV / 2], dv[NKV / 2];
#pragma unroll
    for (int i = 0; i < NKV / 2; ++i) dk[i] = dv[i] = 0.f;
    for (int s = 0; s < x.nsteps; ++s, ++step) {
      const int h = x.kvh * G + s / x.nqt;
      const int qt = x.qt_begin + s % x.nqt;
      const int q0 = qt * kBQ;
      const int stage = s % C::NST;
      hop::mbar_wait_warp(full + stage, (phases >> stage) & 1);
      phases ^= 1u << stage;
      const uint32_t q_s = hop::smem(q_at(stage));
      const uint64_t q_km = hop::desc(q_s, 16, 1024);
      const uint64_t o_km = hop::adv(q_km, C::Q_BYTES);
      const uint64_t q_mn = hop::desc(q_s, C::Q_BLK, 1024);
      const uint64_t o_mn = hop::adv(q_mn, C::Q_BYTES);
      const float* Ls = ld_at(stage);
      const float* Ds = Ls + kBQ;
      const uint64_t kd = hop::opaque(k_km), vd = hop::opaque(v_km);

      // S = Q.K^T, dP = dO.V^T: 64 q rows x this warpgroup's kv columns
      float sc[NS / 2], dp[NS / 2];
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t qo = (kk >> 2) * C::Q_BLK + (kk & 3) * 32;
        const uint32_t ko = (kk >> 2) * C::KV_BLK + kv_off * 128
                            + (kk & 3) * 32;
        if constexpr (NS == 64) {
          hop::wgmma_ss_n64<0, 0>(sc, hop::adv(q_km, qo), hop::adv(kd, ko),
                                  kk > 0);
          hop::wgmma_ss_n64<0, 0>(dp, hop::adv(o_km, qo), hop::adv(vd, ko),
                                  kk > 0);
        } else {
          hop::wgmma_ss_n32<0, 0>(sc, hop::adv(q_km, qo), hop::adv(kd, ko),
                                  kk > 0);
          hop::wgmma_ss_n32<0, 0>(dp, hop::adv(o_km, qo), hop::adv(vd, ko),
                                  kk > 0);
        }
      }
      hop::wg_commit();
      if constexpr (!C::KSPLIT) {
        if (pending >= 0) release_atomic(p, pending, ct);
      } else {
        if (ct == 0)
          bulk_step<HD>(p, rel, pending, pending_target, seen,
                        sm + C::OFF_DQ + ((step + 1) & 1) * C::DQ_BYTES);
        __syncwarp();
        rel = pending;
      }
      pending = -1;
      hop::wg_wait<0>();
      hop::keep(sc);
      hop::keep(dp);

      // P = exp2(s' - lse'), 0 where masked; dS = P (dP - D) f; both
      // rounded to bf16 into shared memory as [q][kv] blocks of 64 kv
      unsigned char* pb = sm + C::OFF_DS
                          + (C::KSPLIT ? 0 : (step & 1) * 2 * C::DS_BYTES);
      unsigned char* db = pb + C::DS_BYTES;
      float lr[2], dr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        lr[hh] = Ls[16 * warp + g + 8 * hh];
        dr[hh] = Ds[16 * warp + g + 8 * hh];
      }
      // the mask is evaluated only where this warpgroup's 64 x NS block
      // is not kept whole (the diagonal, a window's edge, the tails)
      auto elementwise = [&](auto masked, auto capped) {
#pragma unroll
        for (int i = 0; i < NS / 2; i += 2) {
          const int hh = (i & 3) >> 1;
          const int r = 16 * warp + g + 8 * hh;
          const int kc = kv_off + 8 * (i >> 2) + 2 * t4;
          float v[2][2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float f;
            const float s2 = score2<decltype(capped)::value>(p, sc[i + u],
                                                              &f);
            float pr = ex2(s2 - lr[hh]);
            if constexpr (decltype(masked)::value)
              pr = kept(p, q0 + r, x.k0 + kc + u) ? pr : 0.f;
            v[0][u] = pr;
            v[1][u] = pr * (dp[i + u] - dr[hh]) * f;
          }
          const uint32_t at = (kc >> 6) * kBlk + swz(r, (kc & 63) >> 3, t4);
          *reinterpret_cast<uint32_t*>(pb + at) = pack(v[0][0], v[0][1]);
          *reinterpret_cast<uint32_t*>(db + at) = pack(v[1][0], v[1][1]);
        }
      };
      const int kv_lo = x.k0 + kv_off, kv_hi = kv_lo + NS - 1;
      const bool whole = q0 + kBQ <= p.Sq && kv_hi < p.Skv
                         && (!p.causal || kv_hi <= q0)
                         && (p.window <= 0 || q0 + kBQ - 1 - kv_lo < p.window);
      using no = std::false_type;
      using yes = std::true_type;
      if (p.softcap > 0.f) {
        if (whole)
          elementwise(no(), yes());
        else
          elementwise(yes(), yes());
      } else if (whole) {
        elementwise(no(), no());
      } else {
        elementwise(yes(), no());
      }
      hop::fence_async_smem();
      // all of P and dS written; both warpgroups are past step s - 1, so
      // its stage takes step s - 1 + NST
      hop::named_sync(1, kThreads);
      if (ct == kLoader && s >= 1 && s - 1 + C::NST < x.nsteps)
        load_step(s - 1 + C::NST);
      __syncwarp();

      // dV += P^T.dO, dK += dS^T.Q: this warpgroup's kv rows x its
      // columns (A MN-major from the [q][kv] block)
      const uint32_t blk = C::KSPLIT ? wg * kBlk : 0;
      const uint64_t p_mn = hop::desc(hop::smem(pb) + blk, kBlk, 1024);
      const uint64_t ds_mn = hop::desc(hop::smem(db) + blk, kBlk, 1024);
      hop::wg_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const uint32_t o = (col_off / 64) * C::Q_BLK + kq * 2048;
        if constexpr (NKV == 128) {
          hop::wgmma_ss_n128<1, 1>(dv, hop::adv(p_mn, kq * 2048),
                                   hop::adv(o_mn, o), 1);
          hop::wgmma_ss_n128<1, 1>(dk, hop::adv(ds_mn, kq * 2048),
                                   hop::adv(q_mn, o), 1);
        } else {
          hop::wgmma_ss_n64<1, 1>(dv, hop::adv(p_mn, kq * 2048),
                                  hop::adv(o_mn, o), 1);
          hop::wgmma_ss_n64<1, 1>(dk, hop::adv(ds_mn, kq * 2048),
                                  hop::adv(q_mn, o), 1);
        }
      }
      hop::wg_commit();

      // dq's share dS.K (A K-major over the kv tile, B MN-major), added
      // to its (b, h, q tile) sum
      const uint64_t ds_km = hop::desc(hop::smem(db), 16, 1024);
      const uint64_t kb = hop::opaque(k_mn);
      const int c = 1 + (x.b * p.H + h) * p.nqt + qt;
      const int target = x.j - first_adder<BKV>(p, qt);
      if constexpr (C::KSPLIT) {
        // columns [wg HD/2, + HD/2) over the tile's 128 kv rows
        float dq[HD / 4];
        const uint32_t cb = HD == 128 ? wg * C::KV_BLK : wg * 64;
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          const uint32_t ao = (kk >> 2) * kBlk + (kk & 3) * 32;
          if constexpr (HD == 128)
            hop::wgmma_ss_n64<0, 1>(dq, hop::adv(ds_km, ao),
                                    hop::adv(kb, cb + kk * 2048), kk > 0);
          else
            hop::wgmma_ss_n32<0, 1>(dq, hop::adv(ds_km, ao),
                                    hop::adv(kb, cb + kk * 2048), kk > 0);
        }
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::keep(dv);
        hop::keep(dk);
        hop::keep(dq);
        // staged in fragment order; thread 0 adds the tile in one bulk
        // reduce at the next step (bulk_add)
        float2* st = reinterpret_cast<float2*>(
            sm + C::OFF_DQ + (step & 1) * C::DQ_BYTES);
#pragma unroll
        for (int e = 0; e < HD / 8; ++e)
          st[frag2(HD == 128 ? wg : 0, warp, HD == 128 ? e : 8 * wg + e,
                   lane)] = make_float2(dq[2 * e], dq[2 * e + 1]);
        hop::fence_async_smem();
        if (ct == 0) seen = hop::ld_relaxed(p.counters + c);
        hop::named_sync(2, kThreads);
      } else {
        // columns [128 wg, + 128) in two halves of 64
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float dq[32];
          hop::wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hop::wgmma_ss_n64<0, 1>(
                dq, hop::adv(ds_km, kk * 32),
                hop::adv(kb, (2 * wg + half) * C::KV_BLK + kk * 2048),
                kk > 0);
          hop::wg_commit();
          hop::wg_wait<0>();
          hop::keep(dq);
          add_dq(p, dq, c, target, 2 * wg + half, HD, wt, wg, half == 0);
        }
        hop::keep(dv);
        hop::keep(dk);
      }
      pending = c;
      pending_target = target;
    }
    if constexpr (!C::KSPLIT) {
      if (pending >= 0) release_atomic(p, pending, ct);
    } else if (ct == 0) {                  // both outstanding adds done
      bulk_step<HD>(p, rel, pending, pending_target, seen,
                    sm + C::OFF_DQ + ((step + 1) & 1) * C::DQ_BYTES);
      bulk_step<HD>(p, pending, -1, 0, 0, nullptr);
    }
    __syncwarp();
    pending = rel = -1;
    store_dkdv(p, x, dk, dv, C::KSPLIT ? wg * 64 : 0, col_off, wt);
  }
}

// lse' = lse * log2(e) and D = rowsum(do * o), one warp a (b, h, i) row of
// the padded (B * H, 2, Sq_pad) layout, 0 past Sq; and the counters zeroed
__global__ void __launch_bounds__(128)
fa_bwd_prep(const BwdArgs a, float* ld, int* counters, int sq_pad,
            int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int i = row % sq_pad, bh = row / sq_pad, h = bh % a.H, b = bh / a.H;
  float dsum = 0.f, l = 0.f;
  if (i < a.Sq) {
    const bf16_t* o = static_cast<const bf16_t*>(a.o) + b * a.os[0]
                      + h * a.os[1] + i * a.os[2];
    const bf16_t* d = static_cast<const bf16_t*>(a.dout) + b * a.dos[0]
                      + h * a.dos[1] + i * a.dos[2];
    for (int c = lane; c < a.hd; c += 32)
      dsum = fmaf(__bfloat162float(o[c]), __bfloat162float(d[c]), dsum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    l = a.lse[(static_cast<int64_t>(b) * a.H + h) * a.Sq + i] * kLog2e;
  }
  if (lane == 0) {
    ld[(static_cast<int64_t>(bh) * 2) * sq_pad + i] = l;
    ld[(static_cast<int64_t>(bh) * 2 + 1) * sq_pad + i] = dsum;
    if (i % kBQ == 0) counters[1 + row / kBQ] = 0;
    if (row == 0) counters[0] = 0;
  }
}

// dq = sum * scale in bf16, one warp a (b, h, i) row; 0 where no kv tile
// reached the row's q tile
template <int HD>
__global__ void __launch_bounds__(128)
fa_bwd_dq_out(const BwdArgs a, const Params p, int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int i = row % a.Sq, bh = row / a.Sq, h = bh % a.H, b = bh / a.H;
  const int c = 1 + bh * p.nqt + i / kBQ;
  const bool seen = p.counters[c] > 0;
  const float2* src = reinterpret_cast<const float2*>(
      p.acc + static_cast<int64_t>(c - 1) * kBQ * HD);
  const int r = i % kBQ;
  bf16_t* dq = static_cast<bf16_t*>(a.dq) + b * a.dqs[0] + h * a.dqs[1]
               + i * a.dqs[2];
  for (int col = 2 * lane; col < a.hd; col += 64) {
    // row r, columns col, col + 1 in fragment order (frag2)
    const int cc = col & 63;
    const float2 v = src[frag2(col >> 6, r >> 4, 2 * (cc >> 3) + ((r >> 3) & 1),
                               4 * (r & 7) + ((cc & 7) >> 1))];
    *reinterpret_cast<uint32_t*>(dq + col) =
        seen ? pack(v.x * a.scale, v.y * a.scale) : 0u;
  }
}

// a (B, heads, S, hd) bf16 view with (b, h, s) element strides `st`, read
// in boxes of 64 columns x `rows` rows, 128-B swizzled, zero past S and hd
bool tensor_map(CUtensorMap* m, const void* ptr, int B, int heads, int S,
                int hd, const int64_t* st, int rows) {
  hop::EncodeTiled enc = hop::encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const BwdArgs& a, Params& p, int B, cudaStream_t stream) {
  using C = Cfg<HD>;
  const int nkv = (a.Skv + C::BKV - 1) / C::BKV;
  p.ntiles = nkv * B * a.KV;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  static int sms[64] = {};             // SMs a device, asked once
  if (err == cudaSuccess && dev < 64 && sms[dev] == 0)
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess && (dev >= 64 || sms[dev] <= 0))
    err = cudaErrorInvalidValue;
  static bool sized[64] = {};          // the attribute, once a device
  if (err == cudaSuccess && !sized[dev]) {
    err = cudaFuncSetAttribute(fa_bwd_fused<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    sized[dev] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return (int)err;
  const int sq_pad = p.nqt * kBQ;
  const int prep_rows = B * a.H * sq_pad;
  fa_bwd_prep<<<(prep_rows + 3) / 4, 128, 0, stream>>>(
      a, const_cast<float*>(p.ld), p.counters, sq_pad, prep_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // encoded while the first pass runs
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, a.q, B, a.H, a.Sq, a.hd, a.qs, kBQ)
      || !tensor_map(&tk, a.k, B, a.KV, a.Skv, a.hd, a.ks, C::BKV)
      || !tensor_map(&tv, a.v, B, a.KV, a.Skv, a.hd, a.vs, C::BKV)
      || !tensor_map(&tdo, a.dout, B, a.H, a.Sq, a.hd, a.dos, kBQ))
    return (int)cudaErrorInvalidValue;
  fa_bwd_fused<HD><<<min(p.ntiles, sms[dev]), kThreads, C::SMEM, stream>>>(
      tq, tk, tv, tdo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = B * a.H * a.Sq;
  fa_bwd_dq_out<HD><<<(rows + 3) / 4, 128, 0, stream>>>(a, p, rows);
  return (int)cudaGetLastError();
}

}  // namespace fused

template <int SW>
int launch(const BwdArgs& a, int dtype, int B, cudaStream_t stream) {
  if (dtype == 0) return f32::launch<SW>(a, B, stream);
  if (dtype == 1) return sliced::launch<SW>(a, B, stream);
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
// the forward's float32 (B, H, Sq), contiguous.  strides: 24 int64, the
// (b, h, s) strides of q, k, v, o, dout, dq, dk and dv in elements; for
// bfloat16 every pointer 16-B aligned and every stride a multiple of 8.
// window <= 0: none; softcap <= 0: none.  Scratch, with nqt = ceil(Sq /
// 64) and HD = max(hd, 64): bfloat16 up to hd 256, delta float32 of
// B * H * 2 * nqt * 64 (lse', D), acc float32 of B * H * nqt * 64 * HD
// and counters int32 of 1 + B * H * nqt (the first pass zeroes acc and
// counters); otherwise delta of B * H * Sq, acc and counters unused.
// Returns the first launch error,
// else cudaGetLastError() after the last.
int fa_backward(const void* q, const void* k, const void* v, const void* o,
                const float* lse, const void* dout, void* dq, void* dk,
                void* dv, float* delta, float* acc, int* counters,
                int dtype, int B, int H, int KV, int Sq, int Skv, int hd,
                const int64_t* strides, float scale, int causal, int window,
                float softcap, void* stream) {
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

  if (dtype == 1 && hd <= fused::kMaxHd) {
    fused::Params p;
    p.ld = delta; p.acc = acc; p.counters = counters;
    p.dk = static_cast<__nv_bfloat16*>(dk);
    p.dv = static_cast<__nv_bfloat16*>(dv);
    for (int i = 0; i < 3; ++i) {
      p.dks[i] = a.dks[i];
      p.dvs[i] = a.dvs[i];
    }
    p.B = B; p.H = H; p.KV = KV; p.Sq = Sq; p.Skv = Skv; p.hd = hd;
    p.nqt = (Sq + fused::kBQ - 1) / fused::kBQ;
    p.scale = scale; p.softcap = softcap; p.causal = causal;
    p.window = window;
    switch (hd) {
      case 32:
      case 64: return fused::launch<64>(a, p, B, s);
      case 128: return fused::launch<128>(a, p, B, s);
      default: return fused::launch<256>(a, p, B, s);
    }
  }
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
