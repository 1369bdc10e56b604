// Flash attention forward for Hopper (sm_90a): online-softmax attention over
// (B, H, Sq, hd) queries and (B, KV, Skv, hd) keys/values, the prefill
// attention of the LM serving path.
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/flash_attention/flash_attention.py:
//   flash_attention (:94, pallas_call at :123), body _flash_kernel (:38-91).
// It computes the same function: GQA (query head h reads kv head h / G),
// optional causal mask with the kv tiles that lie wholly after the q tile
// skipped, optional sliding window ((q - k) < window), optional tanh softcap
// (tanh(s / cap) * cap), the kv tail masked; m, l and acc in float32; the
// output in the input's type.  Masked scores are the -1e30 sentinel, never
// -inf, and the final denominator is floored at 1e-30, as in the Pallas body.
//
// What bounds it on this card: at the internlm2-1.8b prefill shape
// (B=8, H=16, KV=8, S=4096, hd=128, causal) the work is 5.5e11 FLOPs against
// 403 MB of inputs and output, so the tensor-core rate bounds it
// (0.56 ms at 989 TFLOP/s bf16, against 0.12 ms of bytes).  This first
// version runs on the CUDA cores in float32 (register-blocked 4x4 FMA
// micro-tiles), so it sits far above that bound; mma/wgmma tiles and TMA
// loads are the later redesign.  Arithmetic follows the Pallas body in
// float32: q is upcast, then scaled; p stays float32 for P.V.
//
// Design (the TPU grid's sequential kv axis becomes a loop inside a block):
//  * one CTA of 256 threads per (q tile of 64 rows, head, batch); the heavy
//    causal tiles (high q index) are scheduled first;
//  * the q tile, pre-scaled, sits in shared memory in float32 for the whole
//    loop; each kv tile of 64 rows is staged through one shared buffer,
//    first K (for the scores), then V (for P.V), converted to float32 once;
//  * thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i (i < 4) of the
//    q tile: scores at columns tx + 16 j, output columns tx + 16 c; the row
//    max and row sum are 16-lane xor shuffles inside a half warp;
//  * strides (in elements) for every dimension but hd, so the model's
//    (B, S, H, hd) projections viewed as (B, H, S, hd) are read in place and
//    the output is written straight into a (B, S, H, hd) buffer;
//  * ragged q and kv edges are bounds checks, not padding copies; no score
//    ever takes exp of a positive difference (s - m_new <= 0, m - m_new <= 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // q rows per CTA
constexpr int kBK = 64;            // kv rows per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kPLD = kBK + 16;     // P row stride: the two rows a warp reads
                                   // land 16 banks apart
constexpr float kNegInf = -1e30f;

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, KV, Sq, Skv;
  int64_t qs[3], ks[3], vs[3], os[3];   // strides of (b, h, s), in elements
  float scale, softcap;
  int causal, window;                   // window <= 0: no window
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

template <int HD>
constexpr int smem_floats() {
  return 2 * kBQ * (HD + 1) + kBQ * kPLD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FaArgs a) {
  constexpr int LD = HD + 1;        // padded row stride of Q and K/V tiles
  constexpr int CJ = HD / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // kBQ x LD: q * scale
  float* KVs = Qs + kBQ * LD;       // kBK x LD: K tile, then V tile
  float* Ps = KVs + kBK * LD;       // kBQ x kPLD: probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;     // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qt * kBQ;
  const T* qp = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* kp = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[1];
  T* op = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, qi = q0 + r;
    Qs[r * LD + d] = qi < a.Sq ? to_f(qp[qi * a.qs[2] + d]) * a.scale : 0.f;
  }

  // kv tiles this q tile needs: causal stops at the tile of its last row,
  // a window starts at the tile of its first row's first key
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  const int nk = (a.Skv + kBK - 1) / kBK;
  const int kt_end = a.causal ? min(nk, q_last / kBK + 1) : nk;
  int kt_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0)
    kt_begin = (q0 - a.window + 1) / kBK;

  float m_i[4], l_i[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                // the last tile's V and P are consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD, kj = k0 + r;
      KVs[r * LD + d] = kj < a.Skv ? to_f(kp[kj * a.ks[2] + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KVs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j];
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        bool keep = kj < a.Skv;
        if (a.causal) keep = keep && kj <= qi;
        if (a.window > 0) keep = keep && (qi - kj) < a.window;
        s[i][j] = keep ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);     // argument <= 0
        Ps[(ty + 16 * i) * kPLD + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m_i[i] - m_new);    // argument <= 0
      l_i[i] = l_i[i] * alpha + psum;
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] *= alpha;
      m_i[i] = m_new;
    }
    __syncthreads();                // K consumed, P written

    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD, kj = k0 + r;
      KVs[r * LD + d] = kj < a.Skv ? to_f(vp[kj * a.vs[2] + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c2 = 0; c2 < kBK; ++c2) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kPLD + c2];
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const float vv = KVs[c2 * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= a.Sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CJ; ++c)
      store(op + qi * a.os[2] + tx + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int HD>
int launch(const FaArgs& a, int B, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const FaArgs& a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, H, Sq, hd), k/v (B, KV, Skv, hd), o (B, H, Sq, hd), all of one type
// (dtype 0: float32, 1: bfloat16), hd contiguous.  strides: 12 int64, the
// (b, h, s) strides of q, k, v and o in elements.  window <= 0: none;
// softcap <= 0: none.  Returns cudaGetLastError() after the launch.
int fa_forward(const void* q, const void* k, const void* v, void* o,
               int dtype, int B, int H, int KV, int Sq, int Skv, int hd,
               const int64_t* strides, float scale, int causal, int window,
               float softcap, void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaSuccess;
  FaArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.H = H; a.KV = KV; a.Sq = Sq; a.Skv = Skv;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.scale = scale; a.softcap = softcap; a.causal = causal; a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(a, B, hd, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(a, B, hd, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
