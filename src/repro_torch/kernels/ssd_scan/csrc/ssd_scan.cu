// Chunked SSD (Mamba-2 state-space duality) for Hopper (sm_90a): the prefill
// scan of the SSD mixer on the LM serving path.
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/ssd_scan/ssd_scan.py:
//   ssd_scan (:73, pallas_call at :90), body _kernel (:30-70).
// For each (batch, head) it walks the chunks of length L in order, with a
// zero initial (P, N) state:
//   cs      = cumsum(dt * A)                                      (L,)
//   y       = tril(C B^T * exp(cs_i - cs_j)) * dt_j . x           (L, P)
//           + (C . state^T) * exp(cs)
//   state  <- state * exp(cs_{L-1}) + x^T . (B * exp(cs_{L-1} - cs) * dt)
// x (B, T, H, P), B and C (B, T, N) shared by all heads, dt (B, T, H) and
// A (H,) in float32.  y and the final state are written in x's type; all
// arithmetic is float32.
//
// What bounds it on this card: at the mamba2-370m prefill shape
// (B=8, T=4096, H=32, P=64, N=128, L=256, bf16) the causal work is about
// 5.3e10 FLOPs (C B^T once per batch row and chunk, the rest per head)
// against about 293 MB of inputs and outputs, so device-memory bytes bound
// it (0.088 ms at 3.35 TB/s).  This first version runs on the CUDA cores in
// float32 and recomputes C B^T for every head, so it sits far above that
// bound; sharing C B^T across heads and mma tiles are the later redesign.
//
// Design (the TPU grid's sequential chunk axis becomes a loop inside a CTA):
//  * one CTA of 256 threads per (head, batch); the (P, N) float32 state lives
//    in shared memory for the whole walk (64 x 128 x 4 B = 32 KB for mamba2);
//  * the L x L decay tile does not fit (256 KB at L = 256), so each chunk is
//    cut into output tiles of TL rows (TL = 64, or 32 / 16 for short chunks)
//    and, for each, key tiles j0 <= i0 of TL rows: G = C_i B_j^T, then
//    W = G * exp(cs_i - cs_j) * dt_j where j <= i and 0 elsewhere, then
//    y_i += W . x_j.  exp is taken only for j <= i (cs_i - cs_j <= 0 there
//    since dt >= 0 and A < 0), so no inf ever meets a 0;
//  * the last output tile of a chunk visits every key tile, and accumulates
//    the state update x^T . (B * w) from the same tiles; the state is
//    replaced only after every output tile has read the old one;
//  * thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i and columns
//    tx + 16 c of every tile it computes; padded row strides keep the
//    shared-memory reads free of bank conflicts;
//  * the cumsum runs in one thread, in order, per chunk (dt * A rounded
//    before each add, as the reference computes dA first);
//  * strides for x, dt, B and C, so the model's slices of the convolution
//    output are read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 64;      // P / 16 <= 4 columns per thread
constexpr int kMaxN = 128;     // N / 16 <= 8 columns per thread
constexpr int kMaxChunk = 256;

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;        // (B, T, H, P) contiguous
  void* state;    // (B, H, P, N) contiguous
  int T, H, P, N, chunk, TL;
  int64_t xs[3];  // (b, t, h) strides of x
  int64_t ds[3];  // (b, t, h) strides of dt
  int64_t bs[2];  // (b, t) strides of B
  int64_t cs[2];  // (b, t) strides of C
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__host__ __device__ inline int smem_floats(int P, int N, int TL, int chunk) {
  return P * (N + 1) + 2 * TL * (N + 1) + TL * (P + 1) + TL * (TL + 1)
         + 4 * chunk;
}

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int64_t row_stride, int rows,
                                          int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols, c = e % cols;
    dst[r * ld + c] = to_f(src[r * row_stride + c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_fwd_kernel(const SsdArgs a) {
  const int P = a.P, N = a.N, TL = a.TL, L = a.chunk;
  const int LDN = N + 1, LDP = P + 1, LDW = TL + 1;
  extern __shared__ float smem[];
  float* S = smem;                  // P x LDN   state
  float* Cs = S + P * LDN;          // TL x LDN  C rows of the output tile
  float* Bs = Cs + TL * LDN;        // TL x LDN  B rows of the key tile
  float* Xs = Bs + TL * LDN;        // TL x LDP  x rows of the key tile
  float* Ws = Xs + TL * LDP;        // TL x LDW  masked weights
  float* cum = Ws + TL * LDW;       // L  cumsum(dt * A)
  float* dts = cum + L;             // L  dt
  float* ecs = dts + L;             // L  exp(cs)
  float* wst = ecs + L;             // L  exp(cs_last - cs) * dt

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int ti = TL / 16, pc = P / 16, nc = N / 16;
  const float A_h = a.A[h];
  const T* xb = static_cast<const T*>(a.x) + b * a.xs[0] + h * a.xs[2];
  const float* db = a.dt + b * a.ds[0] + h * a.ds[2];
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.bs[0];
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.cs[0];
  T* yb = static_cast<T*>(a.y) + (int64_t)b * a.T * a.H * P + (int64_t)h * P;
  const int64_t ys = (int64_t)a.H * P;

  for (int e = tid; e < P * LDN; e += kThreads) S[e] = 0.f;

  const int n_tiles = L / TL;
  for (int t0 = 0; t0 < a.T; t0 += L) {
    __syncthreads();               // the last chunk's state is written
    for (int l = tid; l < L; l += kThreads) dts[l] = db[(t0 + l) * a.ds[1]];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int l = 0; l < L; ++l) {
        run = __fadd_rn(run, __fmul_rn(dts[l], A_h));
        cum[l] = run;
      }
    }
    __syncthreads();
    const float cs_last = cum[L - 1];
    for (int l = tid; l < L; l += kThreads) {
      ecs[l] = expf(cum[l]);
      wst[l] = expf(cs_last - cum[l]) * dts[l];
    }

    float upd[4][kMaxN / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < kMaxN / 16; ++n) upd[i][n] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * TL;
      const bool last = it == n_tiles - 1;
      __syncthreads();             // Cs of the last tile is consumed
      load_rows(Cs, LDN, Cb + (t0 + i0) * a.cs[1], a.cs[1], TL, N);

      float yacc[4][kMaxP / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kMaxP / 16; ++c) yacc[i][c] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TL;
        __syncthreads();           // Bs, Xs and Ws of the last tile consumed
        load_rows(Bs, LDN, Bb + (t0 + j0) * a.bs[1], a.bs[1], TL, N);
        load_rows(Xs, LDP, xb + (t0 + j0) * a.xs[1], a.xs[1], TL, P);
        __syncthreads();

        // W = tril(C_i B_j^T * exp(cs_i - cs_j)) * dt_j
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = i < ti ? Cs[(ty + 16 * i) * LDN + n] : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = j < ti ? Bs[(tx + 16 * j) * LDN + n] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= ti) continue;
          const int li = i0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j >= ti) continue;
            const int lj = j0 + tx + 16 * j;
            float w = 0.f;
            if (lj <= li) w = g[i][j] * expf(cum[li] - cum[lj]) * dts[lj];
            Ws[(ty + 16 * i) * LDW + tx + 16 * j] = w;
          }
        }
        __syncthreads();

        // y_i += W . x_j
        for (int j = 0; j < TL; ++j) {
          float wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            wv[i] = i < ti ? Ws[(ty + 16 * i) * LDW + j] : 0.f;
#pragma unroll
          for (int c = 0; c < kMaxP / 16; ++c) {
            if (c >= pc) continue;
            const float xv = Xs[j * LDP + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < 4; ++i) yacc[i][c] = fmaf(wv[i], xv, yacc[i][c]);
          }
        }

        // the last output tile sees every key tile: state update x^T . (B w)
        if (last) {
          for (int j = 0; j < TL; ++j) {
            const float w = wst[j0 + j];
            float xv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              xv[i] = i < pc ? Xs[j * LDP + ty + 16 * i] : 0.f;
#pragma unroll
            for (int n = 0; n < kMaxN / 16; ++n) {
              if (n >= nc) continue;
              const float bw = Bs[j * LDN + tx + 16 * n] * w;
#pragma unroll
              for (int i = 0; i < 4; ++i) upd[i][n] = fmaf(xv[i], bw, upd[i][n]);
            }
          }
        }
      }

      // y_i += (C_i . state^T) * exp(cs_i), then write the tile
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= ti) continue;
        const int r = ty + 16 * i;
        float inter[kMaxP / 16];
#pragma unroll
        for (int c = 0; c < kMaxP / 16; ++c) inter[c] = 0.f;
        for (int n = 0; n < N; ++n) {
          const float cv = Cs[r * LDN + n];
#pragma unroll
          for (int c = 0; c < kMaxP / 16; ++c)
            if (c < pc) inter[c] = fmaf(cv, S[(tx + 16 * c) * LDN + n], inter[c]);
        }
        const float e = ecs[i0 + r];
        T* yrow = yb + (int64_t)(t0 + i0 + r) * ys;
#pragma unroll
        for (int c = 0; c < kMaxP / 16; ++c)
          if (c < pc) store(yrow + tx + 16 * c, yacc[i][c] + inter[c] * e);
      }
    }

    // every output tile has read the old state: replace it
    __syncthreads();
    const float decay = expf(cs_last);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= pc) continue;
#pragma unroll
      for (int n = 0; n < kMaxN / 16; ++n) {
        if (n >= nc) continue;
        float* s = S + (ty + 16 * i) * LDN + tx + 16 * n;
        *s = *s * decay + upd[i][n];
      }
    }
  }

  __syncthreads();
  T* st = static_cast<T*>(a.state) + ((int64_t)b * a.H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    store(st + e, S[(e / N) * LDN + e % N]);
}

}  // namespace

extern "C" {

// x (Bsz, T, H, P), dt (Bsz, T, H) f32, A (H,) f32, B/C (Bsz, T, N);
// y (Bsz, T, H, P) and state (Bsz, H, P, N) contiguous, in x's type
// (dtype 0: float32, 1: bfloat16).  strides: 10 int64 in elements, the
// (b, t, h) strides of x and of dt, then the (b, t) strides of B and of C.
// The caller checks T % chunk == 0, chunk % 16 == 0, P % 16 == 0,
// N % 16 == 0 and the maxima above.  Returns cudaGetLastError().
int ssd_forward(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, void* y, void* state, int dtype, int Bsz,
                int T, int H, int P, int N, int chunk, const int64_t* strides,
                void* stream) {
  if (Bsz <= 0 || H <= 0) return (int)cudaSuccess;
  if (P % 16 || N % 16 || chunk % 16 || P > kMaxP || N > kMaxN ||
      chunk > kMaxChunk || T % chunk)
    return (int)cudaErrorInvalidValue;
  SsdArgs a;
  a.x = x; a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = Bm; a.Cm = Cm; a.y = y; a.state = state;
  a.T = T; a.H = H; a.P = P; a.N = N; a.chunk = chunk;
  a.TL = chunk % 64 == 0 ? 64 : (chunk % 32 == 0 ? 32 : 16);
  for (int i = 0; i < 3; ++i) {
    a.xs[i] = strides[i];
    a.ds[i] = strides[3 + i];
  }
  for (int i = 0; i < 2; ++i) {
    a.bs[i] = strides[6 + i];
    a.cs[i] = strides[8 + i];
  }
  const int smem = smem_floats(P, N, a.TL, chunk) * (int)sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, Bsz);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(ssd_fwd_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    ssd_fwd_kernel<float><<<grid, kThreads, smem, s>>>(a);
  } else if (dtype == 1) {
    err = cudaFuncSetAttribute(ssd_fwd_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    ssd_fwd_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
