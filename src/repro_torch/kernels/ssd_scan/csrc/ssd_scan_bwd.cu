// Chunked SSD backward for Hopper (sm_90a): dx, ddt, dA, dB and dC of the
// forward in ssd_scan.cu (zero initial state) from y's cotangent gy and the
// final state's gstate, the SSD gradient of the mamba2 training path.
//
// Replaces no TPU kernel: the JAX package trains by differentiating the jnp
// src/repro/models/ssd.py::ssd_scan_ref (:59), whose gradient XLA derives;
// its Pallas kernel (src/repro/kernels/ssd_scan/ssd_scan.py:90) has no
// backward.  This computes that gradient.  Per (b, h) and chunk c, with
// cs = cumsum(dt A) inside the chunk, G = C B^T (shared by the heads),
// D_ls = exp(cs_l - cs_s) for s <= l, w_s = exp(cs_{L-1} - cs_s) dt_s, h_c
// the state entering the chunk and dh the cotangent of the state leaving it
// (gstate for the last chunk), M_ls = gy_l . x_s and E = G * D * M:
//   dx_s  = sum_{l>=s} G_ls D_ls dt_s gy_l + w_s dh B_s
//   dC_l  = sum_heads [sum_{s<=l} M_ls D_ls dt_s B_s + e^{cs_l} h_c^T gy_l]
//   dB_s  = sum_heads [sum_{l>=s} M_ls D_ls dt_s C_l + w_s dh^T x_s]
//   dh_c  = e^{cs_{L-1}} dh + sum_l e^{cs_l} gy_l (x) C_l
//   dcs_l = sum_s E_ls dt_s + e^{cs_l} <gy_l h_c, C_l> - dt_l (ce_l + u_l)
//           [+ sum_s dt_s u_s + e^{cs_{L-1}} <h_c, dh> at l = L-1]
//     with ce_s = sum_{l>=s} E_ls and u_s = e^{cs_{L-1}-cs_s} <x_s dh, B_s>;
//   da = reverse cumsum of dcs; ddt = A da + ce + u; dA = sum dt da.
// (ref.py::ssd_bwd_ref is the plain twin; the tests hold it to jax.vjp.)
//
// Six launches, each with one job, in order on the caller's stream:
//  1. bwd_states, one CTA per (chunk, head, batch row): the chunk's cumsum
//     (one thread, in order, dt * A rounded before each add, as the float32
//     forward), written to a (B, H, T) table; the chunk's own state
//     sum_s (x_s w_s) (x) B_s and its own cotangent sum_l (gy_l e^{cs_l})
//     (x) C_l, (P, N) products over the chunk's rows;
//  2. bwd_scan, eight CTAs per (head, batch row), each elementwise over an
//     eighth of (P, N): the states carried forward (each chunk's slot
//     becomes the state entering it) and the cotangents carried back from
//     gstate (each chunk's slot becomes the cotangent of the state leaving
//     it), and each eighth's part of <h_c, dh> per chunk by a fixed-order
//     block reduction.  The recurrence is a chain of short steps, so the
//     loads of 8 chunks are issued together before the 8 steps run: taken
//     one chunk at a time, each step waits out its loads' latency and the
//     pass runs far below the card's memory rate;
//  3. bwd_rows, one CTA per (row tile i, chunk, batch row x head group):
//     G_ij = C_i B_j^T for the tiles j <= i once, kept in shared memory as
//     float32, then for each head of the group M_ij = gy_i x_j^T, the
//     decay-weighted Md = M * D * dt, dC_i += Md . B_j and, from the state,
//     dC_i += e^{cs} (gy_i . h_c); the rows' dcs terms (sum_s G Md, the
//     state's) to a (B, H, T) table; dC_i summed over the group's heads in
//     registers;
//  4. bwd_cols, one CTA per (key tile j, chunk, batch row x head group):
//     G_ij for i >= j once, then for each head dx_j = w (B_j . dh^T) +
//     sum_i Wd . gy_i and dB_j += w (x_j . dh) + sum_i Md^T . C_i (Wd = G *
//     D * dt and Md^T staged in turn), the column sums ce and u to tables;
//  5. bwd_dt, one warp per (head, batch row), walking the chunks in order:
//     dcs, its reverse cumsum (a warp scan), ddt and the row's dA;
//  6. bwd_reduce: dB and dC summed over the head groups in group order and
//     written in x's type, dA over the batch rows in order.
// Deterministic: every sum is taken in one fixed order (no atomics), so two
// calls give the same bits and a restarted training run repeats a run.
//
// What bounds it on this card: at mamba2-370m's training shape (B=8,
// T=2048, H=32, P=64, N=128, L=256, bf16) the products above take about
// 9.5e10 FLOPs over the causal triangles (kernels/cost.py::
// ssd_scan_bwd_cost) against about 0.2 GB of inputs and outputs, so the
// tensor cores' rate bounds it.  Launches 3 and 4 compute G twice, re-read
// x and gy per tile pair and wait for each tile's loads (one CTA of 4 warps
// an SM, for their shared memory): simple first, tuned later.
//
// Products: every one a warp's 16-row strip of a (TL x W) output, its
// operands staged in shared memory (rows padded by 16 B), the accumulator
// in mma.sync m16n8k16 fragments (row g / g+8, columns 2t, 2t+1 of each
// 8-column block; g = lane / 4, t = lane % 4).  Operand tiles arrive by
// cp.async, every copy of a tile in flight at once; the float32 states by
// float4 loads, converted to the operand type.  Off the diagonal the decay
// is factored by tiles as in the forward, exp(cs_l - cs_s) = rin_l
// exp(cs_i0 - cs_j1) rout_s (i0 the row tile's first row, j1 the key
// tile's last; per-position tables of the head, one exp a tile pair); the
// diagonal tile takes exp per element (ex2.approx) and masks.
//  * bfloat16: the tensor cores, ldmatrix(.trans) and mma.sync bf16 -> f32,
//    the forward's pieces.  Rounding points, the divergence from the
//    reference (float32 throughout): gy e^{cs} in launch 1 (x w there is
//    taken as two bf16 parts, hi + lo, so the states are float32 to about
//    2^-16); the carried states h_c and dh as operands; the decay-weighted
//    tiles Md (rows and columns) and Wd before their products.  G, M, E,
//    every sum, every table and dt, A, ddt, dA are float32; dx, dB and dC
//    are written in bfloat16.
//  * float32: the CUDA cores in full float32 (fmaf, no TF32): each thread
//    computes the same fragment elements from the float32 operands in
//    shared memory, so both types share every other line of the kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16_t = __nv_bfloat16;

constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxChunk = 256;
constexpr int kTL = 64;                  // rows of a tile, at most
constexpr int kThreads = 128;            // 4 warps of 16 rows
constexpr int kScanThreads = 256;
constexpr int kScanParts = 8;            // CTAs a (b, h) state is split over
constexpr int kScanBlock = 8;            // chunks whose loads fly at once
constexpr int kLDG = kTL + 4;            // float32 G tiles, padded

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const void* gy;        // (B, T, H, P) contiguous
  const void* gstate;    // (B, H, P, N) contiguous
  void* dx;              // (B, T, H, P) contiguous
  float* ddt;            // (B, T, H) contiguous
  float* dA;             // (H,)
  void* dB;              // (B, T, N) contiguous
  void* dC;              // (B, T, N) contiguous
  // scratch, float32
  float* cum;            // (B, H, T)  cumsum(dt * A) within each chunk
  float* st;             // (B, nc, H, P, N) states entering each chunk
  float* dst;            // (B, nc, H, P, N) cotangents leaving each chunk
  float* hd;             // (B, H, nc, kScanParts) <h_c, dh>, by parts
  float* rq;             // (B, H, T)  row terms of dcs
  float* ce;             // (B, H, T)  column sums of E
  float* us;             // (B, H, T)  the state term u
  float* dBp;            // (groups, B, T, N) dB of each head group
  float* dCp;            // (groups, B, T, N) dC of each head group
  float* dAp;            // (B, H) dA of each batch row
  int Bsz, T, H, P, N, chunk, TL, nc, hpg, groups;
  int64_t xs[3];         // (b, t, h) strides of x
  int64_t ds[3];         // (b, t, h) strides of dt
  int64_t bs[2];         // (b, t) strides of B
  int64_t cst[2];        // (b, t) strides of C
};

template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int v = 4; };    // 16 B
template <> struct Pad<bf16_t> { static constexpr int v = 8; };   // 16 B

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16_t v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16_t from_f<bf16_t>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// the sum over the 4 lanes that share a fragment row (same bits in each)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A warp's product: acc (16 x 8 nfl, in fragments) += A (16 x K) . B
// (K x 8 nfl), K a multiple of 16, nfl even; `a` points at the strip's
// row 0 (TA: its column 0):
//   A(m, k) = TA ? a[k * lda + m] : a[m * lda + k]
//   B(k, n) = TB ? b[k * ldb + n] : b[n * ldb + k]
// float32: each lane computes its fragment elements by fmaf.
template <bool TA, bool TB, int NF>
__device__ __forceinline__ void warp_mm(float (&acc)[NF][4], int nfl,
                                        const float* a, int lda,
                                        const float* b, int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float a0 = TA ? a[k * lda + g] : a[g * lda + k];
    const float a1 = TA ? a[k * lda + g + 8] : a[(g + 8) * lda + k];
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      if (nf >= nfl) continue;
      const int n = 8 * nf + 2 * t;
      const float b0 = TB ? b[k * ldb + n] : b[n * ldb + k];
      const float b1 = TB ? b[k * ldb + n + 1] : b[(n + 1) * ldb + k];
      acc[nf][0] = fmaf(a0, b0, acc[nf][0]);
      acc[nf][1] = fmaf(a0, b1, acc[nf][1]);
      acc[nf][2] = fmaf(a1, b0, acc[nf][2]);
      acc[nf][3] = fmaf(a1, b1, acc[nf][3]);
    }
  }
}

// bfloat16: ldmatrix (.trans where the operand is stored the other way)
// and mma.sync; the lane addresses are the forward's (ssd_scan.cu):
//   A rows (C there): rows lane % 16, k half lane / 16;
//   A from columns (x^T there): k rows lane % 8 + 8 (lane / 16), m half
//     (lane / 8) % 2;
//   B from rows (B for S there): n rows lane % 8 + 8 (lane / 16), k half
//     (lane / 8) % 2;
//   B from columns (x for W.x there): k rows lane % 8 + 8 ((lane / 8) % 2),
//     n half lane / 16.
template <bool TA, bool TB, int NF>
__device__ __forceinline__ void warp_mm(float (&acc)[NF][4], int nfl,
                                        const bf16_t* a, int lda,
                                        const bf16_t* b, int ldb, int K) {
  const int lane = threadIdx.x & 31;
  const uint32_t a_lane =
      TA ? smem_u32(a + ((lane & 7) + ((lane >> 4) << 3)) * lda
                    + ((lane >> 3) & 1) * 8)
         : smem_u32(a + (lane & 15) * lda + (lane >> 4) * 8);
  const uint32_t b_lane =
      TB ? smem_u32(b + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ldb
                    + (lane >> 4) * 8)
         : smem_u32(b + ((lane & 7) + ((lane >> 4) << 3)) * ldb
                    + ((lane >> 3) & 1) * 8);
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    if (TA) ldsm_x4_trans(af, a_lane + kk * 16 * lda * 2);
    else ldsm_x4(af, a_lane + kk * 32);
#pragma unroll
    for (int np = 0; np < NF / 2; ++np) {
      if (2 * np >= nfl) continue;
      uint32_t bf[4];
      if (TB) ldsm_x4_trans(bf, b_lane + (kk * 16 * ldb + np * 16) * 2);
      else ldsm_x4(bf, b_lane + (np * 16 * ldb + kk * 16) * 2);
      mma(acc[2 * np], af, bf[0], bf[1]);
      mma(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

template <int NF>
__device__ __forceinline__ void zero(float (&acc)[NF][4]) {
#pragma unroll
  for (int n = 0; n < NF; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// global -> shared, bypassing the registers: 16 B (L1 bypassed) or 4 B
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// wait for this thread's cp.async copies; a barrier after it makes every
// thread's visible
__device__ __forceinline__ void loads_done() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// rows [0, rows) of a (row-strided, last dim contiguous) operand into a
// padded shared tile by cp.async (all in flight at once; loads_done()
// waits); cols a multiple of 16
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int64_t stride, int rows,
                                          int cols) {
  if (sizeof(T) == 2) {      // 16-B copies: the launcher checks alignment
    const int cpr = cols / 8;
    for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
      const int r = e / cpr, c = e - r * cpr;
      cp_async_16(smem_u32(dst + r * ld + c * 8), src + r * stride + c * 8);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, c = e - r * cols;
      cp_async_4(smem_u32(dst + r * ld + c), src + r * stride + c);
    }
  }
}

// two floats -> bf16x2, round to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) to p[0..1], and four floats to p[0..3], in T
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16_t* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack(a, b);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16_t* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack(v.x, v.y), pack(v.z, v.w));
}

// a float32 (P, N) state into a padded shared tile of T (the operand):
// float4 loads, four in flight a thread
template <typename T>
__device__ __forceinline__ void load_state(T* dst, int ld, const float* src,
                                           int P, int N) {
  constexpr int kB = 4;
  const int n4 = P * N / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int e0 = threadIdx.x; e0 < n4; e0 += kB * blockDim.x) {
    float4 v[kB];
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      const int e = e0 + k * blockDim.x;
      if (e < n4) v[k] = s4[e];
    }
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      const int e = e0 + k * blockDim.x;
      if (e >= n4) continue;
      const int r = 4 * e / N, c = 4 * e - r * N;
      store4(dst + r * ld + c, v[k]);
    }
  }
}

// 8 consecutive elements (16-B aligned for bfloat16) as floats
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = p[q];
}
__device__ __forceinline__ void load8(float (&v)[8], const bf16_t* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[q]));
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}

// e^x on the special-function unit (2^(x log2 e)), as the forward's
// diagonal tile takes it; x <= 0 wherever the result is kept
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ int64_t bht(const BwdArgs& a, int b, int h) {
  return ((int64_t)b * a.H + h) * a.T;
}

__device__ __forceinline__ int64_t state_at(const BwdArgs& a, int b, int c,
                                            int h) {
  return (((int64_t)b * a.nc + c) * a.H + h) * a.P * a.N;
}

// -- 1. the chunk's cumsum, own state and own cotangent ----------------------

template <typename T>
constexpr int states_smem() {
  return kTL * (2 * (kMaxP + Pad<T>::v) + kMaxN + Pad<T>::v) * (int)sizeof(T)
         + 4 * kMaxChunk * (int)sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_states(const BwdArgs a) {
  constexpr int LDP = kMaxP + Pad<T>::v, LDN = kMaxN + Pad<T>::v;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);     // kTL x LDP: x w or gy e^cs
  T* Al = As + kTL * LDP;                     // kTL x LDP: x w's low part
  T* Bs = Al + kTL * LDP;                     // kTL x LDN: B or C rows
  float* cum = reinterpret_cast<float*>(Bs + kTL * LDN);
  float* dts = cum + kMaxChunk;
  float* wst = dts + kMaxChunk;               // exp(cs_{L-1} - cs) dt
  float* ecs = wst + kMaxChunk;               // exp(cs)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = a.chunk, TL = a.TL, P = a.P, N = a.N, t0 = c * L;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* db = a.dt + b * a.ds[0] + h * a.ds[2];
  for (int l = tid; l < L; l += kThreads)
    dts[l] = db[(int64_t)(t0 + l) * a.ds[1]];
  __syncthreads();
  if (tid == 0) {
    const float A_h = a.A[h];
    float run = 0.f;
    for (int l = 0; l < L; ++l) {
      run = __fadd_rn(run, __fmul_rn(dts[l], A_h));
      cum[l] = run;
    }
  }
  __syncthreads();
  const float cs_last = cum[L - 1];
  float* cum_out = a.cum + bht(a, b, h) + t0;
  for (int l = tid; l < L; l += kThreads) {
    wst[l] = expf(cs_last - cum[l]) * dts[l];
    ecs[l] = expf(cum[l]);
    cum_out[l] = cum[l];
  }

  const T* xb = static_cast<const T*>(a.x) + b * a.xs[0] + h * a.xs[2];
  const T* gb = static_cast<const T*>(a.gy)
                + ((int64_t)b * a.T * a.H + h) * P;
  const int64_t gs = (int64_t)a.H * P;
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.bs[0];
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.cst[0];
  for (int pass = 0; pass < 2; ++pass) {
    // pass 0: sum_s (x_s w_s) (x) B_s; pass 1: sum_l (gy_l e^{cs_l}) (x) C_l.
    // In bfloat16 pass 0 takes x w as two parts, hi = bf16(x w) and lo =
    // bf16(x w - hi), one product each: the states reach ddt and dA
    // through <h_c, dh> and e^{cs} <gy h_c, C>, where one rounding of x w
    // moves a short sequence's dA by about 1%
    const bool split = sizeof(T) == 2 && pass == 0;
    const T* src = pass == 0 ? xb : gb;
    const int64_t sst = pass == 0 ? a.xs[1] : gs;
    const float* scale = pass == 0 ? wst : ecs;
    float acc[kMaxN / 8][4];
    zero(acc);
    for (int j0 = 0; j0 < L; j0 += TL) {
      __syncthreads();           // the tables are written, the tiles read
      if (pass == 0)
        load_rows(Bs, LDN, Bb + (int64_t)(t0 + j0) * a.bs[1], a.bs[1], TL,
                  N);
      else
        load_rows(Bs, LDN, Cb + (int64_t)(t0 + j0) * a.cst[1], a.cst[1], TL,
                  N);
      // the scaled rows, 8 elements a load, 4 loads in flight a thread
      const int cpr = P / 8;
      for (int e0 = tid; e0 < TL * cpr; e0 += 4 * kThreads) {
        float v[4][8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = e0 + k * kThreads;
          if (e >= TL * cpr) continue;
          const int r = e / cpr, col = 8 * (e - r * cpr);
          load8(v[k], src + (int64_t)(t0 + j0 + r) * sst + col);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = e0 + k * kThreads;
          if (e >= TL * cpr) continue;
          const int r = e / cpr, col = 8 * (e - r * cpr);
          const float sc = scale[j0 + r];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float x = v[k][q] * sc;
            const T hi = from_f<T>(x);
            As[r * LDP + col + q] = hi;
            if (split) Al[r * LDP + col + q] = from_f<T>(x - to_f(hi));
          }
        }
      }
      loads_done();
      __syncthreads();
      if (16 * w < P) {          // (P x N) += (rows of As)^T . Bs
        warp_mm<true, true>(acc, N / 8, As + 16 * w, LDP, Bs, LDN, TL);
        if (split)
          warp_mm<true, true>(acc, N / 8, Al + 16 * w, LDP, Bs, LDN, TL);
      }
    }
    if (16 * w < P) {
      float* out = (pass == 0 ? a.st : a.dst) + state_at(a, b, c, h);
#pragma unroll
      for (int nf = 0; nf < kMaxN / 8; ++nf) {
        if (nf >= N / 8) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out[(16 * w + g + 8 * (e >> 1)) * N + 8 * nf + 2 * t + (e & 1)] =
              acc[nf][e];
      }
    }
  }
}

// -- 2. states carried forward, cotangents carried back ----------------------

template <typename T>
__global__ void __launch_bounds__(kScanThreads) bwd_scan(const BwdArgs a) {
  constexpr int kE = kMaxP * kMaxN / (kScanThreads * kScanParts);
  constexpr int kC = kScanBlock;
  __shared__ float red[kC][kScanThreads / 32];
  const int part = blockIdx.x % kScanParts, h = blockIdx.x / kScanParts;
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const int PN = a.P * a.N, L = a.chunk, nc = a.nc;
  const float* cum = a.cum + bht(a, b, h);
  int at[kE];                    // this thread's elements of the state
#pragma unroll
  for (int k = 0; k < kE; ++k)
    at[k] = tid + kScanThreads * (part + kScanParts * k);
  float v[kE];
#pragma unroll
  for (int k = 0; k < kE; ++k) v[k] = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kC) {
    float own[kC][kE], last[kC];
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      const int c = c0 + q;
      const bool ok = c < nc;
      const float* s = a.st + state_at(a, b, ok ? c : 0, h);
      last[q] = ok ? cum[c * L + L - 1] : 0.f;
#pragma unroll
      for (int k = 0; k < kE; ++k)
        own[q][k] = ok && at[k] < PN ? s[at[k]] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      const int c = c0 + q;
      if (c >= nc) continue;
      const float dec = expf(last[q]);
      float* s = a.st + state_at(a, b, c, h);
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        if (at[k] >= PN) continue;
        s[at[k]] = v[k];
        v[k] = v[k] * dec + own[q][k];
      }
    }
  }
  const T* gst = static_cast<const T*>(a.gstate)
                 + ((int64_t)b * a.H + h) * PN;
#pragma unroll
  for (int k = 0; k < kE; ++k) v[k] = at[k] < PN ? to_f(gst[at[k]]) : 0.f;
  for (int c1 = nc - 1; c1 >= 0; c1 -= kC) {   // chunks c1, c1 - 1, ...
    float own[kC][kE], hv[kC][kE], last[kC], sum[kC];
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      const int c = c1 - q;
      const bool ok = c >= 0;
      const float* d = a.dst + state_at(a, b, ok ? c : 0, h);
      const float* s = a.st + state_at(a, b, ok ? c : 0, h);
      last[q] = ok ? cum[c * L + L - 1] : 0.f;
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        own[q][k] = ok && at[k] < PN ? d[at[k]] : 0.f;
        hv[q][k] = ok && at[k] < PN ? s[at[k]] : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      const int c = c1 - q;
      sum[q] = 0.f;
      if (c < 0) continue;
      const float dec = expf(last[q]);
      float* d = a.dst + state_at(a, b, c, h);
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        if (at[k] >= PN) continue;
        d[at[k]] = v[k];
        sum[q] = fmaf(hv[q][k], v[k], sum[q]);
        v[k] = v[k] * dec + own[q][k];
      }
    }
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      const float w = warp_sum(sum[q]);
      if (lane == 0) red[q][tid >> 5] = w;
    }
    __syncthreads();
    if (tid < kC && c1 - tid >= 0) {
      float tot = 0.f;
      for (int i = 0; i < kScanThreads / 32; ++i) tot += red[tid][i];
      a.hd[(((int64_t)b * a.H + h) * nc + c1 - tid) * kScanParts + part] =
          tot;
    }
    __syncthreads();
  }
}

// -- 3 and 4: the chunk-parallel passes --------------------------------------

template <typename T>
constexpr int pass_smem() {
  constexpr int LDP = kMaxP + Pad<T>::v, LDN = kMaxN + Pad<T>::v,
                LDT = kTL + Pad<T>::v;
  return kMaxChunk * kLDG * (int)sizeof(float)
         + (2 * kTL * LDN + kMaxP * LDN + 2 * kTL * LDP + kTL * LDT)
               * (int)sizeof(T)
         + 4 * kMaxChunk * (int)sizeof(float);
}

// the chunk's tables of head h: dt, the cumsum, and the decay factored by
// tiles as the forward factors it: rin_l = exp(cs_l - cs at l's tile's
// first row), rout_s = exp(cs at s's tile's last row - cs_s), so that off
// the diagonal exp(cs_l - cs_s) = rin_l exp(cs_i0 - cs_j1) rout_s, each
// factor <= 1
__device__ __forceinline__ void load_tables(const BwdArgs& a, float* tab,
                                            int b, int c, int h) {
  const int L = a.chunk, TL = a.TL, t0 = c * L;
  const float* db = a.dt + b * a.ds[0] + h * a.ds[2];
  const float* cb = a.cum + bht(a, b, h) + t0;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const int l0 = l & ~(TL - 1);
    const float d = db[(int64_t)(t0 + l) * a.ds[1]], cv = cb[l];
    const float first = cb[l0], last = cb[l0 + TL - 1];
    tab[l] = cv;
    tab[kMaxChunk + l] = d;
    tab[2 * kMaxChunk + l] = expf(cv - first);
    tab[3 * kMaxChunk + l] = expf(last - cv);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_rows(const BwdArgs a) {
  constexpr int LDP = kMaxP + Pad<T>::v, LDN = kMaxN + Pad<T>::v,
                LDT = kTL + Pad<T>::v;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Gs = reinterpret_cast<float*>(smem_raw);  // tiles j: TL x (TL + 4)
  T* Ci = reinterpret_cast<T*>(Gs + kMaxChunk * kLDG);  // kTL x LDN
  T* Hb = Ci + kTL * LDN;          // kMaxP x LDN: h_c, then the B_j tiles
  T* Gy = Hb + kMaxP * LDN;        // kTL x LDP: gy rows of tile i
  T* Xj = Gy + kTL * LDP;          // kTL x LDP: x rows of tile j
  T* Md = Xj + kTL * LDP;          // kTL x LDT: the staged Md tile
  float* cum = reinterpret_cast<float*>(Md + kTL * LDT);   // load_tables
  float* dts = cum + kMaxChunk;
  float* rin = dts + kMaxChunk;
  float* rout = rin + kMaxChunk;

  const int it = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / a.groups, grp = blockIdx.z % a.groups;
  const int h_lo = grp * a.hpg, h_hi = min(a.H, h_lo + a.hpg);
  const int L = a.chunk, TL = a.TL, P = a.P, N = a.N, ldg = TL + 4;
  const int t0 = c * L, i0 = it * TL;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool rows_w = 16 * w < TL;
  const int r0 = 16 * w + g;               // the thread's rows r0, r0 + 8
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.bs[0];
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.cst[0];

  // G_ij = C_i B_j^T, j <= i, once for every head
  load_rows(Ci, LDN, Cb + (int64_t)(t0 + i0) * a.cst[1], a.cst[1], TL, N);
  for (int jt = 0; jt <= it; ++jt) {
    __syncthreads();
    load_rows(Hb, LDN, Bb + (int64_t)(t0 + jt * TL) * a.bs[1], a.bs[1], TL,
              N);
    loads_done();
    __syncthreads();
    if (rows_w) {
      float acc[kTL / 8][4];
      zero(acc);
      warp_mm<false, false>(acc, TL / 8, Ci + 16 * w * LDN, LDN, Hb, LDN,
                            N);
      float* G = Gs + jt * TL * ldg;
#pragma unroll
      for (int nf = 0; nf < kTL / 8; ++nf) {
        if (nf >= TL / 8) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          G[(r0 + 8 * (e >> 1)) * ldg + 8 * nf + 2 * t + (e & 1)] =
              acc[nf][e];
      }
    }
  }

  float dc[kMaxN / 8][4];                  // dC rows of tile i, the group
  zero(dc);
  for (int h = h_lo; h < h_hi; ++h) {
    __syncthreads();             // the last head's tiles are consumed
    load_tables(a, cum, b, c, h);
    load_rows(Gy, LDP, static_cast<const T*>(a.gy)
                           + (((int64_t)b * a.T + t0 + i0) * a.H + h) * P,
              (int64_t)a.H * P, TL, P);
    load_state(Hb, LDN, a.st + state_at(a, b, c, h), P, N);
    loads_done();
    __syncthreads();
    float rsum[2] = {0.f, 0.f};  // sum_s G Md, this thread's columns
    float inter[2] = {0.f, 0.f};
    if (rows_w) {
      // from the state: dC_i += e^{cs} (gy_i . h_c), and its dcs term
      // e^{cs_l} <gy_l h_c, C_l>
      float t1[kMaxN / 8][4];
      zero(t1);
      warp_mm<false, true>(t1, N / 8, Gy + 16 * w * LDP, LDP, Hb, LDN, P);
      const float e0 = expf(cum[i0 + r0]), e1 = expf(cum[i0 + r0 + 8]);
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int nf = 0; nf < kMaxN / 8; ++nf) {
        if (nf >= N / 8) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = 8 * nf + 2 * t + q;
          p0 = fmaf(t1[nf][q], to_f(Ci[r0 * LDN + col]), p0);
          p1 = fmaf(t1[nf][2 + q], to_f(Ci[(r0 + 8) * LDN + col]), p1);
          dc[nf][q] = fmaf(e0, t1[nf][q], dc[nf][q]);
          dc[nf][2 + q] = fmaf(e1, t1[nf][2 + q], dc[nf][2 + q]);
        }
      }
      inter[0] = e0 * quad_sum(p0);
      inter[1] = e1 * quad_sum(p1);
    }
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * TL;
      __syncthreads();           // Hb, Xj and Md are consumed
      load_rows(Xj, LDP, static_cast<const T*>(a.x) + b * a.xs[0]
                             + h * a.xs[2] + (int64_t)(t0 + j0) * a.xs[1],
                a.xs[1], TL, P);
      load_rows(Hb, LDN, Bb + (int64_t)(t0 + j0) * a.bs[1], a.bs[1], TL, N);
      loads_done();
      __syncthreads();
      if (!rows_w) continue;
      // M = gy_i . x_j^T, then Md = M * D * dt (0 above the diagonal)
      float m[kTL / 8][4];
      zero(m);
      warp_mm<false, false>(m, TL / 8, Gy + 16 * w * LDP, LDP, Xj, LDP, P);
      const float* G = Gs + jt * TL * ldg;
      const bool diag = jt == it;
      const float ex = diag ? 0.f : expf(cum[i0] - cum[j0 + TL - 1]);
      const float ri0 = rin[i0 + r0] * ex, ri1 = rin[i0 + r0 + 8] * ex;
#pragma unroll
      for (int nf = 0; nf < kTL / 8; ++nf) {
        if (nf >= TL / 8) continue;
        const int col = 8 * nf + 2 * t, s = j0 + col;
        float md[4];
        if (!diag) {             // the factored decay, times dt_s
          const float c0 = rout[s] * dts[s], c1 = rout[s + 1] * dts[s + 1];
          md[0] = m[nf][0] * ri0 * c0;
          md[1] = m[nf][1] * ri0 * c1;
          md[2] = m[nf][2] * ri1 * c0;
          md[3] = m[nf][3] * ri1 * c1;
        } else {                 // exp per element, 0 above the diagonal
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + 8 * (e >> 1), cc = col + (e & 1);
            const float v =
                m[nf][e] * fast_exp(cum[i0 + r] - cum[j0 + cc]) * dts[j0 + cc];
            md[e] = cc <= r ? v : 0.f;
          }
        }
        const float2 g0 = *reinterpret_cast<const float2*>(G + r0 * ldg + col);
        const float2 g1 =
            *reinterpret_cast<const float2*>(G + (r0 + 8) * ldg + col);
        rsum[0] = fmaf(g0.x, md[0], fmaf(g0.y, md[1], rsum[0]));
        rsum[1] = fmaf(g1.x, md[2], fmaf(g1.y, md[3], rsum[1]));
        store2(Md + r0 * LDT + col, md[0], md[1]);
        store2(Md + (r0 + 8) * LDT + col, md[2], md[3]);
      }
      __syncwarp();              // the warp reads back its own Md rows
      warp_mm<false, true>(dc, N / 8, Md + 16 * w * LDT, LDT, Hb, LDN, TL);
    }
    if (rows_w) {
      const float q0 = quad_sum(rsum[0]), q1 = quad_sum(rsum[1]);
      if (t == 0) {
        float* rq = a.rq + bht(a, b, h) + t0 + i0;
        rq[r0] = q0 + inter[0];
        rq[r0 + 8] = q1 + inter[1];
      }
    }
  }
  if (rows_w) {
    float* out = a.dCp + (((int64_t)grp * a.Bsz + b) * a.T + t0 + i0) * N;
#pragma unroll
    for (int nf = 0; nf < kMaxN / 8; ++nf) {
      if (nf >= N / 8) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(int64_t)(r0 + 8 * (e >> 1)) * N + 8 * nf + 2 * t + (e & 1)] =
            dc[nf][e];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_cols(const BwdArgs a) {
  constexpr int LDP = kMaxP + Pad<T>::v, LDN = kMaxN + Pad<T>::v,
                LDT = kTL + Pad<T>::v;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Gs = reinterpret_cast<float*>(smem_raw);  // tiles i: TL x (TL + 4)
  T* Bj = reinterpret_cast<T*>(Gs + kMaxChunk * kLDG);  // kTL x LDN
  T* Cb = Bj + kTL * LDN;          // kMaxP x LDN: dh, then the C_i tiles
  T* Gy = Cb + kMaxP * LDN;        // kTL x LDP: gy rows of tile i
  T* Xj = Gy + kTL * LDP;          // kTL x LDP: x rows of tile j
  T* St = Xj + kTL * LDP;          // kTL x LDT: the staged Md^T, then Wd
  float* cum = reinterpret_cast<float*>(St + kTL * LDT);   // load_tables
  float* dts = cum + kMaxChunk;
  float* rin = dts + kMaxChunk;
  float* rout = rin + kMaxChunk;

  const int jt = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / a.groups, grp = blockIdx.z % a.groups;
  const int h_lo = grp * a.hpg, h_hi = min(a.H, h_lo + a.hpg);
  const int L = a.chunk, TL = a.TL, P = a.P, N = a.N, ldg = TL + 4;
  const int nt = L / TL, t0 = c * L, j0 = jt * TL;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool rows_w = 16 * w < TL;
  const int r0 = 16 * w + g;               // the thread's key rows r0, +8
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.bs[0];
  const T* Cg = static_cast<const T*>(a.Cm) + b * a.cst[0];

  // G_ij = C_i B_j^T, i >= j, once for every head (tile i stored [s][l])
  load_rows(Bj, LDN, Bb + (int64_t)(t0 + j0) * a.bs[1], a.bs[1], TL, N);
  for (int it = jt; it < nt; ++it) {
    __syncthreads();
    load_rows(Cb, LDN, Cg + (int64_t)(t0 + it * TL) * a.cst[1], a.cst[1],
              TL, N);
    loads_done();
    __syncthreads();
    if (rows_w) {
      float acc[kTL / 8][4];
      zero(acc);
      warp_mm<false, false>(acc, TL / 8, Cb + 16 * w * LDN, LDN, Bj, LDN,
                            N);
      float* G = Gs + it * TL * ldg;
#pragma unroll
      for (int nf = 0; nf < kTL / 8; ++nf) {
        if (nf >= TL / 8) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)    // transposed: G[s][l]
          G[(8 * nf + 2 * t + (e & 1)) * ldg + r0 + 8 * (e >> 1)] =
              acc[nf][e];
      }
    }
  }

  float db[kMaxN / 8][4];                  // dB rows of tile j, the group
  zero(db);
  for (int h = h_lo; h < h_hi; ++h) {
    __syncthreads();             // the last head's tiles are consumed
    load_tables(a, cum, b, c, h);
    load_rows(Xj, LDP, static_cast<const T*>(a.x) + b * a.xs[0]
                           + h * a.xs[2] + (int64_t)(t0 + j0) * a.xs[1],
              a.xs[1], TL, P);
    load_state(Cb, LDN, a.dst + state_at(a, b, c, h), P, N);
    loads_done();
    __syncthreads();
    float dxa[kMaxP / 8][4];     // dx rows of tile j, this head
    zero(dxa);
    float ca[2] = {0.f, 0.f}, ua[2] = {0.f, 0.f};
    if (rows_w) {
      const float cl = cum[L - 1];
      const float ew0 = expf(cl - cum[j0 + r0]);
      const float ew1 = expf(cl - cum[j0 + r0 + 8]);
      const float w0 = ew0 * dts[j0 + r0], w1 = ew1 * dts[j0 + r0 + 8];
      // from the state: dx_j = w (B_j . dh^T), dB_j += w (x_j . dh), and
      // u_s = e^{cs_{L-1} - cs_s} <x_s dh, B_s>
      warp_mm<false, false>(dxa, P / 8, Bj + 16 * w * LDN, LDN, Cb, LDN, N);
#pragma unroll
      for (int nf = 0; nf < kMaxP / 8; ++nf) {
        dxa[nf][0] *= w0;
        dxa[nf][1] *= w0;
        dxa[nf][2] *= w1;
        dxa[nf][3] *= w1;
      }
      float t3[kMaxN / 8][4];
      zero(t3);
      warp_mm<false, true>(t3, N / 8, Xj + 16 * w * LDP, LDP, Cb, LDN, P);
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int nf = 0; nf < kMaxN / 8; ++nf) {
        if (nf >= N / 8) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = 8 * nf + 2 * t + q;
          p0 = fmaf(t3[nf][q], to_f(Bj[r0 * LDN + col]), p0);
          p1 = fmaf(t3[nf][2 + q], to_f(Bj[(r0 + 8) * LDN + col]), p1);
          db[nf][q] = fmaf(w0, t3[nf][q], db[nf][q]);
          db[nf][2 + q] = fmaf(w1, t3[nf][2 + q], db[nf][2 + q]);
        }
      }
      ua[0] = ew0 * quad_sum(p0);
      ua[1] = ew1 * quad_sum(p1);
    }
    for (int it = jt; it < nt; ++it) {
      const int i0 = it * TL;
      __syncthreads();           // Cb, Gy and St are consumed
      load_rows(Gy, LDP, static_cast<const T*>(a.gy)
                             + (((int64_t)b * a.T + t0 + i0) * a.H + h) * P,
                (int64_t)a.H * P, TL, P);
      load_rows(Cb, LDN, Cg + (int64_t)(t0 + i0) * a.cst[1], a.cst[1], TL,
                N);
      loads_done();
      __syncthreads();
      if (!rows_w) continue;
      // M^T = x_j . gy_i^T; Md^T = M^T * D * dt_s staged, Wd kept in m
      float m[kTL / 8][4];
      zero(m);
      warp_mm<false, false>(m, TL / 8, Xj + 16 * w * LDP, LDP, Gy, LDP, P);
      const float* G = Gs + it * TL * ldg;
      const bool diag = it == jt;
      const float ex = diag ? 0.f : expf(cum[i0] - cum[j0 + TL - 1]);
      const float ro0 = rout[j0 + r0] * ex, ro1 = rout[j0 + r0 + 8] * ex;
      const float d0 = dts[j0 + r0], d1 = dts[j0 + r0 + 8];
#pragma unroll
      for (int nf = 0; nf < kTL / 8; ++nf) {
        if (nf >= TL / 8) continue;
        const int col = 8 * nf + 2 * t, l = i0 + col;
        float dd[4];
        if (!diag) {             // the factored decay
          const float c0 = rin[l], c1 = rin[l + 1];
          dd[0] = ro0 * c0;
          dd[1] = ro0 * c1;
          dd[2] = ro1 * c0;
          dd[3] = ro1 * c1;
        } else {                 // exp per element, 0 below the diagonal
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + 8 * (e >> 1), cc = col + (e & 1);
            const float v = fast_exp(cum[i0 + cc] - cum[j0 + r]);
            dd[e] = cc >= r ? v : 0.f;
          }
        }
        const float2 g0 = *reinterpret_cast<const float2*>(G + r0 * ldg + col);
        const float2 g1 =
            *reinterpret_cast<const float2*>(G + (r0 + 8) * ldg + col);
        const float g[4] = {g0.x, g0.y, g1.x, g1.y};
        float mdt[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ds = e < 2 ? d0 : d1;
          const float gd = g[e] * dd[e];
          ca[e >> 1] = fmaf(gd, m[nf][e], ca[e >> 1]);
          mdt[e] = m[nf][e] * dd[e] * ds;
          m[nf][e] = gd * ds;
        }
        store2(St + r0 * LDT + col, mdt[0], mdt[1]);
        store2(St + (r0 + 8) * LDT + col, mdt[2], mdt[3]);
      }
      __syncwarp();
      warp_mm<false, true>(db, N / 8, St + 16 * w * LDT, LDT, Cb, LDN, TL);
      __syncwarp();              // Md^T is read: Wd takes its place
#pragma unroll
      for (int nf = 0; nf < kTL / 8; ++nf) {
        if (nf >= TL / 8) continue;
        const int col = 8 * nf + 2 * t;
        store2(St + r0 * LDT + col, m[nf][0], m[nf][1]);
        store2(St + (r0 + 8) * LDT + col, m[nf][2], m[nf][3]);
      }
      __syncwarp();
      warp_mm<false, true>(dxa, P / 8, St + 16 * w * LDT, LDT, Gy, LDP, TL);
    }
    if (rows_w) {
      const float c0 = quad_sum(ca[0]), c1 = quad_sum(ca[1]);
      const int64_t at = bht(a, b, h) + t0 + j0;
      if (t == 0) {
        a.ce[at + r0] = c0;
        a.ce[at + r0 + 8] = c1;
        a.us[at + r0] = ua[0];
        a.us[at + r0 + 8] = ua[1];
      }
      T* dxb = static_cast<T*>(a.dx)
               + (((int64_t)b * a.T + t0 + j0) * a.H + h) * P;
      const int64_t xsr = (int64_t)a.H * P;
#pragma unroll
      for (int nf = 0; nf < kMaxP / 8; ++nf) {
        if (nf >= P / 8) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dxb[(r0 + 8 * (e >> 1)) * xsr + 8 * nf + 2 * t + (e & 1)] =
              from_f<T>(dxa[nf][e]);
      }
    }
  }
  if (rows_w) {
    float* out = a.dBp + (((int64_t)grp * a.Bsz + b) * a.T + t0 + j0) * N;
#pragma unroll
    for (int nf = 0; nf < kMaxN / 8; ++nf) {
      if (nf >= N / 8) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(int64_t)(r0 + 8 * (e >> 1)) * N + 8 * nf + 2 * t + (e & 1)] =
            db[nf][e];
    }
  }
}

// -- 5. ddt and dA -----------------------------------------------------------

__global__ void __launch_bounds__(32) bwd_dt(const BwdArgs a) {
  constexpr int kE = kMaxChunk / 32;
  const int h = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const int L = a.chunk, E = (L + 31) / 32;
  const float A_h = a.A[h];
  float dA_part = 0.f;
  {
    const float* db = a.dt + b * a.ds[0] + h * a.ds[2];
    for (int c = 0; c < a.nc; ++c) {
      const int t0 = c * L;
      const int64_t row = bht(a, b, h) + t0;
      float dtv[kE], dd[kE], dcs[kE];
      float vs = 0.f;
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const int l = lane * E + k;
        const bool ok = k < E && l < L;
        dtv[k] = ok ? db[(int64_t)(t0 + l) * a.ds[1]] : 0.f;
        const float u = ok ? a.us[row + l] : 0.f;
        dd[k] = ok ? a.ce[row + l] + u : 0.f;
        dcs[k] = ok ? a.rq[row + l] - dtv[k] * dd[k] : 0.f;
        vs = fmaf(dtv[k], u, vs);
      }
      vs = warp_sum(vs);
      const float* hdc =
          a.hd + (((int64_t)b * a.H + h) * a.nc + c) * kScanParts;
      float hsum = 0.f;
      for (int q = 0; q < kScanParts; ++q) hsum += hdc[q];
#pragma unroll
      for (int k = 0; k < kE; ++k)
        if (k < E && lane * E + k == L - 1)
          dcs[k] += vs + expf(a.cum[row + L - 1]) * hsum;
      // da = reverse cumsum of dcs: in order within a lane, then the sum
      // of the later lanes' totals
      float run = 0.f, suf[kE];
#pragma unroll
      for (int k = kE - 1; k >= 0; --k) {
        run += dcs[k];
        suf[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += v;
      }
      float later = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) later = 0.f;
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const int l = lane * E + k;
        if (k >= E || l >= L) continue;
        const float da = suf[k] + later;
        a.ddt[((int64_t)b * a.T + t0 + l) * a.H + h] = A_h * da + dd[k];
        dA_part = fmaf(dtv[k], da, dA_part);
      }
    }
  }
  dA_part = warp_sum(dA_part);
  if (lane == 0) a.dAp[(int64_t)b * a.H + h] = dA_part;
}

// -- 6. dB and dC over the head groups ---------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) bwd_reduce(const BwdArgs a) {
  const int64_t n = (int64_t)a.Bsz * a.T * a.N;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    float sb = 0.f, sc = 0.f;
    for (int q = 0; q < a.groups; ++q) {
      sb += a.dBp[q * n + e];
      sc += a.dCp[q * n + e];
    }
    static_cast<T*>(a.dB)[e] = from_f<T>(sb);
    static_cast<T*>(a.dC)[e] = from_f<T>(sc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < a.H; h += blockDim.x) {
      float s = 0.f;
      for (int b = 0; b < a.Bsz; ++b) s += a.dAp[(int64_t)b * a.H + h];
      a.dA[h] = s;
    }
  }
}

int64_t scratch_floats(int Bsz, int T, int H, int P, int N, int chunk,
                       int groups) {
  const int64_t nc = T / chunk, bht = (int64_t)Bsz * H * T;
  return 4 * bht + 2 * (int64_t)Bsz * nc * H * P * N
         + (int64_t)Bsz * H * nc * kScanParts
         + 2 * (int64_t)groups * Bsz * T * N + (int64_t)Bsz * H;
}

template <typename T>
int launch(const BwdArgs& a, cudaStream_t s) {
  cudaError_t err;
  const int nt = a.chunk / a.TL;
  const int ss = states_smem<T>(), ps = pass_smem<T>();
  err = cudaFuncSetAttribute(bwd_states<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, ss);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_rows<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, ps);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_cols<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, ps);
  if (err != cudaSuccess) return (int)err;
  bwd_states<T><<<dim3(a.nc, a.H, a.Bsz), kThreads, ss, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_scan<T><<<dim3(a.H * kScanParts, a.Bsz), kScanThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid(nt, a.nc, a.Bsz * a.groups);
  bwd_rows<T><<<grid, kThreads, ps, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_cols<T><<<grid, kThreads, ps, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_dt<<<dim3(a.H, a.Bsz), 32, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)a.Bsz * a.T * a.N;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  bwd_reduce<T><<<blocks, 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch ssd_backward needs for these shapes and head groups.
int64_t ssd_backward_scratch(int Bsz, int T, int H, int P, int N, int chunk,
                             int groups) {
  return scratch_floats(Bsz, T, H, P, N, chunk, groups);
}

// x (Bsz, T, H, P), dt (Bsz, T, H) f32, A (H,) f32, B/C (Bsz, T, N) as the
// forward takes them (strides: 10 int64 in elements, the (b, t, h) strides
// of x and of dt, then the (b, t) strides of B and of C; bfloat16 x, B and
// C 16-B aligned with strides in multiples of 8); gy (Bsz, T, H, P) and
// gstate (Bsz, H, P, N) contiguous in x's type, gy 16-B aligned.  Writes dx
// (Bsz, T, H, P), dB and dC (Bsz, T, N) contiguous in x's type and ddt
// (Bsz, T, H), dA (H,) float32 (dtype 0: float32, CUDA cores; 1: bfloat16,
// tensor cores).  scratch holds ssd_backward_scratch(...) floats; `groups`
// head groups split each chunk's heads across CTAs (1 <= groups <= H).  The
// caller checks the forward's limits, Bsz, T / chunk and Bsz * groups
// within 65535, and T > 0.  Returns the first launch error, or
// cudaGetLastError() after the last launch.
int ssd_backward(const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, const void* gy,
                 const void* gstate, void* dx, void* ddt, void* dA, void* dB,
                 void* dC, void* scratch, int dtype, int Bsz, int T, int H,
                 int P, int N, int chunk, int groups, const int64_t* strides,
                 void* stream) {
  if (Bsz <= 0 || H <= 0) return (int)cudaSuccess;
  if (P % 16 || N % 16 || chunk % 16 || P > kMaxP || N > kMaxN ||
      chunk > kMaxChunk || T <= 0 || T % chunk || groups < 1 || groups > H)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.x = x; a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = Bm; a.Cm = Cm; a.gy = gy; a.gstate = gstate;
  a.dx = dx; a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA); a.dB = dB; a.dC = dC;
  a.Bsz = Bsz; a.T = T; a.H = H; a.P = P; a.N = N; a.chunk = chunk;
  a.TL = chunk % 64 == 0 ? 64 : (chunk % 32 == 0 ? 32 : 16);
  a.nc = T / chunk;
  a.hpg = (H + groups - 1) / groups;
  a.groups = (H + a.hpg - 1) / a.hpg;
  float* f = static_cast<float*>(scratch);
  const int64_t bht = (int64_t)Bsz * H * T;
  const int64_t states = (int64_t)Bsz * a.nc * H * P * N;
  a.cum = f; f += bht;
  a.rq = f; f += bht;
  a.ce = f; f += bht;
  a.us = f; f += bht;
  a.st = f; f += states;
  a.dst = f; f += states;
  a.hd = f; f += (int64_t)Bsz * H * a.nc * kScanParts;
  a.dBp = f; f += (int64_t)groups * Bsz * T * N;
  a.dCp = f; f += (int64_t)groups * Bsz * T * N;
  a.dAp = f;
  for (int i = 0; i < 3; ++i) {
    a.xs[i] = strides[i];
    a.ds[i] = strides[3 + i];
  }
  for (int i = 0; i < 2; ++i) {
    a.bs[i] = strides[6 + i];
    a.cst[i] = strides[8 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, s);
  if (dtype == 1) return launch<bf16_t>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
