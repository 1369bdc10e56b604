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
// A (H,) in float32.  y and the final state are written in x's type.
//
// What bounds it on this card: at the mamba2-370m prefill shape
// (B=8, T=4096, H=32, P=64, N=128, L=256, bf16) the causal work is about
// 5.3e10 FLOPs (C B^T once per batch row and chunk, the rest per head)
// against about 293 MB of inputs and outputs, so device-memory bytes bound
// it (0.088 ms at 3.35 TB/s).  The entry point picks one of two kernels by
// dtype.  Both give each CTA one (head, batch) and walk its chunks in order
// (the TPU grid's sequential chunk axis becomes a loop inside the CTA), and
// both read x, dt, B and C through strides, so the model's slices of the
// convolution output are read in place.
//
// bfloat16 (ssd_fwd_bf16): the tensor cores.  An SSD chunk is causal linear
// attention with a decay mask in place of the softmax (C plays Q, B plays K,
// x plays V), so it reuses the flash-attention kernel's pieces
// (flash_attention.cu): mma.sync m16n8k16 bf16 -> f32, ldmatrix(.trans),
// a cp.async ring.
//  * 4 warps, 2 CTAs an SM (111,616 B of shared memory each), so the 256
//    CTAs of the mamba2 prefill are all resident at once on 132 SMs.
//  * A chunk is cut into output tiles of TL rows (TL = 64, or 32 / 16 for
//    short chunks); warp w owns rows 16w..16w+15 of a tile.  For output
//    tile i and each key tile j <= i:
//      S = C_i B_j^T (C fragments held in registers for the whole tile),
//      W = S * exp(cs_i - cs_j) * dt_j in registers, rounded to bf16 as the
//          A fragment of the next product (as flash rounds P),
//      y_i += W . x_j (x by ldmatrix.trans, as V in flash).
//    Off the diagonal the decay factors as
//      exp(cs_i - cs_i0) * exp(cs_i0 - cs_j1) * exp(cs_j1 - cs_j) * dt_j
//    (i0 the output tile's first row, j1 the key tile's last), each factor
//    <= 1, so one exp a tile pair and two per-row tables replace an exp an
//    element; only the diagonal tile takes exp(cs_i - cs_j) per element
//    and masks j > i (the select drops the masked side's exp, which may
//    overflow).  There a warp also skips the key columns past its last row.
//  * Inter-chunk term, first at each output tile: y_i = (C_i . h^T) *
//    exp(cs_i), with a bf16 copy of the carried state h in shared memory as
//    the B operand; the W.x products then accumulate on top.
//  * State update: h <- h * exp(cs_{L-1}) + (x * w)^T . B, w = exp(cs_{L-1}
//    - cs) * dt, on the tensor cores while the last output tile walks every
//    key tile of the chunk.  h itself stays float32, as the mma accumulator
//    of the warp that owns its rows 16w..16w+15 (64 registers a thread),
//    for the whole walk.  w scales the x fragment (16 values a k step)
//    rather than the B fragments (64), so x * w is what is rounded to bf16.
//  * The cumsum is a warp scan: each lane sums L/32 consecutive dt * A in
//    order, a Hillis-Steele __shfl_up_sync scan adds the lane totals, and
//    each lane adds its exclusive prefix.  This changes the summation
//    order against the reference's sequential cumsum (float32 rounding
//    only).  The next chunk's dt is loaded into registers meanwhile.
//  * Loads: 16-B cp.async copies into rows padded by 16 B (so the 8 rows
//    of an ldmatrix phase fall on distinct bank groups), B and x in a
//    2-stage ring across the whole walk (the next tile pair's rows are in
//    flight while this one is multiplied), C in two slots that alternate
//    by output tile.  Nothing is converted to float32 in shared memory.
//  Rounding points, the divergence from the reference (float32
//  throughout): W, x * w and the state operand are rounded to bf16 before
//  the tensor cores; all sums are float32.  C B^T is recomputed for every
//  head (43% of the tile work): computing it once per (batch row, chunk)
//  needs several heads a CTA, the next step for this kernel.
//
// float32 (ssd_fwd_kernel): the CUDA cores, all arithmetic float32.
// The reference's float32 limit of 1e-4 needs full float32 products; TF32
// tensor cores (10-bit mantissa) would not hold it.
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
//    before each add, as the reference computes dA first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// -- float32: CUDA cores ------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;

__host__ __device__ inline int smem_floats(int P, int N, int TL, int chunk) {
  return P * (N + 1) + 2 * TL * (N + 1) + TL * (P + 1) + TL * (TL + 1)
         + 4 * chunk;
}

__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src,
                                          int64_t row_stride, int rows,
                                          int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols, c = e % cols;
    dst[r * ld + c] = src[r * row_stride + c];
  }
}

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
  const float* xb = static_cast<const float*>(a.x) + b * a.xs[0] + h * a.xs[2];
  const float* db = a.dt + b * a.ds[0] + h * a.ds[2];
  const float* Bb = static_cast<const float*>(a.Bm) + b * a.bs[0];
  const float* Cb = static_cast<const float*>(a.Cm) + b * a.cs[0];
  float* yb = static_cast<float*>(a.y) + (int64_t)b * a.T * a.H * P
              + (int64_t)h * P;
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
        float* yrow = yb + (int64_t)(t0 + i0 + r) * ys;
#pragma unroll
        for (int c = 0; c < kMaxP / 16; ++c)
          if (c < pc) yrow[tx + 16 * c] = yacc[i][c] + inter[c] * e;
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
  float* st = static_cast<float*>(a.state) + ((int64_t)b * a.H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    st[e] = S[(e / N) * LDN + e % N];
}


}  // namespace f32

// -- bfloat16: tensor cores (mma.sync m16n8k16) ------------------------------

namespace bf16 {

using bf16_t = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTL = 64;                 // rows of an output or key tile
constexpr int kLDN = kMaxN + 8;         // padded row of C, B and the state
constexpr int kLDP = kMaxP + 8;         // padded row of x
constexpr int kRowN = kLDN * (int)sizeof(bf16_t);   // bytes
constexpr int kRowP = kLDP * (int)sizeof(bf16_t);
constexpr int kE = kMaxChunk / 32;      // cumsum terms a lane, at most
constexpr float kLog2e = 1.4426950408889634f;
// C: 2 slots, B and x: 2 stages, the state copy, then 6 float tables of
// the chunk (cumsum, dt, exp(cs), state weights, row and column decay)
constexpr int kSmemBytes =
    (4 * kTL * kLDN + 2 * kTL * kLDP + kMaxP * kLDN) * (int)sizeof(bf16_t)
    + 6 * kMaxChunk * (int)sizeof(float);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 B global -> shared, bypassing L1
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// two floats -> bf16x2, round to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a bf16x2 times (lo, hi), rounded back to bf16x2
__device__ __forceinline__ uint32_t scale2(uint32_t v, float lo, float hi) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack(f.x * lo, f.y * hi);
}

// e^x on the special-function unit (2^(x log2 e)); used on the diagonal
// tile, where x = cs_i - cs_j <= 0 for every kept element
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16: a[0] (row g, k 2t..2t+1), a[1] (row g+8, same k),
//            a[2] (row g, k 2t+8..), a[3] (row g+8, k 2t+8..);
//   B 16x8:  b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g);
//   C 16x8:  c[0..1] (row g, col 2t..2t+1), c[2..3] (row g+8, same cols).
// ldmatrix.x4: lanes 8i..8i+7 address the rows of 8x8 matrix i, which lands
// in register i (row g, cols 2t..2t+1; .trans: col g, rows 2t..2t+1).
// The products and where their operands come from:
//   S = C . B^T     A: C rows (ldmatrix), B: B rows as columns (ldmatrix);
//   y += W . x      A: W from S's registers, B: x (ldmatrix.trans);
//   y  = C . h^T    A: C, B: the state copy's rows (ldmatrix);
//   h += (x w)^T B  A: x (ldmatrix.trans, scaled by w in registers),
//                   B: B (ldmatrix.trans).
__global__ void __launch_bounds__(kThreads, 2) ssd_fwd_bf16(const SsdArgs a) {
  const int P = a.P, N = a.N, L = a.chunk, TL = a.TL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* Cs = reinterpret_cast<bf16_t*>(smem_raw);   // 2 x kTL x kLDN
  bf16_t* Bs = Cs + 2 * kTL * kLDN;                    // 2 x kTL x kLDN
  bf16_t* Xs = Bs + 2 * kTL * kLDN;                    // 2 x kTL x kLDP
  bf16_t* Hs = Xs + 2 * kTL * kLDP;                    // kMaxP x kLDN
  float* cum = reinterpret_cast<float*>(Hs + kMaxP * kLDN);
  float* dts = cum + kMaxChunk;    // dt
  float* ecs = dts + kMaxChunk;    // exp(cs)
  float* wst = ecs + kMaxChunk;    // exp(cs_{L-1} - cs) * dt
  float* rin = wst + kMaxChunk;    // exp(cs - cs at the tile's first row)
  float* rout = rin + kMaxChunk;   // exp(cs at the tile's last row - cs) dt

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const float A_h = a.A[h];
  const bf16_t* xb = static_cast<const bf16_t*>(a.x) + b * a.xs[0]
                     + h * a.xs[2];
  const float* db = a.dt + b * a.ds[0] + h * a.ds[2];
  const bf16_t* Bb = static_cast<const bf16_t*>(a.Bm) + b * a.bs[0];
  const bf16_t* Cb = static_cast<const bf16_t*>(a.Cm) + b * a.cs[0];
  bf16_t* yb = static_cast<bf16_t*>(a.y) + (int64_t)b * a.T * a.H * P
               + (int64_t)h * P;
  const int64_t ys = (int64_t)a.H * P;

  const int nt = L / TL;                          // tiles a chunk
  const int n_chunks = a.T / L;
  const int total = n_chunks * nt * (nt + 1) / 2; // tile pairs in the walk
  const int PT = P / 16, NT = N / 16, KT = TL / 16;
  const bool has_rows = 16 * w < TL;              // output rows in a tile
  const bool has_state = 16 * w < P;              // state rows

  // rows [r0, r0 + TL) of a (T, cols) operand into a padded tile
  auto load_tile = [&](bf16_t* dst, int ld, const bf16_t* src,
                       int64_t stride, int r0, int cols) {
    const int cpr = cols / 8;                     // 16-B chunks a row
    for (int e = tid; e < TL * cpr; e += kThreads) {
      const int r = e / cpr, c = e - r * cpr;
      cp_async_16(smem_u32(dst + r * ld + c * 8),
                  src + (int64_t)(r0 + r) * stride + c * 8);
    }
  };
  // pair (c, it, jt): B and x of key tile jt into stage st, and C of output
  // tile it into its slot when jt == 0
  auto load_pair = [&](int c, int it, int jt, int st) {
    const int t0 = c * L;
    load_tile(Bs + st * kTL * kLDN, kLDN, Bb, a.bs[1], t0 + jt * TL, N);
    load_tile(Xs + st * kTL * kLDP, kLDP, xb, a.xs[1], t0 + jt * TL, P);
    if (jt == 0)
      load_tile(Cs + ((c * nt + it) & 1) * kTL * kLDN, kLDN, Cb, a.cs[1],
                t0 + it * TL, N);
  };
  load_pair(0, 0, 0, 0);
  cp_async_commit();

  // per-lane ldmatrix addresses (stage, slot and tile offsets added later):
  //   row-major A (C): rows lane % 16, k half lane / 16;
  //   B from rows (B for S, the state copy for C.h^T): rows lane % 8 +
  //     8 (lane / 16), k half (lane / 8) % 2;
  //   B from columns, .trans (x for W.x, B for the state update): k rows
  //     lane % 8 + 8 ((lane / 8) % 2), column half lane / 16;
  //   A from columns, .trans (x^T for the state update): k rows lane % 8 +
  //     8 (lane / 16), m half (lane / 8) % 2.
  const uint32_t c_lane =
      smem_u32(Cs + (16 * w + (lane & 15)) * kLDN + (lane >> 4) * 8);
  const int row_b = (lane & 7) + ((lane >> 4) << 3);
  const int half_b = ((lane >> 3) & 1) * 8;
  const int row_t = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int half_t = (lane >> 4) * 8;
  const uint32_t b_lane = smem_u32(Bs + row_b * kLDN + half_b);
  const uint32_t h_lane = smem_u32(Hs + row_b * kLDN + half_b);
  const uint32_t x_lane = smem_u32(Xs + row_t * kLDP + half_t);
  const uint32_t bt_lane = smem_u32(Bs + row_t * kLDN + half_t);
  const uint32_t xt_lane = smem_u32(Xs + row_b * kLDP + 16 * w + half_b);

  // the chunk's dt, E consecutive steps a lane of warp 0
  const int E = (L + 31) / 32;
  float dtv[kE];
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const int l = lane * E + k;
    dtv[k] = (w == 0 && k < E && l < L) ? db[(int64_t)l * a.ds[1]] : 0.f;
  }

  // the state: rows 16w + g (+8), columns 8n + 2t (+1), float32
  float hacc[kMaxN / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxN / 8; ++n)
    hacc[n][0] = hacc[n][1] = hacc[n][2] = hacc[n][3] = 0.f;

  int p = 0;                                      // tile pair of the walk
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    __syncthreads();             // the last chunk's tables and Hs are read
    if (w == 0) {
      // cumsum(dt * A): in order within a lane, a warp scan across lanes
      float run[kE], acc = 0.f;
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        acc = __fadd_rn(acc, __fmul_rn(dtv[k], A_h));
        run[k] = acc;
      }
      float incl = acc;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl = __fadd_rn(incl, v);
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const int l = lane * E + k;
        if (k < E && l < L) {
          cum[l] = __fadd_rn(excl, run[k]);
          dts[l] = dtv[k];
        }
      }
      // the next chunk's dt, in flight while this chunk is computed
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const int l = lane * E + k;
        dtv[k] = (c + 1 < n_chunks && k < E && l < L)
                     ? db[(int64_t)(t0 + L + l) * a.ds[1]] : 0.f;
      }
    }
    if (has_state) {             // the old state, bf16, for C . h^T
#pragma unroll
      for (int n = 0; n < kMaxN / 8; ++n) {
        if (n >= N / 8) continue;
        bf16_t* row = Hs + (16 * w + g) * kLDN + 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(row) = pack(hacc[n][0], hacc[n][1]);
        *reinterpret_cast<uint32_t*>(row + 8 * kLDN) =
            pack(hacc[n][2], hacc[n][3]);
      }
    }
    __syncthreads();
    const float cs_last = cum[L - 1];
    for (int l = tid; l < L; l += kThreads) {
      const float cv = cum[l], d = dts[l];
      const int l0 = l & ~(TL - 1);
      ecs[l] = expf(cv);
      wst[l] = expf(cs_last - cv) * d;
      rin[l] = expf(cv - cum[l0]);
      rout[l] = expf(cum[l0 + TL - 1] - cv) * d;
    }
    const float decay = expf(cs_last);
#pragma unroll
    for (int n = 0; n < kMaxN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[n][e] *= decay;

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * TL;
      const int ri = i0 + 16 * w + g;             // the thread's rows ri, +8
      const uint32_t c_slot = c_lane + ((c * nt + it) & 1) * kTL * kRowN;
      uint32_t cf[kMaxN / 16][4];                 // C rows, k = N
      float yacc[kMaxP / 8][4];                   // y rows, columns 8n + 2t
#pragma unroll
      for (int n = 0; n < kMaxP / 8; ++n)
        yacc[n][0] = yacc[n][1] = yacc[n][2] = yacc[n][3] = 0.f;

      for (int jt = 0; jt <= it; ++jt, ++p) {
        const int st = p & 1;
        if (p + 1 < total) {     // the next pair into the other stage
          if (jt < it) load_pair(c, it, jt + 1, st ^ 1);
          else if (it + 1 < nt) load_pair(c, it + 1, 0, st ^ 1);
          else load_pair(c + 1, 0, 0, st ^ 1);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const int j0 = jt * TL;

        if (has_rows) {
          if (jt == 0) {
#pragma unroll
            for (int kk = 0; kk < kMaxN / 16; ++kk)
              if (kk < NT) ldsm_x4(cf[kk], c_slot + kk * 32);
            if (c > 0) {         // y = (C . h^T) * exp(cs)
#pragma unroll
              for (int kk = 0; kk < kMaxN / 16; ++kk) {
                if (kk >= NT) continue;
#pragma unroll
                for (int pp = 0; pp < kMaxP / 16; ++pp) {
                  if (pp >= PT) continue;
                  uint32_t hb[4];
                  ldsm_x4(hb, h_lane + pp * 16 * kRowN + kk * 32);
                  mma(yacc[2 * pp], cf[kk], hb[0], hb[1]);
                  mma(yacc[2 * pp + 1], cf[kk], hb[2], hb[3]);
                }
              }
              const float e0 = ecs[ri], e1 = ecs[ri + 8];
#pragma unroll
              for (int n = 0; n < kMaxP / 8; ++n) {
                yacc[n][0] *= e0;
                yacc[n][1] *= e0;
                yacc[n][2] *= e1;
                yacc[n][3] *= e1;
              }
            }
          }

          // S = C_i . B_j^T over the key columns this warp needs
          const bool diag = jt == it;
          const int nlim = diag ? min(TL, 16 * w + 16) / 8 : TL / 8;
          float s[kTL / 8][4];
#pragma unroll
          for (int n = 0; n < kTL / 8; ++n)
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
          const uint32_t b_st = b_lane + st * kTL * kRowN;
#pragma unroll
          for (int kk = 0; kk < kMaxN / 16; ++kk) {
            if (kk >= NT) continue;
#pragma unroll
            for (int np = 0; np < kTL / 16; ++np) {
              if (2 * np >= nlim) continue;
              uint32_t kb[4];
              ldsm_x4(kb, b_st + np * 16 * kRowN + kk * 32);
              mma(s[2 * np], cf[kk], kb[0], kb[1]);
              mma(s[2 * np + 1], cf[kk], kb[2], kb[3]);
            }
          }

          // W = S * exp(cs_i - cs_j) * dt_j, masked on the diagonal
          if (!diag) {
            const float ex = expf(cum[i0] - cum[j0 + TL - 1]);
            const float r0 = rin[ri], r1 = rin[ri + 8];
#pragma unroll
            for (int n = 0; n < kTL / 8; ++n) {
              if (n >= nlim) continue;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float cf_j = ex * rout[j0 + 8 * n + 2 * t + e];
                s[n][e] = s[n][e] * r0 * cf_j;
                s[n][2 + e] = s[n][2 + e] * r1 * cf_j;
              }
            }
          } else {
            const float c0 = cum[ri], c1 = cum[ri + 8];
#pragma unroll
            for (int n = 0; n < kTL / 8; ++n) {
              if (n >= nlim) continue;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int j = j0 + 8 * n + 2 * t + e;
                const float cj = cum[j], dj = dts[j];
                const float w0 = s[n][e] * fast_exp(c0 - cj) * dj;
                const float w1 = s[n][2 + e] * fast_exp(c1 - cj) * dj;
                s[n][e] = j <= ri ? w0 : 0.f;
                s[n][2 + e] = j <= ri + 8 ? w1 : 0.f;
              }
            }
          }

          // y += W . x_j: score tiles 2kk and 2kk+1 are the k16 A fragment kk
          const uint32_t x_st = x_lane + st * kTL * kRowP;
#pragma unroll
          for (int kk = 0; kk < kTL / 16; ++kk) {
            if (2 * kk >= nlim) continue;
            uint32_t wa[4];
            wa[0] = pack(s[2 * kk][0], s[2 * kk][1]);
            wa[1] = pack(s[2 * kk][2], s[2 * kk][3]);
            wa[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            wa[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int dp = 0; dp < kMaxP / 16; ++dp) {
              if (dp >= PT) continue;
              uint32_t vb[4];
              ldsm_x4_trans(vb, x_st + kk * 16 * kRowP + dp * 32);
              mma(yacc[2 * dp], wa, vb[0], vb[1]);
              mma(yacc[2 * dp + 1], wa, vb[2], vb[3]);
            }
          }
        }

        // the last output tile walks every key tile: h += (x_j w)^T . B_j
        if (it == nt - 1 && has_state) {
          const uint32_t xt_st = xt_lane + st * kTL * kRowP;
          const uint32_t bt_st = bt_lane + st * kTL * kRowN;
#pragma unroll
          for (int kk = 0; kk < kTL / 16; ++kk) {
            if (kk >= KT) continue;
            uint32_t xa[4];
            ldsm_x4_trans(xa, xt_st + kk * 16 * kRowP);
            const int k = j0 + 16 * kk + 2 * t;
            const float w0 = wst[k], w1 = wst[k + 1];
            const float w8 = wst[k + 8], w9 = wst[k + 9];
            xa[0] = scale2(xa[0], w0, w1);
            xa[1] = scale2(xa[1], w0, w1);
            xa[2] = scale2(xa[2], w8, w9);
            xa[3] = scale2(xa[3], w8, w9);
#pragma unroll
            for (int np = 0; np < kMaxN / 16; ++np) {
              if (np >= NT) continue;
              uint32_t bb[4];
              ldsm_x4_trans(bb, bt_st + kk * 16 * kRowN + np * 32);
              mma(hacc[2 * np], xa, bb[0], bb[1]);
              mma(hacc[2 * np + 1], xa, bb[2], bb[3]);
            }
          }
        }
        __syncthreads();         // stage st is free for pair p + 2
      }

      if (has_rows) {            // y rows ri and ri + 8, bf16 pairs
        bf16_t* y0 = yb + (int64_t)(t0 + ri) * ys + 2 * t;
        bf16_t* y1 = y0 + 8 * ys;
#pragma unroll
        for (int n = 0; n < kMaxP / 8; ++n) {
          if (n >= P / 8) continue;
          *reinterpret_cast<uint32_t*>(y0 + 8 * n) =
              pack(yacc[n][0], yacc[n][1]);
          *reinterpret_cast<uint32_t*>(y1 + 8 * n) =
              pack(yacc[n][2], yacc[n][3]);
        }
      }
    }
  }

  if (has_state) {
    bf16_t* st = static_cast<bf16_t*>(a.state)
                 + ((int64_t)b * a.H + h) * P * N + (16 * w + g) * N + 2 * t;
#pragma unroll
    for (int n = 0; n < kMaxN / 8; ++n) {
      if (n >= N / 8) continue;
      *reinterpret_cast<uint32_t*>(st + 8 * n) = pack(hacc[n][0], hacc[n][1]);
      *reinterpret_cast<uint32_t*>(st + 8 * N + 8 * n) =
          pack(hacc[n][2], hacc[n][3]);
    }
  }
}

}  // namespace bf16

}  // namespace

extern "C" {

// x (Bsz, T, H, P), dt (Bsz, T, H) f32, A (H,) f32, B/C (Bsz, T, N);
// y (Bsz, T, H, P) and state (Bsz, H, P, N) contiguous, in x's type
// (dtype 0: float32, CUDA-core kernel; 1: bfloat16, tensor-core kernel).
// strides: 10 int64 in elements, the (b, t, h) strides of x and of dt,
// then the (b, t) strides of B and of C; for bfloat16 x, B and C start
// 16-B aligned and their strides are multiples of 8.  The caller checks
// T % chunk == 0, chunk % 16 == 0, P % 16 == 0, N % 16 == 0 and the maxima
// above.  Returns cudaGetLastError().
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, Bsz);
  cudaError_t err;
  if (dtype == 0) {
    const int smem =
        f32::smem_floats(P, N, a.TL, chunk) * (int)sizeof(float);
    err = cudaFuncSetAttribute(f32::ssd_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    f32::ssd_fwd_kernel<<<grid, f32::kThreads, smem, s>>>(a);
  } else if (dtype == 1) {
    err = cudaFuncSetAttribute(bf16::ssd_fwd_bf16,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bf16::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    bf16::ssd_fwd_bf16<<<grid, bf16::kThreads, bf16::kSmemBytes, s>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
