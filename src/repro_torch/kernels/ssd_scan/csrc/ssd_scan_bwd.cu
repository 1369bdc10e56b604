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
// What bounds it on this card: at phase 6's table shape (B=8, T=4096,
// H=32, P=64, N=128, L=256, bf16) the products above take 1.905e11 FLOPs
// over the causal triangles (kernels/cost.py::ssd_scan_bwd_cost) against
// about 0.45 GB of inputs and outputs, so the tensor cores' rate bounds it
// (0.19 ms at 989 TFLOP/s), and only wgmma reaches that rate.  The row
// and column passes carry most of the work (about 205 GFLOP counted by
// whole tiles); their first design (route 0) ran them at about 5% of the
// rate: one CTA of 4 warps an SM (a float32 G tile row in shared memory),
// every tile's loads waited out before its products, G and M computed in
// both passes, B_j and C_i reloaded each head, CTAs of 1 to 4 tile pairs,
// mma.sync through ldmatrix.
//
// Six launches, each with one job, in order on the caller's stream.
// Route 1 (the launcher's choice, ssd_scan.py backward_route: bfloat16,
// P = 64, N = 64 or 128, chunks a multiple of 64, the boxes the tensor
// maps below describe) runs launches 1, 3 and 4 on wgmma fed by TMA
// (namespace wg; building blocks in ../../csrc/hopper.cuh); route 0 (float32,
// and bfloat16 at any other shape the kernels take) runs the first
// design's, on mma.sync or the CUDA cores.
//  1. bwd_states (route 0) / bwd_wgstates (route 1), one CTA per (chunk,
//     head, batch row): the chunk's cumsum (one thread, in order, dt * A
//     rounded before each add, as the float32 forward), written to a (B,
//     H, T) table (route 1: dt and the decay's factors rin and rout too,
//     head-major, for the passes' bulk copies); the chunk's own state
//     sum_s (x_s w_s) (x) B_s and its own cotangent sum_l (gy_l e^{cs_l})
//     (x) C_l, (P, N) products over the chunk's rows.  Route 1: one
//     warpgroup, 64-row steps of x and B, then gy and C, through a ring
//     of two TMA stages; each step's scaled rows written once into a
//     swizzled tile (a row's scale keeps every 16-B chunk in its place)
//     and read by wgmma as the transposed A;
//  2. bwd_scan, eight CTAs per (head, batch row), each elementwise over an
//     eighth of (P, N): the states carried forward (each chunk's slot
//     becomes the state entering it) and the cotangents carried back from
//     gstate (each chunk's slot becomes the cotangent of the state leaving
//     it), and each eighth's part of <h_c, dh> per chunk by a fixed-order
//     block reduction; route 1 also writes the states as their bf16
//     operands, and the cotangents only so.
//     The recurrence is a chain of short steps, so the loads of 8 chunks
//     are issued together before the 8 steps run: taken one chunk at a
//     time, each step waits out its loads' latency and the pass runs far
//     below the card's memory rate;
//  3. rows: for each row tile i, dC_i = sum over the group's heads of
//     e^{cs} (gy_i . h_c) + sum_{j<=i} Md . B_j (M = gy_i x_j^T, Md = M * D
//     * dt) and the rows' dcs terms (sum_s G Md, the state's) to (B, H, T)
//     tables.  Route 0 (bwd_rows): one CTA per (row tile, chunk, batch row
//     x head group), G_ij = C_i B_j^T for j <= i once into shared memory,
//     the heads in turn, mma.sync.  Route 1 (bwd_wgrows): see below;
//  4. columns: for each key tile j, dx_j = w (B_j . dh^T) + sum_{i>=j} Wd
//     . gy_i of each head and dB_j = sum over the heads of w (x_j . dh) +
//     sum_i Md^T . C_i (Wd = G * D * dt), the column sums ce and u to
//     tables.  Route 0 (bwd_cols): one CTA per (key tile, chunk, batch row
//     x head group), as bwd_rows.  Route 1 (bwd_wgcols): see below;
//  5. bwd_dt, one warp per (head, batch row), walking the chunks in order:
//     dcs (route 1: its two warpgroups' parts of the row and column terms
//     summed in order), its reverse cumsum (a warp scan), ddt and dA;
//  6. bwd_reduce: dB and dC summed over the head groups in group order and
//     written in x's type, dA over the batch rows in order.
// Deterministic: every sum is taken in one fixed order (no atomics), so two
// calls give the same bits and a restarted training run repeats a run.
//
// Route 1's passes (bwd_wgrows, bwd_wgcols): one CTA an SM, 256 threads (a
// producer warp beside them made ptxas budget 168 registers a thread and
// spill; two warpgroups alone get 255), one CTA per (fold f, chunk, batch
// row x head group).  Fold f takes tiles f and nt - 1 - f, so every CTA
// does nt + 1 tile pairs a head (the middle tile of an odd nt alone), and
// walks the group's heads for each of its tiles in turn.  The CTA keeps
// the head-independent tiles (rows: B_j, j up to its larger tile; columns:
// C_i, i from its smaller one) and its tile's other operand (C_i; B_j),
// loaded once a CTA; a ring of two stages brings each head's own tile
// (gy_i; x_j), its bf16 state (h_c; dh), the tiles of its pairs (x_j, j
// <= i; gy_i, i >= j) and the chunk's tables, by TMA (x, B and C
// through 4-D and 3-D tensor maps of the caller's strided views, so the
// model's slices of one convolution buffer cost no copy) and bulk copies,
// completing on mbarriers; the second warpgroup's thread 0 refills a stage
// as soon as every thread has released it, so the next head's tiles are
// in flight while this one's products run.  A tile's pairs k = 0, 1, ...
// go to warpgroup k % 2; each computes G for its pairs once a tile into
// registers (float32, kept over the heads) and M once a (head, pair), so
// neither G nor M is held in shared memory; the decay-weighted tiles Md
// (rows), Md^T and Wd (columns) go from the accumulator straight to the
// next wgmma as register A operands, as FlashAttention-3 does with P.
// The state terms go to warpgroup 1 (columns with an even number of
// pairs: dx's to warpgroup 0), which balances the two.  Sums: each
// warpgroup keeps its own over the heads in order; dC_i and dB_j add
// warpgroup 1's to warpgroup 0's at the tile's end, dx_j at each head's
// through shared memory (warpgroup 0 writes it), rq and ce are written as
// two tables that bwd_dt adds.  Rows and columns stay two passes: a chunk's
// dB and dC summed over a head group are 2 x 256 x 128 float32 (256 KB),
// more than an SM holds beside the tiles, and a pass's accumulators fill
// the registers (dC or dB 64, G 64, M 32 a thread).
//
// Products and roundings: route 0 takes every product as a warp's 16-row
// strip of a (TL x W) output, operands staged in shared memory (rows
// padded by 16 B), the accumulator in mma.sync m16n8k16 fragments (row g
// / g+8, columns 2t, 2t+1 of each 8-column block; g = lane / 4, t = lane
// % 4), operand tiles by cp.async, the float32 states by float4 loads
// converted to the operand type.  Off the diagonal both routes factor the
// decay by tiles as the forward does, exp(cs_l - cs_s) = rin_l exp(cs_i0
// - cs_j1) rout_s (i0 the row tile's first row, j1 the key tile's last;
// rin and rout one exp a position, route 1's from launch 1's tables, so
// that a pair's elementwise work takes no exp); the diagonal tile takes
// exp per element (ex2.approx) and masks.
//  * bfloat16: the tensor cores (route 0 ldmatrix(.trans) and mma.sync,
//    route 1 wgmma), bf16 -> f32.  Rounding points, the divergence from
//    the reference (float32 throughout): gy e^{cs} in launch 1 (x w there
//    is taken as two bf16 parts, hi + lo, so the states are float32 to
//    about 2^-16); the carried states h_c and dh as operands; the
//    decay-weighted tiles Md (rows and columns) and Wd before their
//    products.  G, M, E, every sum, every table and dt, A, ddt, dA are
//    float32; dx, dB and dC are written in bfloat16.
//  * float32: the CUDA cores in full float32 (fmaf, no TF32): each thread
//    computes the same fragment elements from the float32 operands in
//    shared memory, so both types share every other line of the kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"

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
  // the wgmma passes' scratch (null on the other route)
  float* dtT;            // (B, H, T)  dt, head-major
  float* rin;            // (B, H, T)  e^{cs - cs at its tile's first row}
  float* rout;           // (B, H, T)  e^{cs at its tile's last row - cs}
  float* rq2;            // (B, H, T)  the second warpgroup's rq
  float* ce2;            // (B, H, T)  the second warpgroup's ce
  bf16_t* stb;           // (B, nc, H, P, N) st as the operand, bfloat16
  bf16_t* dstb;          // (B, nc, H, P, N) dst as the operand, bfloat16
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
        if (a.stb)
          a.stb[state_at(a, b, c, h) + at[k]] = __float2bfloat16_rn(v[k]);
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
        if (a.dstb)            // route 1 reads only the bf16 operand
          a.dstb[state_at(a, b, c, h) + at[k]] = __float2bfloat16_rn(v[k]);
        else
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

// -- 3 and 4 on Hopper: the bf16 row and column passes on wgmma --------------

namespace wg {

constexpr int kT = 64;                     // rows of a tile: one wgmma M
constexpr int kP = 64;                     // the head dim the route takes
constexpr int kBlk = kT * 128;             // a 64-column block of 64 rows
constexpr int kTiles = kMaxChunk / kT;     // tiles of a chunk, at most
// two warpgroups, the second's thread 0 also issuing the copies: a
// producer warp beside them makes ptxas budget registers as for three
// warpgroups (168 a thread; the passes then spill), two alone leave 255
constexpr int kThreads = 256;
constexpr int kLoader = 128;
constexpr int kStages = 2;
// named barriers (0 is __syncthreads'): both warpgroups;
// the column pass's staged dx written, and read
constexpr int kBarAll = 1, kBarDxFull = 2, kBarDxFree = 3;

// Shared memory of a pass at N = 64 NB (P = 64), every tile 1024-B
// aligned: the head-independent tiles the CTA keeps (rows: B_j for j up
// to the fold's larger row tile; cols: C_i for i from its smaller column
// tile), the current tile of the other operand (rows: C_r; cols: B_j),
// the ring's stages (the head's own tile, gy_r or x_j; its state, h_c or
// dh; the pairs' tiles, x_j for j <= r or gy_i for i >= j; the chunk's
// cumsum, dt, rin and rout), the column pass's staged dx, the mbarriers.
template <int NB>
struct Smem {
  static constexpr int TILE = NB * kBlk;               // 64 x N, bf16
  static constexpr int OFF_ONE = kTiles * TILE;
  static constexpr int OFF_STAGE = OFF_ONE + TILE;
  static constexpr int ST_STATE = kBlk;
  static constexpr int ST_LIST = ST_STATE + TILE;
  static constexpr int ST_TAB = ST_LIST + kTiles * kBlk;
  static constexpr int STAGE = ST_TAB + 4 * kMaxChunk * 4;
  static constexpr int OFF_DX = OFF_STAGE + kStages * STAGE;
  static_assert(STAGE % 1024 == 0, "stages keep their tiles aligned");
  __host__ __device__ static constexpr int bar(bool cols) {
    return OFF_DX + (cols ? kT * kT * 4 : 0);
  }
  // + 6 mbarriers and the slack to align the base
  __host__ __device__ static constexpr int bytes(bool cols) {
    return bar(cols) + 64 + 1024;
  }
  static_assert(bar(true) + 64 + 1024 <= 232448, "shared memory");
};

// two bf16 of a swizzled 64 x (64 NB) tile: row r, columns 64 cb + 8 nf +
// 2 t (+ 1), as floats
__device__ __forceinline__ float2 tile_pair(const unsigned char* tile,
                                            int r, int cb, int nf, int t) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(
      tile + cb * kBlk + r * 128 + ((nf ^ (r & 7)) << 4) + 4 * t);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// d (64 x 64) = A . B^T, A and B 64-row K-major tiles of KB 64-column
// blocks (K = 64 KB)
template <int KB>
__device__ __forceinline__ void mm_kk(float (&d)[32], uint32_t a,
                                      uint32_t b) {
  const uint64_t da = hop::desc(a, 16, 1024), db = hop::desc(b, 16, 1024);
  hop::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * KB; ++kk) {
    const uint32_t o = (kk >> 2) * kBlk + (kk & 3) * 32;
    hop::wgmma_ss_n64<0, 0>(d, hop::adv(da, o), hop::adv(db, o), kk > 0);
  }
  hop::wg_commit();
  hop::wg_wait<0>();
  hop::keep(d);
}

// d (64 x 64) = A . B, A a 64 x 64 K-major tile, B the 64-column block at
// `b` of an MN-major 64-row tile
__device__ __forceinline__ void mm_kn(float (&d)[32], uint32_t a,
                                      uint32_t b) {
  const uint64_t da = hop::desc(a, 16, 1024), db = hop::desc(b, kBlk, 1024);
  hop::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::wgmma_ss_n64<0, 1>(d, hop::adv(da, kk * 32), hop::adv(db, kk * 2048),
                            kk > 0);
  hop::wg_commit();
  hop::wg_wait<0>();
  hop::keep(d);
}

// d (64 x 64 NB) += A . B, A (64 x 64) in registers (4 k16 fragments), B
// an MN-major 64-row tile of NB blocks; issued, not waited on
template <int NB>
__device__ __forceinline__ void mm_rs(float (&d)[32 * NB],
                                      const uint32_t (&a)[4][4], uint32_t b) {
  const uint64_t db = hop::desc(b, kBlk, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (NB == 2)
      hop::wgmma_rs_n128<1>(d, a[kk], hop::adv(db, kk * 2048), 1);
    else
      hop::wgmma_rs_n64<1>(d, a[kk], hop::adv(db, kk * 2048), 1);
  }
}

// the tile of the fold's tiles at position u: the pass's tiles f and
// nt - 1 - f (one when they are equal), the one with more tile pairs
// first
__device__ __forceinline__ int fold_tile(bool cols, int f, int nt, int u) {
  const int big = nt - 1 - f;
  return cols ? (u == 0 ? f : big) : (u == 0 ? big : f);
}

// One CTA a (fold f, chunk c, batch row b x head group), two warpgroups.
// Rows (COLS false): for the fold's row tiles r, dC_r summed over the
// group's heads and the rows' dcs terms; columns: for its column tiles j,
// dB_j summed over the heads, dx_j of each head and the columns' ce and u.
// A tile's pairs k = 0, 1, ... (rows: key tiles j = k; columns: row tiles
// i = j + k) go to warpgroup k % 2; the state terms to warpgroup 1
// (columns with an even number of pairs: dx's to warpgroup 0).  Each
// warpgroup computes G for its own pairs once a tile into registers and M
// once a (head, pair), and keeps its own sums; they are added in
// warpgroup order: dC and dB at the tile's end, dx at each head's, rq and
// ce by bwd_dt.
template <bool COLS, int NB>
__device__ __forceinline__ void pass(const CUtensorMap* mfix,
                                     const CUtensorMap* mone,
                                     const CUtensorMap* mhead,
                                     const CUtensorMap* mlist,
                                     const CUtensorMap* mstate,
                                     const BwdArgs& a) {
  using S = Smem<NB>;
  constexpr int N = 64 * NB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::bar(COLS));
  uint64_t* empty = full + kStages;
  uint64_t* fixed = empty + kStages;
  uint64_t* one_full = fixed + 1;

  const int f = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / a.groups, grp = blockIdx.z % a.groups;
  const int h_lo = grp * a.hpg, h_hi = min(a.H, h_lo + a.hpg);
  const int nh = h_hi - h_lo;
  const int L = a.chunk, nt = L / kT, t0 = c * L;
  const int ntl = nt - 1 - f == f ? 1 : 2;
  const int uses = ntl * nh;               // stage uses: (tile, head)
  // the kept tiles: rows B_0 .. B_{nt-1-f}; columns C_f .. C_{nt-1}
  const int k_lo = COLS ? f : 0, k_n = nt - f;
  const int ct = threadIdx.x;
  if (ct == 0) {
    for (int q = 0; q < kStages; ++q) {
      hop::mbar_init(full + q, 1);
      hop::mbar_init(empty + q, kThreads);
    }
    hop::mbar_init(fixed, 1);
    hop::mbar_init(one_full, 1);
    hop::mbar_init_fence();
  }
  __syncthreads();

  // the copies (the loader thread): the fold's tile u of the other operand
  auto load_one = [&](int u) {
    hop::mbar_expect_tx(one_full, S::TILE);
    for (int cb = 0; cb < NB; ++cb)
      hop::tma_load_3d(sm + S::OFF_ONE + cb * kBlk, mone, one_full, 64 * cb,
                       t0 + fold_tile(COLS, f, nt, u) * kT, b);
  };
  // stage use s: tile s / nh, head h_lo + s % nh; its own tile, state,
  // pairs' tiles and tables
  auto load_stage = [&](int s) {
    const int tt = fold_tile(COLS, f, nt, s / nh), h = h_lo + s % nh;
    const int np = COLS ? nt - tt : tt + 1, st = s & 1;
    unsigned char* sp = sm + S::OFF_STAGE + st * S::STAGE;
    hop::mbar_expect_tx(full + st, kBlk + S::TILE + np * kBlk + 4 * L * 4);
    hop::tma_load_4d(sp, mhead, full + st, 0, t0 + tt * kT, h, b);
    const int srow = ((b * a.nc + c) * a.H + h) * kP;
    for (int cb = 0; cb < NB; ++cb)
      hop::tma_load_2d(sp + S::ST_STATE + cb * kBlk, mstate, full + st,
                       64 * cb, srow);
    for (int k = 0; k < np; ++k)
      hop::tma_load_4d(sp + S::ST_LIST + k * kBlk, mlist, full + st, 0,
                       t0 + (COLS ? tt + k : k) * kT, h, b);
    const int64_t row = bht(a, b, h) + t0;
    const float* tabs[4] = {a.cum, a.dtT, a.rin, a.rout};
    for (int q = 0; q < 4; ++q)
      hop::bulk_load(sp + S::ST_TAB + q * kMaxChunk * 4, tabs[q] + row,
                     L * 4, full + st);
  };
  if (ct == kLoader) {
    hop::mbar_expect_tx(fixed, k_n * S::TILE);
    for (int k = 0; k < k_n; ++k)
      for (int cb = 0; cb < NB; ++cb)
        hop::tma_load_3d(sm + k * S::TILE + cb * kBlk, mfix, fixed, 64 * cb,
                         t0 + (k_lo + k) * kT, b);
    load_one(0);
    for (int q = 0; q < kStages && q < uses; ++q) load_stage(q);
  }
  __syncwarp();

  const int wgi = ct >> 7, wt = ct & 127;
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g;            // the thread's rows r0, r0 + 8
  const unsigned char* one = sm + S::OFF_ONE;
  const uint32_t one_s = hop::smem(one);
  float2* dxs = reinterpret_cast<float2*>(sm + S::OFF_DX);
  if (COLS && wgi == 0) hop::named_arrive(kBarDxFree, kThreads);
  hop::mbar_wait_warp(fixed, 0);
  int s = 0;
  for (int u = 0; u < ntl; ++u) {
    const int tt = fold_tile(COLS, f, nt, u);
    const int np = COLS ? nt - tt : tt + 1;
    const int x0 = tt * kT;                // the tile's first row in the chunk
    hop::mbar_wait_warp(one_full, u & 1);
    // G (rows: C_r B_j^T; columns: its transpose B_j C_i^T) of this
    // warpgroup's pairs, float32, kept over the heads
    float G[2][32];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = 2 * q + wgi;
      if (k >= np) break;
      const int kept = (COLS ? tt + k : k) - k_lo;
      mm_kk<NB>(G[q], one_s, hop::smem(sm + kept * S::TILE));
    }
    float acc[32 * NB];                    // rows: dC_r; columns: dB_j
#pragma unroll
    for (int e = 0; e < 32 * NB; ++e) acc[e] = 0.f;

    for (int h = h_lo; h < h_hi; ++h, ++s) {
      const int st = s & 1;
      hop::mbar_wait_warp(full + st, (s >> 1) & 1);
      const unsigned char* sp = sm + S::OFF_STAGE + st * S::STAGE;
      const uint32_t head_s = hop::smem(sp);
      const uint32_t state_s = head_s + S::ST_STATE;
      const uint32_t list_s = head_s + S::ST_LIST;
      const float* cum = reinterpret_cast<const float*>(sp + S::ST_TAB);
      const float* dts = cum + kMaxChunk;
      const float* rin = dts + kMaxChunk;
      const float* rout = rin + kMaxChunk;
      const int64_t at = bht(a, b, h) + t0 + x0;
      // each row's factor of the decay (rows: rin; columns: rout)
      float fr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        fr[hh] = (COLS ? rout : rin)[x0 + r0 + 8 * hh];
      if constexpr (!COLS) {
        // -- rows: tile i = tt, pairs j = k ---------------------------------
        float rsum[2] = {0.f, 0.f}, inter[2] = {0.f, 0.f};
        if (wgi == 1) {
          // from the state: dC_i += e^{cs} (gy_i . h_c), and its dcs term
          // e^{cs_l} <gy_l h_c, C_l>
          const float e0 = expf(cum[x0 + r0]), e1 = expf(cum[x0 + r0 + 8]);
          float p0 = 0.f, p1 = 0.f;
#pragma unroll
          for (int cb = 0; cb < NB; ++cb) {
            float t1[32];
            mm_kn(t1, head_s, state_s + cb * kBlk);
#pragma unroll
            for (int nf = 0; nf < 8; ++nf) {
              const float2 c0 = tile_pair(one, r0, cb, nf, t4);
              const float2 c1 = tile_pair(one, r0 + 8, cb, nf, t4);
              float* d = acc + 32 * cb + 4 * nf;
              const float* v = t1 + 4 * nf;
              p0 = fmaf(v[0], c0.x, p0);
              p0 = fmaf(v[1], c0.y, p0);
              p1 = fmaf(v[2], c1.x, p1);
              p1 = fmaf(v[3], c1.y, p1);
              d[0] = fmaf(e0, v[0], d[0]);
              d[1] = fmaf(e0, v[1], d[1]);
              d[2] = fmaf(e1, v[2], d[2]);
              d[3] = fmaf(e1, v[3], d[3]);
            }
          }
          inter[0] = e0 * quad_sum(p0);
          inter[1] = e1 * quad_sum(p1);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = 2 * q + wgi;
          if (j >= np) break;
          const int j0 = j * kT;
          // M = gy_i . x_j^T, then Md = M * D * dt (0 above the diagonal)
          float m[32];
          mm_kk<1>(m, head_s, list_s + j * kBlk);
          const bool diag = j == tt;
          const float ex = diag ? 0.f : expf(cum[x0] - cum[j0 + kT - 1]);
          const float ri0 = fr[0] * ex, ri1 = fr[1] * ex;
          uint32_t af[4][4];
#pragma unroll
          for (int nf = 0; nf < 8; ++nf) {
            const int col = 8 * nf + 2 * t4, sc = j0 + col;
            float md[4];
            if (!diag) {         // the factored decay, times dt_s
              const float c0 = rout[sc] * dts[sc];
              const float c1 = rout[sc + 1] * dts[sc + 1];
              md[0] = m[4 * nf] * ri0 * c0;
              md[1] = m[4 * nf + 1] * ri0 * c1;
              md[2] = m[4 * nf + 2] * ri1 * c0;
              md[3] = m[4 * nf + 3] * ri1 * c1;
            } else {             // exp per element, 0 above the diagonal
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = r0 + 8 * (e >> 1), cc = col + (e & 1);
                const float v = m[4 * nf + e]
                                * fast_exp(cum[x0 + r] - cum[j0 + cc])
                                * dts[j0 + cc];
                md[e] = cc <= r ? v : 0.f;
              }
            }
            const float* gg = G[q] + 4 * nf;
            rsum[0] = fmaf(gg[0], md[0], fmaf(gg[1], md[1], rsum[0]));
            rsum[1] = fmaf(gg[2], md[2], fmaf(gg[3], md[3], rsum[1]));
            af[nf >> 1][2 * (nf & 1)] = pack(md[0], md[1]);
            af[nf >> 1][2 * (nf & 1) + 1] = pack(md[2], md[3]);
          }
          // dC_i += Md . B_j (Md from registers)
          hop::wg_fence();
          mm_rs<NB>(acc, af, hop::smem(sm + (j - k_lo) * S::TILE));
          hop::wg_commit();
          hop::wg_wait<0>();
          hop::keep(acc);
          hop::keep(af);
        }
        const float q0 = quad_sum(rsum[0]) + inter[0];
        const float q1 = quad_sum(rsum[1]) + inter[1];
        if (t4 == 0) {
          float* rq = (wgi == 0 ? a.rq : a.rq2) + at;
          rq[r0] = q0;
          rq[r0 + 8] = q1;
        }
      } else {
        // -- columns: tile j = tt, pairs i = j + k --------------------------
        const float cl = cum[L - 1];
        const float ew0 = expf(cl - cum[x0 + r0]);
        const float ew1 = expf(cl - cum[x0 + r0 + 8]);
        const float d0 = dts[x0 + r0], d1 = dts[x0 + r0 + 8];
        const float w0 = ew0 * d0, w1 = ew1 * d1;
        float dx[32];
        if (wgi == (np & 1)) {
          // from the state: dx_j = w (B_j . dh^T)
          mm_kk<NB>(dx, one_s, state_s);
#pragma unroll
          for (int e = 0; e < 32; ++e) dx[e] *= (e & 2) ? w1 : w0;
        } else {
#pragma unroll
          for (int e = 0; e < 32; ++e) dx[e] = 0.f;
        }
        float ca[2] = {0.f, 0.f}, ua[2] = {0.f, 0.f};
        if (wgi == 1) {
          // from the state: dB_j += w (x_j . dh), and u_s = e^{cs_{L-1} -
          // cs_s} <x_s dh, B_s>
          float p0 = 0.f, p1 = 0.f;
#pragma unroll
          for (int cb = 0; cb < NB; ++cb) {
            float t3[32];
            mm_kn(t3, head_s, state_s + cb * kBlk);
#pragma unroll
            for (int nf = 0; nf < 8; ++nf) {
              const float2 b0 = tile_pair(one, r0, cb, nf, t4);
              const float2 b1 = tile_pair(one, r0 + 8, cb, nf, t4);
              float* d = acc + 32 * cb + 4 * nf;
              const float* v = t3 + 4 * nf;
              p0 = fmaf(v[0], b0.x, p0);
              p0 = fmaf(v[1], b0.y, p0);
              p1 = fmaf(v[2], b1.x, p1);
              p1 = fmaf(v[3], b1.y, p1);
              d[0] = fmaf(w0, v[0], d[0]);
              d[1] = fmaf(w0, v[1], d[1]);
              d[2] = fmaf(w1, v[2], d[2]);
              d[3] = fmaf(w1, v[3], d[3]);
            }
          }
          ua[0] = ew0 * quad_sum(p0);
          ua[1] = ew1 * quad_sum(p1);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k = 2 * q + wgi;
          if (k >= np) break;
          const int i0 = (tt + k) * kT;
          // M^T = x_j . gy_i^T; Md^T = M^T * D * dt_s and Wd = G * D *
          // dt_s (0 below the diagonal), both to registers
          float m[32];
          mm_kk<1>(m, head_s, list_s + k * kBlk);
          const bool diag = k == 0;
          const float ex = diag ? 0.f : expf(cum[i0] - cum[x0 + kT - 1]);
          const float ro0 = fr[0] * ex, ro1 = fr[1] * ex;
          uint32_t ab[4][4], aw[4][4];
#pragma unroll
          for (int nf = 0; nf < 8; ++nf) {
            const int col = 8 * nf + 2 * t4, l = i0 + col;
            float dd[4];
            if (!diag) {         // the factored decay
              const float c0 = rin[l], c1 = rin[l + 1];
              dd[0] = ro0 * c0;
              dd[1] = ro0 * c1;
              dd[2] = ro1 * c0;
              dd[3] = ro1 * c1;
            } else {             // exp per element, 0 below the diagonal
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = r0 + 8 * (e >> 1), cc = col + (e & 1);
                const float v = fast_exp(cum[i0 + cc] - cum[x0 + r]);
                dd[e] = cc >= r ? v : 0.f;
              }
            }
            float mdt[4], wd[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ds = e < 2 ? d0 : d1;
              const float gd = G[q][4 * nf + e] * dd[e];
              ca[e >> 1] = fmaf(gd, m[4 * nf + e], ca[e >> 1]);
              mdt[e] = m[4 * nf + e] * dd[e] * ds;
              wd[e] = gd * ds;
            }
            ab[nf >> 1][2 * (nf & 1)] = pack(mdt[0], mdt[1]);
            ab[nf >> 1][2 * (nf & 1) + 1] = pack(mdt[2], mdt[3]);
            aw[nf >> 1][2 * (nf & 1)] = pack(wd[0], wd[1]);
            aw[nf >> 1][2 * (nf & 1) + 1] = pack(wd[2], wd[3]);
          }
          // dB_j += Md^T . C_i and dx_j += Wd . gy_i (A from registers)
          hop::wg_fence();
          mm_rs<NB>(acc, ab, hop::smem(sm + (tt + k - k_lo) * S::TILE));
          mm_rs<1>(dx, aw, list_s + k * kBlk);
          hop::wg_commit();
          hop::wg_wait<0>();
          hop::keep(acc);
          hop::keep(dx);
          hop::keep(ab);
          hop::keep(aw);
        }
        const float c0 = quad_sum(ca[0]), c1 = quad_sum(ca[1]);
        if (t4 == 0) {
          float* ce = (wgi == 0 ? a.ce : a.ce2) + at;
          ce[r0] = c0;
          ce[r0 + 8] = c1;
          if (wgi == 1) {
            a.us[at + r0] = ua[0];
            a.us[at + r0 + 8] = ua[1];
          }
        }
        // dx_j = warpgroup 0's + warpgroup 1's, through shared memory
        if (wgi == 1) {
          hop::named_sync(kBarDxFree, kThreads);
#pragma unroll
          for (int e = 0; e < 16; ++e)
            dxs[(warp * 16 + e) * 32 + lane] = make_float2(dx[2 * e],
                                                           dx[2 * e + 1]);
          hop::named_arrive(kBarDxFull, kThreads);
        } else {
          hop::named_sync(kBarDxFull, kThreads);
          bf16_t* dxb = static_cast<bf16_t*>(a.dx)
                        + (((int64_t)b * a.T + t0 + x0) * a.H + h) * kP;
          const int64_t xsr = (int64_t)a.H * kP;
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const float2 o = dxs[(warp * 16 + e) * 32 + lane];
            const int r = r0 + 8 * (e & 1), col = 8 * (e >> 1) + 2 * t4;
            store2(dxb + r * xsr + col, dx[2 * e] + o.x, dx[2 * e + 1] + o.y);
          }
          if (s + 1 < uses) hop::named_arrive(kBarDxFree, kThreads);
        }
      }
      hop::mbar_arrive(empty + st);        // this thread is done with it
      if (ct == kLoader && s + kStages < uses) {   // its next use, once free
        hop::mbar_wait(empty + st, (s >> 1) & 1);
        load_stage(s + kStages);
      }
      __syncwarp();
    }
    // the tile's sum over the group's heads: warpgroup 0's, then 1's added
    float* out = (COLS ? a.dBp : a.dCp)
                 + (((int64_t)grp * a.Bsz + b) * a.T + t0 + x0) * N;
    if (wgi == 0) {
#pragma unroll
      for (int e = 0; e < 16 * NB; ++e) {
        const int r = r0 + 8 * (e & 1), col = 8 * (e >> 1) + 2 * t4;
        *reinterpret_cast<float2*>(out + (int64_t)r * N + col) =
            make_float2(acc[2 * e], acc[2 * e + 1]);
      }
    }
    hop::named_sync(kBarAll, kThreads);
    // every thread is past its reads of this tile's C_r or B_j
    if (ct == kLoader && u + 1 < ntl) load_one(u + 1);
    __syncwarp();
    if (wgi == 1) {
#pragma unroll
      for (int e = 0; e < 16 * NB; ++e) {
        const int r = r0 + 8 * (e & 1), col = 8 * (e >> 1) + 2 * t4;
        float2* o = reinterpret_cast<float2*>(out + (int64_t)r * N + col);
        const float2 v = *o;
        *o = make_float2(v.x + acc[2 * e], v.y + acc[2 * e + 1]);
      }
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
bwd_wgrows(const __grid_constant__ CUtensorMap mx,
           const __grid_constant__ CUtensorMap mgy,
           const __grid_constant__ CUtensorMap mb,
           const __grid_constant__ CUtensorMap mc,
           const __grid_constant__ CUtensorMap mst, const BwdArgs a) {
  pass<false, NB>(&mb, &mc, &mgy, &mx, &mst, a);
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
bwd_wgcols(const __grid_constant__ CUtensorMap mx,
           const __grid_constant__ CUtensorMap mgy,
           const __grid_constant__ CUtensorMap mb,
           const __grid_constant__ CUtensorMap mc,
           const __grid_constant__ CUtensorMap mdst, const BwdArgs a) {
  pass<true, NB>(&mc, &mb, &mx, &mgy, &mdst, a);
}

// Launch 1 on this route: one warpgroup a (chunk, head, batch row), the
// chunk's cumsum and tables as bwd_states takes them, then its own state
// sum_s (x_s w_s) (x) B_s (x w as bf16 hi + lo, two products) and its own
// cotangent sum_l (gy_l e^{cs_l}) (x) C_l on wgmma: 2 nt steps of 64 rows
// (x_k and B_k, then gy_k and C_k) through a ring of two TMA stages, each
// step's scaled rows written once into a swizzled tile beside it (the
// scale is a row's, so a 16-B chunk keeps its place) and read as the
// transposed A operand.
constexpr int kStateThreads = 128;

template <int NB>
struct StateSmem {
  static constexpr int TILE = NB * kBlk;
  static constexpr int STAGE = kBlk + TILE;              // x or gy; B or C
  static constexpr int OFF_SCALED = kStages * STAGE;     // hi, lo
  static constexpr int OFF_TAB = OFF_SCALED + 2 * kBlk;  // 4 tables
  static constexpr int OFF_BAR = OFF_TAB + 4 * kMaxChunk * 4;
  __host__ __device__ static constexpr int bytes() {
    return OFF_BAR + 8 * kStages + 1024;
  }
};

template <int NB>
__global__ void __launch_bounds__(kStateThreads)
bwd_wgstates(const __grid_constant__ CUtensorMap mx,
             const __grid_constant__ CUtensorMap mgy,
             const __grid_constant__ CUtensorMap mb,
             const __grid_constant__ CUtensorMap mc, const BwdArgs a) {
  using S = StateSmem<NB>;
  constexpr int N = 64 * NB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* cum = reinterpret_cast<float*>(sm + S::OFF_TAB);
  float* dts = cum + kMaxChunk;
  float* wst = dts + kMaxChunk;               // exp(cs_{L-1} - cs) dt
  float* ecs = wst + kMaxChunk;               // exp(cs)
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::OFF_BAR);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = a.chunk, nt = L / kT, t0 = c * L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // step k: x_k and B_k (k < nt), then gy and C of tile k - nt
  auto load_step = [&](int k) {
    const int st = k & 1, row = t0 + (k % nt) * kT;
    unsigned char* sp = sm + st * S::STAGE;
    hop::mbar_expect_tx(full + st, S::STAGE);
    hop::tma_load_4d(sp, k < nt ? &mx : &mgy, full + st, 0, row, h, b);
    for (int cb = 0; cb < NB; ++cb)
      hop::tma_load_3d(sp + kBlk + cb * kBlk, k < nt ? &mb : &mc, full + st,
                       64 * cb, row, b);
  };
  if (tid == 0) {
    for (int q = 0; q < kStages; ++q) hop::mbar_init(full + q, 1);
    hop::mbar_init_fence();
    for (int k = 0; k < kStages; ++k) load_step(k);
  }
  __syncwarp();
  // the tables, as bwd_states makes them
  const float* db = a.dt + b * a.ds[0] + h * a.ds[2];
  for (int l = tid; l < L; l += kStateThreads) {
    dts[l] = db[(int64_t)(t0 + l) * a.ds[1]];
    a.dtT[bht(a, b, h) + t0 + l] = dts[l];
  }
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
  for (int l = tid; l < L; l += kStateThreads) {
    wst[l] = expf(cs_last - cum[l]) * dts[l];
    ecs[l] = expf(cum[l]);
    cum_out[l] = cum[l];
    // the decay factored by tiles, for the passes
    a.rin[bht(a, b, h) + t0 + l] = expf(cum[l] - cum[l & ~(kT - 1)]);
    a.rout[bht(a, b, h) + t0 + l] = expf(cum[l | (kT - 1)] - cum[l]);
  }
  __syncthreads();

  unsigned char* hi = sm + S::OFF_SCALED;
  unsigned char* lo = hi + kBlk;
  const uint64_t hi_mn = hop::desc(hop::smem(hi), kBlk, 1024);
  const uint64_t lo_mn = hop::desc(hop::smem(lo), kBlk, 1024);
  float acc[32 * NB];
#pragma unroll
  for (int e = 0; e < 32 * NB; ++e) acc[e] = 0.f;
  for (int k = 0; k < 2 * nt; ++k) {
    const int st = k & 1, pass = k >= nt, r0 = (k % nt) * kT;
    unsigned char* sp = sm + st * S::STAGE;
    hop::mbar_wait_warp(full + st, (k >> 1) & 1);
    // the rows scaled (pass 0: x w, as hi and lo; pass 1: gy e^{cs}), 16
    // B a thread at a time, every chunk in its swizzled place
    const float* scale = pass ? ecs : wst;
    for (int q = tid; q < kBlk / 16; q += kStateThreads) {
      const int r = q >> 3;
      float v[8];
      load8(v, reinterpret_cast<const bf16_t*>(sp) + 8 * q);
      const float sc = scale[r0 + r];
      uint32_t wh[4], wl[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float x0 = v[2 * u] * sc, x1 = v[2 * u + 1] * sc;
        const bf16_t h0 = from_f<bf16_t>(x0), h1 = from_f<bf16_t>(x1);
        wh[u] = pack(x0, x1);
        wl[u] = pack(x0 - to_f(h0), x1 - to_f(h1));
      }
      *reinterpret_cast<uint4*>(hi + 16 * q) =
          make_uint4(wh[0], wh[1], wh[2], wh[3]);
      if (!pass)
        *reinterpret_cast<uint4*>(lo + 16 * q) =
            make_uint4(wl[0], wl[1], wl[2], wl[3]);
    }
    hop::fence_async_smem();
    hop::named_sync(1, kStateThreads);
    // (P x N) += (rows of hi [+ lo])^T . (rows of B or C)
    const uint64_t op = hop::desc(hop::smem(sp + kBlk), kBlk, 1024);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (NB == 2)
        hop::wgmma_ss_n128<1, 1>(acc, hop::adv(hi_mn, kk * 2048),
                                 hop::adv(op, kk * 2048), 1);
      else
        hop::wgmma_ss_n64<1, 1>(acc, hop::adv(hi_mn, kk * 2048),
                                hop::adv(op, kk * 2048), 1);
    }
    if (!pass) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (NB == 2)
          hop::wgmma_ss_n128<1, 1>(acc, hop::adv(lo_mn, kk * 2048),
                                   hop::adv(op, kk * 2048), 1);
        else
          hop::wgmma_ss_n64<1, 1>(acc, hop::adv(lo_mn, kk * 2048),
                                  hop::adv(op, kk * 2048), 1);
      }
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::keep(acc);
    // every thread is past the stage and the scaled tiles
    hop::named_sync(1, kStateThreads);
    if (tid == 0 && k + kStages < 2 * nt) load_step(k + kStages);
    __syncwarp();
    if (k == nt - 1 || k == 2 * nt - 1) {
      float* out = (pass ? a.dst : a.st) + state_at(a, b, c, h);
#pragma unroll
      for (int e = 0; e < 16 * NB; ++e) {
        const int r = 16 * warp + g + 8 * (e & 1);
        const int col = 8 * (e >> 1) + 2 * t4;
        *reinterpret_cast<float2*>(out + r * N + col) =
            make_float2(acc[2 * e], acc[2 * e + 1]);
        acc[2 * e] = acc[2 * e + 1] = 0.f;
      }
    }
  }
}

// a bf16 tensor map of `rank` dims (innermost first; `strides` in
// elements, rank - 1 of them), read in 64 x 64 boxes (1 in the outer
// dims), 128-B swizzled
bool tensor_map(CUtensorMap* m, const void* ptr, int rank,
                const uint64_t* dims, const int64_t* strides) {
  hop::EncodeTiled enc = hop::encoder();
  if (enc == nullptr) return false;
  cuuint64_t d[4], st[3];
  cuuint32_t box[4], unit[4];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    box[i] = i < 2 ? kT : 1;
    unit[i] = 1;
    if (i + 1 < rank) st[i] = static_cast<cuuint64_t>(strides[i]) * 2;
  }
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(ptr), d, st, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// launches 1 to 4 on this route: the tensor maps of x, gy, B, C and the
// bf16 states, the chunks' states, the state scan, then the two passes
// over (fold, chunk, batch row x group)
template <int NB>
int launch(const BwdArgs& a, cudaStream_t s) {
  using S = Smem<NB>;
  const uint64_t T = a.T, H = a.H, B = a.Bsz, N = a.N;
  CUtensorMap mx, mgy, mb, mc, mst, mdst;
  const uint64_t dx4[4] = {kP, T, H, B};
  const int64_t sx[3] = {a.xs[1], a.xs[2], a.xs[0]};
  const int64_t sg[3] = {(int64_t)a.H * kP, kP, (int64_t)a.T * a.H * kP};
  const uint64_t db3[3] = {N, T, B};
  const int64_t sb[2] = {a.bs[1], a.bs[0]}, sc[2] = {a.cst[1], a.cst[0]};
  const uint64_t ds2[2] = {N, B * a.nc * H * kP};
  const int64_t ss[1] = {(int64_t)N};
  if (!tensor_map(&mx, a.x, 4, dx4, sx) || !tensor_map(&mgy, a.gy, 4, dx4, sg)
      || !tensor_map(&mb, a.Bm, 3, db3, sb)
      || !tensor_map(&mc, a.Cm, 3, db3, sc)
      || !tensor_map(&mst, a.stb, 2, ds2, ss)
      || !tensor_map(&mdst, a.dstb, 2, ds2, ss))
    return (int)cudaErrorInvalidValue;
  constexpr int ss_bytes = StateSmem<NB>::bytes();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_wgstates<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ss_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_wgrows<NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::bytes(false));
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_wgcols<NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::bytes(true));
  if (err != cudaSuccess) return (int)err;
  bwd_wgstates<NB><<<dim3(a.nc, a.H, a.Bsz), kStateThreads, ss_bytes, s>>>(
      mx, mgy, mb, mc, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_scan<bf16_t><<<dim3(a.H * kScanParts, a.Bsz), kScanThreads, 0, s>>>(
      a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int nt = a.chunk / kT;
  const dim3 grid((nt + 1) / 2, a.nc, a.Bsz * a.groups);
  bwd_wgrows<NB><<<grid, kThreads, S::bytes(false), s>>>(mx, mgy, mb, mc,
                                                          mst, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_wgcols<NB><<<grid, kThreads, S::bytes(true), s>>>(mx, mgy, mb, mc,
                                                         mdst, a);
  return (int)cudaGetLastError();
}

}  // namespace wg

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
        // the wgmma passes leave two warpgroups' parts, summed in order
        const float ce = !ok ? 0.f : a.ce2 ? a.ce[row + l] + a.ce2[row + l]
                                           : a.ce[row + l];
        const float rq = !ok ? 0.f : a.rq2 ? a.rq[row + l] + a.rq2[row + l]
                                           : a.rq[row + l];
        dd[k] = ok ? ce + u : 0.f;
        dcs[k] = ok ? rq - dtv[k] * dd[k] : 0.f;
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

// route 0: the first design's row and column passes (bwd_rows, bwd_cols);
// 1: the
// wgmma passes (bwd_wgrows, bwd_wgcols), for bfloat16 with P = 64, N = 64
// or 128 and chunks a multiple of 64 (the launcher chooses: ssd_scan.py
// backward_route)
bool route_takes(int route, int dtype, int P, int N, int chunk) {
  if (route == 0) return true;
  return route == 1 && dtype == 1 && P == wg::kP && (N == 64 || N == 128)
         && chunk % wg::kT == 0;
}

int64_t scratch_floats(int Bsz, int T, int H, int P, int N, int chunk,
                       int groups, int route) {
  const int64_t nc = T / chunk, bht = (int64_t)Bsz * H * T;
  const int64_t states = (int64_t)Bsz * nc * H * P * N;
  return 4 * bht + 2 * states + (int64_t)Bsz * H * nc * kScanParts
         + 2 * (int64_t)groups * Bsz * T * N
         + (route == 1 ? 5 * bht + states : 0) + (int64_t)Bsz * H;
}

template <typename T>
int launch(const BwdArgs& a, cudaStream_t s, int route) {
  cudaError_t err;
  if (route == 1) {
    if constexpr (sizeof(T) == 2) {
      const int e = a.N == 128 ? wg::launch<2>(a, s) : wg::launch<1>(a, s);
      if (e) return e;
    }
  } else {
    const int nt = a.chunk / a.TL;
    const int ss = states_smem<T>(), ps = pass_smem<T>();
    err = cudaFuncSetAttribute(bwd_states<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ss);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(bwd_rows<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ps);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(bwd_cols<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ps);
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
  }
  bwd_dt<<<dim3(a.H, a.Bsz), 32, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)a.Bsz * a.T * a.N;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  bwd_reduce<T><<<blocks, 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch ssd_backward needs for these shapes, head groups and
// route.
int64_t ssd_backward_scratch(int Bsz, int T, int H, int P, int N, int chunk,
                             int groups, int route) {
  return scratch_floats(Bsz, T, H, P, N, chunk, groups, route);
}

// x (Bsz, T, H, P), dt (Bsz, T, H) f32, A (H,) f32, B/C (Bsz, T, N) as the
// forward takes them (strides: 10 int64 in elements, the (b, t, h) strides
// of x and of dt, then the (b, t) strides of B and of C; bfloat16 x, B and
// C 16-B aligned with strides in multiples of 8); gy (Bsz, T, H, P) and
// gstate (Bsz, H, P, N) contiguous in x's type, gy 16-B aligned.  Writes dx
// (Bsz, T, H, P), dB and dC (Bsz, T, N) contiguous in x's type and ddt
// (Bsz, T, H), dA (H,) float32 (dtype 0: float32, CUDA cores; 1: bfloat16,
// tensor cores).  scratch holds ssd_backward_scratch(...) floats; `groups`
// head groups split each chunk's heads across CTAs (1 <= groups <= H);
// `route` picks the row and column passes (route_takes).  The caller
// checks the forward's limits, Bsz, T / chunk and Bsz * groups within
// 65535, and T > 0.  Returns the first launch error, or
// cudaGetLastError() after the last launch.
int ssd_backward(const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, const void* gy,
                 const void* gstate, void* dx, void* ddt, void* dA, void* dB,
                 void* dC, void* scratch, int dtype, int Bsz, int T, int H,
                 int P, int N, int chunk, int groups, int route,
                 const int64_t* strides, void* stream) {
  if (Bsz <= 0 || H <= 0) return (int)cudaSuccess;
  if (P % 16 || N % 16 || chunk % 16 || P > kMaxP || N > kMaxN ||
      chunk > kMaxChunk || T <= 0 || T % chunk || groups < 1 || groups > H
      || !route_takes(route, dtype, P, N, chunk))
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
  a.dtT = a.rin = a.rout = a.rq2 = a.ce2 = nullptr;
  a.stb = a.dstb = nullptr;
  if (route == 1) {          // every part a multiple of 16 B
    a.dtT = f; f += bht;
    a.rin = f; f += bht;
    a.rout = f; f += bht;
    a.rq2 = f; f += bht;
    a.ce2 = f; f += bht;
    a.stb = reinterpret_cast<bf16_t*>(f); f += states / 2;
    a.dstb = reinterpret_cast<bf16_t*>(f); f += states / 2;
  }
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
  if (dtype == 0) return launch<float>(a, s, route);
  if (dtype == 1) return launch<bf16_t>(a, s, route);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
