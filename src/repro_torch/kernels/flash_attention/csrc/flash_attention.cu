// Flash attention forward for Hopper (sm_90a): online-softmax attention over
// (B, H, Sq, hd) queries and (B, KV, Skv, hd) keys/values, the prefill
// attention of the LM serving path and the forward of the training path.
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
// For training it also writes each row's log-sum-exp, lse = m + ln(l) in
// float32 (natural log in both kernels), which the backward
// (flash_attention_bwd.cu) recomputes P from; serving passes no lse buffer,
// writes none and (bf16) runs an instantiation without the store.
//
// What bounds it on this card: at the internlm2-1.8b prefill shape
// (B=8, H=16, KV=8, S=4096, hd=128, causal) the work is 5.5e11 FLOPs against
// 403 MB of inputs and output, so the tensor-core rate bounds it: 0.556 ms
// at 989 TFLOP/s bf16, against 0.12 ms of bytes.  The entry point picks one
// of two kernels by dtype.  Both give each CTA one (q tile, head, batch),
// schedule the heavy causal tiles (high q index) first, and loop over the
// kv tiles [kt_begin, kt_end) inside the CTA (the TPU grid's sequential kv
// axis); strides in elements for every dimension but hd let the model's
// (B, S, H, hd) projections, viewed as (B, H, S, hd), be read in place and
// the output be written straight into a (B, S, H, hd) buffer.
//
// Head dims: each kernel is built for 32, 64, 128 and 256.  A head dim
// above 256 (a multiple of 32) is split into slices of built widths (256,
// then 128, 64, 32): one launch per slice, each accumulating O for its own
// columns [c0, c0 + HD) (WIDE), while q.k^T runs over the full width in
// chunks of HD columns staged through shared memory, zero past hd.  Every
// slice recomputes the scores; only the first writes lse.
//
// bfloat16 (flash_fwd_bf16): the tensor cores, FlashAttention-2 style.
//  * 4 warps; S = Q.K^T and O += P.V are mma.sync.m16n8k16 (bf16 in,
//    float32 accumulate).  Q and K fragments come from shared memory by
//    ldmatrix, V by ldmatrix.trans from its row-major tile.  Shared memory,
//    not the tensor cores, limits mma.sync here (one ldmatrix.x4 feeds only
//    two products), so at hd = 128 each warp owns 32 q rows (two m16 tiles,
//    a 128-row q tile) and every K and V fragment feeds four products; Q is
//    then re-read from shared memory each k step, since O (128) and S (64)
//    already take 192 registers a thread.  The tanh softcap is a template
//    flag; with it, hd = 128 keeps 16 rows a warp (64-row q tile) and Q in
//    registers, as hd 32 and 64 do.  At hd = 256 the 16x256 accumulator
//    alone takes 128 registers, so Q is re-read and the kv tile is 32 rows.
//    A WIDE slice keeps 16 rows a warp at every width.  Every instantiation
//    fits in 255 registers with no spills (the build's -Xptxas -v log) but
//    the training one at hd = 128 (32-row warps with the lse store), which
//    spills 40 B.
//  * K and V tiles (64 keys) come through a 2-stage ring in shared memory
//    by cp.async (16 B a thread, rows past Skv zero-filled, so no stale NaN
//    meets a p of 0): tile kt+1 is in flight while tile kt is multiplied.
//    Q is loaded once per CTA.  Rows are padded by 16 B, so the 8 rows of
//    one ldmatrix phase fall on 8 distinct 16-B bank groups.  A WIDE slice
//    stages each q.k chunk of Q and K, then V's slice, synchronously.
//  * The scale is applied to the float32 scores (s * scale; softcap
//    tanh(s * scale / cap) * cap), with log2(e) folded in for ex2.approx;
//    the reference scales q in float32 before the product, which differs
//    only by float32 rounding.  Row max and row sum live in registers and
//    reduce over the 4 threads of an mma quad.  Masks are applied only on
//    tiles that straddle the diagonal, the window's edge or the kv tail.
//  * P is rounded to bf16 in registers: two n8 score tiles are one k16 A
//    fragment of P.V, so P never goes through shared memory.  This is the
//    one numerical divergence from the reference, which keeps P in float32
//    (within its bf16 limit of 2e-2).  The row sum l takes the float32 p.
//  * Epilogue: O / max(l, 1e-30), rounded to bf16, staged through the
//    warp's own Q rows in shared memory, written as 16-B stores; q rows
//    >= Sq are never written.  lse = (m + log2 l) ln 2, m kept in log2 units.
//  The further step is wgmma with TMA loads and warp specialisation (a
//  producer warp feeding consumer warpgroups, B read from shared memory by
//  the hardware, not by ldmatrix), the only way to the card's full
//  tensor-core rate.
//
// float32 (flash_fwd_f32): the CUDA cores.  The reference's float32 limit
// of 3e-5 needs full float32 products; TF32 tensor cores (10-bit mantissa)
// would not hold it.  256 threads as a 16 x 16 grid, thread (ty, tx) owning
// rows ty + 16 i (i < 4), score columns tx + 16 j, output columns
// tx + 16 c (register-blocked 4x4 FMA micro-tiles out of shared memory);
// q, pre-scaled, sits in shared memory in float32, each kv tile of 64 rows
// is staged through one shared buffer, first K (for the scores), then V
// (for P.V); P stays float32.  Ragged q and kv edges are bounds checks,
// not padding copies; no score ever takes exp of a positive difference.

#include "fa_common.cuh"

namespace {

using fa::kNegInf;

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                           // (B, H, Sq) or null: none written
  int H, KV, Sq, Skv;
  int hd, c0, nch;                      // full head dim; this launch's
                                        // output columns [c0, c0 + HD);
                                        // q.k chunks of HD columns
  int64_t qs[3], ks[3], vs[3], os[3];   // strides of (b, h, s), in elements
  float scale, softcap;
  int causal, window;                   // window <= 0: no window
};

// -- float32: CUDA cores -------------------------------------------------------

namespace f32 {

constexpr int kBQ = 64;            // q rows per CTA
constexpr int kBK = 64;            // kv rows per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kPLD = kBK + 16;     // P row stride: the two rows a warp reads
                                   // land 16 banks apart

template <int HD>
constexpr int smem_floats() {
  return 2 * kBQ * (HD + 1) + kBQ * kPLD;
}

template <int HD, bool WIDE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const FaArgs a) {
  constexpr int LD = HD + 1;        // padded row stride of Q and K/V tiles
  constexpr int CJ = HD / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // kBQ x LD: q * scale (WIDE: one chunk)
  float* KVs = Qs + kBQ * LD;       // kBK x LD: K tile, then V tile
  float* Ps = KVs + kBK * LD;       // kBQ x kPLD: probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;     // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qt * kBQ;
  const float* qp = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* kp = static_cast<const float*>(a.k) + b * a.ks[0]
                    + kvh * a.ks[1];
  const int c0 = WIDE ? a.c0 : 0;   // this launch's output columns
  const float* vp = static_cast<const float*>(a.v) + b * a.vs[0]
                    + kvh * a.vs[1] + c0;
  float* op = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[1] + c0;

  // Q's columns [col, col + HD), pre-scaled, zero past Sq and hd
  auto load_q = [&](int col) {
    for (int e = tid; e < kBQ * HD; e += kThreads) {
      const int r = e / HD, d = e % HD, qi = q0 + r;
      Qs[r * LD + d] = qi < a.Sq && (!WIDE || col + d < a.hd)
                           ? qp[qi * a.qs[2] + col + d] * a.scale : 0.f;
    }
  };
  if constexpr (!WIDE) load_q(0);

  int kt_begin, kt_end;
  fa::kv_range(a.Sq, a.Skv, a.causal, a.window, q0, kBQ, kBK, &kt_begin,
               &kt_end);

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
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int ch = 0; ch < (WIDE ? a.nch : 1); ++ch) {
      const int col = ch * HD;
      __syncthreads();              // the last tile's V and P (or chunk)
      if constexpr (WIDE) load_q(col);               // are consumed
      for (int e = tid; e < kBK * HD; e += kThreads) {
        const int r = e / HD, d = e % HD, kj = k0 + r;
        KVs[r * LD + d] = kj < a.Skv && (!WIDE || col + d < a.hd)
                              ? kp[kj * a.ks[2] + col + d] : 0.f;
      }
      __syncthreads();
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
      KVs[r * LD + d] = kj < a.Skv ? vp[kj * a.vs[2] + d] : 0.f;
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
      op[qi * a.os[2] + tx + 16 * c] = acc[i][c] / denom;
    if (a.lse != nullptr && tx == 0)
      a.lse[((int64_t)b * a.H + h) * a.Sq + qi] = m_i[i] + logf(denom);
  }
}

template <int HD, bool WIDE>
int launch(const FaArgs& a, int B, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  flash_fwd_f32<HD, WIDE><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace f32

// -- bfloat16: tensor cores (mma.sync m16n8k16) ---------------------------------

namespace bf16 {

using bf16_t = __nv_bfloat16;
using fa::cp_async_16;
using fa::cp_async_commit;
using fa::cp_async_wait;
using fa::ex2;
using fa::kLog2e;
using fa::ldsm_x4;
using fa::ldsm_x4_trans;
using fa::mma;
using fa::pack;
using fa::smem_u32;

constexpr int kStages = 2;         // K/V ring depth

template <int HD, bool CAP, bool WIDE>
struct Tile {
  static constexpr int kWarps = 4;
  static constexpr int MT = HD == 128 && !CAP && !WIDE ? 2 : 1;  // m16 tiles
  static constexpr int kBQ = 16 * MT * kWarps;     // q rows a CTA
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BK = HD == 256 ? 32 : 64;   // kv rows per tile
  static constexpr bool kQInRegs = !WIDE && MT == 1 && HD <= 128;
  static constexpr int LDS = HD + 8;               // padded row, in bf16
  static constexpr int smem_bytes =
      (kBQ + 2 * kStages * BK) * LDS * (int)sizeof(bf16_t);
};

// (Fragment layouts: fa_common.cuh.)  A warp owns MT m16 row tiles: each K
// and V fragment feeds MT products.  LSE: whether the launch may write lse
// (a template flag, so that serving runs the code it ran before lse).
template <int HD, bool CAP, bool WIDE, bool LSE>
__global__ void __launch_bounds__(Tile<HD, CAP, WIDE>::kThreads)
flash_fwd_bf16(const FaArgs a) {
  using T = Tile<HD, CAP, WIDE>;
  constexpr int BK = T::BK, LDS = T::LDS, kBQ = T::kBQ, MT = T::MT;
  constexpr int kThreads = T::kThreads;
  constexpr int WR = 16 * MT;       // rows a warp
  constexpr int NT = BK / 8;        // score n8 tiles of an m16 tile
  constexpr int DT = HD / 8;        // output n8 tiles of an m16 tile
  constexpr int CH = HD / 8;        // 16-B chunks in a row
  constexpr int ROW = LDS * (int)sizeof(bf16_t);   // bytes a smem row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* Qs = reinterpret_cast<bf16_t*>(smem_raw);   // kBQ x LDS
  bf16_t* Ks = Qs + kBQ * LDS;                        // kStages x BK x LDS
  bf16_t* Vs = Ks + kStages * BK * LDS;               // kStages x BK x LDS

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;     // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qt * kBQ;
  const bf16_t* qp = static_cast<const bf16_t*>(a.q) + b * a.qs[0]
                     + h * a.qs[1];
  const bf16_t* kp = static_cast<const bf16_t*>(a.k) + b * a.ks[0]
                     + kvh * a.ks[1];
  const int c0 = WIDE ? a.c0 : 0;   // this launch's output columns
  const bf16_t* vp = static_cast<const bf16_t*>(a.v) + b * a.vs[0]
                     + kvh * a.vs[1] + c0;
  bf16_t* op = static_cast<bf16_t*>(a.o) + b * a.os[0] + h * a.os[1] + c0;

  // a thread copies 16-B chunk cc of rows r0, r0 + RP, ...
  constexpr int RP = kThreads / CH;
  static_assert(kThreads % CH == 0 && BK % RP == 0 && kBQ % RP == 0, "");
  const int r0 = tid / CH, cc = tid % CH;

  // Q's columns [col, col + HD), rows past Sq and columns past hd zero
  auto load_q = [&](int col) {
    const bool in = !WIDE || col + cc * 8 < a.hd;
    for (int r = r0; r < kBQ; r += RP) {
      const bool ok = in && q0 + r < a.Sq;
      cp_async_16(smem_u32(Qs + r * LDS + cc * 8),
                  qp + (ok ? (int64_t)(q0 + r) * a.qs[2] + col : 0) + cc * 8,
                  ok);
    }
  };
  // K's columns [col, col + HD) into stage st
  auto load_k = [&](int kt, int st, int col) {
    const int k0 = kt * BK;
    const bool in = !WIDE || col + cc * 8 < a.hd;
    for (int r = r0; r < BK; r += RP) {
      const bool ok = in && k0 + r < a.Skv;
      const int64_t row = ok ? k0 + r : 0;
      cp_async_16(smem_u32(Ks + (st * BK + r) * LDS + cc * 8),
                  kp + (ok ? row * a.ks[2] + col : 0) + cc * 8, ok);
    }
  };
  auto load_v = [&](int kt, int st) {
    const int k0 = kt * BK;
    for (int r = r0; r < BK; r += RP) {
      const bool ok = k0 + r < a.Skv;
      const int64_t row = ok ? k0 + r : 0;
      cp_async_16(smem_u32(Vs + (st * BK + r) * LDS + cc * 8),
                  vp + row * a.vs[2] + cc * 8, ok);
    }
  };
  // K and V's tile kt into stage st, one head-dim-wide load of each
  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * BK;
    for (int r = r0; r < BK; r += RP) {
      const bool ok = k0 + r < a.Skv;
      const int64_t row = ok ? k0 + r : 0;
      const int at = (st * BK + r) * LDS + cc * 8;
      cp_async_16(smem_u32(Ks + at), kp + row * a.ks[2] + cc * 8, ok);
      cp_async_16(smem_u32(Vs + at), vp + row * a.vs[2] + cc * 8, ok);
    }
  };

  int kt_begin, kt_end;
  fa::kv_range(a.Sq, a.Skv, a.causal, a.window, q0, kBQ, BK, &kt_begin,
               &kt_end);
  if constexpr (!WIDE) {
    // Q once per CTA, then the first K/V tile
    load_q(0);
    cp_async_commit();
    if (kt_begin < kt_end) load_kv(kt_begin, 0);
    cp_async_commit();
  }

  // per-lane ldmatrix addresses: Q as A, K as B of S = Q.K^T, V as B of
  // P.V (transposed)
  const uint32_t q_lane = fa::lane_a(Qs + WR * w * LDS, LDS, lane);
  const uint32_t k_lane = fa::lane_b(Ks, LDS, lane);
  const uint32_t v_lane = fa::lane_t(Vs, LDS, lane);

  uint32_t qf[T::kQInRegs ? HD / 16 : 1][4];
  if constexpr (T::kQInRegs) {
    cp_async_wait<1>();              // the Q group; the first K/V may fly
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(qf[kk], q_lane + kk * 32);
  }

  float o[MT][DT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int d = 0; d < DT; ++d)
      o[mt][d][0] = o[mt][d][1] = o[mt][d][2] = o[mt][d][3] = 0.f;
  float m[MT][2], l[MT][2];          // rows g and g + 8 of each m16 tile:
#pragma unroll                       // max (log2 domain), this thread's
  for (int mt = 0; mt < MT; ++mt)    // share of the sum
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = kNegInf;
      l[mt][r] = 0.f;
    }
  const int qw = q0 + WR * w;        // the warp's first row
  const float sl2 = a.scale * kLog2e;

  // s += Q.K^T over the HD columns in shared memory (K in stage at k_st)
  auto qk = [&](float (&s)[MT][NT][4], uint32_t k_st) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (T::kQInRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[mt][i] = qf[kk][i];
        } else {
          ldsm_x4(qa[mt], q_lane + mt * 16 * ROW + kk * 32);
        }
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, k_st + np * 16 * ROW + kk * 32);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * np], qa[mt], kb[0], kb[1]);
          mma(s[mt][2 * np + 1], qa[mt], kb[2], kb[3]);
        }
      }
    }
  };

  int st = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt, st ^= 1) {
    const int k0 = kt * BK;
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
    uint32_t v_st;
    if constexpr (WIDE) {
      // each q.k chunk of Q and K, then V's slice, all in stage 0
      for (int ch = 0; ch < a.nch; ++ch) {
        __syncthreads();             // the last chunk (or tile) is consumed
        load_q(ch * HD);
        load_k(kt, 0, ch * HD);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        qk(s, k_lane);
      }
      __syncthreads();
      load_v(kt, 0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      v_st = v_lane;
    } else {
      if (kt + 1 < kt_end) {
        load_kv(kt + 1, st ^ 1);     // read by the last tile, synced below
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      qk(s, k_lane + st * BK * ROW);
      v_st = v_lane + st * BK * ROW;
    }

    // scale (softcap), fold log2(e); mask only the straddling tiles
    const bool edge = k0 + BK > a.Skv
                      || (a.causal && k0 + BK - 1 > qw)
                      || (a.window > 0 && qw + WR - 1 - k0 >= a.window);
    if constexpr (CAP) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s[mt][j][c] = tanhf(s[mt][j][c] * a.scale / a.softcap)
                          * a.softcap * kLog2e;
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[mt][j][c] *= sl2;
    }
    if (edge) {                      // keep lo < key < hi, row by row
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qi = qw + 16 * mt + g + 8 * r;
          const int hi = a.causal ? min(a.Skv, qi + 1) : a.Skv;
          const int lo = a.window > 0 ? qi - a.window : -1;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kj = k0 + 8 * j + 2 * t + c;
              if (kj >= hi || kj <= lo) s[mt][j][2 * r + c] = kNegInf;
            }
        }
    }

    // online softmax: a row's max over the quad's 4 threads
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][r], mx);
        alpha[r] = ex2(m[mt][r] - m_new);
        m[mt][r] = m_new;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          s[mt][j][2 * r] = ex2(s[mt][j][2 * r] - m_new);
          s[mt][j][2 * r + 1] = ex2(s[mt][j][2 * r + 1] - m_new);
          psum += s[mt][j][2 * r] + s[mt][j][2 * r + 1];
        }
        l[mt][r] = l[mt][r] * alpha[r] + psum;
      }
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[mt][d][0] *= alpha[0];
        o[mt][d][1] *= alpha[0];
        o[mt][d][2] *= alpha[1];
        o[mt][d][3] *= alpha[1];
      }
    }

    // O += P . V: score tiles 2kk and 2kk+1 are the k16 A fragment kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        fa::c_to_a(pa[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, v_st + kk * 16 * ROW + dp * 32);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(o[mt][2 * dp], pa[mt], vb[0], vb[1]);
          mma(o[mt][2 * dp + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();                 // stage st is free for tile kt + 2
  }
  cp_async_wait<0>();                // an empty loop leaves Q in flight,
  __syncthreads();                   // and its rows are other threads' loads

  // epilogue: full row sums, O / max(l, 1e-30) in bf16 through the warp's
  // own Q rows, then 16-B stores of the rows < Sq; lse by the quad's first
  // thread
  bf16_t* Os = Qs + WR * w * LDS;
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float denom = fmaxf(sum, 1e-30f);
      inv[r] = 1.f / denom;
      const int qi = qw + 16 * mt + g + 8 * r;
      // (b, h) re-read from the grid: kept live through the loop, they
      // would cost the hd = 128 tile its last registers
      if (LSE && a.lse != nullptr && t == 0 && qi < a.Sq)
        a.lse[((int64_t)blockIdx.z * a.H + blockIdx.y) * a.Sq + qi] =
            (m[mt][r] + log2f(denom)) * fa::kLn2;
    }
    bf16_t* row = Os + (16 * mt + g) * LDS + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<uint32_t*>(row + 8 * d) =
          pack(o[mt][d][0] * inv[0], o[mt][d][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(row + 8 * LDS + 8 * d) =
          pack(o[mt][d][2] * inv[1], o[mt][d][3] * inv[1]);
    }
  }
  __syncwarp();
  for (int c = lane; c < WR * CH; c += 32) {
    const int r = c / CH, cc = c % CH, qi = qw + r;
    if (qi < a.Sq)
      *reinterpret_cast<uint4*>(op + qi * a.os[2] + cc * 8) =
          *reinterpret_cast<const uint4*>(Os + r * LDS + cc * 8);
  }
}

template <int HD, bool CAP, bool WIDE, bool LSE>
int launch_lse(const FaArgs& a, int B, cudaStream_t stream) {
  using T = Tile<HD, CAP, WIDE>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<HD, CAP, WIDE, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + T::kBQ - 1) / T::kBQ, a.H, B);
  flash_fwd_bf16<HD, CAP, WIDE, LSE>
      <<<grid, T::kThreads, T::smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// a WIDE slice always takes the lse flag (only the first passes a buffer)
template <int HD, bool CAP, bool WIDE>
int launch_cap(const FaArgs& a, int B, cudaStream_t stream) {
  if (WIDE || a.lse != nullptr)
    return launch_lse<HD, CAP, WIDE, true>(a, B, stream);
  return launch_lse<HD, CAP, WIDE, WIDE>(a, B, stream);
}

template <int HD, bool WIDE>
int launch(const FaArgs& a, int B, cudaStream_t stream) {
  return a.softcap > 0.f ? launch_cap<HD, true, WIDE>(a, B, stream)
                         : launch_cap<HD, false, WIDE>(a, B, stream);
}

}  // namespace bf16

template <int HD, bool WIDE>
int launch(const FaArgs& a, int dtype, int B, cudaStream_t stream) {
  if (dtype == 0) return f32::launch<HD, WIDE>(a, B, stream);
  if (dtype == 1) return bf16::launch<HD, WIDE>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool WIDE>
int launch_width(const FaArgs& a, int w, int dtype, int B,
                 cudaStream_t s) {
  switch (w) {
    case 32: return launch<32, WIDE>(a, dtype, B, s);
    case 64: return launch<64, WIDE>(a, dtype, B, s);
    case 128: return launch<128, WIDE>(a, dtype, B, s);
    case 256: return launch<256, WIDE>(a, dtype, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, H, Sq, hd), k/v (B, KV, Skv, hd), o (B, H, Sq, hd), all of one type
// (dtype 0: float32, CUDA-core kernel; 1: bfloat16, tensor-core kernel),
// hd contiguous; hd 32, 64, 128, 256, or above 256 a multiple of 32 (one
// launch per slice of built width).  lse: float32 (B, H, Sq) contiguous, or
// null for none.  strides: 12 int64, the (b, h, s) strides of q, k, v and o
// in elements; for bfloat16 every pointer 16-B aligned and every stride a
// multiple of 8.  window <= 0: none; softcap <= 0: none.  Returns
// cudaGetLastError() after the (last) launch, or the first error.
int fa_forward(const void* q, const void* k, const void* v, void* o,
               float* lse, int dtype, int B, int H, int KV, int Sq, int Skv,
               int hd, const int64_t* strides, float scale, int causal,
               int window, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaSuccess;
  FaArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.H = H; a.KV = KV; a.Sq = Sq; a.Skv = Skv; a.hd = hd;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.scale = scale; a.softcap = softcap; a.causal = causal; a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= fa::kMaxSlice) {
    if (hd != 32 && hd != 64 && hd != 128 && hd != 256)
      return (int)cudaErrorInvalidValue;
    a.c0 = 0;
    a.nch = 1;
    return launch_width<false>(a, hd, dtype, B, s);
  }
  if (hd % 32) return (int)cudaErrorInvalidValue;
  for (int c0 = 0; c0 < hd;) {
    const int w = fa::next_slice(hd - c0, fa::kMaxSlice);
    a.c0 = c0;
    a.nch = (hd + w - 1) / w;
    a.lse = c0 == 0 ? lse : nullptr;
    const int err = launch_width<true>(a, w, dtype, B, s);
    if (err) return err;
    c0 += w;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
