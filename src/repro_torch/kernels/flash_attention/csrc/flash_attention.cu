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
// 403 MB of inputs and output, so the tensor-core rate bounds it: 0.556 ms
// at 989 TFLOP/s bf16, against 0.12 ms of bytes.  The entry point picks one
// of two kernels by dtype.  Both give each CTA one (q tile, head, batch),
// schedule the heavy causal tiles (high q index) first, and loop over the
// kv tiles [kt_begin, kt_end) inside the CTA (the TPU grid's sequential kv
// axis); strides in elements for every dimension but hd let the model's
// (B, S, H, hd) projections, viewed as (B, H, S, hd), be read in place and
// the output be written straight into a (B, S, H, hd) buffer.
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
//    Every instantiation fits in 255 registers with no spills (the build's
//    -Xptxas -v log).
//  * K and V tiles (64 keys) come through a 2-stage ring in shared memory
//    by cp.async (16 B a thread, rows past Skv zero-filled, so no stale NaN
//    meets a p of 0): tile kt+1 is in flight while tile kt is multiplied.
//    Q is loaded once per CTA.  Rows are padded by 16 B, so the 8 rows of
//    one ldmatrix phase fall on 8 distinct 16-B bank groups.
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
//    >= Sq are never written.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// kv tiles a q tile [q0, q0 + rows) needs: causal stops at the tile of its
// last row, a window starts at the tile of its first row's first key
__device__ __forceinline__ void kv_range(const FaArgs& a, int q0, int rows,
                                         int bk, int* begin, int* end) {
  const int q_last = min(q0 + rows, a.Sq) - 1;
  const int nk = (a.Skv + bk - 1) / bk;
  *end = a.causal ? min(nk, q_last / bk + 1) : nk;
  *begin = (a.window > 0 && q0 - a.window + 1 > 0)
               ? (q0 - a.window + 1) / bk : 0;
}

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

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const FaArgs a) {
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
  const float* qp = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* kp = static_cast<const float*>(a.k) + b * a.ks[0]
                    + kvh * a.ks[1];
  const float* vp = static_cast<const float*>(a.v) + b * a.vs[0]
                    + kvh * a.vs[1];
  float* op = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[1];

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, qi = q0 + r;
    Qs[r * LD + d] = qi < a.Sq ? qp[qi * a.qs[2] + d] * a.scale : 0.f;
  }

  int kt_begin, kt_end;
  kv_range(a, q0, kBQ, kBK, &kt_begin, &kt_end);

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
      KVs[r * LD + d] = kj < a.Skv ? kp[kj * a.ks[2] + d] : 0.f;
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
  }
}

template <int HD>
int launch(const FaArgs& a, int B, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  flash_fwd_f32<HD><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace f32

// -- bfloat16: tensor cores (mma.sync m16n8k16) ---------------------------------

namespace bf16 {

using bf16_t = __nv_bfloat16;

constexpr int kStages = 2;         // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

template <int HD, bool CAP>
struct Tile {
  static constexpr int kWarps = 4;
  static constexpr int MT = HD == 128 && !CAP ? 2 : 1;   // m16 tiles a warp
  static constexpr int kBQ = 16 * MT * kWarps;     // q rows a CTA
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BK = HD == 256 ? 32 : 64;   // kv rows per tile
  static constexpr bool kQInRegs = MT == 1 && HD <= 128;
  static constexpr int LDS = HD + 8;               // padded row, in bf16
  static constexpr int smem_bytes =
      (kBQ + 2 * kStages * BK) * LDS * (int)sizeof(bf16_t);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 B global -> shared, bypassing L1; src_size 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
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

// 2^x on the special-function unit; every argument here is <= 0, where
// the result is exp2f's (1 for 0, 0 for the -1e30 sentinel's differences)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16: a[0] (row g, k 2t..2t+1), a[1] (row g+8, same k),
//            a[2] (row g, k 2t+8..), a[3] (row g+8, k 2t+8..);
//   B 16x8:  b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g);
//   C 16x8:  c[0..1] (row g, col 2t..2t+1), c[2..3] (row g+8, same cols).
// ldmatrix.x4: lanes 8i..8i+7 address the rows of 8x8 matrix i, which lands
// in register i (row g, cols 2t..2t+1; .trans: col g, rows 2t..2t+1).
// A warp owns MT m16 row tiles: each K and V fragment feeds MT products.
template <int HD, bool CAP>
__global__ void __launch_bounds__(Tile<HD, CAP>::kThreads)
flash_fwd_bf16(const FaArgs a) {
  using T = Tile<HD, CAP>;
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
  const bf16_t* vp = static_cast<const bf16_t*>(a.v) + b * a.vs[0]
                     + kvh * a.vs[1];
  bf16_t* op = static_cast<bf16_t*>(a.o) + b * a.os[0] + h * a.os[1];

  // a thread copies 16-B chunk cc of rows r0, r0 + RP, ...
  constexpr int RP = kThreads / CH;
  static_assert(kThreads % CH == 0 && BK % RP == 0 && kBQ % RP == 0, "");
  const int r0 = tid / CH, cc = tid % CH;

  // Q once per CTA, rows past Sq zero-filled
  for (int r = r0; r < kBQ; r += RP) {
    const bool ok = q0 + r < a.Sq;
    cp_async_16(smem_u32(Qs + r * LDS + cc * 8),
                qp + (ok ? (int64_t)(q0 + r) * a.qs[2] : 0) + cc * 8, ok);
  }
  cp_async_commit();

  int kt_begin, kt_end;
  kv_range(a, q0, kBQ, BK, &kt_begin, &kt_end);

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
  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  cp_async_commit();

  // per-lane ldmatrix addresses: Q as A (rows lane % 16, k half lane / 16);
  // K as B of S (keys lane % 8 + 8 (lane / 16), k half (lane / 8) % 2);
  // V as B of P.V, transposed (keys lane % 8 + 8 ((lane / 8) % 2), cols
  // half lane / 16)
  const uint32_t q_lane =
      smem_u32(Qs + (WR * w + (lane & 15)) * LDS + (lane >> 4) * 8);
  const uint32_t k_lane = smem_u32(
      Ks + ((lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 8);
  const uint32_t v_lane = smem_u32(
      Vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDS + (lane >> 4) * 8);

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

  int st = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt, st ^= 1) {
    if (kt + 1 < kt_end) {
      load_kv(kt + 1, st ^ 1);       // read by the last tile, synced below
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * BK;
    const uint32_t k_st = k_lane + st * BK * ROW;
    const uint32_t v_st = v_lane + st * BK * ROW;

    // S = Q . K^T, float32
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
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
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
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
  // own Q rows, then 16-B stores of the rows < Sq
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
      inv[r] = 1.f / fmaxf(sum, 1e-30f);
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

template <int HD, bool CAP>
int launch_cap(const FaArgs& a, int B, cudaStream_t stream) {
  using T = Tile<HD, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<HD, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + T::kBQ - 1) / T::kBQ, a.H, B);
  flash_fwd_bf16<HD, CAP><<<grid, T::kThreads, T::smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const FaArgs& a, int B, cudaStream_t stream) {
  return a.softcap > 0.f ? launch_cap<HD, true>(a, B, stream)
                         : launch_cap<HD, false>(a, B, stream);
}

}  // namespace bf16

template <int HD>
int launch(const FaArgs& a, int dtype, int B, cudaStream_t stream) {
  if (dtype == 0) return f32::launch<HD>(a, B, stream);
  if (dtype == 1) return bf16::launch<HD>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, H, Sq, hd), k/v (B, KV, Skv, hd), o (B, H, Sq, hd), all of one type
// (dtype 0: float32, CUDA-core kernel; 1: bfloat16, tensor-core kernel),
// hd contiguous.  strides: 12 int64, the (b, h, s) strides of q, k, v and o
// in elements; for bfloat16 every pointer 16-B aligned and every stride a
// multiple of 8.  window <= 0: none; softcap <= 0: none.  Returns
// cudaGetLastError() after the launch.
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
  switch (hd) {
    case 32: return launch<32>(a, dtype, B, s);
    case 64: return launch<64>(a, dtype, B, s);
    case 128: return launch<128>(a, dtype, B, s);
    case 256: return launch<256>(a, dtype, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
