// Decode attention for Hopper (sm_90a): one query a (batch row, head) over a
// KV cache read in place, the attention of every cached decode step.
//
// Replaces no Pallas kernel: the reference's decode attention is jnp,
// src/repro/models/layers.py sdpa (:144) and its online-softmax twin
// flash_decode (:236), which the port keeps as layers.sdpa and
// layers.flash_decode.  It computes layers.flash_decode's function for
// q (B, 1, H, hd) and k (B, Skv, KV, hd), v (B, Skv, KV, vd), query head h
// reading kv head h / G (G = H / KV): q scaled in its own type, float32
// scores, an optional tanh softcap (tanh(s / cap) * cap), online softmax in
// float32, p rounded to v's type before P.V, float32 sums, the output in q's
// type.  The launcher turns kv_len, causal, q_offset and window into the one
// range of keys [lo, hi) that a single query sees (every other key scores
// -1e30 in the reference and adds exactly nothing), so the kernel reads no
// key outside it and masks nothing inside it.  float32, bfloat16 and float16
// caches; hd and vd up to 256, each a multiple of 16 bytes, vd free of hd
// (MLA's non-absorbed decode reads 192 / 128).
//
// What bounds it on this card: bytes.  A query does 2 (hd + vd) FLOPs a key
// for every (hd + vd) elements of K and V, times G heads: at internlm2's
// G = 2 in bf16 two FLOPs a byte, where the card needs ~295 before the
// arithmetic counts.  At its decode shape (B 8, KV 8, 8,200 keys, hd 128)
// one layer's K and V prefix is 268.7 MB, 0.080 ms at 3.35 TB/s.  So the
// design reads each byte once and keeps many of them in flight:
//  * Grid (kv head x head group, split, batch row).  One CTA serves the G
//    query heads of its kv head (up to 8; a larger group takes several
//    CTAs), so each K and V byte is read by one CTA, and the CTAs of one
//    key range's kv heads, which read the same cache rows, run side by
//    side.  The launcher splits the key range into equal runs so that the
//    grid covers the SMs a few times over, but no split is shorter than
//    256 keys: a short cache (whisper's decoder) keeps one split and one
//    launch.
//  * No shared-memory staging and no barrier in the key loop: each group
//    of `lpk` lanes (a slot: the fewest lanes, a power of two, that hold a
//    K or a V row as 16-B chunks, one a lane, two in float32 past 128)
//    walks its own keys, every (4 warps x 32 / lpk)-th of the split.  A
//    slot loads the K and V chunks of unroll() keys into registers (16-B
//    read-only loads) before it uses any: at internlm2's shape 8 keys, so
//    each warp keeps 8 KB in flight and an SM's 16 warps 128 KB.
//  * Scores on the CUDA cores in float32: each lane dots its chunks of q
//    (scaled and rounded to its type, held as float32 in registers) for
//    every head of the group, and the slot's lanes sum them by xor
//    shuffles.  Each slot keeps its own running (m, l) and its lanes' P.V
//    chunks for every head, rescaled once per unroll() keys.
//  * Every sum runs in one order, whatever the timing: after the last key
//    the slots' (m, l, acc) are combined in slot order through shared
//    memory; a split writes them to float32 scratch and a second launch
//    merges the splits in ascending order (with one split the CTA
//    normalises and writes the output itself), so two calls give the same
//    bits.
// Tensor cores would not help: at G <= 8 the CUDA cores keep pace with the
// bytes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "fa_common.cuh"

namespace {

using fa::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;                 // (B, H, vd) contiguous, q's type
  float* part;             // (B, H, splits, vd) float32 sums, or null: one
  float* ml;               // split writes o; (B, H, splits, 2) its (m, l)
  int H, KV, G, hd, vd;
  int lpk;                 // lanes a key (a slot), a power of two
  int64_t qs[2];           // q's (b, h) strides, in elements
  int64_t ks[3], vs[3];    // k's and v's (b, s, kv head) strides
  int lo, hi;              // the keys [lo, hi) attended
  int chunk, splits;       // keys a split, splits
  float scale, softcap;    // softcap <= 0: none
};

// one element type: its 16-B vector and its conversions
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ static float to(float x) { return x; }
  __device__ static float from(float x) { return x; }
  __device__ static void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float to(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ static void unpack(const uint4& u, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

template <>
struct Elem<__half> {
  static constexpr int kVec = 8;
  __device__ static float to(__half x) { return __half2float(x); }
  __device__ static __half from(float x) { return __float2half_rn(x); }
  __device__ static void unpack(const uint4& u, float (&f)[8]) {
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __half22float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

// keys a slot loads before it computes: fewer for the widest head groups,
// whose q and P.V chunks already take 128 registers
template <int GC>
__host__ __device__ constexpr int unroll() {
  return GC >= 8 ? 2 : 8;
}

// shared memory after the key loop: each slot's (m, l) and P.V sums
__host__ __device__ inline int smem_bytes(int lpk, int vd, int gc) {
  return kWarps * (32 / lpk) * gc * (vd + 2) * 4;
}

template <typename T, int GC, int CPL>
__global__ void __launch_bounds__(kThreads)
decode_split(const DecodeArgs a) {
  using E = Elem<T>;
  constexpr int V = E::kVec;               // elements in 16 B
  constexpr int U = unroll<GC>();
  extern __shared__ __align__(16) float red[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpk = a.lpk, kpw = 32 / lpk;
  const int sub = lane / lpk, cl = lane - sub * lpk;
  const int nslots = kWarps * kpw, slot = warp * kpw + sub;
  const int groups = (a.G + GC - 1) / GC;
  const int kvh = blockIdx.x / groups;
  const int g0 = (blockIdx.x - kvh * groups) * GC;
  const int gn = min(GC, a.G - g0);
  const int split = blockIdx.y, b = blockIdx.z;
  const int key_begin = a.lo + split * a.chunk;
  const int key_end = min(a.hi, key_begin + a.chunk);
  const int ck = a.hd / V, cv = a.vd / V;  // 16-B chunks of a K, a V row

  // this lane's chunks of q, scaled in q's own type as the reference does;
  // the group's unused heads and the chunks past hd are zeros
  const T* qp = static_cast<const T*>(a.q) + b * a.qs[0];
  float q[GC][CPL][V];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = cl + i * lpk;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float x = 0.f;
        if (g < gn && c < ck)
          x = E::to(E::from(E::to(qp[(int64_t)(kvh * a.G + g0 + g) * a.qs[1]
                                     + c * V + e]) * a.scale));
        q[g][i][e] = x;
      }
    }

  const char* kb = reinterpret_cast<const char*>(
      static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[2]);
  const char* vb = reinterpret_cast<const char*>(
      static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[2]);
  const int64_t kstep = a.ks[1] * (int64_t)sizeof(T);   // bytes a key
  const int64_t vstep = a.vs[1] * (int64_t)sizeof(T);
  bool kon[CPL], von[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    kon[i] = cl + i * lpk < ck;
    von[i] = cl + i * lpk < cv;
  }

  float m[GC], l[GC], acc[GC][CPL][V];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][i][e] = 0.f;
  }

  // the loop runs alike for every lane of a warp (its first slot's keys
  // decide), so the shuffles below never meet a lane that has left it
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int base = key_begin + warp * kpw; base < key_end;
       base += U * nslots) {
    uint4 kr[U][CPL], vr[U][CPL];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = base + sub + u * nslots;
      ok[u] = key < key_end;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int off = (cl + i * lpk) * 16;
        kr[u][i] = ok[u] && kon[i]
            ? __ldg(reinterpret_cast<const uint4*>(kb + key * kstep + off))
            : zero;
        vr[u][i] = ok[u] && von[i]
            ? __ldg(reinterpret_cast<const uint4*>(vb + key * vstep + off))
            : zero;
      }
    }
    // the U keys' scores for every head: this lane's share, then the
    // slot's lanes summed (every lane of the warp shuffles: lpk is uniform)
    float s[U][GC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < GC; ++g) s[u][g] = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        float kf[V];
        E::unpack(kr[u][i], kf);
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int e = 0; e < V; ++e)
            s[u][g] = fmaf(q[g][i][e], kf[e], s[u][g]);
      }
      for (int o = lpk >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < GC; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
      }
    }
    // online softmax: the running max, alpha, p (rounded to v's type for
    // P.V; l takes it unrounded), acc rescaled
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (a.softcap > 0.f) s[u][g] = tanhf(s[u][g] / a.softcap) * a.softcap;
        if (ok[u]) mx = fmaxf(mx, s[u][g]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ok[u] ? expf(s[u][g] - m_new) : 0.f;
        sum += p;
        s[u][g] = E::to(E::from(p));
      }
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < CPL; ++i)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][i][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        float vf[V];
        E::unpack(vr[u][i], vf);
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[g][i][e] = fmaf(s[u][g], vf[e], acc[g][i][e]);
      }
    }
  }

  // the slots combined in slot order: M = max m, L = sum l e^(m - M),
  // acc = sum acc e^(m - M)
  float* red_ml = red;                                // [slot][gc][2]
  float* red_acc = red + nslots * GC * 2;             // [slot][gc][vd]
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (cl == 0) {
      red_ml[(slot * GC + g) * 2] = m[g];
      red_ml[(slot * GC + g) * 2 + 1] = l[g];
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      if (von[i])
#pragma unroll
        for (int e = 0; e < V; ++e)
          red_acc[(slot * GC + g) * a.vd + (cl + i * lpk) * V + e] =
              acc[g][i][e];
  }
  __syncthreads();
  for (int i = tid; i < gn * a.vd; i += kThreads) {
    const int g = i / a.vd, d = i - g * a.vd;
    float mx = kNegInf;
    for (int s = 0; s < nslots; ++s)
      mx = fmaxf(mx, red_ml[(s * GC + g) * 2]);
    float ls = 0.f, x = 0.f;
    for (int s = 0; s < nslots; ++s) {
      const float w = expf(red_ml[(s * GC + g) * 2] - mx);
      ls += red_ml[(s * GC + g) * 2 + 1] * w;
      x += red_acc[(s * GC + g) * a.vd + d] * w;
    }
    const int64_t row = (int64_t)b * a.H + kvh * a.G + g0 + g;
    if (a.part == nullptr) {
      static_cast<T*>(a.o)[row * a.vd + d] = E::from(x / fmaxf(ls, 1e-30f));
    } else {
      const int64_t at = row * a.splits + split;
      a.part[at * a.vd + d] = x;
      if (d == 0) {
        a.ml[2 * at] = mx;
        a.ml[2 * at + 1] = ls;
      }
    }
  }
}

// the splits of one (b, h) merged in ascending order:
// o = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30)
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_merge(const float* part, const float* ml, T* o, int splits, int vd) {
  const int64_t row = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  const float* m = ml + row * splits * 2;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m[2 * s]);
  float l = 0.f;
  for (int s = 0; s < splits; ++s) l += m[2 * s + 1] * expf(m[2 * s] - mx);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < vd; d += kThreads) {
    float x = 0.f;
    for (int s = 0; s < splits; ++s)
      x += part[(row * splits + s) * vd + d] * expf(m[2 * s] - mx);
    o[row * vd + d] = Elem<T>::from(x * inv);
  }
}

template <typename T, int GC, int CPL>
int launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  const int bytes = smem_bytes(a.lpk, a.vd, GC);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split<T, GC, CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.KV * ((a.G + GC - 1) / GC), a.splits, B);
  decode_split<T, GC, CPL><<<grid, kThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.part == nullptr) return (int)err;
  decode_merge<T><<<dim3(a.H, B), kThreads, 0, stream>>>(
      a.part, a.ml, static_cast<T*>(a.o), a.splits, a.vd);
  return (int)cudaGetLastError();
}

template <typename T, int CPL>
int launch_group(const DecodeArgs& a, int gc, int B, cudaStream_t s) {
  switch (gc) {
    case 1: return launch<T, 1, CPL>(a, B, s);
    case 2: return launch<T, 2, CPL>(a, B, s);
    case 4: return launch<T, 4, CPL>(a, B, s);
    case 8: return launch<T, 8, CPL>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// lanes a key: the fewest, a power of two, whose 16-B chunks (one a lane;
// two in float32 past 128) hold the wider of a K and a V row
template <typename T>
int launch_type(DecodeArgs& a, int gc, int B, cudaStream_t s) {
  const int vec = 16 / (int)sizeof(T);
  const int width = (a.hd > a.vd ? a.hd : a.vd) / vec;
  const int cpl = width > 32 ? 2 : 1;
  a.lpk = 1;
  while (a.lpk * cpl < width) a.lpk *= 2;
  if constexpr (sizeof(T) == 4) {   // a 2-byte row of 256 is 32 chunks
    if (cpl == 2) return launch_group<T, 2>(a, gc, B, s);
  }
  return launch_group<T, 1>(a, gc, B, s);
}

}  // namespace

extern "C" {

// q (B, 1, H, hd), k (B, Skv, KV, hd), v (B, Skv, KV, vd), all of one type
// (dtype 0: float32, 1: bfloat16, 2: float16), the last dim contiguous;
// strides: 8 int64 in elements, q's (b, h) and k's and v's (b, s, kv head),
// with every k and v pointer 16-B aligned and every k and v stride, hd and
// vd multiples of 16 B.  o: (B, H, vd) contiguous, q's type.  The keys
// [lo, hi) are attended, hi > lo, in `splits` runs of `chunk` keys (the
// last may be shorter); with more than one, part (B, H, splits, vd) and ml
// (B, H, splits, 2) are float32 scratch, else null.  gc: 1, 2, 4 or 8 heads
// a CTA.  softcap <= 0: none.  Returns cudaGetLastError() after the last
// launch, or the first error.
int fa_decode(const void* q, const void* k, const void* v, void* o,
              float* part, float* ml, int dtype, int B, int H, int KV,
              int hd, int vd, const int64_t* strides, int lo, int hi,
              int chunk, int splits, int gc, float scale, float softcap,
              void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  if (hi <= lo || KV <= 0 || H % KV || splits <= 0 || chunk <= 0
      || hd > fa::kMaxSlice || vd > fa::kMaxSlice)
    return (int)cudaErrorInvalidValue;
  if ((splits > 1) != (part != nullptr)) return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.part = part; a.ml = ml;
  a.H = H; a.KV = KV; a.G = H / KV; a.hd = hd; a.vd = vd;
  a.qs[0] = strides[0];
  a.qs[1] = strides[1];
  for (int i = 0; i < 3; ++i) {
    a.ks[i] = strides[2 + i];
    a.vs[i] = strides[5 + i];
  }
  a.lo = lo; a.hi = hi; a.chunk = chunk; a.splits = splits;
  a.scale = scale; a.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_type<float>(a, gc, B, s);
  if (dtype == 1) return launch_type<__nv_bfloat16>(a, gc, B, s);
  if (dtype == 2) return launch_type<__half>(a, gc, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
