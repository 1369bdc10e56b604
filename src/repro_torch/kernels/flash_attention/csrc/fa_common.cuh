// What the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu) share: the masked-score sentinel, the kv range of
// a q tile, the head-dim slices a launch covers, and the tensor-core helpers
// of the bfloat16 kernels (cp.async, ldmatrix, mma.sync m16n8k16, bf16x2
// packing, ex2).
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16: a[0] (row g, k 2t..2t+1), a[1] (row g+8, same k),
//            a[2] (row g, k 2t+8..), a[3] (row g+8, k 2t+8..);
//   B 16x8:  b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g);
//   C 16x8:  c[0..1] (row g, col 2t..2t+1), c[2..3] (row g+8, same cols).
// ldmatrix.x4: lanes 8i..8i+7 address the rows of 8x8 matrix i, which lands
// in register i (row g, cols 2t..2t+1; .trans: col g, rows 2t..2t+1).  So a
// row-major smem tile X[r][c] gives, per 16x16 block:
//   A of X (rows r, k = c):       ldsm_x4 at lane_a(X)
//   B of X^T (k = c, n = r):      ldsm_x4 at lane_b(X), two n8 tiles
//   B of X (k = r, n = c):        ldsm_x4_trans at lane_t(X), two n8 tiles
// and two n8 C tiles side by side are one k16 A fragment (P, dS: the
// product's next operand never goes through shared memory).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the widest head-dim slice a forward launch accumulates
constexpr int kMaxSlice = 256;

// kv tiles a q tile [q0, q0 + rows) needs: causal stops at the tile of its
// last row, a window starts at the tile of its first row's first key
__device__ __forceinline__ void kv_range(int Sq, int Skv, int causal,
                                         int window, int q0, int rows,
                                         int bk, int* begin, int* end) {
  const int q_last = min(q0 + rows, Sq) - 1;
  const int nk = (Skv + bk - 1) / bk;
  *end = causal ? min(nk, q_last / bk + 1) : nk;
  *begin = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / bk : 0;
}

// the widest built head dim (32, 64, 128, up to `cap`) that fits in `rest`
// columns, `rest` a multiple of 32: the next slice of a head dim split into
// built widths
inline int next_slice(int rest, int cap) {
  int w = cap;
  while (w > rest) w >>= 1;
  return w;
}

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

// per-lane ldmatrix addresses into a row-major tile of `ld` bf16 a row (see
// the header): A of X, B of X^T, B of X
__device__ __forceinline__ uint32_t lane_a(const __nv_bfloat16* x, int ld,
                                           int lane) {
  return smem_u32(x + (lane & 15) * ld + (lane >> 4) * 8);
}
__device__ __forceinline__ uint32_t lane_b(const __nv_bfloat16* x, int ld,
                                           int lane) {
  return smem_u32(x + ((lane & 7) + ((lane >> 4) << 3)) * ld
                  + ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ uint32_t lane_t(const __nv_bfloat16* x, int ld,
                                           int lane) {
  return smem_u32(x + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld
                  + (lane >> 4) * 8);
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

// two n8 C tiles (k 0..7 and 8..15 of a k16 step) as one A fragment,
// rounded to bf16
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// 2^x on the special-function unit; every argument here is <= 0 but for
// float rounding, where the result is exp2f's (1 for 0, 0 for the -1e30
// sentinel's differences)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace fa
