// Hash-partition kernels for Hopper (sm_90a): storage-time dispatch and the
// counting-sort scatter behind every device shuffle (DESIGN §5).
//
// Replaces the three Pallas TPU kernels of
// src/repro/kernels/hash_partition/hash_partition.py:
//   hash_partition         (:83)  Wang hash, pid = h % m, (m,) histogram
//   hash_partition_padded  (:142) the same over a power-of-two bucket; rows at
//                                 position >= n_valid go to overflow pid m
//   scatter_perm           (:208) dest = inverse(argsort(pids, stable))
//
// What bounds them on this card: all three are integer streaming passes with
// a handful of ALU operations per 4-byte element and no tensor-core work, so
// they are bounded by device-memory bytes (3.35 TB/s on an H100 SXM): the hash
// reads 4 bytes of key per valid row and writes 4 bytes of pid per row, the
// scatter reads the pids twice and writes the destinations once.
//
// Design:
//  * hash: a grid-stride loop, one row per thread per step; each CTA keeps a
//    shared-memory histogram and flushes it with one atomicAdd per bin.
//    Integer atomics commute, so the counts are bit-exact whatever the order.
//    n_valid is a plain argument: there is no trace to reuse, unlike the
//    Pallas kernel's scalar prefetch.  Padding rows (position >= n_valid)
//    cost only their pid write: their keys are not loaded, and their bin is
//    counted once, by arithmetic, instead of one atomic per row.
//  * scatter: the Pallas kernel walks its grid in order ("arbitrary") and
//    carries running per-partition offsets from step to step.  CTAs on a GPU
//    run concurrently in no order, so the carry becomes three passes:
//      1. every warp counts its own tile of rows per bin into an
//         (bins x n_tiles) bin-major matrix;
//      2. one CTA per bin turns its row of the matrix into bases: the
//         exclusive prefix of `counts` (computed here, in the kernel) plus an
//         exclusive scan over the tiles;
//      3. every warp re-reads its tile in order, 32 rows at a time, and ranks
//         each row among the equal pids of its step with __match_any_sync and
//         __popc(peers & lanemask_lt); the warp's running per-bin offsets
//         live in its own slice of shared memory.
//    Stability (equal pids keep input order) follows from tiles in order,
//    steps in order inside a tile and lanes in order inside a step; the
//    bit-identical guarantee rests on it.  Pids outside [0, bins) are never
//    counted and never move a real row; their own dest is written as 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
// Shared-memory budget a CTA uses without opting in to more than 48 KB.
constexpr int kSmemInts = 12288;
constexpr int kHashThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kMaxWarpsPerCta = 8;

__device__ __forceinline__ uint32_t wang_hash(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x = x * 9u;
  x = x ^ (x >> 4);
  x = x * 0x27D4EB2Du;
  x = x ^ (x >> 15);
  return x;
}

template <bool kPadded>
__global__ void hash_partition_kernel(const int32_t* __restrict__ keys,
                                      int32_t* __restrict__ pids,
                                      int32_t* __restrict__ counts,
                                      int64_t n, int64_t n_valid, uint32_t m,
                                      int bins) {
  extern __shared__ int s_hist[];
  for (int b = threadIdx.x; b < bins; b += blockDim.x) s_hist[b] = 0;
  __syncthreads();
  // Rows at position >= nv are padding: their keys are never read.
  const int64_t nv = kPadded ? max((int64_t)0, min(n_valid, n)) : n;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = first; i < nv; i += stride) {
    const int pid = (int)(wang_hash((uint32_t)keys[i]) % m);
    pids[i] = pid;
    atomicAdd(&s_hist[pid], 1);
  }
  if (kPadded) {
    for (int64_t i = nv + first; i < n; i += stride) pids[i] = (int)m;
    // No valid row hashes to m, so one thread counts all the padding.
    if (blockIdx.x == 0 && threadIdx.x == 0) s_hist[m] += (int)(n - nv);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    const int c = s_hist[b];
    if (c) atomicAdd(&counts[b], c);
  }
}

// Pass 1: per-(bin, tile) counts; one warp per tile of `tile_rows` rows.
__global__ void tile_count_kernel(const int32_t* __restrict__ pids,
                                  int32_t* __restrict__ tile_counts, int64_t n,
                                  int bins, int64_t n_tiles, int tile_rows) {
  extern __shared__ int s_mem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (tile >= n_tiles) return;
  int* s_cnt = s_mem + warp * bins;
  for (int b = lane; b < bins; b += 32) s_cnt[b] = 0;
  __syncwarp();
  const int64_t start = tile * tile_rows;
  const int64_t end = min(start + (int64_t)tile_rows, n);
  for (int64_t i0 = start; i0 < end; i0 += 32) {
    const int64_t i = i0 + lane;
    const int pid = i < end ? pids[i] : -1;
    const bool valid = (unsigned)pid < (unsigned)bins;
    const unsigned peers = __match_any_sync(kFullMask, valid ? pid : -1);
    if (valid && lane == __ffs(peers) - 1) s_cnt[pid] += __popc(peers);
    __syncwarp();
  }
  for (int b = lane; b < bins; b += 32)
    tile_counts[(int64_t)b * n_tiles + tile] = s_cnt[b];
}

// Exclusive scan of one value per thread across the CTA; `total` gets the
// CTA's sum.  s_warp holds one int per warp.
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, w, o);
      if (lane >= o) w += y;
    }
    if (lane < n_warps) s_warp[lane] = w;
  }
  __syncthreads();
  const int prefix = warp > 0 ? s_warp[warp - 1] : 0;
  *total = s_warp[n_warps - 1];
  __syncthreads();  // s_warp is reused by the next call
  return prefix + x - v;
}

// Pass 2: one CTA per bin turns its row of tile counts into tile bases, in
// place: base[b][t] = sum(counts[:b]) + sum(tile_counts[b][:t]).
__global__ void tile_base_kernel(const int32_t* __restrict__ counts,
                                 int32_t* __restrict__ tile_counts,
                                 int64_t n_tiles) {
  __shared__ int s_warp[32];
  const int b = blockIdx.x;
  int part = 0;
  for (int j = threadIdx.x; j < b; j += blockDim.x) part += counts[j];
  int carry;
  block_exclusive_scan(part, s_warp, &carry);  // carry = sum(counts[:b])
  int32_t* row = tile_counts + (int64_t)b * n_tiles;
  for (int64_t t0 = 0; t0 < n_tiles; t0 += blockDim.x) {
    const int64_t t = t0 + threadIdx.x;
    const int v = t < n_tiles ? row[t] : 0;
    int total;
    const int excl = block_exclusive_scan(v, s_warp, &total);
    if (t < n_tiles) row[t] = carry + excl;
    carry += total;
  }
}

// Pass 3: stable rank of each row inside its tile, plus the tile's base.
__global__ void tile_dest_kernel(const int32_t* __restrict__ pids,
                                 const int32_t* __restrict__ tile_base,
                                 int32_t* __restrict__ dest, int64_t n,
                                 int bins, int64_t n_tiles, int tile_rows) {
  extern __shared__ int s_mem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (tile >= n_tiles) return;
  int* s_off = s_mem + warp * bins;
  for (int b = lane; b < bins; b += 32)
    s_off[b] = tile_base[(int64_t)b * n_tiles + tile];
  __syncwarp();
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const int64_t start = tile * tile_rows;
  const int64_t end = min(start + (int64_t)tile_rows, n);
  for (int64_t i0 = start; i0 < end; i0 += 32) {
    const int64_t i = i0 + lane;
    const int pid = i < end ? pids[i] : -1;
    const bool valid = (unsigned)pid < (unsigned)bins;
    const unsigned peers = __match_any_sync(kFullMask, valid ? pid : -1);
    const int d = valid ? s_off[pid] + __popc(peers & lanemask_lt) : 0;
    __syncwarp();  // every peer has read s_off[pid] before the leader bumps it
    if (valid && lane == __ffs(peers) - 1) s_off[pid] += __popc(peers);
    __syncwarp();
    if (i < end) dest[i] = d;
  }
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

}  // namespace

extern "C" {

// Largest number of histogram bins (m, or m + 1 in the padded form) the
// kernels hold in shared memory.
int hp_max_bins() { return kSmemInts; }

// keys (n,) int32 -> pids (n,) int32 and counts (bins,) int32, which the
// caller zeroes.  padded=0: bins = m, every row hashed.  padded=1:
// bins = m + 1, rows at position >= n_valid get pid m.
int hp_hash_partition(const void* keys, void* pids, void* counts, int64_t n,
                      int64_t n_valid, int m, int padded, void* stream) {
  const int bins = padded ? m + 1 : m;
  if (n <= 0) return (int)cudaSuccess;
  if (m < 1 || bins > kSmemInts) return (int)cudaErrorInvalidValue;
  int64_t blocks = (n + kHashThreads - 1) / kHashThreads;
  const int64_t cap = (int64_t)num_sms() * 8;
  if (blocks > cap) blocks = cap;
  const size_t smem = (size_t)bins * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  if (padded) {
    hash_partition_kernel<true><<<(unsigned)blocks, kHashThreads, smem, s>>>(
        (const int32_t*)keys, (int32_t*)pids, (int32_t*)counts, n, n_valid,
        (uint32_t)m, bins);
  } else {
    hash_partition_kernel<false><<<(unsigned)blocks, kHashThreads, smem, s>>>(
        (const int32_t*)keys, (int32_t*)pids, (int32_t*)counts, n, n,
        (uint32_t)m, bins);
  }
  return (int)cudaGetLastError();
}

// pids (n,) int32 and counts (bins,) int32 -> dest (n,) int32.  scratch holds
// bins * ceil(n / tile_rows) int32; tile_rows is a multiple of 32.
int hp_scatter_perm(const void* pids, const void* counts, void* dest,
                    void* scratch, int64_t n, int bins, int tile_rows,
                    void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (bins < 1 || bins > kSmemInts || tile_rows <= 0 || tile_rows % 32)
    return (int)cudaErrorInvalidValue;
  int warps = kSmemInts / bins;
  if (warps > kMaxWarpsPerCta) warps = kMaxWarpsPerCta;
  const int64_t n_tiles = (n + tile_rows - 1) / tile_rows;
  const int64_t blocks = (n_tiles + warps - 1) / warps;
  const size_t smem = (size_t)warps * bins * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* tiles = (int32_t*)scratch;
  tile_count_kernel<<<(unsigned)blocks, warps * 32, smem, s>>>(
      (const int32_t*)pids, tiles, n, bins, n_tiles, tile_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_base_kernel<<<(unsigned)bins, kScanThreads, 0, s>>>(
      (const int32_t*)counts, tiles, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_dest_kernel<<<(unsigned)blocks, warps * 32, smem, s>>>(
      (const int32_t*)pids, tiles, (int32_t*)dest, n, bins, n_tiles,
      tile_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
