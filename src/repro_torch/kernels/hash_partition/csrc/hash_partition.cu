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
// reads 4 bytes of key per valid row and writes 4 bytes of pid per row; the
// scatter must read 4 bytes of pid and write 4 bytes of dest per row.
//
// Hash: a grid-stride loop, one row per thread per step; each CTA keeps a
// shared-memory histogram and flushes it with one atomicAdd per bin.  Integer
// atomics commute, so the counts are bit-exact whatever the order.  n_valid
// is a plain argument: there is no trace to reuse, unlike the Pallas
// kernel's scalar prefetch.  Padding rows (position >= n_valid) cost only
// their pid write: their keys are not loaded, and their bin is counted once,
// by arithmetic, instead of one atomic per row.
//
// Scatter.  The Pallas kernel walks its grid in order ("arbitrary") and
// carries running per-partition offsets from step to step.  CTAs on a GPU
// run concurrently in no order, so the carry has to cross CTAs.
//
//  * The first design (three passes, kept below as the route above
//    kSinglePassMaxBins bins) counts per (bin, 2048-row warp tile) into a
//    matrix, scans each bin's row of it with one CTA per bin, and re-reads
//    the pids to rank them.  Measured at 2^26 rows and 33 bins
//    (scripts/scatter_compare.py): 0.71 ms, of which the count pass 0.33 ms,
//    the scan 0.03 ms and the rank pass 0.32 ms.  Its two tile passes are
//    held back by __match_any_sync, whose cost grows with the distinct pids
//    in a 32-row step (all rows in one bin: 0.11 and 0.19 ms), not by their
//    bytes.
//  * The single pass (bins <= kSinglePassMaxBins) reads every pid once and
//    writes every dest once.  One CTA of 512 threads takes a tile of 16,384
//    rows.  The tile's index comes from an atomic counter, not blockIdx, so
//    every tile a CTA looks back at belongs to a CTA already running: the
//    look-back cannot deadlock.
//      1. The tile's 64 KB of pids are staged into shared memory with 16-B
//         cp.async (8 per thread), all in flight at once.
//      2. Each warp counts its 1024 consecutive rows into its own per-bin
//         counters (shared-memory atomics); one thread per bin scans them in
//         warp order into the warps' bases inside the tile and the tile's
//         histogram.  The histogram is published at once, before the
//         ranking, so that later tiles wait the less for it: its row of an
//         (n_tiles, bins) int32 array, then, after a barrier, the tile's
//         flag, which thread 0 writes with st.release.gpu (the barrier
//         orders every thread's counts before the release).  Tile 0 seeds
//         every bin's chain: it publishes inclusive counts, the exclusive
//         scan of `counts` (computed here, in the kernel) plus its
//         histogram, so no other tile reads `counts`.
//      3. Each warp ranks its rows in input order, 32 a step, from counters
//         that start at its bases.  The peers of a row (equal pids in its
//         step) come from one __ballot_sync per key bit, a constant cost,
//         where __match_any_sync's grows with the distinct pids.  The
//         group's leader reads the warp's counter and hands it round with a
//         shuffle; the row's place among the tile's rows of its pid is that
//         plus __popc(peers & lanemask_lt), packed beside the pid into the
//         row's slot.
//      4. Decoupled look-back: the CTA reads the flags of 512 predecessors a
//         round, one a thread, with ld.acquire.gpu, nearest first, until an
//         inclusive tile with every nearer one published (it spins while
//         one is not).  The prefix is that tile's inclusive counts plus the
//         nearer tiles' aggregates, which lie contiguous in memory: every
//         thread sums a strided share (ld.relaxed.gpu, L2 and never a stale
//         L1 line) into shared memory.  The CTA then publishes its inclusive
//         counts and flips its flag.  Counts reach 2^31 - 1 rows, so they
//         sit in their own int32 arrays and the flag is a separate word;
//         release and acquire pair them.
//      5. dest = the tile's prefix for the pid (bin base included) + the
//         row's place in the tile, written 32 consecutive rows a warp step.
//    Traffic: pids once, dest once, plus 8 B a (tile, bin) of counts and 4 B
//    a tile of flags (the flags zeroed on the stream before the launch),
//    read back by the look-back mostly from L2: 1.1 MB at 2^26 rows and 33
//    bins, 0.2% of the floor.
//    What bounds it in practice is not the bytes: a CTA holds its tile in
//    shared memory (70 KB at 33 bins, three CTAs an SM) from its load until
//    its dest is written, so rows in flight are capped, and the time is
//    about rows x a tile's lifetime / the rows the card's shared memory
//    holds.  At 2^26 rows and 33 bins (scripts/scatter_variants.py) a
//    tile lives ~26 us: load ~5.4, histogram and publication ~7.6, ranking
//    ~7.3, look-back ~3.6, dest ~2.5; the look-back costs ~5% (0.327 ms
//    against 0.312 ms with none).  Why one flag a tile, read by the whole
//    CTA: one 64-bit flag-and-count word a (tile, bin), walked back one
//    word at a time by one thread a bin, lets each walk run as far back as
//    tiles are in flight (0.59 ms at 33 bins, 0.96 ms at 257 bins with
//    4096-row tiles, scripts/scatter_compare.py).  Why the histogram is
//    published before the ranking: published after it, every look-back
//    waits for its slower predecessors' ranking.
//  * Bin threshold kSinglePassMaxBins = 512: the warp counters take 16 x
//    bins x 4 B of shared memory beside the 64 KB tile (two CTAs an SM at
//    512), and the look-back sums a tile's aggregates over bins columns.
//    Above 512 bins the three-pass kernels remain the route; both routes are
//    checked on the card.
//
// Stability (equal pids keep input order) follows from tiles in order,
// warps in order inside a tile, steps in order inside a warp and lanes in
// order inside a step; the bit-identical guarantee rests on it.  Pids
// outside [0, bins) are never counted and never move a real row; their own
// dest is written as 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
// Shared-memory budget a CTA uses without opting in to more than 48 KB.
constexpr int kSmemInts = 12288;
constexpr int kHashThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kMaxWarpsPerCta = 8;

// single-pass scatter: one CTA of kTileThreads threads a tile of kTileRows
// rows; each warp ranks kWarpRows consecutive rows, 32 a step
constexpr int kTileThreads = 512;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileRows = 16384;
constexpr int kWarpRows = kTileRows / kTileWarps;
constexpr int kWarpSteps = kWarpRows / 32;
constexpr int kSinglePassMaxBins = 512;
// warp steps whose peer masks are held in registers at once
constexpr int kRankChunk = 8;
// a ranked row's slot packs (place in the tile << kKeyBits) | key
constexpr int kKeyBits = 10;
constexpr int kKeyMask = (1 << kKeyBits) - 1;
static_assert(kSinglePassMaxBins < (1 << kKeyBits), "key bits");
static_assert(kTileRows <= (1 << (31 - kKeyBits)), "place bits");
static_assert(kWarpSteps % kRankChunk == 0, "rank chunks");
// aggregate counts a thread loads at once when it sums the nearer tiles
constexpr int kSumBatch = 4;
// a tile's flag: 0 until published, then the kind of its per-bin counts
constexpr uint32_t kFlagAggregate = 1;
constexpr uint32_t kFlagInclusive = 2;
// the tile counter sits at the head of the scratch, the flags after it
constexpr int64_t kCounterBytes = 256;
// three-pass scatter: rows one warp owns in the tile passes
constexpr int kThreePassTileRows = 2048;

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

// -- single-pass scatter ------------------------------------------------------

// 16 B global -> shared, bypassing L1
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// a count another CTA published: read from L2, never from a stale L1 line
__device__ __forceinline__ int load_relaxed(const int32_t* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The lanes whose key equals this lane's, one ballot per key bit
// (key < 2^kBits): a constant cost, where __match_any_sync's grows with
// the number of distinct keys in the step.
template <int kBits>
__device__ __forceinline__ unsigned match_key(int key) {
  unsigned peers = kFullMask;
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    const bool bit = (key >> b) & 1;
    const unsigned vote = __ballot_sync(kFullMask, bit);
    peers &= bit ? vote : ~vote;
  }
  return peers;
}

// Publish a tile's per-bin aggregate s_agg: its row of agg, then, after a
// barrier, its flag, which thread 0 writes with st.release.gpu (the barrier
// orders every thread's counts before the release).  Tile 0 publishes
// inclusive counts instead, seeded with the exclusive scan of `counts`
// (computed here, in the kernel), which it leaves in s_excl: no other tile
// reads `counts`.  flags (zeroed at launch), agg and incl: (n_tiles,),
// (n_tiles, bins) and (n_tiles, bins).
__device__ void publish_aggregate(int64_t tile, int bins,
                                  const int32_t* __restrict__ counts,
                                  uint32_t* __restrict__ flags,
                                  int32_t* __restrict__ agg,
                                  int32_t* __restrict__ incl,
                                  const int* s_agg, int* s_excl, int* s_warp) {
  if (tile == 0) {
    int carry = 0;
    for (int b0 = 0; b0 < bins; b0 += kTileThreads) {
      const int b = b0 + threadIdx.x;
      int total;
      const int ex = block_exclusive_scan(b < bins ? counts[b] : 0, s_warp,
                                          &total);
      if (b < bins) {
        s_excl[b] = carry + ex;
        incl[b] = carry + ex + s_agg[b];
      }
      carry += total;
    }
  } else {
    for (int b = threadIdx.x; b < bins; b += kTileThreads)
      agg[tile * bins + b] = s_agg[b];
  }
  __syncthreads();
  if (threadIdx.x == 0)
    store_release(&flags[tile], tile == 0 ? kFlagInclusive : kFlagAggregate);
}

// Decoupled look-back of a tile past 0: its exclusive prefix per bin, bin
// bases included, into s_excl; then publish its inclusive counts.  The CTA
// reads the flags of kTileThreads predecessors a round, one a thread, with
// ld.acquire.gpu, nearest first, until an inclusive one with every nearer
// one published (it spins while one is not).  The prefix is that tile's
// inclusive counts plus the nearer tiles' aggregates (as many as arrived
// during a look-back), which lie contiguous after its row: every thread
// sums a strided share (ld.relaxed.gpu: L2, never a stale L1 line) into
// shared memory.
__device__ void look_back(int64_t tile, int bins,
                          uint32_t* __restrict__ flags,
                          const int32_t* __restrict__ agg,
                          int32_t* __restrict__ incl, const int* s_agg,
                          int* s_excl, unsigned (&s_masks)[2][kTileWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t near = tile - 1;
  int64_t stop = -1;
  while (stop < 0) {
    const int64_t j = near - threadIdx.x;
    // past tile 0 reads as inclusive: tile 0 itself always comes first
    const uint32_t f = j >= 0 ? load_acquire(flags + j) : kFlagInclusive;
    const unsigned inclusive = __ballot_sync(kFullMask, f == kFlagInclusive);
    const unsigned unpublished = __ballot_sync(kFullMask, f == 0);
    if (lane == 0) {
      s_masks[0][warp] = inclusive;
      s_masks[1][warp] = unpublished;
    }
    __syncthreads();
    int first = -1;
    bool wait = false;
    for (int w = 0; w < kTileWarps && first < 0 && !wait; ++w) {
      const unsigned inc = s_masks[0][w];
      const int f1 = inc ? __ffs(inc) - 1 : 32;
      const unsigned upto = f1 < 31 ? (2u << f1) - 1u : kFullMask;
      if (s_masks[1][w] & upto) wait = true;
      else if (inc) first = w * 32 + f1;
    }
    __syncthreads();                            // masks are rewritten
    if (!wait) {
      if (first >= 0) stop = near - first;
      else near -= kTileThreads;
    }
  }
  for (int b = threadIdx.x; b < bins; b += kTileThreads)
    s_excl[b] = load_relaxed(incl + stop * bins + b);
  __syncthreads();
  const int32_t* nearer = agg + (stop + 1) * bins;
  const int pairs = (int)(tile - 1 - stop) * bins;
  for (int p0 = threadIdx.x; p0 < pairs; p0 += kSumBatch * kTileThreads) {
    int v[kSumBatch];                           // loads in flight together
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u) {
      const int p = p0 + u * kTileThreads;
      v[u] = p < pairs ? load_relaxed(nearer + p) : 0;
    }
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u) {
      const int p = p0 + u * kTileThreads;
      if (p < pairs) atomicAdd(&s_excl[p % bins], v[u]);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += kTileThreads)
    incl[tile * bins + b] = s_excl[b] + s_agg[b];
  __syncthreads();
  if (threadIdx.x == 0) store_release(&flags[tile], kFlagInclusive);
}

// bins <= kSinglePassMaxBins < 2^kBits.
template <int kBits>
__global__ void __launch_bounds__(kTileThreads, 3)
scatter_single_pass_kernel(const int32_t* __restrict__ pids,
                           const int32_t* __restrict__ counts,
                           int32_t* __restrict__ dest,
                           unsigned int* __restrict__ tile_counter,
                           uint32_t* __restrict__ flags,
                           int32_t* __restrict__ agg,
                           int32_t* __restrict__ incl, int64_t n, int bins) {
  extern __shared__ __align__(16) int s_scatter[];
  int* s_rows = s_scatter;                      // kTileRows
  int* s_cnt = s_rows + kTileRows;              // kTileWarps x bins
  int* s_agg = s_cnt + kTileWarps * bins;       // bins
  int* s_excl = s_agg + bins;                   // bins
  __shared__ int s_tile;
  __shared__ int s_warp[32];
  __shared__ unsigned s_masks[2][kTileWarps];

  if (threadIdx.x == 0) s_tile = (int)atomicAdd(tile_counter, 1u);
  for (int i = threadIdx.x; i < kTileWarps * bins; i += kTileThreads)
    s_cnt[i] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t start = tile * kTileRows;
  const int rows = (int)min((int64_t)kTileRows, n - start);

  // 1. stage the tile's pids; rows past n read as a sentinel
  if (rows == kTileRows &&
      (reinterpret_cast<uintptr_t>(pids) & 15) == 0) {
    for (int c = threadIdx.x; c < kTileRows / 4; c += kTileThreads)
      cp_async_16(s_rows + 4 * c, pids + start + 4 * c);
    cp_async_wait_all();
  } else {
    for (int i = threadIdx.x; i < kTileRows; i += kTileThreads)
      s_rows[i] = i < rows ? pids[start + i] : -1;
  }
  __syncthreads();

  // 2. each warp's histogram of its rows; one thread per bin turns the
  // warps' counts into their bases inside the tile (in warp order) and the
  // tile's aggregate, published before the ranking, so that the tiles after
  // it wait the less for it in their look-back
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* cnt = s_cnt + warp * bins;
  int* wrow = s_rows + warp * kWarpRows;
  for (int r = lane; r < kWarpRows; r += 32) {
    const int pid = wrow[r];
    if ((unsigned)pid < (unsigned)bins) atomicAdd(&cnt[pid], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += kTileThreads) {
    int run = 0;
    for (int w = 0; w < kTileWarps; ++w) {
      const int c = s_cnt[w * bins + b];
      s_cnt[w * bins + b] = run;
      run += c;
    }
    s_agg[b] = run;
  }
  __syncthreads();
  publish_aggregate(tile, bins, counts, flags, agg, incl, s_agg, s_excl,
                    s_warp);

  // 3. stable rank inside the tile, in input order: each warp ranks its
  // rows 32 a step from counters that start at its bases.  A row's key is
  // its pid, or `bins` for a pid outside [0, bins); its slot then holds
  // (place among the tile's rows of its bin << kKeyBits) | key.
  const unsigned lanemask_lt = (1u << lane) - 1u;
  for (int s0 = 0; s0 < kWarpSteps; s0 += kRankChunk) {
    // the chunk's peer masks first (independent), then the counter chain
    int keys[kRankChunk];
    unsigned peers[kRankChunk];
#pragma unroll
    for (int s = 0; s < kRankChunk; ++s) {
      const int pid = wrow[(s0 + s) * 32 + lane];
      keys[s] = (unsigned)pid < (unsigned)bins ? pid : bins;
      peers[s] = match_key<kBits>(keys[s]);
    }
#pragma unroll
    for (int s = 0; s < kRankChunk; ++s) {
      const int key = keys[s];
      const int leader = __ffs(peers[s]) - 1;
      const bool lead = lane == leader && key < bins;
      const int seen = __shfl_sync(kFullMask, lead ? cnt[key] : 0, leader);
      if (lead) cnt[key] = seen + __popc(peers[s]);
      wrow[(s0 + s) * 32 + lane] =
          ((seen + __popc(peers[s] & lanemask_lt)) << kKeyBits) | key;
      __syncwarp();
    }
  }

  // 4. the tile's prefix per bin, bin bases included (tile 0 has it from
  // its publication)
  if (tile != 0) look_back(tile, bins, flags, agg, incl, s_agg, s_excl,
                           s_masks);

  // 5. dest, 32 consecutive rows a warp step
  int32_t* wd = dest + start + warp * kWarpRows;
  const int wrows = rows - warp * kWarpRows;
#pragma unroll
  for (int s = 0; s < kWarpSteps; ++s) {
    const int r = s * 32 + lane;
    const int packed = wrow[r];
    const int key = packed & kKeyMask;
    if (r < wrows) wd[r] = key < bins ? s_excl[key] + (packed >> kKeyBits) : 0;
  }
}

// -- three-pass scatter (bins > kSinglePassMaxBins) ---------------------------

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

// The SM count of the device current at the first launch, kept for every
// later launch on any device: right where every card is the same part (the
// H100s of one host), which is the only kind of mesh the port places on.
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

bool single_pass(int bins) { return bins <= kSinglePassMaxBins; }

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Scratch of the single pass, in bytes: the tile counter and a flag a tile
// (the part zeroed on the stream), then each tile's per-bin aggregate and
// inclusive count, written before the flag that publishes them.
struct SinglePassScratch {
  int64_t flags, zeroed, agg, incl, bytes;
  SinglePassScratch(int64_t n, int bins) {
    const int64_t n_tiles = ceil_div(n, kTileRows);
    flags = kCounterBytes;
    zeroed = flags + n_tiles * (int64_t)sizeof(uint32_t);
    agg = ceil_div(zeroed, 256) * 256;
    incl = agg + n_tiles * bins * (int64_t)sizeof(int32_t);
    bytes = incl + n_tiles * bins * (int64_t)sizeof(int32_t);
  }
};

using SinglePassKernel = void (*)(const int32_t*, const int32_t*, int32_t*,
                                  unsigned int*, uint32_t*, int32_t*,
                                  int32_t*, int64_t, int);

// the kernel whose key bits hold 0..bins (bins marks a pid out of range)
SinglePassKernel single_pass_kernel(int bins) {
  switch (32 - __builtin_clz((unsigned)bins)) {
    case 1: return scatter_single_pass_kernel<1>;
    case 2: return scatter_single_pass_kernel<2>;
    case 3: return scatter_single_pass_kernel<3>;
    case 4: return scatter_single_pass_kernel<4>;
    case 5: return scatter_single_pass_kernel<5>;
    case 6: return scatter_single_pass_kernel<6>;
    case 7: return scatter_single_pass_kernel<7>;
    case 8: return scatter_single_pass_kernel<8>;
    case 9: return scatter_single_pass_kernel<9>;
    default: return scatter_single_pass_kernel<kKeyBits>;
  }
}

int launch_single_pass(const int32_t* pids, const int32_t* counts,
                       int32_t* dest, void* scratch, int64_t n, int bins,
                       cudaStream_t s) {
  const SinglePassScratch layout(n, bins);
  cudaError_t err = cudaMemsetAsync(scratch, 0, layout.zeroed, s);
  if (err != cudaSuccess) return (int)err;
  const SinglePassKernel kernel = single_pass_kernel(bins);
  const size_t smem =
      (size_t)(kTileRows + kTileWarps * bins + 2 * bins) * sizeof(int);
  err = cudaFuncSetAttribute((const void*)kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  char* base = (char*)scratch;
  kernel<<<(unsigned)ceil_div(n, kTileRows), kTileThreads, smem, s>>>(
      pids, counts, dest, (unsigned int*)base,
      (uint32_t*)(base + layout.flags), (int32_t*)(base + layout.agg),
      (int32_t*)(base + layout.incl), n, bins);
  return (int)cudaGetLastError();
}

int launch_three_pass(const int32_t* pids, const int32_t* counts,
                      int32_t* dest, void* scratch, int64_t n, int bins,
                      cudaStream_t s) {
  int warps = kSmemInts / bins;
  if (warps > kMaxWarpsPerCta) warps = kMaxWarpsPerCta;
  const int64_t n_tiles = ceil_div(n, kThreePassTileRows);
  const int64_t blocks = ceil_div(n_tiles, warps);
  const size_t smem = (size_t)warps * bins * sizeof(int);
  int32_t* tiles = (int32_t*)scratch;
  tile_count_kernel<<<(unsigned)blocks, warps * 32, smem, s>>>(
      pids, tiles, n, bins, n_tiles, kThreePassTileRows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_base_kernel<<<(unsigned)bins, kScanThreads, 0, s>>>(counts, tiles,
                                                           n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_dest_kernel<<<(unsigned)blocks, warps * 32, smem, s>>>(
      pids, tiles, dest, n, bins, n_tiles, kThreePassTileRows);
  return (int)cudaGetLastError();
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

// Bytes of scratch hp_scatter_perm needs for n rows and `bins` bins.
int64_t hp_scatter_scratch_bytes(int64_t n, int bins) {
  if (n <= 0 || bins < 1) return 0;
  if (single_pass(bins)) return SinglePassScratch(n, bins).bytes;
  return ceil_div(n, kThreePassTileRows) * bins * (int64_t)sizeof(int32_t);
}

// pids (n,) int32 and counts (bins,) int32 -> dest (n,) int32.  scratch
// holds hp_scatter_scratch_bytes(n, bins) bytes, 16-B aligned; the single
// pass zeroes what it uses on the stream before its launch.
int hp_scatter_perm(const void* pids, const void* counts, void* dest,
                    void* scratch, int64_t n, int bins, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (bins < 1 || bins > kSmemInts) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (single_pass(bins))
    return launch_single_pass((const int32_t*)pids, (const int32_t*)counts,
                              (int32_t*)dest, scratch, n, bins, s);
  return launch_three_pass((const int32_t*)pids, (const int32_t*)counts,
                           (int32_t*)dest, scratch, n, bins, s);
}

}  // extern "C"
