// Two-pass scans over tiles (K15, prune_table.cu), and the block scan that
// K12-K14 (through bucket_sort.cuh), K3 and K15 share.
//
// A tile is kScanTile consecutive items, kScanItems consecutive ones a
// thread, one block a tile. Pass 1 (each kernel's own) counts a tile's
// flagged items into one int64 a tile; sage2_scan_tiles, one block,
// turns those counts into exclusive offsets in place and writes their
// sum to a device scalar; pass 2 (each kernel's own) recounts its tile's
// flags, scans them across the block from the tile's offset and writes
// each flagged item at its slot. The flags are cheap to recompute, so
// nothing but the counts passes between the launches, and nothing waits
// on the host.

#pragma once

#include "common.cuh"

constexpr int kScanItems = 4;
constexpr int kScanTile = kThreads * kScanItems;
constexpr int kScanWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Exclusive prefix sum of v over the block's threads, in thread order;
// *total gets the block's sum. Every thread of the block calls it.
template <typename T>
__device__ T block_exclusive_scan(T v, T* total) {
  __shared__ T warp_sums[kScanWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < kScanWarps ? warp_sums[lane] : T(0);
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(kFullMask, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kScanWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const T before = warp ? warp_sums[warp - 1] : T(0);
  *total = warp_sums[kScanWarps - 1];
  __syncthreads();   // the next call may overwrite warp_sums
  return before + x - v;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// The first item of this thread in its block's tile.
__device__ __forceinline__ int64_t scan_first_item() {
  return blockIdx.x * static_cast<int64_t>(kScanTile) +
         threadIdx.x * kScanItems;
}

// One block: counts[0, n) -> their exclusive prefix sums, *total -> the
// sum. Each thread sums a contiguous run of the counts, the block scans
// the run sums, and each thread writes its run's offsets.
__global__ void __launch_bounds__(kThreads)
    scan_tiles_kernel(int64_t* __restrict__ counts, int64_t n,
                      int64_t* __restrict__ total) {
  const int64_t per = (n + kThreads - 1) / kThreads;
  const int64_t lo = min64(n, threadIdx.x * per);
  const int64_t hi = min64(n, lo + per);
  int64_t sum = 0;
  for (int64_t i = lo; i < hi; ++i) sum += counts[i];
  int64_t all;
  int64_t run = block_exclusive_scan<int64_t>(sum, &all);
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t c = counts[i];
    counts[i] = run;
    run += c;
  }
  if (threadIdx.x == 0) *total = all;
}

// counts: (n_tiles,) int64, pass 1's count of each tile, replaced by the
// tile's first slot; total: one int64, the number of flagged items.
SAGE2_EXPORT int sage2_scan_tiles(void* counts, int64_t n_tiles, void* total,
                                  void* stream) {
  scan_tiles_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(counts), n_tiles, static_cast<int64_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

static inline int scan_tiles_of(int64_t n) {
  const int64_t t = (n + kScanTile - 1) / kScanTile;
  return t < 1 ? 1 : static_cast<int>(t);
}
