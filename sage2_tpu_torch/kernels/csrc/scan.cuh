// The block scan that K3, K12-K15 (K12-K14 through bucket_sort.cuh) and
// K20's request dedup share: a scan over the threads of one block, in
// thread order, under an associative and commutative operator.

#pragma once

#include "common.cuh"

constexpr int kScanWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

struct ScanSum {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

struct ScanMax {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a < b ? b : a;
  }
};

// The exclusive scan of v over the block's threads under op (identity
// its neutral value): op over the threads before this one; *total gets
// op over the whole block. Every thread of the block calls it.
template <typename T, typename Op>
__device__ T block_exclusive_scan(T v, T identity, Op op, T* total) {
  __shared__ T warp_sums[kScanWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x = op(x, y);
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < kScanWarps ? warp_sums[lane] : identity;
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(kFullMask, s, d);
      if (lane >= d) s = op(s, y);
    }
    if (lane < kScanWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const T before = warp ? warp_sums[warp - 1] : identity;
  T in_warp = __shfl_up_sync(kFullMask, x, 1);
  if (lane == 0) in_warp = identity;
  *total = warp_sums[kScanWarps - 1];
  __syncthreads();   // the next call may overwrite warp_sums
  return op(before, in_warp);
}

// The exclusive prefix sum of v over the block's threads; *total gets the
// block's sum.
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* total) {
  return block_exclusive_scan<T>(v, T(0), ScanSum(), total);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
