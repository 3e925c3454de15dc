// Shared by the port's CUDA kernels: launch geometry and the plain C ABI.
//
// Every launcher is `extern "C"`, takes raw device pointers, sizes and a
// cudaStream_t passed as void*, launches on that stream without
// synchronising, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define SAGE2_EXPORT extern "C" __attribute__((visibility("default")))

constexpr int kThreads = 256;

// Grid-stride kernels: enough blocks to cover n, capped so the grid
// stays well inside the card's limits for any n.
static inline int sage2_blocks(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b > (int64_t{1} << 20)) b = int64_t{1} << 20;
  return b < 1 ? 1 : static_cast<int>(b);
}

#define SAGE2_GRID_STRIDE(i, n)                                          \
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +      \
                   threadIdx.x;                                          \
       i < (n); i += static_cast<int64_t>(gridDim.x) * blockDim.x)

// The 16 bases [q, q + 16) of a read from its unshifted packed words
// (W int64 words holding uint32, 16 bases a word, first base in the top
// bits), zero past the last word: the seed word of the streamed join.
__device__ __forceinline__ uint32_t word_at(const int64_t* __restrict__ row,
                                            int W, int q) {
  const int w = q >> 4, r = q & 15;
  const uint32_t cur = w < W ? static_cast<uint32_t>(row[w]) : 0u;
  if (r == 0) return cur;
  const uint32_t nxt = w + 1 < W ? static_cast<uint32_t>(row[w + 1]) : 0u;
  return (cur << (2 * r)) | (nxt >> (32 - 2 * r));
}

SAGE2_EXPORT const char* sage2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
