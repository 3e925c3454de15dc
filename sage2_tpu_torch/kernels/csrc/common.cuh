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

SAGE2_EXPORT const char* sage2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
