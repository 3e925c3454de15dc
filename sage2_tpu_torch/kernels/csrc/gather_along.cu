// P1: gather along one axis of an (N, W) int32 table.
//
//   axis 0: out[i, j] = tbl[idx[i, j], j]
//   axis 1: out[i, j] = tbl[i, idx[i, j]]
//
// Replaces the repo's only pl.pallas_call, scripts/probe_pallas_gather.py
// (:73; kernels gather_axis0_kernel :55 and gather_axis1_kernel :60),
// which probed how Mosaic lowers jnp.take_along_axis inside a kernel
// whose whole operands sit in VMEM. On this card there is no such
// staging to do: one thread per output element, neighbouring threads on
// neighbouring j, so the idx reads and out writes are coalesced; the
// table reads are coalesced along a row on axis 0 when idx repeats, and
// random otherwise. Indices are taken as given: the wrapper checks that
// they are in range.
//
// Bound: bytes (12 a element: the index, one table word, the output).

#include "common.cuh"

__global__ void gather_along_kernel(const int32_t* __restrict__ tbl,
                                    const int32_t* __restrict__ idx,
                                    int64_t N, int64_t W, int axis,
                                    int32_t* __restrict__ out) {
  SAGE2_GRID_STRIDE(t, N * W) {
    const int64_t i = t / W;
    const int64_t j = t - i * W;
    const int64_t g = idx[t];
    out[t] = axis == 0 ? tbl[g * W + j] : tbl[i * W + g];
  }
}

// tbl, idx, out: (N, W) int32, row-major; axis 0 or 1.
SAGE2_EXPORT int sage2_gather_along(const void* tbl, const void* idx,
                                    int64_t N, int64_t W, int axis,
                                    void* out, void* stream) {
  gather_along_kernel<<<sage2_blocks(N * W), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tbl), static_cast<const int32_t*>(idx), N,
      W, axis, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
