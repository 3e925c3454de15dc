// P1: gather along one axis of an (N, W) int32 table.
//
//   axis 0: out[i, j] = tbl[idx[i, j], j]
//   axis 1: out[i, j] = tbl[i, idx[i, j]]
//
// Replaces the repo's only pl.pallas_call, scripts/probe_pallas_gather.py
// (:73; kernels gather_axis0_kernel :55 and gather_axis1_kernel :60),
// which probed how Mosaic lowers jnp.take_along_axis inside a kernel
// whose whole operands sit in VMEM.
//
// Bound: bytes, 12 an element (the index, one table word, the output).
// What stands between a gather and that bound on this card:
//   - a check of the index range before the launch is one more pass over
//     the index and a host round trip with the card idle. Here the kernel
//     tests every index it reads against the extent of its axis, writes 0
//     for one outside, and each block that saw one sets a 4-byte flag once
//     (__syncthreads_or, one atomicOr); the wrapper reads the flag after
//     the launch and raises.
//   - axis 1 reads each row at random, W times. A block stages its row
//     (several rows while W is small, 2,048 elements a tile) in shared
//     memory with 16-byte loads, then gathers from there; the index comes
//     in and the output goes out as int4 where index and output are
//     16-byte aligned alike, with scalar heads and tails. A row wider than
//     48 K elements (192 KB) gathers straight from global memory (the
//     same kernel's other branch).
//   - axis 0 gathers one random row's word an element: a 32-byte sector
//     for 4 useful bytes, from L2 while the table fits it and from device
//     memory beyond. A warp takes 4 x 32 columns of two rows (int4 index
//     loads and output stores where W % 4 == 0 and both are aligned),
//     so a thread has 8 independent table loads in flight, through the
//     read-only path; the row and column come from one division a warp
//     task, none an element.
//
// Registers (nvcc -Xptxas -v, sm_90a): gather_rows_kernel 28 (staged) and
// 40 (direct), gather_cols_kernel 40; no spills.

#include "common.cuh"

constexpr int kTileElems = 2048;        // elements a block stages (axis 1)
constexpr int64_t kMaxStaged = 49152;   // the widest row staged: 192 KB
constexpr int kSegment = 128;           // columns a warp task (axis 0)

__device__ __forceinline__ int32_t ld_stream(const int32_t* p) {
  return __ldcs(p);
}

// Axis 1: tiles of R whole rows, [a, b) of the flat arrays.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const int32_t* __restrict__ tbl,
                       const int32_t* __restrict__ idx, int64_t N, int64_t W,
                       int64_t R, bool vec, int32_t* __restrict__ out,
                       int* __restrict__ flag) {
  extern __shared__ int4 smem4[];
  int32_t* s = reinterpret_cast<int32_t*>(smem4);
  const int64_t tiles = (N + R - 1) / R;
  bool bad = false;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t a = tile * R * W;
    const int64_t n = (tile * R + R <= N ? R : N - tile * R) * W;
    // table element a + l sits at s[m + l]: a 16-byte aligned global
    // address lands on a 16-byte aligned shared one
    int m = 0;
    if (kStaged) {
      m = static_cast<int>((reinterpret_cast<uintptr_t>(tbl + a) >> 2) & 3);
      const int64_t head = min(n, static_cast<int64_t>((4 - m) & 3));
      const int64_t nv = (n - head) >> 2;
      for (int64_t l = threadIdx.x; l < head; l += blockDim.x)
        s[m + l] = ld_stream(tbl + a + l);
      const int4* src = reinterpret_cast<const int4*>(tbl + a + head);
      int4* dst = reinterpret_cast<int4*>(s + m + head);
      for (int64_t v = threadIdx.x; v < nv; v += blockDim.x)
        dst[v] = __ldcs(src + v);
      for (int64_t l = head + 4 * nv + threadIdx.x; l < n; l += blockDim.x)
        s[m + l] = ld_stream(tbl + a + l);
      __syncthreads();
    }
    auto pick = [&](int64_t l, int32_t v) -> int32_t {
      const bool ok = v >= 0 && v < W;
      bad |= !ok;
      if (!ok) return 0;
      const int64_t row = R == 1 ? 0 : static_cast<int32_t>(l) /
                                            static_cast<int32_t>(W);
      return kStaged ? s[m + row * W + v] : __ldg(tbl + a + row * W + v);
    };
    // scalar head up to the first 16-byte aligned index, int4 middle,
    // scalar tail (all scalar where index and output align differently)
    const int mi =
        static_cast<int>((reinterpret_cast<uintptr_t>(idx + a) >> 2) & 3);
    const int64_t head = vec ? min(n, static_cast<int64_t>((4 - mi) & 3)) : n;
    const int64_t nv = (n - head) >> 2;
    for (int64_t l = threadIdx.x; l < head; l += blockDim.x)
      __stcs(out + a + l, pick(l, ld_stream(idx + a + l)));
    const int4* iv = reinterpret_cast<const int4*>(idx + a + head);
    int4* ov = reinterpret_cast<int4*>(out + a + head);
    for (int64_t v = threadIdx.x; v < nv; v += blockDim.x) {
      const int4 x = __ldcs(iv + v);
      const int64_t l = head + 4 * v;
      __stcs(ov + v, make_int4(pick(l, x.x), pick(l + 1, x.y),
                               pick(l + 2, x.z), pick(l + 3, x.w)));
    }
    for (int64_t l = head + 4 * nv + threadIdx.x; l < n; l += blockDim.x)
      __stcs(out + a + l, pick(l, ld_stream(idx + a + l)));
    if (kStaged) __syncthreads();     // the next tile reuses s
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

// Axis 0: a warp task is kSegment columns of one row; a warp takes two
// tasks at a time, a lane 4 columns of each.
__global__ void __launch_bounds__(kThreads)
    gather_cols_kernel(const int32_t* __restrict__ tbl,
                       const int32_t* __restrict__ idx, int64_t N, int64_t W,
                       int64_t segs, bool vec, int32_t* __restrict__ out,
                       int* __restrict__ flag) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t tasks = N * segs;
  bool bad = false;
  for (int64_t t0 = 2 * warp; t0 < tasks; t0 += 2 * warps) {
    int64_t e[2], col[2];
    int cnt[2];
    int32_t v[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int64_t t = t0 + u;
      cnt[u] = 0;
      e[u] = col[u] = 0;
      if (t < tasks) {
        const int64_t row = t / segs;
        col[u] = (t - row * segs) * kSegment + 4 * lane;
        e[u] = row * W + col[u];
        cnt[u] = static_cast<int>(min(int64_t{4}, max(int64_t{0},
                                                      W - col[u])));
      }
      if (vec && cnt[u] == 4) {
        const int4 x = __ldcs(reinterpret_cast<const int4*>(idx + e[u]));
        v[u][0] = x.x, v[u][1] = x.y, v[u][2] = x.z, v[u][3] = x.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[u][k] = k < cnt[u] ? ld_stream(idx + e[u] + k) : 0;
      }
    }
    int32_t r[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool ok = v[u][k] >= 0 && v[u][k] < N;
        bad |= k < cnt[u] && !ok;
        r[u][k] = k < cnt[u] && ok
                      ? __ldg(tbl + v[u][k] * W + col[u] + k)
                      : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (vec && cnt[u] == 4) {
        __stcs(reinterpret_cast<int4*>(out + e[u]),
               make_int4(r[u][0], r[u][1], r[u][2], r[u][3]));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < cnt[u]) __stcs(out + e[u] + k, r[u][k]);
      }
    }
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

// tbl, idx, out: (N, W) int32, row-major; axis 0 or 1; flag: one int32,
// zero before the launch, nonzero after it when an index was out of range.
SAGE2_EXPORT int sage2_gather_along(const void* tbl, const void* idx,
                                    int64_t N, int64_t W, int axis, void* out,
                                    void* flag, void* stream) {
  const auto* t = static_cast<const int32_t*>(tbl);
  const auto* x = static_cast<const int32_t*>(idx);
  auto* o = static_cast<int32_t*>(out);
  auto* f = static_cast<int*>(flag);
  const auto st = static_cast<cudaStream_t>(stream);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(idx);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if (axis == 0) {
    const int64_t segs = (W + kSegment - 1) / kSegment;
    const bool vec = W % 4 == 0 && xa % 16 == 0 && oa % 16 == 0;
    const int64_t pairs = (N * segs + 1) / 2;     // a warp each
    gather_cols_kernel<<<sage2_blocks(pairs * 32), kThreads, 0, st>>>(
        t, x, N, W, segs, vec, o, f);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = (xa - oa) % 16 == 0;
  if (W > kMaxStaged) {
    gather_rows_kernel<false><<<sage2_blocks(N * kThreads), kThreads, 0, st>>>(
        t, x, N, W, 1, vec, o, f);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t R = W >= kTileElems ? 1 : kTileElems / W;
  const int64_t tiles = (N + R - 1) / R;
  const size_t smem = (R * W + 4) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        gather_rows_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  gather_rows_kernel<true><<<sage2_blocks(tiles * kThreads), kThreads, smem,
                             st>>>(t, x, N, W, R, vec, o, f);
  return static_cast<int>(cudaGetLastError());
}
