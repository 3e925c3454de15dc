// K6: the prep half of the device transitive reduction: per-vertex run
// bounds of the two edge orders, and each edge's expansion count.
//
// Replaces sage2_tpu/graph/reduce.py _reduce_prep (:133, jitted; the same
// arithmetic as lines 66-91 of the in-core transitive_reduction, and as
// _reduce_prep_host :162). There the (src, sl) adjacency order came from a
// two-key sort, the run starts from lexicographic binary searches over
// (hi, lo) uint32 pairs and maxsl from a segment_max. Here the wrapper's
// caller sorts the composite int64 keys src << 32 | sl stably (one
// torch.sort), and two launches search them:
//
//   vertex pass  one thread per vertex v in [0, V]:
//                  start[v]  = lower bound of (v, 0) in the adjacency keys
//                              (also defined for a vertex without edges),
//                  maxsl[v]  = sl of the last key of v's run, or -1,
//                  startd[v] = lower bound of v in the (src, dst)-sorted
//                              src array (the membership probe's run
//                              table; v = V gives the end of the last run);
//   edge pass    one thread per edge e of the (src, dst) order: with
//                sl = len(src) - ovl[e] and bound = maxsl[src] - sl, the
//                number of dst's out-edges with sl <= bound,
//                  counts[e] = upper bound of (dst, bound) - start[dst],
//                or 0 for padding rows and negative bounds. len(v) is the
//                scalar read length, or lens[v] for ragged reads (the
//                reference's (V,) read_len, :139-143); the caller's keys
//                carry the same sl.
//
// Bound: operations, a few binary searches of log2(E) dependent loads per
// vertex and per edge; the bytes are the keys and edge arrays read once.

#include "common.cuh"

constexpr int32_t kI32Max = 0x7fffffff;

// binary search of a sorted a[0, n): the first index with a[i] >= key
// (lower bound), or with a[i] > key when `upper` (upper bound)
template <typename T>
__device__ __forceinline__ int64_t bound_of(const T* __restrict__ a,
                                            int64_t n, T key, bool upper) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < key || (upper && a[mid] == key)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void reduce_vertex_kernel(const int64_t* __restrict__ keys,
                                     const int32_t* __restrict__ src,
                                     int64_t E, int64_t V,
                                     int32_t* __restrict__ start,
                                     int32_t* __restrict__ maxsl,
                                     int32_t* __restrict__ startd) {
  SAGE2_GRID_STRIDE(v, V + 1) {
    startd[v] = static_cast<int32_t>(
        bound_of<int32_t>(src, E, static_cast<int32_t>(v), false));
    if (v == V) continue;
    const int64_t s = bound_of<int64_t>(keys, E, v << 32, false);
    const int64_t e = bound_of<int64_t>(keys, E, (v + 1) << 32, false);
    start[v] = static_cast<int32_t>(s);
    maxsl[v] = e > s ? static_cast<int32_t>(keys[e - 1] & 0xffffffff) : -1;
  }
}

__global__ void reduce_edge_kernel(const int64_t* __restrict__ keys,
                                   const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ dst,
                                   const int32_t* __restrict__ ovl,
                                   int64_t E, int read_len,
                                   const int32_t* __restrict__ lens,
                                   const int32_t* __restrict__ start,
                                   const int32_t* __restrict__ maxsl,
                                   int32_t* __restrict__ counts) {
  SAGE2_GRID_STRIDE(e, E) {
    const int32_t v = src[e];
    int32_t n = 0;
    if (v != kI32Max) {
      const int len_v = lens == nullptr ? read_len : lens[v];
      const int64_t bound =
          static_cast<int64_t>(maxsl[v]) - (len_v - ovl[e]);
      if (bound >= 0) {
        const int64_t w = dst[e];
        const int64_t upto = bound_of<int64_t>(keys, E, (w << 32) | bound,
                                               true);
        n = static_cast<int32_t>(upto - start[w]);
      }
    }
    counts[e] = n;
  }
}

// keys: (E,) sorted int64 src << 32 | sl; src, dst, ovl: (E,) int32 in
// (src, dst) order, padding src == INT32_MAX at the tail; start, maxsl:
// (V,) int32; startd: (V + 1,) int32; counts: (E,) int32; lens: (V,)
// int32 per-vertex read lengths, or NULL (every read is read_len long).
SAGE2_EXPORT int sage2_reduce_vertices(const void* keys, const void* src,
                                       int64_t E, int64_t V, void* start,
                                       void* maxsl, void* startd,
                                       void* stream) {
  reduce_vertex_kernel<<<sage2_blocks(V + 1), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int32_t*>(src), E,
      V, static_cast<int32_t*>(start), static_cast<int32_t*>(maxsl),
      static_cast<int32_t*>(startd));
  return static_cast<int>(cudaGetLastError());
}

SAGE2_EXPORT int sage2_reduce_edges(const void* keys, const void* src,
                                    const void* dst, const void* ovl,
                                    int64_t E, int read_len,
                                    const void* lens, const void* start,
                                    const void* maxsl, void* counts,
                                    void* stream) {
  reduce_edge_kernel<<<sage2_blocks(E), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dst), static_cast<const int32_t*>(ovl), E,
      read_len, static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(maxsl), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
