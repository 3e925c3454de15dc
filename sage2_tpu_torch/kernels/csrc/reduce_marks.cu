// K7: the expansion and membership-probe half of the device transitive
// reduction, over one range [j0, j1) of the expansion slots.
//
// Replaces sage2_tpu/graph/reduce.py _chunk_kernel (:520, jitted at :521;
// the same arithmetic as lines 93-118 of the in-core
// transitive_reduction). On the TPU each chunk materialised its slots
// with expand_by_counts (a scatter and a cummax over the chunk capacity)
// and then probed them in whole-array bisection steps. Here one thread
// owns one slot j and nothing is materialised:
//
//   e1   = the edge whose expansion holds j: the first edge with
//          offsets[e1] > j, by binary search over the inclusive int64
//          prefix sum of the per-edge counts (K6);
//   rank = j - (offsets[e1] - counts[e1]), e2 = start[dst[e1]] + rank:
//          the rank-th out-edge of w = dst[e1] in the (src, sl) order;
//   x    = ss_dst[e2]; the path v -> w -> x with v = src[e1] is skipped
//          when x == v; otherwise x is bisected in v's out-run of the
//          (src, dst) order, dst[startd[v] : startd[v + 1]], and a hit
//          with len(v) - ovl[pos] == sl[e1] + ss_sl[e2] marks
//          removed[pos] = 1, where sl[e1] = len(v) - ovl[e1] and len(v)
//          is the scalar read length, or lens[v] for ragged reads (the
//          reference's c_plen, :551).
//
// Racing stores write the same 1, so the marks do not depend on the
// order of the threads. The wrapper launches the slot space in ranges of
// at most 2^24 slots; the in-core form ends the last range at its
// capacity. The slot space is counted in int64: at E. coli scale it is
// within 2x of 2^31.
//
// Bound: operations, two binary searches a slot (log2 E and log2 of the
// largest out-degree dependent loads); the arrays are read once.

#include "common.cuh"

__global__ void reduce_marks_kernel(
    uint8_t* __restrict__ removed, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ ovl, const int32_t* __restrict__ ss_sl,
    const int32_t* __restrict__ ss_dst, const int32_t* __restrict__ start,
    const int32_t* __restrict__ startd, int64_t E, int read_len,
    const int32_t* __restrict__ lens, int64_t j0, int64_t j1) {
  SAGE2_GRID_STRIDE(i, j1 - j0) {
    const int64_t j = j0 + i;
    int64_t lo = 0, hi = E;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (offsets[mid] <= j) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int64_t e1 = lo;
    const int64_t first = e1 > 0 ? offsets[e1 - 1] : 0;
    const int64_t e2 = start[dst[e1]] + (j - first);
    const int32_t v = src[e1];
    const int32_t x = ss_dst[e2];
    if (x == v) continue;
    const int32_t len_v = lens == nullptr ? read_len : lens[v];
    const int32_t sls = (len_v - ovl[e1]) + ss_sl[e2];
    int64_t a = startd[v], b = startd[v + 1];
    const int64_t end = b;
    while (a < b) {
      const int64_t mid = (a + b) >> 1;
      if (dst[mid] < x) {
        a = mid + 1;
      } else {
        b = mid;
      }
    }
    if (a < end && dst[a] == x && len_v - ovl[a] == sls) removed[a] = 1;
  }
}

// removed: (E,) uint8, marks added in place; offsets: (E,) int64 inclusive
// prefix sum of the expansion counts; src, dst, ovl: (E,) int32 in (src,
// dst) order; ss_sl, ss_dst: (E,) int32 in (src, sl) order; start: (V,)
// int32; startd: (V + 1,) int32; lens: (V,) int32 per-vertex read
// lengths, or NULL (every read is read_len long); 0 <= j0 <= j1 <=
// offsets[E - 1].
SAGE2_EXPORT int sage2_reduce_marks(void* removed, const void* offsets,
                                    const void* src, const void* dst,
                                    const void* ovl, const void* ss_sl,
                                    const void* ss_dst, const void* start,
                                    const void* startd, int64_t E,
                                    int read_len, const void* lens,
                                    int64_t j0, int64_t j1, void* stream) {
  reduce_marks_kernel<<<sage2_blocks(j1 - j0), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(removed), static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(ovl), static_cast<const int32_t*>(ss_sl),
      static_cast<const int32_t*>(ss_dst),
      static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(startd), E, read_len,
      static_cast<const int32_t*>(lens), j0, j1);
  return static_cast<int>(cudaGetLastError());
}
