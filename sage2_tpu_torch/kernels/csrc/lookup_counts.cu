// K2: count of each query key in a sorted count table, 0 where absent.
//
// Replaces sage2_tpu/kmer/count.py lookup_counts (:97), which on the TPU
// was one combined sort of table and queries (a binary search cost
// log2(T) dependent gathers per query there). On this card the table
// (a few hundred MB at most) is searched in place: one thread per query,
// a lower-bound binary search over the int64 keys, then one equality
// test. No sort, no scatter.
//
// Bound: bytes of the queries and answers (the upper levels of the
// search tree stay in L2); the search itself is latency-bound, which
// the many queries in flight hide.

#include "common.cuh"

__global__ void lookup_counts_kernel(const int64_t* __restrict__ table,
                                     const int32_t* __restrict__ counts,
                                     int64_t T,
                                     const int64_t* __restrict__ queries,
                                     int64_t Q, int32_t* __restrict__ out) {
  SAGE2_GRID_STRIDE(i, Q) {
    const int64_t key = queries[i];
    int64_t lo = 0, hi = T;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (table[mid] < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    out[i] = (lo < T && table[lo] == key) ? counts[lo] : 0;
  }
}

// table: (T,) sorted int64 keys; counts: (T,) int32; queries, out: (Q,).
SAGE2_EXPORT int sage2_lookup_counts(const void* table, const void* counts,
                                     int64_t T, const void* queries,
                                     int64_t Q, void* out, void* stream) {
  lookup_counts_kernel<<<sage2_blocks(Q), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table),
      static_cast<const int32_t*>(counts), T,
      static_cast<const int64_t*>(queries), Q, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
