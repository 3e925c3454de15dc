// K2: count of each query key in a sorted count table, 0 where absent.
//
// Replaces sage2_tpu/kmer/count.py lookup_counts (:97), which on the TPU
// was one combined sort of table and queries (a binary search cost
// log2(T) dependent gathers per query there). The function needs 12
// bytes a query (its key in, its count out), but a query's answer sits at
// a random place in a table that, at the E. coli scale's 5,126,426 keys
// (41 MB of keys, 20.5 MB of counts), does not fit the 50 MB L2 whole: what
// bounds a lookup on this card is the chain of dependent loads, each a
// random sector from L2 or device memory. A lower-bound search of the
// whole table (this kernel before, and torch.searchsorted) makes 23 of
// them a query.
//
// Two launches (bucket_search.cuh):
//   1. the bucket directory: bits = clamp(ceil(log2 T) - 2, 0, 22), 2^21
//      buckets (an 8.4 MB int32 directory) at 5,126,426 keys; one thread an
//      entry, each a lower-bound search for its bucket's lowest key, so no
//      thread walks a gap or a run and a skewed table (every key but one in
//      bucket 0) costs no more than an even one. Where the buckets are at
//      most 2^32 apart (2^29 at that table), the same launch packs each
//      entry as (uint32 offset below its bucket, int32 count): 41 MB in
//      place of 61.5. The table's span, the bucket width and the branch
//      are decided on the card: the host makes no sync.
//   2. the lookup: a query outside the table's span answers 0 at once;
//      otherwise one pair of directory entries (one sector, mostly in L2),
//      an exact search inside the bucket (2-3 steps over one or two
//      sectors at an even table; log2 of its size in any bucket), and the
//      count from the entry found (packed) or from the counts beside the
//      keys. Four queries a thread (two 16-byte loads where aligned) step
//      together, so their chains overlap; queries and answers stream past
//      L2 (evict-first), which keeps the directory and table there.
// That is 2-3 random sectors a query in place of 23 dependent loads.
//
// Registers (nvcc -Xptxas -v, sm_90a): lookup_counts_kernel 48,
// bucket_directory_kernel 24; no spills.

#include "bucket_search.cuh"
#include "common.cuh"

constexpr int kQueriesPerThread = 4;

// Groups of four queries, grid-stride: load (two 16-byte loads where
// aligned), search, answer.
template <typename Keys>
__device__ __forceinline__ void lookup_groups(
    const Keys& keys, const int32_t* __restrict__ dir, const BucketSpan& span,
    const int64_t* __restrict__ queries, int64_t Q, bool vec,
    int32_t* __restrict__ out) {
  constexpr int C = kQueriesPerThread;
  static_assert(C == 4, "a group is two 16-byte loads");
  SAGE2_GRID_STRIDE(g, (Q + C - 1) / C) {
    const int64_t i0 = g * C;
    const bool full = i0 + C <= Q;
    int64_t q[C];
    bool live[C];
    if (vec && full) {
      const longlong2* p = reinterpret_cast<const longlong2*>(queries + i0);
      const longlong2 x = __ldcs(p), y = __ldcs(p + 1);
      q[0] = x.x, q[1] = x.y, q[2] = y.x, q[3] = y.y;
#pragma unroll
      for (int c = 0; c < C; ++c) live[c] = true;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        live[c] = i0 + c < Q;
        q[c] = live[c] ? __ldcs(reinterpret_cast<const long long*>(queries) +
                                i0 + c)
                       : 0;
      }
    }
    int32_t pos[C], r[C];
    bucket_find<C>(keys, dir, span, q, live, pos);
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = pos[c] >= 0 ? keys.count(pos[c]) : 0;
    if (vec && full) {
      __stcs(reinterpret_cast<int4*>(out + i0),
             make_int4(r[0], r[1], r[2], r[3]));
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (live[c]) __stcs(out + i0 + c, r[c]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    lookup_counts_kernel(const int64_t* __restrict__ table,
                         const int32_t* __restrict__ counts, int64_t T,
                         int64_t* __restrict__ scratch,
                         const int64_t* __restrict__ queries, int64_t Q,
                         bool vec, int32_t* __restrict__ out) {
  const BucketSpan span = load_span(scratch);
  const int32_t* dir = dir_of(scratch, T);
  if (ldg_key(scratch + 3)) {         // packed (uniform over the grid)
    lookup_groups(PackedKeys{packed_of(scratch), suffix_mask(span.shift)},
                  dir, span, queries, Q, vec, out);
  } else {
    lookup_groups(Int64Keys{table, counts}, dir, span, queries, Q, vec, out);
  }
}

// The bucket directory over table and counts (bucket_search.cuh).
SAGE2_EXPORT int sage2_lookup_directory(const void* table, const void* counts,
                                        int64_t T, int bits, void* scratch,
                                        void* stream) {
  return bucket_directory_launch(table, counts, T, bits, scratch, stream);
}

// queries, out: (Q,); scratch as sage2_lookup_directory left it.
SAGE2_EXPORT int sage2_lookup_counts(const void* table, const void* counts,
                                     int64_t T, void* scratch,
                                     const void* queries, int64_t Q,
                                     void* out, void* stream) {
  const bool vec = reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t groups = (Q + kQueriesPerThread - 1) / kQueriesPerThread;
  lookup_counts_kernel<<<sage2_blocks(groups), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), static_cast<const int32_t*>(counts),
      T, static_cast<int64_t*>(scratch),
      static_cast<const int64_t*>(queries), Q, vec,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
