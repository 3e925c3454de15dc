// K14: the longest overlap of each (src, dst) pair among the overlap
// join's verified candidates, sorted by (src, dst), compacted and padded.
//
// Replaces sage2_tpu/overlap/detect.py _reduce_fused (:1015) and
// reduce_edge_candidates (:488): the masked (src, dst | ovl) sort, the
// last-of-run flags and the compaction (a second sort there). The port
// ran two stable sorts of the compacted candidates (by ovl, then by
// (src, dst)), six gathers and a boolean compaction.
//
//   keys     one launch packs each ok candidate into one int64,
//            src << (db + ob) | dst << ob | ovl (db = bit_length(V - 1),
//            ob = bit_length(read_len)), -1 where not ok, so that one
//            torch.sort orders (src, dst, ovl) and the rows that are not
//            ok come first. Where 2 db + ob > 63 (vertex ids near 2^30)
//            the key is ovl; a stable sort orders it, sage2_edge_pairs
//            gathers src << 32 | dst through that order, and a second
//            stable sort orders the pairs.
//   count    a candidate is kept when its key is not -1 and its (src,
//            dst) differs from the next row's: the last of its run holds
//            the longest ovl. Pass 1 counts a tile's kept rows, the scan
//            (scan.cuh) makes them offsets and n_edges;
//   write    pass 2 writes each kept row's (src, dst, ovl) at its slot,
//            and the grid fills the slots from n_edges to the capacity
//            with (INT32_MAX, INT32_MAX, 0).
//
// The deferred mode (find_overlaps_stacked's, detect.py:1050-1054) keeps
// every valid row: the count pass counts a tile's valid rows (key >= 0)
// for the scan and adds its keepers (the last row of each run) to a
// device counter; the write pass copies every valid sorted row, so a
// (src, dst) pair verified at several lengths keeps all of its rows,
// the longest last. n_edges (the keepers) and n_dups (valid rows less
// keepers) stay on the card: nothing waits on the host.
//
// Bound: bytes. The candidates (13 bytes each) are read once, the padded
// edges (12 bytes a slot) written once; the sort's passes move the rest.

#include "scan.cuh"

namespace {

constexpr int32_t kInt32Max = 0x7FFFFFFF;

__global__ void edge_keys_kernel(const bool* __restrict__ ok,
                                 const int32_t* __restrict__ a,
                                 const int32_t* __restrict__ b,
                                 const int32_t* __restrict__ ovl, int64_t n,
                                 int db, int ob, bool wide,
                                 int64_t* __restrict__ keys) {
  SAGE2_GRID_STRIDE(i, n) {
    int64_t k = -1;
    if (ok[i]) {
      k = wide ? static_cast<int64_t>(ovl[i])
               : (static_cast<int64_t>(a[i]) << (db + ob)) |
                     (static_cast<int64_t>(b[i]) << ob) |
                     static_cast<int64_t>(ovl[i]);
    }
    keys[i] = k;
  }
}

__global__ void edge_pairs_kernel(const bool* __restrict__ ok,
                                  const int32_t* __restrict__ a,
                                  const int32_t* __restrict__ b,
                                  const int64_t* __restrict__ perm,
                                  int64_t n, int64_t* __restrict__ keys) {
  SAGE2_GRID_STRIDE(i, n) {
    const int64_t p = perm[i];
    keys[i] = ok[p] ? (static_cast<int64_t>(a[p]) << 32) |
                          static_cast<int64_t>(b[p])
                    : int64_t{-1};
  }
}

// the last row of its (src, dst) run among the kept (key >= 0) rows
__device__ __forceinline__ bool last_of_run(const int64_t* __restrict__ keys,
                                            int64_t n, int64_t i,
                                            int shift) {
  const int64_t k = keys[i];
  return k >= 0 && (i + 1 == n || (keys[i + 1] >> shift) != (k >> shift));
}

// the rows pass 2 writes: the keepers, or in the deferred mode every
// valid row
__device__ __forceinline__ bool written(const int64_t* __restrict__ keys,
                                        int64_t n, int64_t i, int shift,
                                        bool deferred) {
  return deferred ? keys[i] >= 0 : last_of_run(keys, n, i, shift);
}

__global__ void __launch_bounds__(kThreads)
    edge_count_kernel(const int64_t* __restrict__ keys, int64_t n,
                      int shift, int64_t* __restrict__ tile_counts,
                      unsigned long long* __restrict__ keepers) {
  const bool deferred = keepers != nullptr;
  const int64_t i0 = scan_first_item();
  int count = 0, kept = 0;
  for (int k = 0; k < kScanItems && i0 + k < n; ++k) {
    count += written(keys, n, i0 + k, shift, deferred);
    if (deferred) kept += last_of_run(keys, n, i0 + k, shift);
  }
  int total;
  block_exclusive_scan<int>(count, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
  if (deferred) {
    block_exclusive_scan<int>(kept, &total);
    if (threadIdx.x == 0 && total) {
      atomicAdd(keepers, static_cast<unsigned long long>(total));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    edge_write_kernel(const int64_t* __restrict__ keys, int64_t n, int db,
                      int ob, bool wide, const int64_t* __restrict__ perm1,
                      const int64_t* __restrict__ perm2,
                      const int32_t* __restrict__ ovl,
                      const int64_t* __restrict__ tile_offsets,
                      const int64_t* __restrict__ n_edges, int64_t capacity,
                      bool deferred, int32_t* __restrict__ src_out,
                      int32_t* __restrict__ dst_out,
                      int32_t* __restrict__ ovl_out) {
  const int shift = wide ? 0 : ob;
  const int64_t i0 = scan_first_item();
  bool keep[kScanItems];
  int count = 0;
  for (int k = 0; k < kScanItems; ++k) {
    keep[k] = i0 + k < n && written(keys, n, i0 + k, shift, deferred);
    count += keep[k];
  }
  int total;
  int64_t slot = tile_offsets[blockIdx.x] +
                 block_exclusive_scan<int>(count, &total);
  for (int k = 0; k < kScanItems; ++k) {
    if (!keep[k]) continue;
    const int64_t key = keys[i0 + k];
    if (wide) {
      src_out[slot] = static_cast<int32_t>(key >> 32);
      dst_out[slot] = static_cast<int32_t>(key & 0xFFFFFFFFll);
      ovl_out[slot] = ovl[perm1[perm2[i0 + k]]];
    } else {
      src_out[slot] = static_cast<int32_t>(key >> (db + ob));
      dst_out[slot] = static_cast<int32_t>((key >> ob) &
                                           ((int64_t{1} << db) - 1));
      ovl_out[slot] = static_cast<int32_t>(key & ((int64_t{1} << ob) - 1));
    }
    ++slot;
  }
  const int64_t kept = *n_edges;
  SAGE2_GRID_STRIDE(j, capacity) {
    if (j >= kept) {
      src_out[j] = kInt32Max;
      dst_out[j] = kInt32Max;
      ovl_out[j] = 0;
    }
  }
}

}  // namespace

// ok: (n,) bool; a, b, ovl: (n,) int32 candidates; keys (n,) int64 out:
// the composite key, or with wide the ovl key; -1 where not ok.
SAGE2_EXPORT int sage2_edge_keys(const void* ok, const void* a, const void* b,
                                 const void* ovl, int64_t n, int db, int ob,
                                 int wide, void* keys, void* stream) {
  edge_keys_kernel<<<sage2_blocks(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(ok), static_cast<const int32_t*>(a),
      static_cast<const int32_t*>(b), static_cast<const int32_t*>(ovl), n,
      db, ob, wide != 0, static_cast<int64_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// The wide order's second key: keys[i] = a << 32 | b of candidate
// perm[i] (perm int64, the ovl sort's), -1 where not ok.
SAGE2_EXPORT int sage2_edge_pairs(const void* ok, const void* a, const void* b,
                                  const void* perm, int64_t n, void* keys,
                                  void* stream) {
  edge_pairs_kernel<<<sage2_blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(ok), static_cast<const int32_t*>(a),
      static_cast<const int32_t*>(b), static_cast<const int64_t*>(perm), n,
      static_cast<int64_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// keys: the sorted keys; shift: ob (composite keys) or 0 (the wide
// order's pair keys); tile_counts: the kept rows of each tile (scan.cuh).
SAGE2_EXPORT int sage2_edge_count(const void* keys, int64_t n, int shift,
                                  void* tile_counts, void* stream) {
  edge_count_kernel<<<scan_tiles_of(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), n, shift,
      static_cast<int64_t*>(tile_counts), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The deferred mode's count pass: tile_counts gets the valid rows of each
// tile, and keepers (one int64, zeroed by the caller) their keepers.
SAGE2_EXPORT int sage2_edge_count_deferred(const void* keys, int64_t n,
                                           int shift, void* tile_counts,
                                           void* keepers, void* stream) {
  edge_count_kernel<<<scan_tiles_of(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), n, shift,
      static_cast<int64_t*>(tile_counts),
      static_cast<unsigned long long*>(keepers));
  return static_cast<int>(cudaGetLastError());
}

// tile_offsets: the scanned tile counts; n_edges: the scan's total;
// perm1, perm2: the wide order's two sort permutations (NULL otherwise),
// through which ovl is read; deferred: write every valid row (the counts
// of sage2_edge_count_deferred); src, dst, ovl_out: (capacity,) int32,
// capacity >= n.
SAGE2_EXPORT int sage2_edge_write(const void* keys, int64_t n, int db, int ob,
                                  int wide, const void* perm1,
                                  const void* perm2, const void* ovl,
                                  const void* tile_offsets,
                                  const void* n_edges, int64_t capacity,
                                  int deferred, void* src, void* dst,
                                  void* ovl_out, void* stream) {
  edge_write_kernel<<<scan_tiles_of(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), n, db, ob, wide != 0,
      static_cast<const int64_t*>(perm1), static_cast<const int64_t*>(perm2),
      static_cast<const int32_t*>(ovl),
      static_cast<const int64_t*>(tile_offsets),
      static_cast<const int64_t*>(n_edges), capacity, deferred != 0,
      static_cast<int32_t*>(src), static_cast<int32_t*>(dst),
      static_cast<int32_t*>(ovl_out));
  return static_cast<int>(cudaGetLastError());
}
