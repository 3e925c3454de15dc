// K15: the solid entries of a sorted k-mer count table, in table order.
//
// Replaces sage2_tpu/kmer/correct.py _prune_impl (:246), jitted once a
// correction round: a masked (hi, lo) sort of the whole table that moved
// the entries with count >= threshold to the front, and a host read of
// their number. The table is sorted already, so the kept entries need no
// sort, only a compaction in place order:
//
//   count  one block a tile of kScanTile entries (scan.cuh) counts the
//          entries with count >= threshold;
//   scan   sage2_scan_tiles turns the tile counts into each tile's first
//          slot and writes the total to a device scalar, which the
//          wrapper reads once to size the outputs;
//   write  each block recounts its tile, scans the flags across the
//          block and writes each kept key and count at its slot.
//
// Bound: bytes. Every key and count is read (12 bytes an entry, twice:
// the flags are recomputed from the counts, 4 bytes an entry, rather
// than stored), and each kept entry written once.

#include "scan.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
    prune_count_kernel(const int32_t* __restrict__ counts, int64_t T,
                       int threshold, int64_t* __restrict__ tile_counts) {
  const int64_t i0 = scan_first_item();
  int count = 0;
  for (int k = 0; k < kScanItems && i0 + k < T; ++k) {
    count += counts[i0 + k] >= threshold;
  }
  int total;
  block_exclusive_scan<int>(count, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    prune_write_kernel(const int64_t* __restrict__ keys,
                       const int32_t* __restrict__ counts, int64_t T,
                       int threshold,
                       const int64_t* __restrict__ tile_offsets,
                       int64_t* __restrict__ keys_out,
                       int32_t* __restrict__ counts_out) {
  const int64_t i0 = scan_first_item();
  int32_t c[kScanItems];
  int count = 0;
  for (int k = 0; k < kScanItems; ++k) {
    c[k] = i0 + k < T ? counts[i0 + k] : 0;
    count += i0 + k < T && c[k] >= threshold;
  }
  int total;
  int64_t slot = tile_offsets[blockIdx.x] +
                 block_exclusive_scan<int>(count, &total);
  for (int k = 0; k < kScanItems; ++k) {
    if (i0 + k >= T || c[k] < threshold) continue;
    keys_out[slot] = keys[i0 + k];
    counts_out[slot] = c[k];
    ++slot;
  }
}

}  // namespace

// counts: (T,) int32; tile_counts: the kept entries of each tile
// (scan.cuh).
SAGE2_EXPORT int sage2_prune_count(const void* counts, int64_t T,
                                   int threshold, void* tile_counts,
                                   void* stream) {
  prune_count_kernel<<<scan_tiles_of(T), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(counts), T, threshold,
      static_cast<int64_t*>(tile_counts));
  return static_cast<int>(cudaGetLastError());
}

// keys: (T,) int64 and counts: (T,) int32, the sorted table;
// tile_offsets: the scanned tile counts; keys_out, counts_out: (n_keep,)
// outputs, n_keep the scan's total.
SAGE2_EXPORT int sage2_prune_write(const void* keys, const void* counts,
                                   int64_t T, int threshold,
                                   const void* tile_offsets, void* keys_out,
                                   void* counts_out, void* stream) {
  prune_write_kernel<<<scan_tiles_of(T), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int32_t*>(counts),
      T, threshold, static_cast<const int64_t*>(tile_offsets),
      static_cast<int64_t*>(keys_out), static_cast<int32_t*>(counts_out));
  return static_cast<int>(cudaGetLastError());
}
