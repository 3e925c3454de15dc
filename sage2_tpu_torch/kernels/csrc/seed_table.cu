// K9: the entry side of the streamed overlap join: the seed of each
// (read, prefix offset) as one sort key, then, over the sorted keys, the
// bucket start table and the slab of entry rows.
//
// Replaces sage2_tpu/stream.py:193-226 (single slab) and :375-397
// (entry blocks): detect.seed_keys_from_words0 at positions 0..g-1
// (overlap/detect.py:258), the (hi, invalid-bit | entry id) operands of
// the two-operand sort, detect.table_from_sorted (:446: a scatter-min of
// each bucket's first slot, a reverse cummin over 2^B + 1 buckets and
// the [start, count] stack) and the slab concat with its words0 gather.
// On the TPU each of those was a pass over device memory, the cummin
// over the whole 2^B-entry table. Here, around one torch.sort:
//
//   key pass    one thread per (read, offset o < g): the 16-base word at
//               o from the read's unshifted words (register shifts,
//               masked to s bases when s < 16; all-ones for an invalid
//               read) and the sort key (hi << 32 | invalid-bit << 31 |
//               entry) with its top bit flipped, so signed int64 order is
//               the reference's unsigned (hi, packed) order. Entry ids are
//               global: (base + read) * g + o.
//   table pass  one thread per sorted slot i, then one per bucket b. A
//               slot writes its slab row [entry, words0 of entry's read]
//               (int32 bit patterns). A bucket finds its first slot by a
//               binary search of the sorted keys: the first key at or
//               above b's lowest key, which is the reference's start
//               table after its forward fill from the right (an empty
//               bucket gets the first slot of a higher one, and the
//               buckets above the last valid one get n_valid); a second
//               search, from there, for the next bucket's lowest key (for
//               the last bucket, the lowest invalid key) gives its count.
//
// Valid entries sort before invalid ones (their packed word lacks the
// invalid bit, and an invalid entry's hi is all-ones), so the valid slots
// are a prefix and the buckets of that prefix ascend. No thread walks a
// run or a gap: a bucket that holds many entries, or a long stretch of
// empty buckets, costs no thread more than two searches.
//
// Bound: bytes. The key pass reads each read's words g times (cached)
// and writes 8 bytes a key; the table pass reads each key once, gathers W
// words and writes (1 + W) * 4 bytes a slot, and writes 8 bytes a bucket.
// The searches of neighbouring buckets take the same path through the
// keys, so most of their reads hit in cache.

#include "common.cuh"

__global__ void seed_keys_kernel(const int64_t* __restrict__ words0,
                                 const bool* __restrict__ valid, int64_t m,
                                 int W, int s, int g, int64_t base,
                                 int64_t* __restrict__ keys) {
  const uint32_t mask = s < 16 ? (0xFFFFFFFFu << (32 - 2 * s)) : 0xFFFFFFFFu;
  SAGE2_GRID_STRIDE(idx, m * g) {
    const int64_t r = idx / g;
    const int o = static_cast<int>(idx - r * g);
    const bool ok = valid[r];
    const uint32_t hi = ok ? (word_at(words0 + r * W, W, o) & mask)
                           : 0xFFFFFFFFu;
    const uint32_t packed =
        (ok ? 0u : 0x80000000u) | static_cast<uint32_t>(base * g + idx);
    const uint64_t u = (static_cast<uint64_t>(hi) << 32) | packed;
    keys[idx] = static_cast<int64_t>(u ^ (uint64_t{1} << 63));
  }
}

// The sort key's unsigned value (top bit flipped back).
__device__ __forceinline__ uint64_t unsigned_key(int64_t key) {
  return static_cast<uint64_t>(key) ^ (uint64_t{1} << 63);
}

// The first slot in [lo, n) whose unsigned key is at least t.
__device__ __forceinline__ int64_t first_at_least(
    const int64_t* __restrict__ keys, int64_t lo, int64_t n, uint64_t t) {
  int64_t hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (unsigned_key(keys[mid]) < t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void seed_table_kernel(const int64_t* __restrict__ keys, int64_t n,
                                  const int64_t* __restrict__ words0, int W,
                                  int g, int64_t base, int B,
                                  int32_t* __restrict__ table,
                                  int32_t* __restrict__ slab) {
  const int64_t nb = int64_t{1} << B;
  // the lowest key of any invalid entry: hi all-ones, the invalid bit set
  const uint64_t invalid_key = 0xFFFFFFFF80000000ull;
  SAGE2_GRID_STRIDE(i, n + nb) {
    if (i < n) {
      const int32_t entry = static_cast<int32_t>(unsigned_key(keys[i]) &
                                                 0x7FFFFFFFu);
      int32_t* row = slab + i * (W + 1);
      row[0] = entry;
      const int64_t* w = words0 + (entry / g - base) * W;
      for (int t = 0; t < W; ++t) row[t + 1] = static_cast<int32_t>(w[t]);
      continue;
    }
    const int64_t b = i - n;
    const int64_t start =
        first_at_least(keys, 0, n, static_cast<uint64_t>(b) << (64 - B));
    const int64_t end = first_at_least(
        keys, start, n,
        b + 1 < nb ? static_cast<uint64_t>(b + 1) << (64 - B) : invalid_key);
    table[2 * b] = static_cast<int32_t>(start);
    table[2 * b + 1] = static_cast<int32_t>(end - start);
  }
}

// words0: (m, W) int64 words of the block's reads (uint32 values); valid:
// (m,) bool; keys: (m * g,) int64 output.
SAGE2_EXPORT int sage2_seed_keys(const void* words0, const void* valid,
                                 int64_t m, int W, int s, int g, int64_t base,
                                 void* keys, void* stream) {
  seed_keys_kernel<<<sage2_blocks(m * g), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(words0), static_cast<const bool*>(valid), m,
      W, s, g, base, static_cast<int64_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// keys: (n,) the sorted keys; table: (2^B, 2) int32 output; slab:
// (n, W + 1) int32 output.
SAGE2_EXPORT int sage2_seed_table(const void* keys, int64_t n,
                                  const void* words0, int W, int g,
                                  int64_t base, int B, void* table,
                                  void* slab, void* stream) {
  seed_table_kernel<<<sage2_blocks(n + (int64_t{1} << B)), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), n,
      static_cast<const int64_t*>(words0), W, g, base, B,
      static_cast<int32_t*>(table), static_cast<int32_t*>(slab));
  return static_cast<int>(cudaGetLastError());
}
