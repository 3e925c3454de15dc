// K13: the seed rows of the overlap join, and the live rows in the join's
// sort order.
//
// Replaces sage2_tpu/overlap/detect.py build_seed_rows (:642) with
// _row_payload (:562) and the row layout of fused_join_core's sort
// (:863): the (M, 16, W) shifted packs, a seed key and a payload row per
// (read, seed position) built by static slices, the tag | id operand and
// the three-operand sort. K3 (overlap_join.cu) joins what this gives.
//
//   rows     one warp a read: the lanes pack its codes into words (16
//            bases each, big-endian, the last word left-aligned) in
//            shared memory, then build each of its R = g + n_pos rows
//            from them with two shifts a word (word_at): the exact seed
//            key (hi:lo left-aligned and masked to s bases, top bit
//            flipped), the live flag (a valid read, and for ragged reads
//            pos + s <= len) and the payload row [aw_0 .. aw_{Wt-1}, xw,
//            len] written as consecutive int32 across the lanes.
//   compact  the rows in the reference's (key, tag | id) tie order are
//            the entries (t < g) by id, then the queries by id: a
//            two-pass scan (scan.cuh) over that order writes each live
//            row's id and key, so the stable torch.sort of the keys
//            keeps the order within a key.
//   gather   s_rows = the live ids through the sort's permutation.
//
// The streamed join (sage2_tpu/stream.py:835-887, _ragged_entry_kernel
// and _ragged_join_kernel) builds the rows of a chunk of reads with
// global ids, (id_base + m) * R + t: the entry rows alone (t < g) for
// its entry slab, or the query rows alone (t >= g) of a query chunk.
// Then the rows kernel builds only the chosen rows, the payload holds
// only theirs ((M, g) or (M, n_pos) rows), and the tie order over one
// kind is read order; the compaction writes the ids behind the rows
// compacted before (the slab: entries by global id), so the stable
// sort of [slab + the chunk's queries] keeps the reference's (key,
// tag | id) order.
//
// The fixed-capacity mode (find_overlaps_stacked, detect.py:1108) keeps
// the live count on the card: the compaction also fills the slots from
// the live count to M * R with dead rows (key INT64_MAX, id -1), and the
// stable sort takes the whole buffer. A live all-T seed has the key
// INT64_MAX too, but it lies before every dead row before the sort, so
// the live rows stay in front; K3 stops at the live count, not at the
// first INT64_MAX key.
//
// Bound: bytes. The codes are read once; the payload (Wt + 2 words a
// row), the keys and the compacted ids and keys are written once; the
// sort moves the rest.

#include "scan.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kRowWarps = kThreads / kWarp;
constexpr int64_t kDeadKey = 0x7FFFFFFFFFFFFFFFll;  // INT64_MAX

// bases [q, q + 16) of a read's words (W uint32), zero past the last word
__device__ __forceinline__ uint32_t word_at_u32(const uint32_t* w, int W,
                                                int q) {
  const int i = q >> 4, r = q & 15;
  const uint32_t cur = i < W ? w[i] : 0u;
  if (r == 0) return cur;
  const uint32_t nxt = i + 1 < W ? w[i + 1] : 0u;
  return (cur << (2 * r)) | (nxt >> (32 - 2 * r));
}

// the top n bases (1 <= n <= 15) of a word
__device__ __forceinline__ uint32_t mask_top(uint32_t w, int n) {
  return w & (0xFFFFFFFFu << (32 - 2 * n));
}

__device__ __forceinline__ int seed_pos(int t, int g) {
  return t < g ? t : g * (t - g + 1);
}

// the built row at position v of the join's tie order: with every row
// built (Rw == R), entries (read-major, t < g), then queries (read-major,
// t >= g); with one kind of row built, read order
__device__ __forceinline__ int64_t row_at(int64_t v, int64_t M, int g,
                                          int n_pos, int Rw) {
  const int64_t R = g + n_pos;
  if (Rw != R) return v;
  const int64_t entries = M * g;
  if (v < entries) return (v / g) * R + v % g;
  const int64_t u = v - entries;
  return (u / n_pos) * R + g + u % n_pos;
}

__global__ void __launch_bounds__(kThreads)
    seed_rows_kernel(const int32_t* __restrict__ reads2,
                     const bool* __restrict__ valid2,
                     const int32_t* __restrict__ lengths, int64_t M, int L,
                     int s, int g, int n_pos, int trim, int t0, int Rw,
                     int64_t* __restrict__ keys, uint8_t* __restrict__ live,
                     int32_t* __restrict__ payload) {
  extern __shared__ uint32_t smem[];
  const int W = (L + 15) / 16;
  const int Wt = (L - g + 15) / 16 - trim;
  const int cols = Wt + 2;
  const int lane = threadIdx.x % kWarp;
  uint32_t* words = smem + (threadIdx.x / kWarp) * W;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kRowWarps;
  for (int64_t m = blockIdx.x * int64_t{kRowWarps} + threadIdx.x / kWarp;
       m < M; m += warps) {
    const int32_t* read = reads2 + m * L;
    for (int t = lane; t < W; t += kWarp) {
      uint32_t w = 0;
      for (int i = 0; i < 16; ++i) {
        const int j = 16 * t + i;
        w = (w << 2) + (j < L ? static_cast<uint32_t>(read[j]) : 0u);
      }
      words[t] = w;
    }
    __syncwarp();
    const int len = lengths == nullptr ? L : lengths[m];
    const bool valid = valid2[m];
    int32_t* prow = payload + m * Rw * cols;
    for (int e = lane; e < Rw * cols; e += kWarp) {
      const int t = t0 + e / cols, col = e % cols;
      const int pos = seed_pos(t, g);
      uint32_t v;
      if (col < Wt) {
        v = word_at_u32(words, W, pos + 16 * (trim + col));
      } else if (col > Wt) {
        v = static_cast<uint32_t>(len);
      } else if (t < g) {
        v = words[0];                       // entry: the read's first word
      } else if (pos < 16) {
        v = words[0] >> (2 * (16 - pos));   // query: the word ending at pos
      } else {
        v = word_at_u32(words, W, pos - 16);
      }
      prow[e] = static_cast<int32_t>(v);
    }
    for (int i = lane; i < Rw; i += kWarp) {
      const int t = t0 + i;
      const int pos = seed_pos(t, g);
      uint32_t hi = word_at_u32(words, W, pos);
      if (s < 16) hi = mask_top(hi, s);
      uint32_t lo = 0;
      if (s > 16) {
        lo = word_at_u32(words, W, pos + 16);
        if (s < 32) lo = mask_top(lo, s - 16);
      }
      keys[m * Rw + i] = static_cast<int64_t>(
          (static_cast<uint64_t>(hi ^ 0x80000000u) << 32) | lo);
      live[m * Rw + i] = valid && (lengths == nullptr || pos + s <= len);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
    seed_count_kernel(const uint8_t* __restrict__ live, int64_t M, int g,
                      int n_pos, int Rw, int64_t* __restrict__ tile_counts) {
  const int64_t n = M * Rw;
  const int64_t i0 = scan_first_item();
  int count = 0;
  for (int k = 0; k < kScanItems && i0 + k < n; ++k) {
    count += live[row_at(i0 + k, M, g, n_pos, Rw)];
  }
  int total;
  block_exclusive_scan<int>(count, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    seed_compact_kernel(const uint8_t* __restrict__ live,
                        const int64_t* __restrict__ keys, int64_t M, int g,
                        int n_pos, int t0, int Rw, int64_t id_base,
                        const int64_t* __restrict__ tile_offsets,
                        const int64_t* __restrict__ n_live,
                        int32_t* __restrict__ base,
                        int64_t* __restrict__ ckeys) {
  const int64_t R = g + n_pos;
  const int64_t n = M * Rw;
  const int64_t i0 = scan_first_item();
  int64_t rows[kScanItems];
  int count = 0;
  for (int k = 0; k < kScanItems; ++k) {
    rows[k] = -1;
    if (i0 + k < n) {
      const int64_t row = row_at(i0 + k, M, g, n_pos, Rw);
      if (live[row]) {
        rows[k] = row;
        ++count;
      }
    }
  }
  int total;
  int64_t slot = tile_offsets[blockIdx.x] +
                 block_exclusive_scan<int>(count, &total);
  for (int k = 0; k < kScanItems; ++k) {
    if (rows[k] < 0) continue;
    // the row's global id: (id_base + read) * R + t
    base[slot] = static_cast<int32_t>((id_base + rows[k] / Rw) * R + t0 +
                                      rows[k] % Rw);
    ckeys[slot] = keys[rows[k]];
    ++slot;
  }
  if (n_live == nullptr) return;
  const int64_t live_rows = *n_live;  // the scan's total: no slot below
  SAGE2_GRID_STRIDE(j, n) {           // it is written by this fill
    if (j >= live_rows) {
      base[j] = -1;
      ckeys[j] = kDeadKey;
    }
  }
}

__global__ void seed_gather_kernel(const int32_t* __restrict__ base,
                                   const int64_t* __restrict__ perm,
                                   int64_t n, int32_t* __restrict__ s_rows) {
  SAGE2_GRID_STRIDE(i, n) { s_rows[i] = base[perm[i]]; }
}

}  // namespace

// reads2: (M, L) int32 codes; valid2: (M,) bool; lengths: (M,) int32 or
// NULL; rows t0 .. t0 + Rw - 1 of each read are built (all: 0, R; the
// entries: 0, g; the queries: g, n_pos); keys (M * Rw,) int64, live
// (M * Rw,) uint8 and payload (M, Rw, Wt + 2) int32 out, R = g + n_pos,
// Wt = ceil((L - g) / 16) - trim.
SAGE2_EXPORT int sage2_seed_rows(const void* reads2, const void* valid2,
                                 const void* lengths, int64_t M, int L, int s,
                                 int g, int n_pos, int trim, int t0, int Rw,
                                 void* keys, void* live, void* payload,
                                 void* stream) {
  const int W = (L + 15) / 16;
  int64_t blocks = (M + kRowWarps - 1) / kRowWarps;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;
  if (blocks < 1) blocks = 1;
  seed_rows_kernel<<<static_cast<int>(blocks), kThreads,
                     kRowWarps * W * sizeof(uint32_t),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(reads2), static_cast<const bool*>(valid2),
      static_cast<const int32_t*>(lengths), M, L, s, g, n_pos, trim, t0, Rw,
      static_cast<int64_t*>(keys), static_cast<uint8_t*>(live),
      static_cast<int32_t*>(payload));
  return static_cast<int>(cudaGetLastError());
}

// tile_counts: the live rows of each tile of the tie order (scan.cuh).
SAGE2_EXPORT int sage2_seed_count(const void* live, int64_t M, int g,
                                  int n_pos, int Rw, void* tile_counts,
                                  void* stream) {
  seed_count_kernel<<<scan_tiles_of(M * Rw), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(live), M, g, n_pos, Rw,
      static_cast<int64_t*>(tile_counts));
  return static_cast<int>(cudaGetLastError());
}

// tile_offsets: the scanned tile counts; base (int32 global ids, (id_base
// + read) * R + t) and ckeys (int64 keys) get the live rows in the tie
// order.
SAGE2_EXPORT int sage2_seed_compact(const void* live, const void* keys,
                                    int64_t M, int g, int n_pos, int t0,
                                    int Rw, int64_t id_base,
                                    const void* tile_offsets, void* base,
                                    void* ckeys, void* stream) {
  seed_compact_kernel<<<scan_tiles_of(M * Rw), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(live), static_cast<const int64_t*>(keys),
      M, g, n_pos, t0, Rw, id_base,
      static_cast<const int64_t*>(tile_offsets), nullptr,
      static_cast<int32_t*>(base), static_cast<int64_t*>(ckeys));
  return static_cast<int>(cudaGetLastError());
}

// The fixed-capacity mode of every row of each read (t0 0, Rw R, id_base
// 0): as sage2_seed_compact, then the slots from n_live (the scan's
// total) to M * R get dead rows, id -1 and key INT64_MAX.
SAGE2_EXPORT int sage2_seed_compact_fixed(const void* live, const void* keys,
                                          int64_t M, int g, int n_pos,
                                          const void* tile_offsets,
                                          const void* n_live, void* base,
                                          void* ckeys, void* stream) {
  const int R = g + n_pos;
  seed_compact_kernel<<<scan_tiles_of(M * R), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(live), static_cast<const int64_t*>(keys),
      M, g, n_pos, 0, R, 0, static_cast<const int64_t*>(tile_offsets),
      static_cast<const int64_t*>(n_live), static_cast<int32_t*>(base),
      static_cast<int64_t*>(ckeys));
  return static_cast<int>(cudaGetLastError());
}

// s_rows[i] = base[perm[i]] for the n live rows (perm int64, the sort's).
SAGE2_EXPORT int sage2_seed_gather(const void* base, const void* perm,
                                   int64_t n, void* s_rows, void* stream) {
  seed_gather_kernel<<<sage2_blocks(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(base), static_cast<const int64_t*>(perm),
      n, static_cast<int32_t*>(s_rows));
  return static_cast<int>(cudaGetLastError());
}
