// K15: the solid entries of a sorted k-mer count table, in table order.
//
// Replaces sage2_tpu/kmer/correct.py _prune_impl (:246), jitted once a
// correction round: a masked (hi, lo) sort of the whole table that moved
// the entries with count >= threshold to the front, and a host read of
// their number. The table is sorted already, so the kept entries need no
// sort, only a compaction in table order, here in one launch:
//
//   a block takes a tile of kTile consecutive entries in ticket order and
//   loads its counts and keys by 16-byte loads (four entries a unit, the
//   units of a tile striped over the threads, so a warp's loads of a unit
//   are consecutive); one block scan of the kept flags gives each kept
//   entry its slot in the tile, where its key and count are staged in
//   shared memory; a decoupled look-back (lookback.cuh, a window of 32
//   tiles a round trip) gives the tile its first output slot, the tile's
//   kept entries go out by coalesced stores, and the last tile writes the
//   total to a device scalar, which the wrapper reads once, after the
//   launch. The outputs are buffers of T entries.
//
// Bound: bytes. Every key and count is read once (12 bytes an entry) and
// each kept entry written once (12 bytes). What holds the launch above it
// is the look-back: a tile's first slot needs every earlier tile's count,
// so each block waits a round trip to L2 or more, under the card's full
// load, before its stores, holding the registers and shared memory that
// the next tiles' loads would use (scripts/probe_prune_heads_ab.py: the
// same launch without the look-back runs at about 2.8 TB/s). So the tiles
// are large (4,096 entries: half the look-backs of 2,048) and four blocks
// fit an SM (64 registers a thread, the staging in 48 KiB of shared
// memory); wider windows, a ring of stages in persistent blocks and keys
// copied to shared memory were slower on the card.

#include "lookback.cuh"
#include "scan.cuh"

namespace {

constexpr int kUnits = 4;                         // 4-entry units a thread
constexpr int kTile = kThreads * 4 * kUnits;      // entries a tile
constexpr int kSmem = kTile * 12;        // the kept keys, then counts

// words: [0] the ticket, [1] the total, then a look-back status word a
// tile, all zeroed by the launcher. vec: keys and counts 16-byte aligned.
__global__ void __launch_bounds__(kThreads, 4)
    prune_kernel(const int64_t* __restrict__ keys,
                 const int32_t* __restrict__ counts, int64_t T,
                 int threshold, bool vec, int64_t* __restrict__ keys_out,
                 int32_t* __restrict__ counts_out,
                 int64_t* __restrict__ words) {
  static_assert(kUnits <= 4 && kThreads * 4 < (1 << 16), "packed scan");
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_keys = reinterpret_cast<int64_t*>(smem);
  int32_t* s_counts = reinterpret_cast<int32_t*>(s_keys + kTile);
  const int64_t tile =
      lookback::block_ticket(reinterpret_cast<unsigned*>(words));
  const int64_t t0 = tile * kTile;
  int32_t c[kUnits][4];
  int64_t k[kUnits][4];
  bool keep[kUnits][4];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int64_t i = t0 + 4 * (u * kThreads + threadIdx.x);
    if (vec && i + 4 <= T) {
      const int4 cv = __ldcs(reinterpret_cast<const int4*>(counts + i));
      // the unit's 32 bytes of keys: two loads, each of a half of the
      // warp's sectors; the second finds its sectors in L1
      const longlong2* k2 = reinterpret_cast<const longlong2*>(keys + i);
      const longlong2 k0 = __ldg(k2), k1 = __ldg(k2 + 1);
      c[u][0] = cv.x; c[u][1] = cv.y; c[u][2] = cv.z; c[u][3] = cv.w;
      k[u][0] = k0.x; k[u][1] = k0.y; k[u][2] = k1.x; k[u][3] = k1.y;
#pragma unroll
      for (int q = 0; q < 4; ++q) keep[u][q] = c[u][q] >= threshold;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = i + q < T;
        c[u][q] = in ? __ldcs(counts + i + q) : 0;
        k[u][q] = in ? __ldg(reinterpret_cast<const long long*>(keys) + i + q)
                   : 0;
        keep[u][q] = in && c[u][q] >= threshold;
      }
    }
  }
  // Each kept entry's slot in the tile. The tile is striped: unit u of
  // every thread comes before unit u + 1 of any, so one block scan of the
  // units' counts packed in 16-bit fields (unit u's at bit 16 u) gives
  // every unit's offsets, and its total every unit's total.
  uint64_t packed = 0;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    int n = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) n += keep[u][q];
    packed |= static_cast<uint64_t>(n) << (16 * u);
  }
  uint64_t packed_total;
  const uint64_t before_me =
      block_exclusive_scan<uint64_t>(packed, &packed_total);
  int slot[kUnits];
  int tile_kept = 0;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    slot[u] = tile_kept + static_cast<int>((before_me >> (16 * u)) & 0xffff);
    tile_kept += static_cast<int>((packed_total >> (16 * u)) & 0xffff);
  }
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (keep[u][q]) {
        s_keys[slot[u]] = k[u][q];
        s_counts[slot[u]] = c[u][q];
        ++slot[u];
      }
    }
  }
  // the look-back's barrier also publishes the staged entries to the block
  const int64_t before = static_cast<int64_t>(lookback::tile_prefix(
      reinterpret_cast<unsigned long long*>(words + 2), tile,
      static_cast<uint64_t>(tile_kept)));
  for (int s = threadIdx.x; s < tile_kept; s += kThreads) {
    keys_out[before + s] = s_keys[s];
    counts_out[before + s] = s_counts[s];
  }
  if (threadIdx.x == 0 && tile == gridDim.x - 1) {
    words[1] = before + tile_kept;
  }
}

}  // namespace

// *tile (a host int64): the entries a tile, kTile, which sizes the
// launcher's words.
SAGE2_EXPORT int sage2_prune_tile(void* tile) {
  *static_cast<int64_t*>(tile) = kTile;
  return 0;
}

// keys: (T,) int64 and counts: (T,) int32, the sorted table, T >= 1;
// keys_out, counts_out: (T,) outputs, the kept entries first; words:
// (2 + ceil(T / kTile),) int64 scratch (sage2_prune_tile), zeroed here;
// words[1] gets the number of kept entries.
SAGE2_EXPORT int sage2_prune_table(const void* keys, const void* counts,
                                   int64_t T, int threshold, void* keys_out,
                                   void* counts_out, void* words,
                                   void* stream) {
  static int device = -1;
  const auto s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev != device) {    // the staging is past 48 KiB with the rest
    rc = cudaFuncSetAttribute(prune_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    device = dev;
  }
  const int64_t tiles = (T + kTile - 1) / kTile;
  rc = cudaMemsetAsync(words, 0, (tiles + 2) * 8, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const bool vec = (reinterpret_cast<uintptr_t>(keys) |
                    reinterpret_cast<uintptr_t>(counts)) % 16 == 0;
  prune_kernel<<<static_cast<unsigned>(tiles), kThreads, kSmem, s>>>(
      static_cast<const int64_t*>(keys), static_cast<const int32_t*>(counts),
      T, threshold, vec, static_cast<int64_t*>(keys_out),
      static_cast<int32_t*>(counts_out), static_cast<int64_t*>(words));
  return static_cast<int>(cudaGetLastError());
}
