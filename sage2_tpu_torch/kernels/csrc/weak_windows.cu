// K16: the flat indices of the weak windows of a correction sub-pass.
//
// Replaces sage2_tpu/kmer/correct.py _phase1_kernel (:270), phase 1 of
// the two-phase single_window corrector: the forward, RC and canonical
// keys of every window (three (N, P) key arrays), a lookup of every
// canonical key in the pruned count table, the weak mask (count below
// the threshold; for ragged reads only windows inside the read, :279-280)
// and a sort that moved the weak windows' flat indices to the front. At
// phase 4 of chip_smoke.py (2.3 M reads of 100, k = 25) the three key
// arrays alone were 1.4 GB each; here no key leaves the SM.
//
// A window is weak where its canonical key counts below the threshold,
// that is where the key is not among the table's solid keys (count at
// least the threshold): a lookup needs membership, not a count. Once a
// round (kernels.table_directory, beside K2's bucket directory, which
// K17 reads only to settle its ties) three launches build a membership
// table of the solid keys of k-mers of B = 2k bits:
//
//   layout  2^bits buckets of one 32-byte sector (solid_table.cuh, which
//           K17 shares); bits puts about 3-6 keys in a bucket
//           (kernels.solid_bits). Mixing the keys first spreads the
//           canonical keys, whose density falls from twice the mean at the
//           low end of their span to zero at its top, evenly over the
//           buckets.
//   build   solid count: each solid key's bucket counted (atomics);
//           solid links: each overfull bucket's list allocated (atomics
//           on one cursor); solid place: each solid key into its bucket
//           or its list. Keys outside [0, 2^B) can match no window and
//           are left out. The table's first words say for which k and
//           threshold it was built: a call with others looks up through
//           K2's directory, as does a call without the table.
//
// Two launches a call, over tiles of kTileReads = 128 reads (one warp
// takes kReadsPerWarp of them, one at a time), in ticket order:
//
//   mask   the lanes load the read's codes into shared memory (coalesced)
//          and pack the read and its reverse complement into 16-base words
//          (big-endian, as K13 packs); window w's forward key is then the
//          2k bits of the read's words at base w, its RC key those of the
//          RC read's words at base L - k - w (two shifts a word, no rolling),
//          so lane l can take windows l, l + 32, ...: four words of windows
//          a round, their canonical keys looked up together: one sector of
//          the membership table each (an overfull bucket's list beside it
//          where the key is not among its seven), or through K2's
//          directory (bucket_search.cuh). A ballot of the weak verdicts is
//          one 32-window word of the read's weak mask; the tile's weak
//          windows are counted and a decoupled look-back (lookback.cuh,
//          128 tiles a round trip: with 32-read tiles the look-back's
//          chain, not the lookups, bounded the launch) gives each tile
//          its first slot, and the last the total, which the wrapper
//          reads once to size the output;
//   write  each block recounts its reads' weak windows from their masks,
//          scans them, and each warp writes its read's weak windows'
//          flat indices r * P + w in ascending order (a warp scan of the
//          mask words' popcounts gives each word its first slot).
//
// Bound: lookups, random sectors of L2 (one a window, 32 MB of buckets
// at phase 4's ~5 M solid keys); the reads (4 bytes a base), the mask
// (one bit a window, twice) and the indices (8 bytes a weak window) are
// the bytes.

#include "bucket_search.cuh"
#include "lookback.cuh"
#include "solid_table.cuh"

namespace {

constexpr int kWarpsPerTile = kThreads / 32;
constexpr int kReadsPerWarp = 16;
constexpr int kTileReads = kWarpsPerTile * kReadsPerWarp;
constexpr int kBatch = 4;     // mask words (32 windows each) a round
constexpr unsigned kFullMask = 0xffffffffu;

// one warp: the codes of a read into shared memory, then its words and
// its reverse complement's words (codes 3 - read[L - 1 - i])
__device__ __forceinline__ void pack_read(const int32_t* __restrict__ read,
                                          int L, int W, int lane,
                                          uint8_t* code, uint32_t* fw,
                                          uint32_t* rw) {
  for (int p = lane; p < L; p += 32) {
    code[p] = static_cast<uint8_t>(__ldcs(read + p));
  }
  __syncwarp();
  for (int t = lane; t < W; t += 32) pack_word(code, L, t, fw + t, rw + t);
  __syncwarp();
}

// The weak verdicts of C canonical keys by their counts through K2's
// bucket directory: Keys is Int64Keys or PackedKeys (bucket_search.cuh).
template <typename Keys>
struct CountLookup {
  Keys keys;
  const int32_t* __restrict__ dir;
  BucketSpan span;
  int threshold;

  template <int C>
  __device__ __forceinline__ void weak(const int64_t (&q)[C],
                                       const bool (&live)[C],
                                       bool (&out)[C]) const {
    int32_t pos[C];
    bucket_find<C>(keys, dir, span, q, live, pos);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      out[c] = live[c] && (pos[c] >= 0 ? keys.count(pos[c]) : 0) < threshold;
    }
  }
};

// Look-back words of the mask launch (int64): [0] the ticket, then one
// status word a tile (zeroed by the launcher).
template <typename Lookup>
__device__ __forceinline__ void mask_tile(
    const Lookup& lookup, const int32_t* __restrict__ reads,
    const int32_t* __restrict__ lengths, int64_t N, int L, int k,
    uint32_t* __restrict__ mask, int64_t* __restrict__ tile_offsets,
    int64_t* __restrict__ total, int64_t* __restrict__ scan) {
  extern __shared__ uint32_t smem[];
  __shared__ int tile_weak;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = (L + 15) / 16;
  const int P = L - k + 1;
  const int PW = (P + 31) / 32;
  uint32_t* fw = smem + warp * (2 * W + (L + 3) / 4);
  uint32_t* rw = fw + W;
  uint8_t* code = reinterpret_cast<uint8_t*>(rw + W);
  const int64_t tile =
      lookback::block_ticket(reinterpret_cast<unsigned*>(scan));
  if (threadIdx.x == 0) tile_weak = 0;
  __syncthreads();
  int n_weak = 0;
  for (int i = 0; i < kReadsPerWarp; ++i) {
    const int64_t r = tile * kTileReads + warp * kReadsPerWarp + i;
    if (r >= N) break;
    const int len = lengths == nullptr ? L : __ldg(lengths + r);
    const int Pv = len - k + 1 < P ? (len - k + 1 > 0 ? len - k + 1 : 0) : P;
    pack_read(reads + r * L, L, W, lane, code, fw, rw);
    for (int j0 = 0; j0 < PW; j0 += kBatch) {
      int64_t q[kBatch];
      bool live[kBatch], weak[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int w = 32 * (j0 + b) + lane;
        live[b] = w < Pv;
        q[b] = 0;
        if (live[b]) {
          const int64_t f = key_at(fw, W, w, k);
          const int64_t c = key_at(rw, W, L - k - w, k);
          q[b] = c < f ? c : f;
        }
      }
      lookup.template weak<kBatch>(q, live, weak);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const uint32_t bits = __ballot_sync(kFullMask, weak[b]);
        if (j0 + b < PW) {
          if (lane == 0) mask[r * PW + j0 + b] = bits;
          n_weak += __popc(bits);
        }
      }
    }
    __syncwarp();       // the next read overwrites the codes and words
  }
  if (lane == 0) atomicAdd(&tile_weak, n_weak);
  __syncthreads();
  const uint64_t before = lookback::tile_prefix<4>(
      reinterpret_cast<unsigned long long*>(scan + 1), tile, tile_weak);
  if (threadIdx.x == 0) {
    tile_offsets[tile] = static_cast<int64_t>(before);
    if (tile == gridDim.x - 1)
      *total = static_cast<int64_t>(before) + tile_weak;
  }
}

// solid: the membership table (its header first) or NULL; it is used
// where it was built for this k and threshold (uniform over the grid).
__global__ void __launch_bounds__(kThreads)
    weak_mask_kernel(const int32_t* __restrict__ reads,
                     const int32_t* __restrict__ lengths, int64_t N, int L,
                     int k, const int64_t* __restrict__ table,
                     const int32_t* __restrict__ counts, int64_t T,
                     const int64_t* __restrict__ scratch,
                     const int64_t* __restrict__ solid, int threshold,
                     uint32_t* __restrict__ mask,
                     int64_t* __restrict__ tile_offsets,
                     int64_t* __restrict__ total,
                     int64_t* __restrict__ scan) {
  SolidLookup members;
  if (solid_lookup(solid, k, threshold, &members)) {
    mask_tile(members, reads, lengths, N, L, k, mask, tile_offsets, total,
              scan);
    return;
  }
  const BucketSpan span = load_span(scratch);
  const int32_t* dir = dir_of(scratch, T);
  if (ldg_key(scratch + 3)) {         // packed (uniform over the grid)
    const CountLookup<PackedKeys> lookup{
        PackedKeys{packed_of(scratch), suffix_mask(span.shift)}, dir, span,
        threshold};
    mask_tile(lookup, reads, lengths, N, L, k, mask, tile_offsets, total,
              scan);
  } else {
    const CountLookup<Int64Keys> lookup{Int64Keys{table, counts}, dir, span,
                                        threshold};
    mask_tile(lookup, reads, lengths, N, L, k, mask, tile_offsets, total,
              scan);
  }
}

// Inclusive warp scan of x.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
    weak_write_kernel(const uint32_t* __restrict__ mask, int64_t N, int P,
                      const int64_t* __restrict__ tile_offsets,
                      int64_t* __restrict__ out) {
  __shared__ int read_first[kTileReads];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int PW = (P + 31) / 32;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTileReads;
  // each warp counts its reads' weak windows
  for (int i = 0; i < kReadsPerWarp; ++i) {
    const int t = warp * kReadsPerWarp + i;
    int n = 0;
    if (r0 + t < N) {
      for (int j = lane; j < PW; j += 32) n += __popc(mask[(r0 + t) * PW + j]);
    }
    for (int d = 16; d > 0; d >>= 1) n += __shfl_xor_sync(kFullMask, n, d);
    if (lane == 0) read_first[t] = n;
  }
  __syncthreads();
  if (warp == 0) {    // the tile's reads in order: their first slots
    constexpr int kPerLane = kTileReads / 32;
    int n[kPerLane], sum = 0;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      n[i] = read_first[lane * kPerLane + i];
      sum += n[i];
    }
    int run = warp_scan(sum, lane) - sum;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      read_first[lane * kPerLane + i] = run;
      run += n[i];
    }
  }
  __syncthreads();
  const int64_t tile0 = tile_offsets[blockIdx.x];
  for (int i = 0; i < kReadsPerWarp; ++i) {
    const int t = warp * kReadsPerWarp + i;
    const int64_t r = r0 + t;
    if (r >= N) break;
    int64_t slot = tile0 + read_first[t];
    for (int j0 = 0; j0 < PW; j0 += 32) {
      const int j = j0 + lane;
      uint32_t bits = j < PW ? mask[r * PW + j] : 0u;
      const int n = __popc(bits);
      const int incl = warp_scan(n, lane);
      int64_t s = slot + incl - n;
      while (bits) {
        const int b = __ffs(bits) - 1;
        out[s++] = r * P + 32 * j + b;
        bits &= bits - 1;
      }
      slot += __shfl_sync(kFullMask, incl, 31);
    }
  }
}

static inline int64_t weak_tiles(int64_t N) {
  const int64_t t = (N + kTileReads - 1) / kTileReads;
  return t < 1 ? 1 : t;
}

// --- the membership table's build ------------------------------------------

struct SolidBuild {
  const int64_t* __restrict__ table;
  const int32_t* __restrict__ counts;
  int64_t T;
  int B, bits, threshold;

  // the bucket and the kept bits of entry i, or false where it is not a
  // solid key of [0, 2^B)
  __device__ __forceinline__ bool at(int64_t i, uint64_t* bucket,
                                     uint32_t* v) const {
    const int64_t key = ldg_key(table + i);
    if (__ldg(counts + i) < threshold || key < 0 ||
        static_cast<uint64_t>(key) >> B != 0)
      return false;
    const uint64_t h = solid_mix(static_cast<uint64_t>(key), B);
    *bucket = h >> (B - bits);
    *v = static_cast<uint32_t>(h & ((uint64_t{1} << (B - bits)) - 1));
    return true;
  }
};

__global__ void __launch_bounds__(kThreads)
    solid_count_kernel(SolidBuild sb, int k, int64_t* __restrict__ solid,
                       uint32_t* __restrict__ fill) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    solid[0] = 1;
    solid[1] = k;
    solid[2] = sb.threshold;
    solid[3] = sb.bits;
  }
  SAGE2_GRID_STRIDE(i, sb.T) {
    uint64_t b;
    uint32_t v;
    if (sb.at(i, &b, &v)) atomicAdd(fill + b, 1u);
  }
}

// An overfull bucket's list: its length, then its keys past the seventh.
__global__ void __launch_bounds__(kThreads)
    solid_links_kernel(const uint32_t* __restrict__ fill, int64_t nb,
                       uint32_t* __restrict__ link, uint32_t* __restrict__ top) {
  SAGE2_GRID_STRIDE(b, nb) {
    const uint32_t c = fill[b];
    if (c > kWays) link[b] = atomicAdd(top, c - (kWays - 2));
  }
}

__global__ void __launch_bounds__(kThreads)
    solid_place_kernel(SolidBuild sb, const uint32_t* __restrict__ fill,
                       const uint32_t* __restrict__ link,
                       uint32_t* __restrict__ cursor,
                       uint32_t* __restrict__ buckets,
                       uint32_t* __restrict__ lists) {
  SAGE2_GRID_STRIDE(i, sb.T) {
    uint64_t b;
    uint32_t v;
    if (!sb.at(i, &b, &v)) continue;
    const uint32_t slot = atomicAdd(cursor + b, 1u);
    const uint32_t c = fill[b];
    if (c <= kWays || slot < kWays - 1) {
      buckets[b * kWays + slot] = v;
      continue;
    }
    const uint32_t off = link[b];
    lists[off + 1 + slot - (kWays - 1)] = v;
    if (slot == kWays - 1) {
      buckets[b * kWays + kWays - 1] = kLink | off;
      lists[off] = c - (kWays - 1);
    }
  }
}

}  // namespace

// table: (T,) sorted unique int64 keys, counts (T,) int32; solid: the
// membership table's int64 words (kernels.solid_words: the header,
// 2^bits buckets of four words, the lists' (T + 2) / 2); work: (3 *
// 2^bits + 1,) uint32, zeroed here. Three launches: count, links, place.
SAGE2_EXPORT int sage2_solid_table(const void* table, const void* counts,
                                   int64_t T, int k, int threshold, int bits,
                                   void* solid, void* work, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t nb = int64_t{1} << bits;
  auto* words = static_cast<int64_t*>(solid);
  auto* buckets = reinterpret_cast<uint32_t*>(words + kSolidHeader);
  auto* fill = static_cast<uint32_t*>(work);
  uint32_t* link = fill + nb;
  uint32_t* cursor = link + nb;
  uint32_t* top = cursor + nb;
  cudaError_t rc = cudaMemsetAsync(buckets, 0xff, nb * kWays * 4, s);
  if (rc == cudaSuccess) rc = cudaMemsetAsync(fill, 0, nb * 4, s);
  if (rc == cudaSuccess) rc = cudaMemsetAsync(cursor, 0, (nb + 1) * 4, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const SolidBuild sb{static_cast<const int64_t*>(table),
                      static_cast<const int32_t*>(counts), T, 2 * k, bits,
                      threshold};
  solid_count_kernel<<<sage2_blocks(T), kThreads, 0, s>>>(sb, k, words, fill);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  solid_links_kernel<<<sage2_blocks(nb), kThreads, 0, s>>>(fill, nb, link,
                                                           top);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  solid_place_kernel<<<sage2_blocks(T), kThreads, 0, s>>>(
      sb, fill, link, cursor, buckets, buckets + nb * kWays);
  return static_cast<int>(cudaGetLastError());
}

// reads: (N, L) int32 codes 0-3; lengths: (N,) int32 or NULL; table: (T,)
// sorted unique int64 canonical keys (1 < k <= 31), counts (T,) int32,
// scratch: their bucket directory (bucket_search.cuh, built by
// sage2_lookup_directory); solid: the membership table
// (sage2_solid_table) or NULL; mask: (N, ceil(P / 32)) uint32 out, bit
// w % 32 of word w / 32 set where window w is weak; scan: (2 tiles + 2,)
// int64, tiles = max(1, ceil(N / kTileReads)): each tile's first slot
// out, the total out, then the ticket and the look-back's status words
// (zeroed here).
SAGE2_EXPORT int sage2_weak_mask(const void* reads, const void* lengths,
                                 int64_t N, int L, int k, const void* table,
                                 const void* counts, int64_t T,
                                 const void* scratch, const void* solid,
                                 int threshold, void* mask, void* scan,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = weak_tiles(N);
  auto* words = static_cast<int64_t*>(scan);
  const cudaError_t rc =
      cudaMemsetAsync(words + tiles + 1, 0, (tiles + 1) * 8, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int W = (L + 15) / 16;
  const size_t smem =
      kWarpsPerTile * (2 * W + (L + 3) / 4) * sizeof(uint32_t);
  weak_mask_kernel<<<static_cast<unsigned>(tiles), kThreads, smem, s>>>(
      static_cast<const int32_t*>(reads),
      static_cast<const int32_t*>(lengths), N, L, k,
      static_cast<const int64_t*>(table), static_cast<const int32_t*>(counts),
      T, static_cast<const int64_t*>(scratch),
      static_cast<const int64_t*>(solid), threshold,
      static_cast<uint32_t*>(mask), words, words + tiles, words + tiles + 1);
  return static_cast<int>(cudaGetLastError());
}

// mask: sage2_weak_mask's; tile_offsets: its scan's first words; out:
// (n_weak,) int64, the weak windows' flat indices r * P + w, ascending.
SAGE2_EXPORT int sage2_weak_write(const void* mask, int64_t N, int P,
                                  const void* tile_offsets, void* out,
                                  void* stream) {
  weak_write_kernel<<<static_cast<unsigned>(weak_tiles(N)), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mask), N, P,
      static_cast<const int64_t*>(tile_offsets), static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
