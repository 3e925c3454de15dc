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
//            len] written as consecutive int32 across the lanes. For the
//            sorted kinds the launch also counts the live rows' coarse
//            buckets (the unflipped key's top bits; bucket_sort.cuh), and
//            a prior slab's.
//   scan     bucket_sort.cuh's look-back scan of the bucket counts.
//   scatter  two passes (bucket_sort.cuh: coarse, then fine buckets):
//            each live row, read in read order (coalesced), goes to its
//            bucket as a 16-byte element (key unflipped, tag << 32 | id).
//            The reference's tie order (detect.py:681-683:
//            entries tag 0, queries 0x80000000, then by id) makes (key,
//            tag | id) unique, so sorting it in any order gives the order
//            the stable sort of the compacted keys gave: no compaction
//            pass, no permutation, no gather. A prior slab's row j (an
//            entry) takes the tag j, below every query of the chunk, so
//            [slab + chunk] sorts as the stable sort of their
//            concatenation did, whatever the slab's order.
//   big      one cooperative launch sorts the buckets past a block
//            (poly-A seeds; bucket_sort.cuh), its last merge round
//            writing their keys and ids.
//   sort     a block a bucket sorts it (bucket_sort.cuh; four blocks an
//            SM, at most 64 registers: 3.37 against 3.95 ms with three on
//            an H100) and writes its keys (flipped back) and ids at the
//            bucket's slots.
//
// The streamed join (sage2_tpu/stream.py:835-887, _ragged_entry_kernel
// and _ragged_join_kernel) builds the rows of a chunk of reads with
// global ids, (id_base + m) * R + t: the entry rows alone (t < g) for
// its entry slab, or the query rows alone (t >= g) of a query chunk.
// Then the rows kernel builds only the chosen rows, and the payload holds
// only theirs ((M, g) or (M, n_pos) rows). An entry slab stays unsorted,
// its live rows in id order: the rows launch, then one compaction pass
// in read order with a decoupled look-back over its tiles (a ticket a
// block; a warp's rows consecutive, ranked by ballots).
//
// The fixed-capacity mode (find_overlaps_stacked, detect.py:1108) keeps
// the live count on the card: the sort's blocks also fill the slots from
// the live count to M * R with dead rows (key INT64_MAX, id -1). A live
// all-T seed has the key INT64_MAX too; its rows sort last among the live
// rows, by tag | id, and the dead rows follow them.
//
// Bound: bytes. The codes are read once; the payload (Wt + 2 words a
// row) and the live rows' keys and ids written once; the keys, flags and
// bucketed elements between the passes are the rest.

#include "bucket_sort.cuh"

namespace {

using bsort::K128;

constexpr int kWarp = 32;
constexpr int kRowWarps = kThreads / kWarp;
constexpr int64_t kDeadKey = 0x7FFFFFFFFFFFFFFFll;  // INT64_MAX
constexpr uint64_t kSign = uint64_t{1} << 63;
constexpr uint32_t kQueryTag = 0x80000000u;
// rows a thread, and a tile, of the entry slab's compaction
constexpr int kCompactItems = 8;
constexpr int kCompactTile = kThreads * kCompactItems;

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

// the bucket of a stored (top-bit-flipped) key: the unflipped key's top d
// bits
__device__ __forceinline__ unsigned seed_bucket(int64_t key, int d) {
  const uint64_t u = static_cast<uint64_t>(key) ^ kSign;
  return d == 0 ? 0u : static_cast<unsigned>(u >> (64 - d));
}

// the global id of built row i < 2^31 (read i / Rw, row t0 + i % Rw)
__device__ __forceinline__ int64_t row_id(int64_t i, int Rw, int t0, int R,
                                          int64_t id_base) {
  const uint32_t u = static_cast<uint32_t>(i), w = static_cast<uint32_t>(Rw);
  return (id_base + u / w) * R + t0 + u % w;
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    seed_rows_kernel(const int32_t* __restrict__ reads2,
                     const bool* __restrict__ valid2,
                     const int32_t* __restrict__ lengths, int64_t M, int L,
                     int s, int g, int n_pos, int trim, int t0, int Rw,
                     int64_t* __restrict__ keys, uint8_t* __restrict__ live,
                     int32_t* __restrict__ payload,
                     const int64_t* __restrict__ prior_keys, int64_t n_prior,
                     int64_t* scratch, int d) {
  extern __shared__ uint32_t smem[];
  __shared__ unsigned hist[1 << bsort::kCoarseBits];
  const int W = (L + 15) / 16;
  const int Wt = (L - g + 15) / 16 - trim;
  const int cols = Wt + 2;
  const int lane = threadIdx.x % kWarp;
  const int dc = bsort::coarse_bits(d);
  if (kCount) {
    for (int b = threadIdx.x; b < (1 << dc); b += kThreads) hist[b] = 0;
    __syncthreads();
  }
  uint32_t* words = smem + (threadIdx.x / kWarp) * W;
  const int64_t warp0 = blockIdx.x * int64_t{kRowWarps} + threadIdx.x / kWarp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kRowWarps;
  for (int64_t m = warp0; m < M; m += warps) {
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
      const int64_t key = static_cast<int64_t>(
          (static_cast<uint64_t>(hi ^ 0x80000000u) << 32) | lo);
      const bool on = valid && (lengths == nullptr || pos + s <= len);
      keys[m * Rw + i] = key;
      live[m * Rw + i] = on;
      if (kCount && on) atomicAdd(&hist[seed_bucket(key, dc)], 1u);
    }
    __syncwarp();
  }
  if (!kCount) return;
  // the prior slab's rows join the chunk's in the sort
  for (int64_t j = blockIdx.x * int64_t{kThreads} + threadIdx.x; j < n_prior;
       j += static_cast<int64_t>(gridDim.x) * kThreads) {
    atomicAdd(&hist[seed_bucket(prior_keys[j], dc)], 1u);
  }
  bsort::flush_coarse(hist, bsort::scratch_of(scratch, d));
}

// The sorted kinds' items for bucket_sort.cuh's passes: built row i < n
// (kept when live) or the prior slab's row i - n, its element (key
// unflipped, tag << 32 | id); the fine bucket the key's top d bits.
struct SeedSource {
  const int64_t* keys;
  const uint8_t* live;
  int64_t n;
  int g, R, t0, Rw;
  int64_t id_base;
  const int64_t* prior_keys;
  const int32_t* prior_ids;
  int d;

  __device__ __forceinline__ int64_t key_of(int64_t i) const {
    return i < n ? __ldg(keys + i) : __ldg(prior_keys + (i - n));
  }

  __device__ __forceinline__ bool probe(int64_t i, unsigned* f) const {
    const bool on = i >= n || __ldg(live + i) != 0;
    *f = fine_of(static_cast<uint64_t>(key_of(i)) ^ kSign);
    return on;
  }

  __device__ __forceinline__ K128 make(int64_t i) const {
    const int64_t key = key_of(i);
    uint32_t tag, id;
    if (i < n) {
      const uint32_t u = static_cast<uint32_t>(i);
      const uint32_t m = u / static_cast<uint32_t>(Rw);
      const int t = t0 + static_cast<int>(u - m * static_cast<uint32_t>(Rw));
      id = static_cast<uint32_t>((id_base + m) * R + t);
      tag = (t >= g ? kQueryTag : 0u) | id;
    } else {
      const int64_t j = i - n;
      id = static_cast<uint32_t>(__ldg(prior_ids + j));
      tag = static_cast<uint32_t>(j);
    }
    return {static_cast<uint64_t>(key) ^ kSign,
            (static_cast<uint64_t>(tag) << 32) | id};
  }

  __device__ __forceinline__ unsigned fine_of(uint64_t u) const {
    return d == 0 ? 0u : static_cast<unsigned>(u >> (64 - d));
  }

  __device__ __forceinline__ unsigned fine(const K128& e) const {
    return fine_of(e.hi);
  }
};

// The big buckets' launch (cooperative; in tmp, pass 2's buckets; elems
// as many elements of scratch; n_cap the most rows, as the scratch was
// sized): the buckets past a block sorted by the whole grid, their keys
// (flipped back) and ids written by the last merge round.
__global__ void __launch_bounds__(kThreads, 4)
    seed_big_kernel(K128* elems, K128* tmp, int64_t* scratch, int d,
                    int64_t n_cap, int64_t* __restrict__ s_keys,
                    int32_t* __restrict__ s_rows) {
  constexpr int E = bsort::kItems;
  bsort::sort_big_buckets<K128>(
      tmp, elems, scratch, d, n_cap,
      [=](int64_t, int64_t off, int64_t n, int64_t base, const K128 (&v)[E],
          const K128&) {
#pragma unroll
        for (int k = 0; k < E; ++k) {
          if (base + k < n) {
            s_keys[off + base + k] = static_cast<int64_t>(v[k].hi ^ kSign);
            s_rows[off + base + k] =
                static_cast<int32_t>(static_cast<uint32_t>(v[k].lo));
          }
        }
      });
}

// A block a bucket that fits a block (in tmp, pass 2's): sorted, its keys
// (flipped back) and ids written at its slots; with fill_to, every block
// also fills the slots from the live count to fill_to with dead rows.
__global__ void __launch_bounds__(kThreads, 4)
    seed_sort_kernel(const K128* tmp, int64_t* scratch, int d,
                     int64_t fill_to, int64_t* __restrict__ s_keys,
                     int32_t* __restrict__ s_rows) {
  constexpr int E = bsort::kItems;
  extern __shared__ __align__(16) unsigned char s_raw[];
  K128* s_elems = reinterpret_cast<K128*>(s_raw);
  const bsort::Scratch sc = bsort::scratch_of(scratch, d);
  const int64_t b = blockIdx.x;
  if (b < sc.nb) {
    const int64_t off = sc.fine_off[b];
    const int64_t n = sc.fine_off[b + 1] - off;
    if (n <= bsort::kBlock) {   // else sorted and written by the big launch
      bsort::count_sort<K128, E>(s_elems, tmp + off, static_cast<int>(n));
      const bsort::Padded<K128, E> v{s_elems};
      for (int64_t i = threadIdx.x; i < n; i += kThreads) {
        const K128 e = v[i];
        s_keys[off + i] = static_cast<int64_t>(e.hi ^ kSign);
        s_rows[off + i] = static_cast<int32_t>(static_cast<uint32_t>(e.lo));
      }
    }
  }
  if (fill_to == 0) return;
  const int64_t live_rows = *sc.total;
  for (int64_t j = live_rows + blockIdx.x * int64_t{kThreads} + threadIdx.x;
       j < fill_to; j += static_cast<int64_t>(gridDim.x) * kThreads) {
    s_keys[j] = kDeadKey;
    s_rows[j] = -1;
  }
}

// The entry slab's compaction: the live rows' ids and keys in read order,
// a tile of kCompactTile rows a block in ticket order, its offset from a
// decoupled look-back. Row k * kThreads + t of a tile is thread t's k-th,
// so a warp's loads and stores are consecutive; a live row's rank is the
// live rows before its (k, warp) group in the tile (a scan of the groups'
// ballot counts) and before it in its warp (a popc of the ballot). state:
// [0] the live rows, [1] the ticket, [2, 2 + tiles) status words.
__global__ void __launch_bounds__(kThreads)
    seed_compact_kernel(const uint8_t* __restrict__ live,
                        const int64_t* __restrict__ keys, int64_t n, int R,
                        int t0, int Rw, int64_t id_base, int64_t* state,
                        int32_t* __restrict__ base,
                        int64_t* __restrict__ ckeys) {
  static_assert(kCompactItems * kRowWarps == 2 * kWarp, "two groups a lane");
  __shared__ int s_group[kCompactItems * kRowWarps + 1];
  unsigned long long* status = reinterpret_cast<unsigned long long*>(state + 2);
  const int64_t tile =
      bsort::block_ticket(reinterpret_cast<unsigned*>(state + 1));
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t first = tile * kCompactTile + threadIdx.x;
  unsigned mask[kCompactItems];
  int64_t key[kCompactItems];
#pragma unroll
  for (int k = 0; k < kCompactItems; ++k) {
    const int64_t i = first + k * kThreads;
    const bool on = i < n && live[i];
    key[k] = on ? keys[i] : 0;
    mask[k] = __ballot_sync(bsort::kFull, on);
    if (lane == 0) s_group[k * kRowWarps + warp] = __popc(mask[k]);
  }
  __syncthreads();
  if (warp == 0) {            // the groups' counts -> their first ranks
    const int a = s_group[2 * lane], b = s_group[2 * lane + 1];
    int incl = a + b;
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(bsort::kFull, incl, o);
      if (lane >= o) incl += y;
    }
    s_group[2 * lane] = incl - a - b;
    s_group[2 * lane + 1] = incl - b;
    if (lane == kWarp - 1) s_group[2 * kWarp] = incl;
  }
  __syncthreads();
  const int agg = s_group[2 * kWarp];
  const int64_t excl = static_cast<int64_t>(bsort::tile_prefix(
      status, tile, static_cast<uint64_t>(agg)));
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kCompactItems; ++k) {
    if (mask[k] >> lane & 1u) {
      const int64_t slot = excl + s_group[k * kRowWarps + warp] +
                           __popc(mask[k] & below);
      base[slot] = static_cast<int32_t>(
          row_id(first + k * kThreads, Rw, t0, R, id_base));
      ckeys[slot] = key[k];
    }
  }
  if (threadIdx.x == 0 && tile == gridDim.x - 1) *state = excl + agg;
}

}  // namespace

// reads2: (M, L) int32 codes; valid2: (M,) bool; lengths: (M,) int32 or
// NULL; rows t0 .. t0 + Rw - 1 of each read are built (all: 0, R; the
// entries: 0, g; the queries: g, n_pos); keys (M * Rw,) int64, live
// (M * Rw,) uint8 and payload (M, Rw, Wt + 2) int32 out, R = g + n_pos,
// Wt = ceil((L - g) / 16) - trim. scratch: a bucket sort's
// (bucket_sort.cuh, 2^d buckets), or NULL; with it the scratch is
// cleared and the live rows' buckets counted, and the n_prior keys of
// prior_keys' (a slab's, int64) too.
SAGE2_EXPORT int sage2_seed_rows(const void* reads2, const void* valid2,
                                 const void* lengths, int64_t M, int L, int s,
                                 int g, int n_pos, int trim, int t0, int Rw,
                                 void* keys, void* live, void* payload,
                                 const void* prior_keys, int64_t n_prior,
                                 void* scratch, int d, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 0 || d > bsort::kMaxBits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (scratch != nullptr) {
    const cudaError_t e = bsort::clear_scratch(scratch, d, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int W = (L + 15) / 16;
  int64_t blocks = (M + kRowWarps - 1) / kRowWarps;
  // with a scratch each block flushes its bucket counts once: one wave of
  // blocks that fills the card, each warp looping over reads
  const bool count = scratch != nullptr;
  const int64_t cap =
      count ? bsort::resident_blocks(seed_rows_kernel<true>, kThreads,
                                     kRowWarps * W * sizeof(uint32_t))
            : int64_t{1} << 20;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const auto kernel = count ? seed_rows_kernel<true> : seed_rows_kernel<false>;
  kernel<<<static_cast<int>(blocks), kThreads,
           kRowWarps * W * sizeof(uint32_t), st>>>(
      static_cast<const int32_t*>(reads2), static_cast<const bool*>(valid2),
      static_cast<const int32_t*>(lengths), M, L, s, g, n_pos, trim, t0, Rw,
      static_cast<int64_t*>(keys), static_cast<uint8_t*>(live),
      static_cast<int32_t*>(payload),
      static_cast<const int64_t*>(prior_keys), n_prior,
      static_cast<int64_t*>(scratch), d);
  return static_cast<int>(cudaGetLastError());
}

// The bucket counts -> each bucket's first slot; the live rows (and prior
// rows) to the scratch's word 0.
SAGE2_EXPORT int sage2_seed_scan(void* scratch, int d, void* stream) {
  bsort::bucket_scan_kernel<<<static_cast<unsigned>(bsort::scan_tiles(d)),
                              kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(scratch), d);
  return static_cast<int>(cudaGetLastError());
}

// keys, live: the rows launch's (M * Rw rows of ids (id_base + m) * R +
// t0 + i); prior_keys (int64), prior_ids (int32): n_prior rows of a slab
// or NULL; elems: (live + prior rows, 2) int64 out, the rows' elements in
// their coarse buckets (pass 1).
SAGE2_EXPORT int sage2_seed_scatter(const void* keys, const void* live,
                                    int64_t M, int g, int n_pos, int t0,
                                    int Rw, int64_t id_base,
                                    const void* prior_keys,
                                    const void* prior_ids, int64_t n_prior,
                                    void* scratch, int d, void* elems,
                                    void* stream) {
  const SeedSource src{static_cast<const int64_t*>(keys),
                       static_cast<const uint8_t*>(live),
                       M * Rw,
                       g,
                       g + n_pos,
                       t0,
                       Rw,
                       id_base,
                       static_cast<const int64_t*>(prior_keys),
                       static_cast<const int32_t*>(prior_ids),
                       d};
  return static_cast<int>(bsort::launch_coarse<K128>(
      src, M * Rw + n_prior, static_cast<int64_t*>(scratch), d,
      static_cast<K128*>(elems), static_cast<cudaStream_t>(stream)));
}

// elems: the scatter's coarse buckets; tmp: as many elements out, in their
// fine buckets (pass 2), whose first slots go to the scratch.
SAGE2_EXPORT int sage2_seed_split(const void* elems, void* tmp, void* scratch,
                                  int d, void* stream) {
  SeedSource src{};
  src.d = d;
  return static_cast<int>(bsort::launch_split<K128>(
      src, static_cast<int64_t*>(scratch), d,
      static_cast<const K128*>(elems), static_cast<K128*>(tmp),
      static_cast<cudaStream_t>(stream)));
}

// The big buckets (more rows than a block sorts) of the scatter's fine
// buckets in tmp, sorted with elems (as many elements) as scratch, their
// keys and ids written to s_keys (int64) and s_rows (int32); n_cap: the
// most rows the scratch was sized for (bucket_plan.scratch_words). One
// cooperative launch.
SAGE2_EXPORT int sage2_seed_big(void* elems, void* tmp, void* scratch, int d,
                                int64_t n_cap, void* s_keys, void* s_rows,
                                void* stream) {
  return static_cast<int>(bsort::launch_big<K128>(
      seed_big_kernel, static_cast<cudaStream_t>(stream),
      static_cast<K128*>(elems), static_cast<K128*>(tmp),
      static_cast<int64_t*>(scratch), d, n_cap,
      static_cast<int64_t*>(s_keys), static_cast<int32_t*>(s_rows)));
}

// The other buckets of tmp sorted and written: s_keys, s_rows the sorted
// rows, of the live count, or with fill_to > 0 of fill_to rows with dead
// rows after the live ones.
SAGE2_EXPORT int sage2_seed_sort(const void* tmp, void* scratch, int d,
                                 int64_t fill_to, void* s_keys, void* s_rows,
                                 void* stream) {
  int64_t extra = (fill_to + kThreads * 16 - 1) / (kThreads * 16);
  if (extra > 2048) extra = 2048;
  return static_cast<int>(bsort::launch_sort<K128>(
      seed_sort_kernel, (int64_t{1} << d) + extra,
      static_cast<cudaStream_t>(stream), static_cast<const K128*>(tmp),
      static_cast<int64_t*>(scratch), d, fill_to,
      static_cast<int64_t*>(s_keys), static_cast<int32_t*>(s_rows)));
}

// The entry slab's rows in read order: base (int32 global ids) and ckeys
// (int64 keys) of the live rows of keys/live (M * Rw rows, t0, id_base as
// the rows launch's); state: 2 + ceil(M * Rw / 2048) int64, [0] gets the
// live count.
SAGE2_EXPORT int sage2_seed_compact(const void* live, const void* keys,
                                    int64_t M, int g, int n_pos, int t0,
                                    int Rw, int64_t id_base, void* state,
                                    void* base, void* ckeys, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = M * Rw;
  int64_t tiles = (n + kCompactTile - 1) / kCompactTile;
  if (tiles < 1) tiles = 1;
  const cudaError_t e = cudaMemsetAsync(
      static_cast<int64_t*>(state) + 1, 0, (1 + tiles) * sizeof(int64_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  seed_compact_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(live), static_cast<const int64_t*>(keys),
      n, g + n_pos, t0, Rw, id_base, static_cast<int64_t*>(state),
      static_cast<int32_t*>(base), static_cast<int64_t*>(ckeys));
  return static_cast<int>(cudaGetLastError());
}
