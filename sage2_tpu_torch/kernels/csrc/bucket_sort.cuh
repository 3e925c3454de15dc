// The bucketed sort shared by K12 (dedup_reads.cu), K13 (seed_rows.cu) and
// K14 (longest_edges.cu), in place of a torch.sort of their keys.
//
// The kernels sort keys that are unique or carry their whole row, so the
// order needs no stability and no permutation travels with it: K13 sorts
// (seed key, tag | id) pairs, K14 the composite (src, dst, ovl) key (or
// (src << 32 | dst, ovl) for wide vertex ids), whose equal keys are equal
// rows, K12 a read's whole key string with its index. An element is a K64
// (one word), a K128 (two words, compared hi first) or a KW<NW> (NW words,
// compared in order). Each element has a fine bucket, a monotone function
// of its key with 2^d values (K13 the key's top d bits, K14 (src - lo) *
// 2^d / span over the sources' range, K12 its first word's offset above
// the smallest, scaled to the words' range); the fine buckets' top dc bits
// (dc = min(d, 8)) are its coarse bucket. The passes, each its own launch:
//
//   histogram  the kernel that builds the keys counts each kept row's
//              coarse bucket in shared memory, a block's counts added to
//              the scratch's by one atomic a bucket (one wave of blocks
//              that fills the card, so few blocks flush).
//   scan       bucket_scan_kernel: the coarse counts become each coarse
//              bucket's first slot and cursor, a block a tile of 2,048
//              counts, in ticket order, with a decoupled look-back
//              (lookback.cuh) over the tiles' status words; the total
//              goes to the scratch's word 0, where the host may read it.
//              (Not scan.cuh's one-block scan.)
//   pass 1     coarse_scatter_kernel: a block a tile of rows counts them
//              by coarse bucket in shared memory, claims each bucket's run
//              by one atomic on its cursor, and writes the runs out from
//              shared memory, consecutive threads on consecutive slots.
//   pass 2     fine_split_kernel: a block a coarse bucket counts its
//              elements by fine bucket in shared memory and scans the
//              counts (the fine buckets' first slots, kept in the
//              scratch), then moves its elements chunk by chunk, each
//              chunk staged bucket by bucket and written out run by run:
//              no global atomics. A global atomic a row (the first
//              scatter of this design) ran at 21-26 G/s on an H100, and a
//              16-byte store to a random slot at about a third of its
//              memory rate: the runs are what make these passes fast.
//   big        one cooperative launch (sort_big_buckets) sorts the
//              buckets larger than a block (below).
//   sort       a block a bucket that fits a block (kBlock = kThreads *
//              kItems elements) sorts it:
//              count_sort, kItems elements a thread in registers counted
//              into 2,048 sub-buckets that split the range of their first
//              words, placed, and each ranked within its sub-bucket by
//              comparisons; where a sub-bucket holds many equal first
//              words, the placed elements are merge-sorted (kItems a
//              thread by an odd-even network, then runs merged by merge
//              path, outputs held in registers across a barrier). Each
//              kernel then writes its rows from the sorted bucket.
//
// A bucket larger than a block (skew: poly-A seeds, a hub vertex, the
// stacked mode's live all-T rows) is decided on the card and sorted by a
// wave of blocks in a launch of its own (sort_big_buckets, before the
// sort): the big buckets are listed in bucket order with their tiles of
// kBlock elements (two grid barriers, one when there is none), each tile
// is sorted by a block in shared memory, then the sorted tiles of each
// bucket are merged pairwise by merge path, round by round (a grid
// barrier a round), every block taking output tiles of every big bucket.
// The last round hands each output tile to the kernel's own writer. In
// the sort launch after it, a big bucket's block only does its
// bookkeeping. (One cooperative launch that also took the other buckets
// by tickets kept its state across them and spilled in their sort: K13's
// sort 3.13 ms against 2.99 for these two launches, K14's 2.37 against
// 1.93, scripts/probe_seed_edges_ab.py on an H100.)
//
// Scratch (int64 words; scratch_words in kernels/bucket_plan.py mirrors
// it): [0] the rows bucketed, [1] a count the kernel keeps (K14's
// keepers), [2] two uint32 tickets (scan tiles, buckets), then 2^dc uint32
// coarse counts (the cursors after the scan), the scan tiles' status
// words, 2^d status words of the fine buckets (K14's keepers in bucket
// order), 2^dc + 1 and 2^d + 1 uint32 first slots; then the big buckets'
// area (Big), sized by the most elements n the sort may hold. Words 1 up
// to the first slots are zeroed by the histogram's launch.

#pragma once

#include <cooperative_groups.h>

#include <tuple>

#include "lookback.cuh"
#include "scan.cuh"

namespace bsort {

namespace cg = cooperative_groups;

using lookback::block_ticket;
using lookback::kFull;
using lookback::kValue;
using lookback::load_relaxed;
using lookback::tile_prefix;
constexpr int kCountsPerThread = 8;
constexpr int kCountTile = kThreads * kCountsPerThread;   // scan: 2,048
constexpr int kMaxBits = 20;
// elements a thread of the sort, and a block's (a tile of a big bucket)
constexpr int kItems = 8;
constexpr int kBlock = kThreads * kItems;
// the most blocks of the sort's wave
constexpr int kMaxGrid = 2048;

struct K64 {
  uint64_t k;
};

struct __align__(16) K128 {
  uint64_t hi, lo;
};

__device__ __forceinline__ bool less(const K64& a, const K64& b) {
  return a.k < b.k;
}

__device__ __forceinline__ bool less(const K128& a, const K128& b) {
  return a.hi < b.hi || (a.hi == b.hi && a.lo < b.lo);
}

// NW words (NW even, so that an element loads as 16-byte vectors),
// compared in order, word 0 first.
template <int NW>
struct __align__(16) KW {
  static_assert(NW % 2 == 0, "KW loads 16 bytes at a time");
  uint64_t w[NW];
};

template <int NW>
__device__ __forceinline__ bool less(const KW<NW>& a, const KW<NW>& b) {
#pragma unroll
  for (int i = 0; i + 1 < NW; ++i) {
    if (a.w[i] != b.w[i]) return a.w[i] < b.w[i];
  }
  return a.w[NW - 1] < b.w[NW - 1];
}

// Above every element the kernels make (they keep it so: K14's keys are
// below 2^63 or have a lo below 2^64 - 1, K13's tags below 2^32 - 1, K12's
// last word below 2^64 - 1).
template <class K>
struct KeyMax;
template <>
struct KeyMax<K64> {
  __device__ __forceinline__ static K64 get() { return {~0ull}; }
};
template <>
struct KeyMax<K128> {
  __device__ __forceinline__ static K128 get() { return {~0ull, ~0ull}; }
};
template <int NW>
struct KeyMax<KW<NW>> {
  __device__ __forceinline__ static KW<NW> get() {
    KW<NW> e;
#pragma unroll
    for (int i = 0; i < NW; ++i) e.w[i] = ~0ull;
    return e;
  }
};
template <class K>
__device__ __forceinline__ K key_max() {
  return KeyMax<K>::get();
}

// elements through the read-only cache (of a buffer the kernel does not
// write)
__device__ __forceinline__ K64 ldg(const K64* p) {
  return {__ldg(reinterpret_cast<const unsigned long long*>(p))};
}
__device__ __forceinline__ K128 ldg(const K128* p) {
  const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(p));
  return {v.x, v.y};
}
template <int NW>
__device__ __forceinline__ KW<NW> ldg(const KW<NW>* p) {
  KW<NW> e;
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(p) + i);
    e.w[2 * i] = v.x;
    e.w[2 * i + 1] = v.y;
  }
  return e;
}

// Buckets are 2^d fine buckets grouped by their top bits into 2^dc coarse
// ones, dc = min(d, kCoarseBits).
constexpr int kCoarseBits = 8;

__host__ __device__ inline int coarse_bits(int d) {
  return d < kCoarseBits ? d : kCoarseBits;
}

struct Scratch {
  int64_t* total;
  unsigned long long* count;
  unsigned* tickets;
  unsigned* hist;                     // coarse counts, then cursors
  unsigned long long* scan_status;
  unsigned long long* bucket_status;  // a fine bucket's (K14's keepers)
  unsigned* coarse_off;               // 2^dc + 1
  unsigned* fine_off;                 // 2^d + 1
  int nb, dc;
};

__host__ __device__ inline int64_t scan_tiles(int d) {
  return ((int64_t{1} << coarse_bits(d)) + kCountTile - 1) / kCountTile;
}

// The words from word 1 that the histogram's launch zeroes.
__host__ __device__ inline int64_t zeroed_words(int d) {
  const int64_t nbc = int64_t{1} << coarse_bits(d);
  return 2 + (nbc + 1) / 2 + scan_tiles(d) + (int64_t{1} << d);
}

__host__ __device__ inline Scratch scratch_of(int64_t* base, int d) {
  const int64_t nbc = int64_t{1} << coarse_bits(d);
  Scratch s;
  s.total = base;
  s.count = reinterpret_cast<unsigned long long*>(base + 1);
  s.tickets = reinterpret_cast<unsigned*>(base + 2);
  s.hist = reinterpret_cast<unsigned*>(base + 3);
  s.scan_status =
      reinterpret_cast<unsigned long long*>(base + 3 + (nbc + 1) / 2);
  s.bucket_status = s.scan_status + scan_tiles(d);
  int64_t* after = base + 1 + zeroed_words(d);
  s.coarse_off = reinterpret_cast<unsigned*>(after);
  s.fine_off = reinterpret_cast<unsigned*>(after + (nbc + 2) / 2);
  s.nb = 1 << d;
  s.dc = coarse_bits(d);
  return s;
}

// The words before the big buckets' area.
__host__ __device__ inline int64_t base_words(int d) {
  const int64_t nbc = int64_t{1} << coarse_bits(d);
  return 1 + zeroed_words(d) + (nbc + 2) / 2 + ((int64_t{1} << d) + 2) / 2;
}

// The most big buckets (more than kBlock elements) among n elements, and
// the most tiles of kBlock elements they take.
__host__ __device__ inline int64_t big_max(int64_t n) {
  return n / (kBlock + 1);
}
__host__ __device__ inline int64_t big_tiles_max(int64_t n) {
  return n / kBlock + big_max(n) + 1;
}

__host__ __device__ inline int64_t scratch_words(int d, int64_t n) {
  return base_words(d) + kMaxGrid + kMaxGrid / 2 + 3 + big_max(n) +
         (big_tiles_max(n) + 1) / 2;
}

// The big buckets' area, written by the big buckets' launch.
struct Big {
  unsigned long long* grid_sum;  // a block's (tiles << 32 | big buckets)
  unsigned* grid_max;            // a block's largest big bucket
  long long* run;                // the big buckets, their tiles, and 1
                                 // where the sorted ones are in b
  unsigned long long* list;      // (bucket << 32 | first tile), in order
  unsigned* tile_keep;           // K14: a tile's keepers
};

__host__ __device__ inline Big big_of(int64_t* base, int d, int64_t n) {
  int64_t* p = base + base_words(d);
  Big b;
  b.grid_sum = reinterpret_cast<unsigned long long*>(p);
  b.grid_max = reinterpret_cast<unsigned*>(p + kMaxGrid);
  b.run = reinterpret_cast<long long*>(p + kMaxGrid + kMaxGrid / 2);
  b.list = reinterpret_cast<unsigned long long*>(b.run + 3);
  b.tile_keep = reinterpret_cast<unsigned*>(b.list + big_max(n));
  return b;
}

// Zeroes the scratch's counters, tickets and status words (the
// histogram's launch does it first on its stream).
inline cudaError_t clear_scratch(void* scratch, int d, cudaStream_t s) {
  return cudaMemsetAsync(static_cast<int64_t*>(scratch) + 1, 0,
                         zeroed_words(d) * sizeof(int64_t), s);
}

// The scan: each coarse bucket's first slot, its cursor, the total.
__global__ void __launch_bounds__(kThreads)
    bucket_scan_kernel(int64_t* scratch, int d) {
  const Scratch sc = scratch_of(scratch, d);
  const int nbc = 1 << sc.dc;
  const int64_t tile = block_ticket(sc.tickets);
  const int64_t i0 =
      tile * kCountTile + static_cast<int64_t>(threadIdx.x) * kCountsPerThread;
  unsigned c[kCountsPerThread];
  uint64_t sum = 0;
  for (int k = 0; k < kCountsPerThread; ++k) {
    c[k] = i0 + k < nbc ? sc.hist[i0 + k] : 0u;
    sum += c[k];
  }
  uint64_t agg;
  const uint64_t before = block_exclusive_scan<uint64_t>(sum, &agg);
  const uint64_t excl = tile_prefix(sc.scan_status, tile, agg);
  uint64_t run = excl + before;
  for (int k = 0; k < kCountsPerThread; ++k) {
    if (i0 + k >= nbc) break;
    sc.coarse_off[i0 + k] = static_cast<unsigned>(run);
    sc.hist[i0 + k] = static_cast<unsigned>(run);
    run += c[k];
  }
  if (tile == scan_tiles(d) - 1 && threadIdx.x == 0) {
    sc.coarse_off[nbc] = static_cast<unsigned>(excl + agg);
    sc.fine_off[sc.nb] = static_cast<unsigned>(excl + agg);
    *sc.total = static_cast<int64_t>(excl + agg);
  }
}

// A block's coarse counts (shared memory, `hist`, 2^dc bins) added to the
// scratch's, one atomic a nonzero bin.
__device__ __forceinline__ void flush_coarse(const unsigned* hist,
                                             const Scratch& sc) {
  __syncthreads();
  for (int b = threadIdx.x; b < (1 << sc.dc); b += kThreads) {
    if (hist[b]) atomicAdd(sc.hist + b, hist[b]);
  }
}

// --- the two scatter passes ----------------------------------------------

// Pass 1: a block of kPassThreads a tile of kPassThreads * U source items
// (U = 128 / sizeof(K): 8,192 two-word or 16,384 one-word elements); each
// kept item's element goes to its coarse bucket. The tile's items are
// counted by coarse bucket in shared memory (an atomic's return is the
// item's rank there), each nonzero bucket claims its run of slots by one
// atomic on the scratch's cursor, the elements are staged in shared memory
// bucket by bucket and written out run by run (consecutive threads,
// consecutive slots: a store to a random slot runs at a third of the
// card's rate). Src: probe(i, &fine) (false: not kept; fine: the item's
// fine bucket), make(i) (the item's element), fine(e) (an element's fine
// bucket); each reads the source through the read-only cache and does
// not branch on what it loads, so a thread's loads of its items are in
// flight together.
constexpr int kPassThreads = 1024;
// element bytes a thread of pass 1 (64 ran slower on an H100: 1.63
// against 1.24 ms on the default path's K13 rows)
constexpr int kPassBytes = 128;

template <class K, class Src>
__global__ void __launch_bounds__(kPassThreads)
    coarse_scatter_kernel(const Src src, int64_t n, int64_t* scratch, int d,
                          K* __restrict__ out) {
  constexpr int U = kPassBytes / sizeof(K);
  constexpr int kTile = kPassThreads * U;
  extern __shared__ __align__(16) unsigned char s_raw[];
  K* stage = reinterpret_cast<K*>(s_raw);
  unsigned char* sbin = s_raw + kTile * sizeof(K);
  __shared__ unsigned hist[1 << kCoarseBits], first[(1 << kCoarseBits) + 1],
      claim[1 << kCoarseBits];
  const Scratch sc = scratch_of(scratch, d);
  const int nbc = 1 << sc.dc, down = d - sc.dc;
  for (int b = threadIdx.x; b < nbc; b += kPassThreads) hist[b] = 0;
  __syncthreads();
  const int64_t base = blockIdx.x * int64_t{kTile};
  unsigned fb[U];
  unsigned on = 0;
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int64_t i = base + k * kPassThreads + threadIdx.x;
    fb[k] = 0;
    if (i < n && src.probe(i, &fb[k])) on |= 1u << k;
  }
  unsigned short rank[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    if (on >> k & 1u) {
      rank[k] = static_cast<unsigned short>(
          atomicAdd(&hist[fb[k] >> down], 1u));
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {   // first slots in the tile, and the claims
    const int lane = threadIdx.x;
    constexpr int per = (1 << kCoarseBits) / 32;
    unsigned sum = 0;
    for (int j = 0; j < per; ++j) {
      sum += lane * per + j < nbc ? hist[lane * per + j] : 0u;
    }
    unsigned incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    unsigned run = incl - sum;
    for (int j = 0; j < per; ++j) {
      const int b = lane * per + j;
      if (b >= nbc) break;
      first[b] = run;
      run += hist[b];
      if (hist[b]) claim[b] = atomicAdd(sc.hist + b, hist[b]);
    }
    if (lane == 31) first[nbc] = run;       // the tile's kept items
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < U; ++k) {
    if (on >> k & 1u) {
      const K e = src.make(base + k * kPassThreads + threadIdx.x);
      const unsigned b = fb[k] >> down;
      const unsigned at = first[b] + rank[k];
      stage[at] = e;
      sbin[at] = static_cast<unsigned char>(b);
    }
  }
  __syncthreads();
  const unsigned total = first[nbc];
  for (unsigned j = threadIdx.x; j < total; j += kPassThreads) {
    const unsigned b = sbin[j];
    out[claim[b] + (j - first[b])] = stage[j];
  }
}

constexpr int kSplitThreads = 1024;
// element bytes a thread of a pass-2 chunk (128 ran slower on an H100:
// 1.59 against 1.43 ms on the default path's K13 rows)
constexpr int kSplitBytes = 64;

// Exclusive prefix sum of v over a block of kSplitThreads, in thread
// order; *total gets the sum. Every thread calls it.
__device__ __forceinline__ unsigned split_scan(unsigned v, unsigned* total) {
  __shared__ unsigned sums[kSplitThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned w = sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    sums[lane] = w;
  }
  __syncthreads();
  const unsigned before = (warp ? sums[warp - 1] : 0u) + x - v;
  *total = sums[kSplitThreads / 32 - 1];
  __syncthreads();
  return before;
}

// cnt[0, nf) -> exclusive prefix sums in first[0, nf) (nf <= 4 a thread);
// returns the sum.
__device__ __forceinline__ unsigned split_scan_bins(const unsigned* cnt,
                                                    unsigned* first, int nf) {
  const int per = (nf + kSplitThreads - 1) / kSplitThreads;
  const int b0 = threadIdx.x * per;
  unsigned sum = 0;
  for (int j = 0; j < per && b0 + j < nf; ++j) sum += cnt[b0 + j];
  unsigned total;
  unsigned run = split_scan(sum, &total);
  for (int j = 0; j < per && b0 + j < nf; ++j) {
    const unsigned x = cnt[b0 + j];
    first[b0 + j] = run;
    run += x;
  }
  return total;
}

// Pass 2: a block of kSplitThreads a coarse bucket (there are only 2^dc of
// them, so a block is large); its elements (in[off, off + n), any order)
// go to their fine buckets in out at the same slots, and the fine
// buckets' first slots to the scratch. A first sweep counts the fine
// buckets (2^(d - dc) bins in shared memory) and scans them into each
// bucket's running slot; then chunk by chunk (kThreads * U elements) the
// chunk is counted again, staged in shared memory bucket by bucket and
// written out run by run, consecutive threads on consecutive slots (a
// store a random slot ran at a third of the card's rate).
template <class K, class Src>
__global__ void __launch_bounds__(kSplitThreads)
    fine_split_kernel(const K* __restrict__ in, K* __restrict__ out,
                      const Src src, int64_t* scratch, int d) {
  constexpr int U = kSplitBytes / sizeof(K);      // elements a thread a chunk
  constexpr int kChunk = kSplitThreads * U;
  extern __shared__ __align__(16) unsigned char s_raw[];
  const Scratch sc = scratch_of(scratch, d);
  const int nf = 1 << (d - sc.dc);
  K* stage = reinterpret_cast<K*>(s_raw);
  unsigned* cursor = reinterpret_cast<unsigned*>(s_raw + kChunk * sizeof(K));
  unsigned* cnt = cursor + nf;
  unsigned* first = cnt + nf;
  unsigned short* sbin = reinterpret_cast<unsigned short*>(first + nf);
  const int64_t c = blockIdx.x;
  const int64_t off = sc.coarse_off[c];
  const int64_t n = sc.coarse_off[c + 1] - off;
  const unsigned f0 = static_cast<unsigned>(c) << (d - sc.dc);
  for (int b = threadIdx.x; b < nf; b += kSplitThreads) cnt[b] = 0;
  __syncthreads();
  for (int64_t i0 = threadIdx.x; i0 < n; i0 += kChunk) {
    unsigned f[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = i0 + u * kSplitThreads;
      f[u] = i < n ? src.fine(ldg(in + off + i)) - f0 : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u * kSplitThreads < n) atomicAdd(&cnt[f[u]], 1u);
    }
  }
  __syncthreads();
  split_scan_bins(cnt, cursor, nf);
  __syncthreads();
  for (int b = threadIdx.x; b < nf; b += kSplitThreads) {
    sc.fine_off[f0 + b] = static_cast<unsigned>(off + cursor[b]);
    cnt[b] = 0;
  }
  __syncthreads();
  for (int64_t c0 = 0; c0 < n; c0 += kChunk) {
    K e[U];
    unsigned short f[U], r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = c0 + u * kSplitThreads + threadIdx.x;
      if (i < n) e[u] = ldg(in + off + i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u * kSplitThreads + threadIdx.x < n) {
        f[u] = static_cast<unsigned short>(src.fine(e[u]) - f0);
        r[u] = static_cast<unsigned short>(atomicAdd(&cnt[f[u]], 1u));
      }
    }
    __syncthreads();
    const unsigned m = split_scan_bins(cnt, first, nf);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u * kSplitThreads + threadIdx.x < n) {
        const unsigned at = first[f[u]] + r[u];
        stage[at] = e[u];
        sbin[at] = f[u];
      }
    }
    __syncthreads();
    for (unsigned j = threadIdx.x; j < m; j += kSplitThreads) {
      const unsigned b = sbin[j];
      out[off + cursor[b] + (j - first[b])] = stage[j];
    }
    __syncthreads();
    for (int b = threadIdx.x; b < nf; b += kSplitThreads) {
      cursor[b] += cnt[b];
      cnt[b] = 0;
    }
    __syncthreads();
  }
}

// The blocks of `kernel` (threads, smem bytes a block) the card holds at
// once: a grid-stride kernel launched with no more fills it in one wave.
template <class Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem) {
  int per_sm = 0, sms = 0, dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
      per_sm < 1) {
    return 1056;
  }
  return per_sm * sms;
}

// Launches pass 1 over n source items into elems (stage: a tile's
// elements and their bins in shared memory, opted in past 48 KB).
template <class K, class Src>
cudaError_t launch_coarse(const Src& src, int64_t n, int64_t* scratch, int d,
                          K* elems, cudaStream_t stream) {
  constexpr int kTile = kPassThreads * (kPassBytes / sizeof(K));
  constexpr size_t smem = kTile * (sizeof(K) + 1);
  const cudaError_t e = cudaFuncSetAttribute(
      coarse_scatter_kernel<K, Src>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles < 1) tiles = 1;
  coarse_scatter_kernel<K, Src>
      <<<static_cast<unsigned>(tiles), kPassThreads, smem, stream>>>(
          src, n, scratch, d, elems);
  return cudaGetLastError();
}

// Launches pass 2 from elems into tmp (a chunk's elements and bins and
// three words a fine bin of shared memory, opted in past 48 KB).
template <class K, class Src>
cudaError_t launch_split(const Src& src, int64_t* scratch, int d,
                         const K* elems, K* tmp, cudaStream_t stream) {
  constexpr int kChunk = kSplitThreads * (kSplitBytes / sizeof(K));
  const size_t nf = size_t{1} << (d - coarse_bits(d));
  const size_t smem = kChunk * (sizeof(K) + 2) + 3 * nf * sizeof(unsigned);
  const cudaError_t e = cudaFuncSetAttribute(
      fine_split_kernel<K, Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  fine_split_kernel<K, Src>
      <<<1u << coarse_bits(d), kSplitThreads, smem, stream>>>(elems, tmp, src,
                                                              scratch, d);
  return cudaGetLastError();
}

// --- the sort of one bucket --------------------------------------------

template <int E>
__device__ __forceinline__ int64_t pad(int64_t i) {
  return i + i / E;
}

template <class K, int E>
__device__ __forceinline__ void sort_regs(K (&v)[E]) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
#pragma unroll
    for (int i = r & 1; i + 1 < E; i += 2) {
      if (less(v[i + 1], v[i])) {
        const K t = v[i];
        v[i] = v[i + 1];
        v[i + 1] = t;
      }
    }
  }
}

// Outputs base .. base + E - 1 of a round that merges the runs of width w
// of src[0, n) pairwise (item i at src[padded ? pad(i) : i]): the merge
// path's split of the thread's diagonal by a binary search, then E steps
// of the merge, A first on ties. `next` (if not null) gets the output
// after them within the pair of runs (key_max past its end).
template <class K, int E, bool kPadded>
__device__ __forceinline__ void merge_outputs(const K* src, int64_t n,
                                              int64_t w, int64_t base,
                                              K (&v)[E], K* next = nullptr) {
  const auto at = [&](int64_t i) { return src[kPadded ? pad<E>(i) : i]; };
  const int64_t p0 = base / (2 * w) * (2 * w);
  const int64_t na = min64(w, n - p0);
  const int64_t nb = min64(w, n - p0 - na);
  const int64_t b0 = p0 + na;
  const int64_t diag = base - p0;
  int64_t lo = diag > nb ? diag - nb : 0, hi = min64(diag, na);
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (!less(at(b0 + diag - 1 - mid), at(p0 + mid))) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int64_t i = lo, j = diag - lo;
  K ha = i < na ? at(p0 + i) : key_max<K>();
  K hb = j < nb ? at(b0 + j) : key_max<K>();
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const bool take_b = less(hb, ha);
    v[k] = take_b ? hb : ha;
    if (take_b) {
      ++j;
      hb = j < nb ? at(b0 + j) : key_max<K>();
    } else {
      ++i;
      ha = i < na ? at(p0 + i) : key_max<K>();
    }
  }
  if (next) *next = less(hb, ha) ? hb : ha;
}

// Sorts s[0, n) (padded, n <= kThreads * E) in shared memory. Every
// thread calls it; it ends with a barrier.
template <class K, int E>
__device__ void block_sort(K* s, int n) {
  const int base = threadIdx.x * E;
  K v[E];
  if (base < n) {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      v[k] = base + k < n ? s[pad<E>(base + k)] : key_max<K>();
    }
    sort_regs<K, E>(v);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (base + k < n) s[pad<E>(base + k)] = v[k];
    }
  }
  __syncthreads();
  for (int w = E; w < n; w *= 2) {
    if (base < n) merge_outputs<K, E, true>(s, n, w, base, v);
    __syncthreads();
    if (base < n) {
#pragma unroll
      for (int k = 0; k < E; ++k) {
        if (base + k < n) s[pad<E>(base + k)] = v[k];
      }
    }
    __syncthreads();
  }
}

// A bucket sorted in shared memory (padded).
template <class K, int E>
struct Padded {
  const K* p;
  __device__ __forceinline__ K operator[](int64_t i) const {
    return p[pad<E>(i)];
  }
};

__device__ __forceinline__ uint64_t first_word(const K64& e) { return e.k; }
__device__ __forceinline__ uint64_t first_word(const K128& e) { return e.hi; }
template <int NW>
__device__ __forceinline__ uint64_t first_word(const KW<NW>& e) {
  return e.w[0];
}

// min and max of v over the block (every thread gets both)
__device__ __forceinline__ void block_min_max(uint64_t* lo, uint64_t* hi) {
  __shared__ uint64_t s_lo[kThreads / 32], s_hi[kThreads / 32];
  uint64_t a = *lo, b = *hi;
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t x = __shfl_xor_sync(kFull, a, o);
    const uint64_t y = __shfl_xor_sync(kFull, b, o);
    a = x < a ? x : a;
    b = y > b ? y : b;
  }
  if ((threadIdx.x & 31) == 0) {
    s_lo[threadIdx.x / 32] = a;
    s_hi[threadIdx.x / 32] = b;
  }
  __syncthreads();
  a = s_lo[0];
  b = s_hi[0];
  for (int w = 1; w < kThreads / 32; ++w) {
    a = s_lo[w] < a ? s_lo[w] : a;
    b = s_hi[w] > b ? s_hi[w] : b;
  }
  *lo = a;
  *hi = b;
  __syncthreads();
}

// sub-buckets of the counting sort, and the largest it ranks by comparison
constexpr int kSubBits = 11;
constexpr int kSubBins = 1 << kSubBits;
constexpr int kSubBinsPerThread = kSubBins / kThreads;
constexpr int kSubMax = 48;

// Sorts a[0, n) (device memory, n <= kThreads * E) into s (padded): E
// elements a thread in registers, each counted into one of kSubBins
// sub-buckets that split [min, max] of the elements' first words evenly
// (a shared-memory atomic gives its place there), the counts scanned, the
// elements placed, then each placed element ranked within its sub-bucket
// by comparing it with the sub-bucket's elements (all at once, a thread a
// placed slot, each sub-bucket a few: the first words of its keys are
// close) and moved to its rank. Where a sub-bucket holds more than
// kSubMax elements (many equal first words) the placed elements are
// merge-sorted instead. a is read through the read-only cache unless
// `written` (a buffer this launch writes). Every thread calls it; it ends
// with a barrier.
template <class K, int E>
__device__ void count_sort(K* s, const K* a, int n, bool written = false) {
  __shared__ unsigned cnt[kSubBins];
  __shared__ int s_big;
  K v[E];
  uint64_t lo = ~0ull, hi = 0;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (i < n) {
      v[k] = written ? a[i] : ldg(a + i);
      const uint64_t w = first_word(v[k]);
      lo = w < lo ? w : lo;
      hi = w > hi ? w : hi;
    }
  }
  for (int b = threadIdx.x; b < kSubBins; b += kThreads) cnt[b] = 0;
  if (threadIdx.x == 0) s_big = 0;
  block_min_max(&lo, &hi);
  const uint64_t span = hi - lo;
  const int bits = span ? 64 - __clzll(static_cast<long long>(span)) : 0;
  const int shift = bits > kSubBits ? bits - kSubBits : 0;
  unsigned rank[E];
  unsigned short bin[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (i < n) {
      bin[k] = static_cast<unsigned short>((first_word(v[k]) - lo) >> shift);
      rank[k] = atomicAdd(&cnt[bin[k]], 1u);
    }
  }
  __syncthreads();
  // the counts -> first slots (kSubBinsPerThread consecutive bins a thread)
  const int b0 = threadIdx.x * kSubBinsPerThread;
  unsigned c[kSubBinsPerThread];
  int sum = 0, most = 0;
#pragma unroll
  for (int j = 0; j < kSubBinsPerThread; ++j) {
    c[j] = cnt[b0 + j];
    sum += c[j];
    most = static_cast<int>(c[j]) > most ? static_cast<int>(c[j]) : most;
  }
  int total;
  int run = block_exclusive_scan<int>(sum, &total);
#pragma unroll
  for (int j = 0; j < kSubBinsPerThread; ++j) {
    cnt[b0 + j] = run;
    run += c[j];
  }
  if (most > kSubMax) atomicOr(&s_big, 1);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (i < n) s[pad<E>(cnt[bin[k]] + rank[k])] = v[k];
  }
  __syncthreads();
  if (s_big) {
    block_sort<K, E>(s, n);
    return;
  }
  // each placed element's rank in its sub-bucket: the elements below it
  // there, and the equal ones placed before it. A thread takes placed
  // slots (not its own elements), so a warp's lanes share a few
  // sub-buckets: they loop alike and read the same words.
  int dest[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int at = k * kThreads + threadIdx.x;
    if (at < n) {
      v[k] = s[pad<E>(at)];
      const unsigned b = static_cast<unsigned>((first_word(v[k]) - lo) >>
                                               shift);
      const int o = cnt[b];
      const int e = b + 1 < kSubBins ? static_cast<int>(cnt[b + 1]) : n;
      int r = o;
      for (int x = o; x < e; ++x) {
        const K y = s[pad<E>(x)];
        r += less(y, v[k]) || (x < at && !less(v[k], y));
      }
      dest[k] = r;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < E; ++k) {
    if (k * kThreads + static_cast<int>(threadIdx.x) < n) {
      s[pad<E>(dest[k])] = v[k];
    }
  }
  __syncthreads();
}

// --- the buckets past a block, sorted by the whole grid ------------------

__host__ __device__ __forceinline__ int64_t tiles_of(int64_t n) {
  return (n + kBlock - 1) / kBlock;
}

// What every block knows of the big buckets after list_big.
struct BigRun {
  int64_t count;    // big buckets
  int64_t tiles;    // their tiles of kBlock elements
  int64_t largest;  // elements of the largest
};

// The sum (max) of v over the block, to every thread.
__device__ __forceinline__ unsigned long long block_sum(unsigned long long v) {
  unsigned long long t;
  block_exclusive_scan<unsigned long long>(v, &t);
  return t;
}

__device__ __forceinline__ unsigned block_max(unsigned v) {
  __shared__ unsigned s_max;
  if (threadIdx.x == 0) s_max = 0;
  __syncthreads();
  if (v) atomicMax(&s_max, v);
  __syncthreads();
  const unsigned m = s_max;
  __syncthreads();
  return m;
}

// Lists the big buckets (more than kBlock elements) in bucket order, each
// with its first tile: each block counts a contiguous range of buckets, a
// grid barrier, each block sums the counts before its own and writes its
// big buckets, a second grid barrier (none when there is no big bucket).
// Every thread of every block calls it.
__device__ BigRun list_big(cg::grid_group& grid, const Scratch& sc,
                           const Big& big) {
  const int64_t G = gridDim.x;
  const int64_t per = (sc.nb + G - 1) / G;
  const int64_t b0 = min64(sc.nb, blockIdx.x * per);
  const int64_t b1 = min64(sc.nb, b0 + per);
  unsigned long long sum = 0;   // (tiles << 32) | big buckets
  unsigned most = 0;
  for (int64_t b = b0 + threadIdx.x; b < b1; b += kThreads) {
    const unsigned n = sc.fine_off[b + 1] - sc.fine_off[b];
    if (n > kBlock) {
      sum += (static_cast<unsigned long long>(tiles_of(n)) << 32) | 1u;
      most = n > most ? n : most;
    }
  }
  const unsigned long long mine = block_sum(sum);
  most = block_max(most);
  if (threadIdx.x == 0) {
    big.grid_sum[blockIdx.x] = mine;
    big.grid_max[blockIdx.x] = most;
  }
  grid.sync();
  unsigned long long all = 0, pre = 0;
  most = 0;
  for (int64_t g = threadIdx.x; g < G; g += kThreads) {
    const unsigned long long x = big.grid_sum[g];
    all += x;
    if (g < blockIdx.x) pre += x;
    const unsigned m = big.grid_max[g];
    most = m > most ? m : most;
  }
  all = block_sum(all);
  pre = block_sum(pre);
  most = block_max(most);
  const BigRun run{static_cast<int64_t>(all & 0xffffffffu),
                   static_cast<int64_t>(all >> 32), most};
  if (run.count == 0) return run;
  if (mine) {
    for (int64_t c0 = b0; c0 < b1; c0 += kThreads) {
      const int64_t b = c0 + threadIdx.x;
      unsigned long long x = 0;
      if (b < b1) {
        const unsigned n = sc.fine_off[b + 1] - sc.fine_off[b];
        if (n > kBlock) {
          x = (static_cast<unsigned long long>(tiles_of(n)) << 32) | 1u;
        }
      }
      unsigned long long t;
      const unsigned long long at =
          pre + block_exclusive_scan<unsigned long long>(x, &t);
      if (x) {
        big.list[at & 0xffffffffu] =
            (static_cast<unsigned long long>(b) << 32) | (at >> 32);
      }
      pre += t;
    }
  }
  grid.sync();
  return run;
}

// The big bucket (its index in the list) that holds tile t.
__device__ __forceinline__ int64_t big_at(const unsigned long long* list,
                                          int64_t count, int64_t t) {
  int64_t lo = 0, hi = count - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if (static_cast<int64_t>(list[mid] & 0xffffffffu) <= t) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The index in the list of big bucket b.
__device__ __forceinline__ int64_t big_find(const unsigned long long* list,
                                            int64_t count, int64_t b) {
  int64_t lo = 0, hi = count - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(list[mid] >> 32) < b) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A tile of a big bucket: the bucket's list index, first slot and
// elements, its tiles [first, end), and the tile's place in it.
struct BigTile {
  int64_t i, off, n, first, end, j;
};

__device__ __forceinline__ BigTile big_tile(const Scratch& sc, const Big& big,
                                            const BigRun& run, int64_t t) {
  BigTile x;
  x.i = big_at(big.list, run.count, t);
  const unsigned long long e = big.list[x.i];
  const int64_t b = static_cast<int64_t>(e >> 32);
  x.first = static_cast<int64_t>(e & 0xffffffffu);
  x.end = x.i + 1 < run.count
              ? static_cast<int64_t>(big.list[x.i + 1] & 0xffffffffu)
              : run.tiles;
  x.off = sc.fine_off[b];
  x.n = sc.fine_off[b + 1] - x.off;
  x.j = t - x.first;
  return x;
}

// Sorts every big bucket of a (pass 2's buffer; b: as many elements of
// scratch) with the whole grid: each tile sorted by a block in shared
// memory s (count_sort) and written back, then each bucket's sorted runs
// merged pairwise, a round a grid barrier, output tiles spread over the
// blocks. In the last round every block calls emit(t, off, n, base, v,
// next) for each tile t it made (all its threads; v: the thread's kItems
// outputs at bucket positions base.., those below n valid; next: the
// output at base + kItems, key_max past n). Returns the buffer that holds
// the sorted buckets. Every thread of every block calls it, after
// list_big found run.count > 0; it ends with a grid barrier.
template <class K, class Emit>
__device__ const K* sort_big(cg::grid_group& grid, const BigRun& run, K* s,
                             K* a, K* b, const Scratch& sc, const Big& big,
                             Emit emit) {
  constexpr int E = kItems;
  for (int64_t t = blockIdx.x; t < run.tiles; t += gridDim.x) {
    const BigTile x = big_tile(sc, big, run, t);
    const int64_t c0 = x.off + x.j * kBlock;
    const int m = static_cast<int>(min64(kBlock, x.n - x.j * kBlock));
    count_sort<K, E>(s, a + c0, m, true);
    for (int i = threadIdx.x; i < m; i += kThreads) a[c0 + i] = s[pad<E>(i)];
    __syncthreads();
  }
  grid.sync();
  K* src = a;
  K* dst = b;
  for (int64_t w = kBlock; w < run.largest; w *= 2) {
    const bool last = 2 * w >= run.largest;
    for (int64_t t = blockIdx.x; t < run.tiles; t += gridDim.x) {
      const BigTile x = big_tile(sc, big, run, t);
      const int64_t base =
          x.j * kBlock + static_cast<int64_t>(threadIdx.x) * E;
      K v[E];
      K next = key_max<K>();
      if (base < x.n) {
        merge_outputs<K, E, false>(src + x.off, x.n, w, base, v, &next);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          if (base + k < x.n) dst[x.off + base + k] = v[k];
        }
      }
      if (last) emit(t, x.off, x.n, base, v, next);
    }
    grid.sync();
    K* tt = src;
    src = dst;
    dst = tt;
  }
  return src;
}

// The body of a big buckets' launch: the big buckets of a (pass 2's
// buffer; b as many elements of scratch) sorted (list_big, then sort_big
// with `emit`); their count, their tiles and the buffer that holds them
// sorted go to big.run for the sort launch.
template <class K, class Emit>
__device__ __forceinline__ void sort_big_buckets(K* a, K* b,
                                                 int64_t* scratch, int d,
                                                 int64_t n_cap, Emit emit) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char s_raw[];
  const Scratch sc = scratch_of(scratch, d);
  const Big big = big_of(scratch, d, n_cap);
  const BigRun run = list_big(grid, sc, big);
  const K* sorted = a;
  if (run.count) {
    sorted = sort_big<K>(grid, run, reinterpret_cast<K*>(s_raw), a, b, sc,
                         big, emit);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    big.run[0] = run.count;
    big.run[1] = run.tiles;
    big.run[2] = sorted == b;
  }
}

// Waits (one thread) until bucket b's status word holds its inclusive
// prefix, and returns it to every thread of the block.
__device__ __forceinline__ uint64_t wait_prefix(
    const unsigned long long* status, int64_t b) {
  __shared__ uint64_t s_incl;
  if (threadIdx.x == 0) {
    unsigned long long w = load_relaxed(status + b);
    while ((w >> 62) != 2) w = load_relaxed(status + b);
    s_incl = w & kValue;
  }
  __syncthreads();
  const uint64_t incl = s_incl;
  __syncthreads();
  return incl;
}

// The shared memory of a sort's block: kThreads * kItems elements and the
// padding, and `extra` bytes of the kernel's own.
template <class K>
__host__ __device__ constexpr size_t sort_smem(size_t extra = 0) {
  return (kBlock + kThreads) * sizeof(K) + extra;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory beside its
// static shared memory (past 48 KB in all it must opt in), and all of the
// SM's shared memory, so that as many blocks fit as the registers allow.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  }
  return e;
}

// Launches a bucket-sort kernel (sort_smem<K>(extra) bytes of shared
// memory a block), `grid` blocks.
template <class K, size_t kExtra = 0, class Kernel, class... Args>
cudaError_t launch_sort(Kernel kernel, int64_t grid, cudaStream_t stream,
                        Args... args) {
  constexpr size_t smem = sort_smem<K>(kExtra);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Launches a big buckets' kernel cooperatively (shared memory as
// launch_sort's): one wave of the blocks the card holds at once, at most
// kMaxGrid.
template <class K, class... P, class... A>
cudaError_t launch_big(void (*kernel)(P...), cudaStream_t stream,
                       A... args) {
  constexpr size_t smem = sort_smem<K>();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess) {
    return e;
  }
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess) {
    return e;
  }
  int64_t grid = static_cast<int64_t>(per_sm) * sms;
  if (grid > kMaxGrid) grid = kMaxGrid;
  if (grid < 1) grid = 1;
  std::tuple<P...> held(args...);
  return std::apply(
      [&](auto&... p) {
        void* ptrs[] = {static_cast<void*>(&p)...};
        return cudaLaunchCooperativeKernel(
            reinterpret_cast<const void*>(kernel),
            dim3(static_cast<unsigned>(grid)), dim3(kThreads), ptrs, smem,
            stream);
      },
      held);
}

}  // namespace bsort
