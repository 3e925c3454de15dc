// K14: the longest overlap of each (src, dst) pair among the overlap
// join's verified candidates, sorted by (src, dst), compacted and padded.
//
// Replaces sage2_tpu/overlap/detect.py _reduce_fused (:1015) and
// reduce_edge_candidates (:488): the masked (src, dst | ovl) sort, the
// last-of-run flags and the compaction (a second sort there). The ok
// candidates alone are sorted, by bucket_sort.cuh's bucketed sort:
//
//   histogram  each ok candidate's bucket, (src - lo) * 2^d / span by a
//              multiply and a shift over the range [lo, lo + span) that
//              holds the sources (all V ids, or a mesh shard's, whose
//              sources are its own range: bucketed over all V, a shard's
//              rows would fill a quarter of the buckets, each past a
//              block), counted. A monotone function of src, so a (src,
//              dst) run never spans two buckets; 2^d <= span.
//   scan       bucket_sort.cuh's look-back scan; the ok count goes to the
//              scratch's word 0.
//   scatter    two passes (bucket_sort.cuh: coarse, then fine buckets):
//              each ok candidate reread and packed into one element, the
//              key src << (db + ob) | dst << ob | ovl (db = bit_length(V -
//              1), ob = bit_length(read_len)), or where 2 db + ob > 63
//              (vertex ids near 2^30) the pair (src << 32 | dst, ovl << 32)
//              of two words. Equal elements are equal rows, so the order
//              needs no stability (the reference's and the plain version's
//              stable sorts give the same rows).
//   big        one cooperative launch (bucket_sort.cuh) sorts the buckets
//              past a block (a hub source) with the whole grid, its last
//              merge round counting each tile's keepers.
//   sort       a block a ticket (four blocks an SM: at most 64 registers,
//              1.87 against 2.38 ms on an H100 with 16 elements a thread
//              and two blocks). A row is kept when its (src, dst) differs
//              from the next row's (the last of its run holds the longest
//              ovl). A bucket's block, in ticket order, sorts it,
//              publishes its keepers and looks back (decoupled, in bucket
//              order) to the keepers before it, writes its keepers at that
//              slot, and fills its share of the padding that the rows it
//              drops leave before the ok count: bucket b's duplicates take
//              the slots [n_ok - off_b + kept_b - dups_b, n_ok - off_b +
//              kept_b), kept_b the keepers before it, off_b its first
//              slot. A big bucket's block sums its tiles' keepers and
//              publishes them; the blocks past the buckets' tickets write
//              the big buckets' keepers and padding, a tile at a time,
//              each once its bucket's prefix is published. Every block
//              fills a share of [n_ok, capacity) with (INT32_MAX,
//              INT32_MAX, 0) and adds its keepers to n_edges.

// The deferred mode (find_overlaps_stacked's, detect.py:1050-1054) keeps
// every valid row: each bucket's sorted rows go to its own slots, so a
// (src, dst) pair verified at several lengths keeps all of its rows, the
// longest last; no look-back. n_edges (the keepers) and n_dups (valid
// rows less keepers) stay on the card: nothing waits on the host.
//
// Bound: bytes. The candidates (13 bytes each) are read once, the padded
// edges (12 bytes a slot) written once; the histogram's reread of ok and
// src, the scatter's of the candidates and the bucketed keys are the
// rest.

#include "bucket_sort.cuh"

namespace {

namespace cg = cooperative_groups;
using bsort::K128;
using bsort::K64;

constexpr int32_t kInt32Max = 0x7FFFFFFF;

// one word: src << (db + ob) | dst << ob | ovl
struct Narrow {
  using K = K64;
  __device__ static K make(int32_t a, int32_t b, int32_t ovl, int db,
                           int ob) {
    return {static_cast<uint64_t>((static_cast<int64_t>(a) << (db + ob)) |
                                  (static_cast<int64_t>(b) << ob) |
                                  static_cast<int64_t>(ovl))};
  }
  __device__ static uint64_t pair(const K& k, int ob) { return k.k >> ob; }
  __device__ static int32_t src(const K& k, int db, int ob) {
    return static_cast<int32_t>(k.k >> (db + ob));
  }
  __device__ static void decode(const K& k, int db, int ob, int32_t* s,
                                int32_t* d, int32_t* o) {
    const int64_t key = static_cast<int64_t>(k.k);
    *s = static_cast<int32_t>(key >> (db + ob));
    *d = static_cast<int32_t>((key >> ob) & ((int64_t{1} << db) - 1));
    *o = static_cast<int32_t>(key & ((int64_t{1} << ob) - 1));
  }
};

// two words: (src << 32 | dst, ovl << 32)
struct Wide {
  using K = K128;
  __device__ static K make(int32_t a, int32_t b, int32_t ovl, int, int) {
    return {(static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
                static_cast<uint32_t>(b),
            static_cast<uint64_t>(static_cast<uint32_t>(ovl)) << 32};
  }
  __device__ static uint64_t pair(const K& k, int) { return k.hi; }
  __device__ static int32_t src(const K& k, int, int) {
    return static_cast<int32_t>(k.hi >> 32);
  }
  __device__ static void decode(const K& k, int, int, int32_t* s, int32_t* d,
                                int32_t* o) {
    *s = static_cast<int32_t>(k.hi >> 32);
    *d = static_cast<int32_t>(static_cast<uint32_t>(k.hi));
    *o = static_cast<int32_t>(k.lo >> 32);
  }
};

// The sources' range [lo, lo + span) and its bucket function: (src - lo)
// * 2^d / span as (src - lo) * m >> 32, m = floor(2^(32 + d) / span) <=
// 2^32 (the wrapper keeps 2^d <= span), sources below lo in bucket 0 and
// past the range in the last: monotone in src.
struct SrcRange {
  int64_t lo;
  uint64_t m;
  int d;

  __host__ __device__ SrcRange(int64_t lo_, int64_t span, int d_)
      : lo(lo_),
        m((uint64_t{1} << (32 + d_)) / static_cast<uint64_t>(span)),
        d(d_) {}

  __device__ __forceinline__ unsigned operator()(int32_t a) const {
    const int64_t x = static_cast<int64_t>(a) - lo;
    if (x <= 0) return 0u;
    const uint64_t nb = uint64_t{1} << d;
    const uint64_t b = (static_cast<uint64_t>(x) * m) >> 32;
    return static_cast<unsigned>(b < nb ? b : nb - 1);
  }
};

__device__ __forceinline__ void put_edge(int32_t* src, int32_t* dst,
                                         int32_t* ovl, int64_t j, int32_t s,
                                         int32_t d, int32_t o) {
  src[j] = s;
  dst[j] = d;
  ovl[j] = o;
}

__global__ void __launch_bounds__(kThreads)
    edge_hist_kernel(const bool* __restrict__ ok,
                     const int32_t* __restrict__ a, int64_t n,
                     SrcRange range, int64_t* scratch, int d) {
  __shared__ unsigned hist[1 << bsort::kCoarseBits];
  const bsort::Scratch sc = bsort::scratch_of(scratch, d);
  for (int b = threadIdx.x; b < (1 << sc.dc); b += kThreads) hist[b] = 0;
  __syncthreads();
  const int down = d - sc.dc;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  constexpr int kUnroll = 8;                 // loads in flight a thread
  for (int64_t i0 = blockIdx.x * int64_t{kThreads} + threadIdx.x; i0 < n;
       i0 += kUnroll * stride) {
    unsigned b[kUnroll];
    bool on[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * stride;
      on[u] = i < n && __ldg(reinterpret_cast<const unsigned char*>(ok) + i);
      b[u] = i < n ? range(__ldg(a + i)) >> down : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (on[u]) atomicAdd(&hist[b[u]], 1u);
    }
  }
  bsort::flush_coarse(hist, sc);
}

// The candidates as bucket_sort.cuh's items: kept where ok, the element
// the candidate's key, the fine bucket its source's.
template <class Tr>
struct EdgeSource {
  const bool* ok;
  const int32_t* a;
  const int32_t* b;
  const int32_t* ovl;
  SrcRange range;
  int db, ob;

  __device__ __forceinline__ bool probe(int64_t i, unsigned* f) const {
    const bool on = __ldg(reinterpret_cast<const unsigned char*>(ok) + i);
    *f = range(__ldg(a + i));
    return on;
  }

  __device__ __forceinline__ typename Tr::K make(int64_t i) const {
    return Tr::make(__ldg(a + i), __ldg(b + i), __ldg(ovl + i), db, ob);
  }

  __device__ __forceinline__ unsigned fine(const typename Tr::K& e) const {
    return range(Tr::src(e, db, ob));
  }
};

// The duplicates' padding of a bucket (first slot off, n rows, kept
// keepers, before them `before`): slots [n_ok - off + before - dups,
// n_ok - off + before), its rows [j0, j1) of them by this block.
__device__ __forceinline__ void dup_padding(int32_t* src, int32_t* dst,
                                            int32_t* ovl, int64_t n_ok,
                                            int64_t off, int64_t n,
                                            int64_t kept, int64_t before,
                                            int64_t j0, int64_t j1) {
  const int64_t dups = n - kept;
  const int64_t first = n_ok - off + before - dups;
  for (int64_t j = j0 + threadIdx.x; j < min64(j1, dups); j += kThreads) {
    put_edge(src, dst, ovl, first + j, kInt32Max, kInt32Max, 0);
  }
}

// The big buckets' launch (cooperative; in tmp, pass 2's buckets; elems
// as many elements of scratch; n_cap the candidates the scratch was sized
// for): the buckets past a block sorted by the whole grid, the last merge
// round counting each tile's keepers (and in the deferred mode writing
// every row at its slot).
template <class Tr>
__global__ void __launch_bounds__(kThreads, 4)
    edge_big_kernel(typename Tr::K* elems, typename Tr::K* tmp,
                    int64_t* scratch, int d, int64_t n_cap, int db, int ob,
                    bool deferred, int32_t* __restrict__ src_out,
                    int32_t* __restrict__ dst_out,
                    int32_t* __restrict__ ovl_out) {
  using K = typename Tr::K;
  constexpr int E = bsort::kItems;
  unsigned* tile_keep = bsort::big_of(scratch, d, n_cap).tile_keep;
  bsort::sort_big_buckets<K>(
      tmp, elems, scratch, d, n_cap,
      [=](int64_t t, int64_t off, int64_t n, int64_t base, const K (&v)[E],
          const K& next) {
        int kept = 0;
#pragma unroll
        for (int k = 0; k < E; ++k) {
          if (base + k < n) {
            const K& after = k + 1 < E ? v[k + 1] : next;
            kept += base + k + 1 == n ||
                    Tr::pair(v[k], ob) != Tr::pair(after, ob);
            if (deferred) {
              int32_t s, t2, o;
              Tr::decode(v[k], db, ob, &s, &t2, &o);
              put_edge(src_out, dst_out, ovl_out, off + base + k, s, t2, o);
            }
          }
        }
        int agg;
        block_exclusive_scan<int>(kept, &agg);
        if (threadIdx.x == 0) tile_keep[t] = agg;
      });
}

// A big bucket's ticket in the sort launch (bucket bk of n rows, sorted
// by the big launch, which counted its tiles' keepers): its keepers added
// to the scratch's count and, unless deferred, published for the
// look-back.
__device__ __noinline__ void edge_big_bucket(int64_t* scratch, int d,
                                             int64_t n_cap, int64_t bk,
                                             int64_t n, bool deferred) {
  const bsort::Scratch sc = bsort::scratch_of(scratch, d);
  const bsort::Big big = bsort::big_of(scratch, d, n_cap);
  const int64_t i = bsort::big_find(big.list, big.run[0], bk);
  const int64_t t0 = static_cast<int64_t>(big.list[i] & 0xffffffffu);
  const int64_t t1 = t0 + bsort::tiles_of(n);
  unsigned long long kept = 0;
  for (int64_t t = t0 + threadIdx.x; t < t1; t += kThreads) {
    kept += big.tile_keep[t];
  }
  const unsigned long long agg = bsort::block_sum(kept);
  if (threadIdx.x == 0 && agg) atomicAdd(sc.count, agg);
  if (!deferred) bsort::tile_prefix(sc.bucket_status, bk, agg);
}

// The big buckets' keepers at their slots and their duplicates' padding,
// tiles first, first + stride, ... (the sort launch's blocks past the
// buckets': each waits until its tile's bucket has published its
// inclusive prefix of keepers, which every bucket's block, started
// before it, does).
template <class Tr>
__device__ __noinline__ void edge_big_rows(
    const typename Tr::K* elems, const typename Tr::K* tmp,
    int64_t* scratch, int d, int64_t n_cap, int64_t first, int64_t stride,
    int64_t n_ok, int db, int ob, int32_t* src_out, int32_t* dst_out,
    int32_t* ovl_out) {
  using K = typename Tr::K;
  constexpr int E = bsort::kItems;
  constexpr int C = bsort::kBlock;
  const bsort::Scratch sc = bsort::scratch_of(scratch, d);
  const bsort::Big big = bsort::big_of(scratch, d, n_cap);
  const bsort::BigRun run{big.run[0], big.run[1], 0};
  const K* sorted = big.run[2] ? elems : tmp;
  for (int64_t t = first; t < run.tiles; t += stride) {
    const bsort::BigTile x = bsort::big_tile(sc, big, run, t);
    unsigned long long pre = 0, all = 0;
    for (int64_t u = x.first + threadIdx.x; u < x.end; u += kThreads) {
      const unsigned c = big.tile_keep[u];
      all += c;
      if (u < t) pre += c;
    }
    pre = bsort::block_sum(pre);
    all = bsort::block_sum(all);
    const int64_t b = static_cast<int64_t>(big.list[x.i] >> 32);
    const int64_t before = static_cast<int64_t>(
        bsort::wait_prefix(sc.bucket_status, b) - all);
    const K* v = sorted + x.off;
    const int64_t p0 = x.j * C + static_cast<int64_t>(threadIdx.x) * E;
    unsigned keep = 0;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int64_t p = p0 + k;
      if (p < x.n && (p + 1 == x.n ||
                      Tr::pair(v[p], ob) != Tr::pair(v[p + 1], ob))) {
        keep |= 1u << k;
      }
    }
    int total;
    int64_t at = before + static_cast<int64_t>(pre) +
                 block_exclusive_scan<int>(__popc(keep), &total);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (keep >> k & 1u) {
        int32_t s, t2, o;
        Tr::decode(v[p0 + k], db, ob, &s, &t2, &o);
        put_edge(src_out, dst_out, ovl_out, at++, s, t2, o);
      }
    }
    dup_padding(src_out, dst_out, ovl_out, n_ok, x.off, x.n,
                static_cast<int64_t>(all), before, x.j * C, (x.j + 1) * C);
  }
}

// A block a ticket: a bucket that fits a block (in tmp, pass 2's) sorted;
// a row is kept when its (src, dst) differs from the next row's. In the
// deferred mode every row is written at its slot; else the block
// publishes its keepers, looks back to the keepers before it, writes its
// keepers there and its duplicates' padding. A big bucket's ticket does
// its bookkeeping; the tickets past the buckets' write the big buckets'
// keepers. Every block fills a share of [n_ok, capacity).
template <class Tr>
__global__ void __launch_bounds__(kThreads, 4)
    edge_sort_kernel(const typename Tr::K* elems, const typename Tr::K* tmp,
                     int64_t* scratch, int d, int64_t n_cap, int db, int ob,
                     int64_t capacity, bool deferred,
                     int32_t* __restrict__ src_out,
                     int32_t* __restrict__ dst_out,
                     int32_t* __restrict__ ovl_out) {
  using K = typename Tr::K;
  constexpr int E = bsort::kItems;
  extern __shared__ __align__(16) unsigned char s_raw[];
  K* s_elems = reinterpret_cast<K*>(s_raw);
  const bsort::Scratch sc = bsort::scratch_of(scratch, d);
  const int64_t n_ok = *sc.total;
  const int64_t bk = bsort::block_ticket(sc.tickets + 1);
  if (bk < sc.nb) {
    const int64_t off = sc.fine_off[bk];
    const int64_t n = sc.fine_off[bk + 1] - off;
    if (n > bsort::kBlock) {
      edge_big_bucket(scratch, d, n_cap, bk, n, deferred);
    } else {
      bsort::count_sort<K, E>(s_elems, tmp + off, static_cast<int>(n));
      const bsort::Padded<K, E> v{s_elems};
      const auto keeper = [&](int64_t i) {
        return i + 1 == n || Tr::pair(v[i], ob) != Tr::pair(v[i + 1], ob);
      };
      int kept = 0;
      for (int64_t i = threadIdx.x; i < n; i += kThreads) {
        kept += keeper(i);
        if (deferred) {
          int32_t s, t, o;
          Tr::decode(v[i], db, ob, &s, &t, &o);
          put_edge(src_out, dst_out, ovl_out, off + i, s, t, o);
        }
      }
      int agg;
      block_exclusive_scan<int>(kept, &agg);
      if (threadIdx.x == 0 && agg) {
        atomicAdd(sc.count, static_cast<unsigned long long>(agg));
      }
      if (!deferred) {
        const int64_t before = static_cast<int64_t>(
            bsort::tile_prefix(sc.bucket_status, bk, agg));
        int64_t at = before;
        for (int64_t c0 = 0; c0 < n; c0 += kThreads) {
          const int64_t i = c0 + threadIdx.x;
          const bool keep = i < n && keeper(i);
          int total;
          const int r = block_exclusive_scan<int>(keep, &total);
          if (keep) {
            int32_t s, t, o;
            Tr::decode(v[i], db, ob, &s, &t, &o);
            put_edge(src_out, dst_out, ovl_out, at + r, s, t, o);
          }
          at += total;
        }
        dup_padding(src_out, dst_out, ovl_out, n_ok, off, n, agg, before, 0,
                    n);
      }
    }
  } else if (!deferred) {
    edge_big_rows<Tr>(elems, tmp, scratch, d, n_cap, bk - sc.nb,
                      gridDim.x - sc.nb, n_ok, db, ob, src_out, dst_out,
                      ovl_out);
  }
  for (int64_t j = n_ok + blockIdx.x * int64_t{kThreads} + threadIdx.x;
       j < capacity; j += static_cast<int64_t>(gridDim.x) * kThreads) {
    put_edge(src_out, dst_out, ovl_out, j, kInt32Max, kInt32Max, 0);
  }
}

template <class Tr>
EdgeSource<Tr> edge_source(const void* ok, const void* a, const void* b,
                           const void* ovl, int64_t lo, int64_t span, int db,
                           int ob, int d) {
  return {static_cast<const bool*>(ok),
          static_cast<const int32_t*>(a),
          static_cast<const int32_t*>(b),
          static_cast<const int32_t*>(ovl),
          SrcRange(lo, span, d),
          db,
          ob};
}

template <class Tr>
int launch_scatter(const void* ok, const void* a, const void* b,
                   const void* ovl, int64_t n, int64_t lo, int64_t span,
                   int db, int ob, void* scratch, int d, void* elems,
                   cudaStream_t stream) {
  return static_cast<int>(bsort::launch_coarse<typename Tr::K>(
      edge_source<Tr>(ok, a, b, ovl, lo, span, db, ob, d), n,
      static_cast<int64_t*>(scratch), d, static_cast<typename Tr::K*>(elems),
      stream));
}

template <class Tr>
int launch_split(const void* elems, void* tmp, void* scratch, int d,
                 int64_t lo, int64_t span, int db, int ob,
                 cudaStream_t stream) {
  using K = typename Tr::K;
  return static_cast<int>(bsort::launch_split<K>(
      edge_source<Tr>(nullptr, nullptr, nullptr, nullptr, lo, span, db, ob,
                      d),
      static_cast<int64_t*>(scratch), d, static_cast<const K*>(elems),
      static_cast<K*>(tmp), stream));
}

template <class Tr>
int launch_edge_big(void* elems, void* tmp, void* scratch, int d,
                    int64_t n_cap, int db, int ob, int deferred, void* src,
                    void* dst, void* ovl, cudaStream_t stream) {
  using K = typename Tr::K;
  return static_cast<int>(bsort::launch_big<K>(
      edge_big_kernel<Tr>, stream, static_cast<K*>(elems),
      static_cast<K*>(tmp), static_cast<int64_t*>(scratch), d, n_cap, db, ob,
      deferred != 0, static_cast<int32_t*>(src), static_cast<int32_t*>(dst),
      static_cast<int32_t*>(ovl)));
}

template <class Tr>
int launch_edge_sort(const void* elems, const void* tmp, void* scratch,
                     int d, int64_t n_cap, int db, int ob, int64_t capacity,
                     int deferred, void* src, void* dst, void* ovl,
                     cudaStream_t stream) {
  using K = typename Tr::K;
  int64_t extra = (capacity + kThreads * 16 - 1) / (kThreads * 16);
  if (extra > 2048) extra = 2048;
  if (extra < 1) extra = 1;             // a block past the buckets
  return static_cast<int>(bsort::launch_sort<K>(
      edge_sort_kernel<Tr>, (int64_t{1} << d) + extra, stream,
      static_cast<const K*>(elems), static_cast<const K*>(tmp),
      static_cast<int64_t*>(scratch), d, n_cap, db, ob, capacity,
      deferred != 0, static_cast<int32_t*>(src), static_cast<int32_t*>(dst),
      static_cast<int32_t*>(ovl)));
}

bool bad_range(int d, int64_t lo, int64_t span) {
  return d < 0 || d > bsort::kMaxBits || lo < 0 || span < 1 ||
         (int64_t{1} << d) > span;
}

}  // namespace

// ok: (n,) bool; a: (n,) int32 sources, bucketed over [lo, lo + span)
// (2^d <= span; a source outside it goes to the first or last bucket);
// scratch: a bucket sort's (bucket_sort.cuh, 2^d buckets), cleared here,
// then the ok candidates' buckets counted.
SAGE2_EXPORT int sage2_edge_hist(const void* ok, const void* a, int64_t n,
                                 int64_t lo, int64_t span, void* scratch,
                                 int d, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_range(d, lo, span)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = bsort::clear_scratch(scratch, d, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one wave of blocks that fills the card: each flushes its counts once
  int blocks = sage2_blocks(n);
  const int cap = bsort::resident_blocks(edge_hist_kernel, kThreads, 0);
  if (blocks > cap) blocks = cap;
  edge_hist_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const bool*>(ok), static_cast<const int32_t*>(a), n,
      SrcRange(lo, span, d), static_cast<int64_t*>(scratch), d);
  return static_cast<int>(cudaGetLastError());
}

// The bucket counts -> each bucket's first slot; the ok count to the
// scratch's word 0.
SAGE2_EXPORT int sage2_edge_scan(void* scratch, int d, void* stream) {
  bsort::bucket_scan_kernel<<<static_cast<unsigned>(bsort::scan_tiles(d)),
                              kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(scratch), d);
  return static_cast<int>(cudaGetLastError());
}

// ok, a, b, ovl: (n,) candidates; lo, span: as the histogram's; wide: 2 db
// + ob > 63; elems: (n, 1 + wide) int64 out, the ok candidates' elements
// in their coarse buckets (pass 1).
SAGE2_EXPORT int sage2_edge_scatter(const void* ok, const void* a,
                                    const void* b, const void* ovl, int64_t n,
                                    int64_t lo, int64_t span, int db, int ob,
                                    int wide, void* scratch, int d,
                                    void* elems, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_range(d, lo, span)) return static_cast<int>(cudaErrorInvalidValue);
  return wide ? launch_scatter<Wide>(ok, a, b, ovl, n, lo, span, db, ob,
                                     scratch, d, elems, st)
              : launch_scatter<Narrow>(ok, a, b, ovl, n, lo, span, db, ob,
                                       scratch, d, elems, st);
}

// elems: the scatter's coarse buckets; tmp: as many elements out, in their
// fine buckets (pass 2), whose first slots go to the scratch.
SAGE2_EXPORT int sage2_edge_split(const void* elems, void* tmp, void* scratch,
                                  int d, int64_t lo, int64_t span, int db,
                                  int ob, int wide, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_range(d, lo, span)) return static_cast<int>(cudaErrorInvalidValue);
  return wide ? launch_split<Wide>(elems, tmp, scratch, d, lo, span, db, ob,
                                   st)
              : launch_split<Narrow>(elems, tmp, scratch, d, lo, span, db,
                                     ob, st);
}

// The big buckets (more candidates than a block sorts) of the scatter's
// fine buckets in tmp, sorted with elems (as many elements) as scratch,
// each tile's keepers counted (deferred: every row written to src, dst,
// ovl at its slot); n_cap: the candidates the scratch was sized for
// (bucket_plan.scratch_words). One cooperative launch.
SAGE2_EXPORT int sage2_edge_big(void* elems, void* tmp, void* scratch, int d,
                                int64_t n_cap, int db, int ob, int wide,
                                int deferred, void* src, void* dst,
                                void* ovl, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return wide ? launch_edge_big<Wide>(elems, tmp, scratch, d, n_cap, db, ob,
                                      deferred, src, dst, ovl, st)
              : launch_edge_big<Narrow>(elems, tmp, scratch, d, n_cap, db,
                                        ob, deferred, src, dst, ovl, st);
}

// The other buckets of tmp sorted (elems: the big launch's buffers); src,
// dst, ovl: (capacity,) int32, capacity >= n: the keepers (or, with
// deferred, every ok row) sorted and padded; the scratch's word 1 gets
// the keepers (n_edges).
SAGE2_EXPORT int sage2_edge_sort(const void* elems, const void* tmp,
                                 void* scratch, int d, int64_t n_cap, int db,
                                 int ob, int wide, int64_t capacity,
                                 int deferred, void* src, void* dst,
                                 void* ovl, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return wide ? launch_edge_sort<Wide>(elems, tmp, scratch, d, n_cap, db, ob,
                                       capacity, deferred, src, dst, ovl, st)
              : launch_edge_sort<Narrow>(elems, tmp, scratch, d, n_cap, db,
                                         ob, capacity, deferred, src, dst,
                                         ovl, st);
}
