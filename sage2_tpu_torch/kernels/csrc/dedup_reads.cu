// K12: the dedup of equal canonical reads: their order, the groups of
// equal reads, each group's representative row, its multiplicity and each
// input read's vertex.
//
// Replaces sage2_tpu/overlap/prepare.py prepare_reads (:67), lines 97-133:
// the multi-operand sort of the canonical words (the length first for
// ragged reads), the head flags, the group ids (a cumsum), the
// representatives and multiplicities (scatters), the canonical rows of
// the representatives and vertex_of_read. K8 (canonical_reads.cu) still
// gives each read's words, its reverse complement and the canonical
// choice, and the reverse-complement rows of the unique reads.
//
// A read's key string is its length (clamped to [0, L]) in lb =
// bit_length(L) bits (ragged reads only), then its W canonical words (rc_w
// where take_rc, else fwd_w): 2 L + lb bits. Equal strings are equal
// canonical rows of equal length, so none of the outputs depends on the
// order inside a group of equal strings, nor on which member stands for
// it: any order of the strings, ascending, gives the reference's outputs.
// So the string is sorted once, whole, by the bucketed sort of
// bucket_sort.cuh, and no order is stable or chained.
//
//   element  a KW<NW> of 32-bit halves: the string's 32-bit words, then
//            (a later pass) the group id of the rest of the string, zero
//            halves, and in the last half the read's index with take_rc
//            in its top bit. Two elements are the same string where every
//            half but the last is equal. NW is the fewest of 2, 4, 6 or 8
//            words that holds them; a string longer than 8 words less the
//            index goes in passes, from its last segment of 14 words to its
//            first, each pass sorting (segment, the previous pass's group
//            id) and giving each read its group id: the dense rank of its
//            string from that segment on (bucket_plan.dedup_passes).
//   range    each read's element built once, its words read once, the
//            elements written in read order (coalesced); the smallest and
//            largest first word (a block's, then one atomic a block).
//   hist     each element's fine bucket, its first word's offset above the
//            smallest scaled to 2^d buckets over the words' range (a
//            length range of ragged reads spreads over the buckets too),
//            its coarse bucket counted (bucket_sort.cuh). Canonical words
//            crowd the low half of their range, so d is chosen for twice
//            (ragged: four times) the reads (kernels.bucket_plan).
//   scan, scatter, split, big    bucket_sort.cuh's passes; the big
//            buckets' last merge round counts each tile's last members of
//            their groups.
//   sort     a block a bucket (tickets in bucket order) sorts it in shared
//            memory; an element is its group's last where the next differs
//            (or the bucket ends: equal strings share a first word, hence a
//            bucket). The block counts them, publishes the count and looks
//            back (lookback.cuh) for the groups before its bucket, then
//            writes each read's vertex (group id, plus N where it was
//            flipped) and, for each group, its multiplicity (the position
//            of its last member less that of its first, found by a search
//            back), its length and its last member's element (reps, in
//            group order). The blocks past the buckets do the same for the
//            big buckets' tiles. An earlier pass writes only each read's
//            group id.
//   rows     (the last pass) one warp a unique row: the canonical codes
//            unpacked from its element's string (a string sorted in passes:
//            gathered from its read or RC), zero past its length; the rows
//            from n_unique on zeroed. Apart from the sort, whose blocks hold
//            a bucket's elements in shared memory (one or two an SM), the
//            rows' stores have the card's warps behind them: inside the
//            sort they took 0.8 of its 1.1 ms at phase 4 on an H100 (PERF.md).
//
// One host read a call: n_unique (the scratch's count).
//
// Bound: bytes, the canonical words (one of the two), the flags and the
// lengths in, the unique rows, multiplicities, vertices and lengths out.
// The elements are written once (range), their first words read (hist),
// and they move through the scatter, the split and the sort.

#include "bucket_sort.cuh"

namespace {

using bsort::KW;
constexpr int kWarp = 32;
constexpr uint32_t kRcBit = 0x80000000u;

// The halves of each read's element in one pass.
struct Layout {
  const int64_t* fwd_w;
  const int64_t* rc_w;
  const bool* take_rc;
  const int32_t* lengths;     // NULL: every read is L long
  const int32_t* prev_gid;    // the previous pass's group ids, or NULL
  int W, L, lb;
  int s0, ns;                 // the string words [s0, s0 + ns) of this pass
  int H;                      // halves (2 NW)

  __device__ __forceinline__ uint32_t word(int64_t r, bool rc, int t) const {
    if (t < 0 || t >= W) return 0u;
    return static_cast<uint32_t>(
        __ldg(reinterpret_cast<const long long*>(rc ? rc_w : fwd_w) +
              r * W + t));
  }
  __device__ __forceinline__ int len(int64_t r) const {
    return lengths == nullptr ? L : min(max(__ldg(lengths + r), 0), L);
  }
  // word t of read r's key string (lb bits of length, then the words)
  __device__ __forceinline__ uint32_t string_word(int64_t r, bool rc,
                                                  int t) const {
    if (lb == 0) return word(r, rc, t);
    const uint32_t prev = t == 0 ? static_cast<uint32_t>(len(r))
                                 : word(r, rc, t - 1);
    return (prev << (32 - lb)) | (word(r, rc, t) >> lb);
  }
  __device__ __forceinline__ uint32_t half(int64_t r, bool rc, int h) const {
    if (h < ns) return string_word(r, rc, s0 + h);
    if (h == H - 1) return static_cast<uint32_t>(r) | (rc ? kRcBit : 0u);
    if (prev_gid != nullptr && h == H - 2) {
      return static_cast<uint32_t>(__ldg(prev_gid + r));
    }
    return 0u;
  }
  __device__ __forceinline__ bool flipped(int64_t r) const {
    return __ldg(reinterpret_cast<const unsigned char*>(take_rc) + r) != 0;
  }
  template <int NW>
  __device__ __forceinline__ KW<NW> element(int64_t r) const {
    const bool rc = flipped(r);
    KW<NW> e;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      e.w[j] = (static_cast<uint64_t>(half(r, rc, 2 * j)) << 32) |
               half(r, rc, 2 * j + 1);
    }
    return e;
  }
};

// The fine bucket of a first word: its offset above the smallest, scaled
// to 2^d buckets over the range (ctl: the smallest, the complement of the
// largest).
struct Fine {
  const unsigned long long* ctl;
  int d;

  __device__ __forceinline__ unsigned of(uint64_t w0) const {
    const uint64_t lo = __ldg(ctl), hi = ~__ldg(ctl + 1);
    const uint64_t span = hi - lo;
    const int bits = span ? 64 - __clzll(static_cast<long long>(span)) : 0;
    const int shift = bits > d ? bits - d : 0;
    return shift >= 64 ? 0u : static_cast<unsigned>((w0 - lo) >> shift);
  }
};

// The elements the range launch built (in read order), for
// bucket_sort.cuh's passes.
template <int NW>
struct DedupSource {
  const KW<NW>* built;
  Fine fine_of;

  __device__ __forceinline__ bool probe(int64_t i, unsigned* f) const {
    *f = fine_of.of(__ldg(reinterpret_cast<const unsigned long long*>(
        built + i)));
    return true;
  }
  __device__ __forceinline__ KW<NW> make(int64_t i) const {
    return bsort::ldg(built + i);
  }
  __device__ __forceinline__ unsigned fine(const KW<NW>& e) const {
    return fine_of.of(e.w[0]);
  }
};

template <int NW>
__device__ __forceinline__ bool same_string(const KW<NW>& a,
                                            const KW<NW>& b) {
  bool eq = (a.w[NW - 1] ^ b.w[NW - 1]) >> 32 == 0;
#pragma unroll
  for (int i = 0; i + 1 < NW; ++i) eq = eq && a.w[i] == b.w[i];
  return eq;
}

template <int NW>
__device__ __forceinline__ uint32_t row_half(const KW<NW>& e) {
  return static_cast<uint32_t>(e.w[NW - 1]);
}

// Each read's element, built once (its words read once, the elements
// written in read order, coalesced), and the range of the first words.
template <int NW>
__global__ void __launch_bounds__(kThreads)
    dedup_range_kernel(Layout lay, int64_t n, KW<NW>* __restrict__ built,
                       unsigned long long* __restrict__ ctl) {
  uint64_t lo = ~0ull, hi = 0;
  SAGE2_GRID_STRIDE(i, n) {
    const KW<NW> e = lay.element<NW>(i);
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) {
      reinterpret_cast<ulonglong2*>(built + i)[j] =
          make_ulonglong2(e.w[2 * j], e.w[2 * j + 1]);
    }
    lo = e.w[0] < lo ? e.w[0] : lo;
    hi = e.w[0] > hi ? e.w[0] : hi;
  }
  // the block's (one atomic a word a block: one address takes them all)
  bsort::block_min_max(&lo, &hi);
  if (threadIdx.x == 0) {
    atomicMin(ctl, static_cast<unsigned long long>(lo));
    atomicMin(ctl + 1, static_cast<unsigned long long>(~hi));
  }
}

// first: the built elements' first words, `stride` words apart
__global__ void __launch_bounds__(kThreads)
    dedup_hist_kernel(const unsigned long long* __restrict__ first,
                      int stride, Fine fine, int64_t n, int64_t* scratch,
                      int d) {
  __shared__ unsigned hist[1 << bsort::kCoarseBits];
  const int dc = bsort::coarse_bits(d);
  for (int b = threadIdx.x; b < (1 << dc); b += kThreads) hist[b] = 0;
  __syncthreads();
  SAGE2_GRID_STRIDE(i, n) {
    atomicAdd(&hist[fine.of(__ldg(first + i * stride)) >> (d - dc)], 1u);
  }
  bsort::flush_coarse(hist, bsort::scratch_of(scratch, d));
}

// Where a pass writes: the last pass every output, an earlier one each
// read's group id (gid).
struct Out {
  const int32_t* lengths;
  int64_t N;
  int32_t* mult;
  int32_t* lens_u;
  int32_t* vertex;
  void* reps;       // (N, NW) int64: each group's last member's element
  int32_t* gid;     // an earlier pass's, else NULL
};

// The groups of positions [j0, j1) of a bucket of n sorted elements (v[i]
// its i-th, any accessor), `before` groups before position j0 in the whole
// order: each read's vertex (or an earlier pass's group id), and for each
// group that ends here its multiplicity, length and the element of its
// last member (reps, in group order: the rows launch's). Every thread of
// the block calls it.
template <int NW, class V>
__device__ void write_groups(const V& v, int64_t n, int64_t j0, int64_t j1,
                             int64_t before, const Out& out) {
  int64_t at = 0;
  KW<NW>* reps = static_cast<KW<NW>*>(out.reps);
  for (int64_t c0 = j0; c0 < j1; c0 += kThreads) {
    const int64_t i = c0 + threadIdx.x;
    bool last = false;
    KW<NW> e;
    if (i < j1) {
      e = v[i];
      last = i + 1 == n || !same_string(e, v[i + 1]);
    }
    int total;
    const int r = block_exclusive_scan<int>(last, &total);
    if (i < j1) {
      const uint32_t h = row_half(e);
      const int64_t row = h & ~kRcBit;
      const int64_t g = before + at + r;
      if (out.gid != nullptr) {
        out.gid[row] = static_cast<int32_t>(g);
      } else {
        out.vertex[row] =
            static_cast<int32_t>(g + ((h & kRcBit) ? out.N : 0));
        if (last) {
          // the group's first member: the first position whose string is
          // this one's (the bucket holds the whole group)
          int64_t lo = 0, hi = i;
          while (lo < hi) {
            const int64_t mid = (lo + hi) >> 1;
            if (same_string(v[mid], e)) {
              hi = mid;
            } else {
              lo = mid + 1;
            }
          }
          out.mult[g] = static_cast<int32_t>(i - lo + 1);
          if (out.lens_u != nullptr) out.lens_u[g] = __ldg(out.lengths + row);
#pragma unroll
          for (int j = 0; j < NW / 2; ++j) {
            reinterpret_cast<ulonglong2*>(reps + g)[j] =
                make_ulonglong2(e.w[2 * j], e.w[2 * j + 1]);
          }
        }
      }
    }
    at += total;
  }
}

// The rows: row g < n_unique is group g's representative in canonical
// orientation, its codes unpacked from its element's key string (whole:
// the elements hold all of it; codes 0-3, as the words hold them; lb bits
// of length first) or, for a string sorted in passes, gathered from the
// read or its reverse complement; zero past its length. Rows from
// n_unique on are zero, and their multiplicities and lengths. One warp a
// row; the element goes through the warp's words of shared memory.
template <int NW>
__global__ void __launch_bounds__(kThreads)
    dedup_rows_kernel(const KW<NW>* __restrict__ reps,
                      const int64_t* __restrict__ count,
                      const int32_t* __restrict__ reads,
                      const int32_t* __restrict__ rc,
                      const int32_t* __restrict__ lengths, int64_t N, int L,
                      int lb, bool whole, int32_t* __restrict__ uniq,
                      int32_t* __restrict__ mult,
                      int32_t* __restrict__ lens_u) {
  __shared__ uint64_t words[kThreads / kWarp][NW + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t* w = words[warp];
  const int64_t n_u = __ldg(reinterpret_cast<const long long*>(count));
  const bool vec = (L & 3) == 0;    // rows of whole 16-byte words
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / kWarp);
  for (int64_t g = blockIdx.x * int64_t{kThreads / kWarp} + warp; g < N;
       g += warps) {
    int32_t* dst = uniq + g * L;
    if (g >= n_u) {
      if (vec) {
        for (int c = lane; 4 * c < L; c += kWarp) {
          reinterpret_cast<int4*>(dst)[c] = make_int4(0, 0, 0, 0);
        }
      } else {
        for (int j = lane; j < L; j += kWarp) dst[j] = 0;
      }
      if (lane == 0) {
        mult[g] = 0;
        if (lens_u != nullptr) lens_u[g] = 0;
      }
      continue;
    }
    if (lane < NW) {
      w[lane] = __ldg(reinterpret_cast<const unsigned long long*>(reps + g) +
                      lane);
    }
    if (lane == NW) w[NW] = 0;
    __syncwarp();
    const uint32_t h = static_cast<uint32_t>(w[NW - 1]);
    if (whole) {
      const int len = lb ? static_cast<int>(w[0] >> (64 - lb)) : L;
      // code j: the 2 bits at string bit lb + 2 j
      const auto code = [&](int j) {
        const int p = lb + 2 * j, i = p >> 6, o = p & 63;
        uint64_t hi = w[i] << o;
        if (o == 63) hi |= w[i + 1] >> 1;
        return j < len ? static_cast<int32_t>(hi >> 62) : 0;
      };
      if (vec) {
        for (int c = lane; 4 * c < L; c += kWarp) {
          reinterpret_cast<int4*>(dst)[c] = make_int4(
              code(4 * c), code(4 * c + 1), code(4 * c + 2), code(4 * c + 3));
        }
      } else {
        for (int j = lane; j < L; j += kWarp) dst[j] = code(j);
      }
    } else {
      const int64_t row = h & ~kRcBit;
      const int len =
          lengths == nullptr ? L : min(max(__ldg(lengths + row), 0), L);
      const int32_t* src = ((h & kRcBit) ? rc : reads) + row * L;
      for (int j = lane; j < L; j += kWarp) {
        dst[j] = j < len ? __ldg(src + j) : 0;
      }
    }
    __syncwarp();       // the next row's element
  }
}

// The big buckets' launch (cooperative; in tmp, pass 2's buckets; elems
// as many elements of scratch): the buckets past a block sorted by the
// whole grid, the last merge round counting each tile's groups' last
// members.
template <int NW>
__global__ void __launch_bounds__(kThreads)
    dedup_big_kernel(KW<NW>* elems, KW<NW>* tmp, int64_t* scratch, int d,
                     int64_t n_cap) {
  constexpr int E = bsort::kItems;
  unsigned* tile_keep = bsort::big_of(scratch, d, n_cap).tile_keep;
  bsort::sort_big_buckets<KW<NW>>(
      tmp, elems, scratch, d, n_cap,
      [=](int64_t t, int64_t, int64_t n, int64_t base, const KW<NW> (&v)[E],
          const KW<NW>& next) {
        int kept = 0;
#pragma unroll
        for (int k = 0; k < E; ++k) {
          if (base + k < n) {
            const KW<NW>& after = k + 1 < E ? v[k + 1] : next;
            kept += base + k + 1 == n || !same_string(v[k], after);
          }
        }
        int agg;
        block_exclusive_scan<int>(kept, &agg);
        if (threadIdx.x == 0) tile_keep[t] = agg;
      });
}

template <int NW>
struct Global {
  const KW<NW>* p;
  __device__ __forceinline__ KW<NW> operator[](int64_t i) const {
    return bsort::ldg(p + i);
  }
};

// A block a ticket: a bucket that fits a block (in tmp, pass 2's) sorted,
// its groups counted, published and looked back on, its groups written; a
// big bucket's ticket publishes the groups the big launch counted; the
// tickets past the buckets write the big buckets' tiles.
template <int NW>
__global__ void __launch_bounds__(kThreads)
    dedup_sort_kernel(const KW<NW>* elems, const KW<NW>* tmp,
                      int64_t* scratch, int d, int64_t n_cap, Out out) {
  using K = KW<NW>;
  constexpr int E = bsort::kItems;
  extern __shared__ __align__(16) unsigned char s_raw[];
  K* s_elems = reinterpret_cast<K*>(s_raw);
  const bsort::Scratch sc = bsort::scratch_of(scratch, d);
  const int64_t bk = bsort::block_ticket(sc.tickets + 1);
  if (bk < sc.nb) {
    const int64_t off = sc.fine_off[bk];
    const int64_t n = sc.fine_off[bk + 1] - off;
    if (n > bsort::kBlock) {
      const bsort::Big big = bsort::big_of(scratch, d, n_cap);
      const int64_t i = bsort::big_find(big.list, big.run[0], bk);
      const int64_t t0 = static_cast<int64_t>(big.list[i] & 0xffffffffu);
      unsigned long long kept = 0;
      for (int64_t t = t0 + threadIdx.x; t < t0 + bsort::tiles_of(n);
           t += kThreads) {
        kept += big.tile_keep[t];
      }
      const unsigned long long agg = bsort::block_sum(kept);
      if (threadIdx.x == 0 && agg) atomicAdd(sc.count, agg);
      bsort::tile_prefix(sc.bucket_status, bk, agg);
      return;
    }
    bsort::count_sort<K, E>(s_elems, tmp + off, static_cast<int>(n));
    const bsort::Padded<K, E> v{s_elems};
    int kept = 0;
    for (int64_t i = threadIdx.x; i < n; i += kThreads) {
      kept += i + 1 == n || !same_string(v[i], v[i + 1]);
    }
    int agg;
    block_exclusive_scan<int>(kept, &agg);
    if (threadIdx.x == 0 && agg) {
      atomicAdd(sc.count, static_cast<unsigned long long>(agg));
    }
    const int64_t before =
        static_cast<int64_t>(bsort::tile_prefix(sc.bucket_status, bk, agg));
    write_groups<NW>(v, n, 0, n, before, out);
    return;
  }
  // the big buckets' tiles, first bk - nb, stride the blocks past the
  // buckets
  const bsort::Big big = bsort::big_of(scratch, d, n_cap);
  const bsort::BigRun run{big.run[0], big.run[1], 0};
  const Global<NW> sorted{big.run[2] ? elems : tmp};
  for (int64_t t = bk - sc.nb; t < run.tiles; t += gridDim.x - sc.nb) {
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
    const int64_t bucket_before = static_cast<int64_t>(
        bsort::wait_prefix(sc.bucket_status, b) - all);
    const Global<NW> v{sorted.p + x.off};
    const int64_t j0 = x.j * bsort::kBlock;
    const int64_t j1 = min64(x.n, j0 + bsort::kBlock);
    write_groups<NW>(v, x.n, j0, j1,
                     bucket_before + static_cast<int64_t>(pre), out);
    __syncthreads();
  }
}

// The launches of one element width.
template <int NW>
struct Passes {
  using K = KW<NW>;

  static cudaError_t range(const Layout& lay, int64_t n, void* built,
                           void* ctl, cudaStream_t s) {
    // a read a thread, so that every read's loads are in flight at once
    dedup_range_kernel<NW><<<sage2_blocks(n), kThreads, 0, s>>>(
        lay, n, static_cast<K*>(built),
        static_cast<unsigned long long*>(ctl));
    return cudaGetLastError();
  }
  static cudaError_t scatter(const void* built, const Fine& fine, int64_t n,
                             void* scratch, int d, void* elems,
                             cudaStream_t s) {
    return bsort::launch_coarse<K>(
        DedupSource<NW>{static_cast<const K*>(built), fine}, n,
        static_cast<int64_t*>(scratch), d, static_cast<K*>(elems), s);
  }
  static cudaError_t split(const Fine& fine, void* scratch, int d,
                           const void* elems, void* tmp, cudaStream_t s) {
    DedupSource<NW> src{};
    src.fine_of = fine;
    return bsort::launch_split<K>(src, static_cast<int64_t*>(scratch), d,
                                  static_cast<const K*>(elems),
                                  static_cast<K*>(tmp), s);
  }
  static cudaError_t big(void* elems, void* tmp, void* scratch, int d,
                         int64_t n_cap, cudaStream_t s) {
    return bsort::launch_big<K>(dedup_big_kernel<NW>, s,
                                static_cast<K*>(elems), static_cast<K*>(tmp),
                                static_cast<int64_t*>(scratch), d, n_cap);
  }
  static cudaError_t rows(const void* reps, const void* count,
                          const int32_t* reads, const int32_t* rc,
                          const int32_t* lengths, int64_t N, int L, int lb,
                          bool whole, int32_t* uniq, int32_t* mult,
                          int32_t* lens_u, cudaStream_t s) {
    int64_t blocks = (N + kThreads / kWarp - 1) / (kThreads / kWarp);
    if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;
    if (blocks < 1) blocks = 1;
    dedup_rows_kernel<NW><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const K*>(reps), static_cast<const int64_t*>(count),
        reads, rc, lengths, N, L, lb, whole, uniq, mult, lens_u);
    return cudaGetLastError();
  }
  static cudaError_t sort(const void* elems, const void* tmp, void* scratch,
                          int d, int64_t n_cap, const Out& out,
                          cudaStream_t s) {
    // blocks past the buckets for the big buckets' tiles
    int64_t extra = n_cap / (4 * bsort::kBlock) + 1;
    if (extra > 1024) extra = 1024;
    return bsort::launch_sort<K>(
        dedup_sort_kernel<NW>, (int64_t{1} << d) + extra, s,
        static_cast<const K*>(elems), static_cast<const K*>(tmp),
        static_cast<int64_t*>(scratch), d, n_cap, out);
  }
};

// Runs Passes<NW>::fn for the element width NW (2, 4, 6 or 8).
#define SAGE2_BY_WIDTH(NW, call)            \
  switch (NW) {                             \
    case 2: return static_cast<int>(Passes<2>::call); \
    case 4: return static_cast<int>(Passes<4>::call); \
    case 6: return static_cast<int>(Passes<6>::call); \
    case 8: return static_cast<int>(Passes<8>::call); \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

Layout make_layout(const void* fwd_w, const void* rc_w, const void* take_rc,
                   const void* lengths, const void* prev_gid, int W, int L,
                   int lb, int s0, int ns, int NW) {
  return Layout{static_cast<const int64_t*>(fwd_w),
                static_cast<const int64_t*>(rc_w),
                static_cast<const bool*>(take_rc),
                static_cast<const int32_t*>(lengths),
                static_cast<const int32_t*>(prev_gid),
                W,
                L,
                lb,
                s0,
                ns,
                2 * NW};
}

}  // namespace

// A pass of K12 over n reads, seven launches, one a function. The reads'
// layout (range): fwd_w, rc_w (n, W) int64 words holding uint32 (K8's);
// take_rc (n,) bool; lengths (n,) int32 or NULL; lb: bits of the length
// in the key string (0 without lengths); s0, ns: the string words of this
// pass; prev_gid: (n,) int32 the previous pass's group ids, or NULL (the
// first pass); NW: the element's words (2, 4, 6 or 8). ctl: two uint64
// words, the first words' range; scratch: a bucket sort's
// (bucket_sort.cuh, 2^d buckets, 0 <= d <= 20); built, elems: (n, NW)
// int64 each.

// Each read's element into built, in read order, and the range of their
// first words; the scratch is cleared.
SAGE2_EXPORT int sage2_dedup_range(const void* fwd_w, const void* rc_w,
                                   const void* take_rc, const void* lengths,
                                   const void* prev_gid, int64_t n, int W,
                                   int L, int lb, int s0, int ns, int NW,
                                   void* ctl, void* scratch, int d,
                                   void* built, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (d < 0 || d > bsort::kMaxBits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = bsort::clear_scratch(scratch, d, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(ctl, 0xff, 16, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Layout lay = make_layout(fwd_w, rc_w, take_rc, lengths, prev_gid, W,
                                 L, lb, s0, ns, NW);
  SAGE2_BY_WIDTH(NW, range(lay, n, built, ctl, st))
}

// Each element's coarse bucket counted.
SAGE2_EXPORT int sage2_dedup_hist(const void* built, int64_t n, int NW,
                                  const void* ctl, void* scratch, int d,
                                  void* stream) {
  int blocks = sage2_blocks(n);
  const int cap = bsort::resident_blocks(dedup_hist_kernel, kThreads, 0);
  if (blocks > cap) blocks = cap;
  dedup_hist_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(built), NW,
      Fine{static_cast<const unsigned long long*>(ctl), d}, n,
      static_cast<int64_t*>(scratch), d);
  return static_cast<int>(cudaGetLastError());
}

// The bucket counts -> each bucket's first slot.
SAGE2_EXPORT int sage2_dedup_scan(void* scratch, int d, void* stream) {
  bsort::bucket_scan_kernel<<<static_cast<unsigned>(bsort::scan_tiles(d)),
                              kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(scratch), d);
  return static_cast<int>(cudaGetLastError());
}

// built -> elems by coarse bucket (pass 1).
SAGE2_EXPORT int sage2_dedup_scatter(const void* built, int64_t n, int NW,
                                     const void* ctl, void* scratch, int d,
                                     void* elems, void* stream) {
  const Fine fine{static_cast<const unsigned long long*>(ctl), d};
  SAGE2_BY_WIDTH(NW, scatter(built, fine, n, scratch, d, elems,
                             static_cast<cudaStream_t>(stream)))
}

// elems -> tmp (as many elements) by fine bucket (pass 2).
SAGE2_EXPORT int sage2_dedup_split(const void* ctl, void* scratch, int d,
                                   int NW, const void* elems, void* tmp,
                                   void* stream) {
  const Fine fine{static_cast<const unsigned long long*>(ctl), d};
  SAGE2_BY_WIDTH(NW, split(fine, scratch, d, elems, tmp,
                           static_cast<cudaStream_t>(stream)))
}

// The big buckets of tmp sorted by the whole grid, elems (as many
// elements) their scratch; n_cap: the reads the scratch was sized for.
// One cooperative launch.
SAGE2_EXPORT int sage2_dedup_big(void* elems, void* tmp, void* scratch,
                                 int d, int64_t n_cap, int NW, void* stream) {
  SAGE2_BY_WIDTH(NW, big(elems, tmp, scratch, d, n_cap,
                         static_cast<cudaStream_t>(stream)))
}

// The other buckets sorted, and the groups written: the last pass (gid
// NULL) writes mult (N,), vertex_of_read (N,) and lens_u (N,) int32 (NULL
// without lengths) and each group's representative element into reps (N,
// NW) int64; an earlier pass writes gid (N,) int32. The scratch's word 1
// gets the groups (n_unique).
SAGE2_EXPORT int sage2_dedup_sort(const void* elems, const void* tmp,
                                  void* scratch, int d, int64_t n_cap, int NW,
                                  const void* lengths, int64_t N, void* mult,
                                  void* vertex, void* lens_u, void* reps,
                                  void* gid, void* stream) {
  const Out out{static_cast<const int32_t*>(lengths),
                N,
                static_cast<int32_t*>(mult),
                static_cast<int32_t*>(lens_u),
                static_cast<int32_t*>(vertex),
                reps,
                static_cast<int32_t*>(gid)};
  SAGE2_BY_WIDTH(NW, sort(elems, tmp, scratch, d, n_cap, out,
                          static_cast<cudaStream_t>(stream)))
}

// The last pass's rows: uniq (N, L) int32 from reps (sage2_dedup_sort's)
// and the group count in the scratch's word 1: unpacked from the elements
// where they hold the whole key string (whole; lb: the length's bits
// before the codes), else gathered from reads and rc (N, L) int32; the
// rows, multiplicities and lengths (lens_u, NULL without lengths) from
// n_unique on zeroed.
SAGE2_EXPORT int sage2_dedup_rows(const void* reps, const void* scratch,
                                  int NW, const void* reads, const void* rc,
                                  const void* lengths, int64_t N, int L,
                                  int lb, int whole, void* uniq, void* mult,
                                  void* lens_u, void* stream) {
  SAGE2_BY_WIDTH(NW, rows(reps, static_cast<const int64_t*>(scratch) + 1,
                          static_cast<const int32_t*>(reads),
                          static_cast<const int32_t*>(rc),
                          static_cast<const int32_t*>(lengths), N, L, lb,
                          whole != 0, static_cast<int32_t*>(uniq),
                          static_cast<int32_t*>(mult),
                          static_cast<int32_t*>(lens_u),
                          static_cast<cudaStream_t>(stream)))
}
