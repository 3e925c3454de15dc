// K17: the edits of a correction sub-pass at its weak windows.
//
// Replaces sage2_tpu/kmer/correct.py _phase2_kernel (:293), phase 2 of
// the two-phase single_window corrector: a gather of each weak window's
// forward and RC key (from three (N, P) key arrays), its four variant
// keys with base `off` set to A, C, G, T (set_base, eight a window), one
// lookup of all of them in the pruned count table, the replacement rule
// (the current base's count below the threshold, the maximum at or above
// it and reached by one variant only) and a scatter of the argmax.
//
// Membership first, counts only where they decide. "count >= threshold"
// is membership in the round's table of the solid keys (solid_table.cuh,
// built by K16 for this k and threshold), so the rule reads:
//   the current variant a member, or no member: no edit;
//   exactly one member (not the current one): the edit goes to it;
//   two or more members: their counts decide (looked up through K2's
//   bucket directory, bucket_search.cuh), the others count below the
//   threshold and can neither tie nor win.
// That is the rule itself for any table. Where the round built no
// membership table (threshold < 1, or kernels.solid_bits gave none), all
// four variants are looked up through K2's directory.
//
// Read-major, the copy inside the kernel. A first launch finds each tile's
// range of the weak windows (a bisection of the ascending indices a tile
// boundary); then a block takes a tile of R consecutive reads (R <= 64,
// fewer for long reads):
//   1. its threads load the tile's codes, coalesced (16-byte words where
//      the rows allow), into shared memory;
//   2. they pack each read and its reverse complement into 16-base words
//      (as K16 does), so that a window's forward and RC keys are two
//      shifts a word (key_at), no per-base gathers;
//   3. a thread a weak window of the range builds its four variant keys,
//      probes the three that are not the current base's (one sector each,
//      read together), and the current one only where one of them is
//      solid: where none is, no edit follows whatever the current one is
//      (most of K16's weak windows: an error makes up to k windows weak,
//      and mostly only the one whose varied base it is has a solid
//      variant). It
//      applies the rule and writes the edit into the tile's codes in
//      shared memory: window w edits base w + off only, the weak windows
//      are distinct, and every key comes from the words packed before any
//      edit;
//   4. the tile's rows go out, edits applied, coalesced.
// The wrapper makes no copy of its own. The range is searched in a launch
// of its own: two warps of each block searching it left ~5 dependent
// round trips at the start of every block (PERF.md).
//
// Bound: bytes, the reads in and out, the indices (8 bytes a weak window)
// and one membership sector a variant (the rare ties add K2's directory
// and table sectors).

#include "bucket_search.cuh"
#include "solid_table.cuh"

namespace {

// a tile's reads at most, and its shared memory (codes and words) at most;
// blocks an SM the launch bounds ask room for (the layouts tried: PERF.md)
constexpr int kMaxTileReads = 64;
constexpr int kTileBytes = 32768;
constexpr int kBlocksPerSm = 4;

// starts[t] for t <= tiles: the first index of widx[0, n) (ascending) at
// or past tile t's first window, (t R) P (a bisection a thread; the
// neighbours' first steps share their sectors).
__global__ void __launch_bounds__(kThreads)
    fix_starts_kernel(const int64_t* __restrict__ widx, int64_t n,
                      int64_t N, int R, int P, int64_t tiles,
                      int64_t* __restrict__ starts) {
  SAGE2_GRID_STRIDE(t, tiles + 1) {
    const int64_t x = (t * R < N ? t * R : N) * P;
    int64_t lo = 0, hi = n;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(reinterpret_cast<const long long*>(widx) + mid) < x) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    starts[t] = lo;
  }
}

// The counts of the variants that `want` names, through K2's directory
// (Keys: Int64Keys or PackedKeys, bucket_search.cuh); 0 elsewhere.
template <typename Keys>
struct CountLookup {
  Keys keys;
  const int32_t* __restrict__ dir;
  BucketSpan span;

  __device__ __forceinline__ void counts(const int64_t (&q)[4],
                                         const bool (&want)[4],
                                         int (&cnt)[4]) const {
    int32_t pos[4];
    bucket_find<4>(keys, dir, span, q, want, pos);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      cnt[b] = want[b] && pos[b] >= 0 ? keys.count(pos[b]) : 0;
    }
  }
};

// The replacement rule on the four variants' counts: the new base, or -1.
__device__ __forceinline__ int rule(const int (&cnt)[4], int cur,
                                    int threshold) {
  const int at_cur = cur == 0 ? cnt[0] : cur == 1 ? cnt[1]
                     : cur == 2 ? cnt[2] : cnt[3];
  int m = cnt[0], best = 0;
#pragma unroll
  for (int b = 1; b < 4; ++b) {
    if (cnt[b] > m) {
      m = cnt[b];
      best = b;
    }
  }
  int n_at_max = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) n_at_max += cnt[b] == m;
  return at_cur < threshold && m >= threshold && n_at_max == 1 ? best : -1;
}

// The four canonical variant keys of a window at base off: from the
// packed words of its read (fw) and of the read's reverse complement (rw).
__device__ __forceinline__ void variants(const uint32_t* fw,
                                         const uint32_t* rw, int W, int L,
                                         int k, int w, int off,
                                         int64_t* q) {
  const uint64_t f = static_cast<uint64_t>(key_at(fw, W, w, k));
  const uint64_t c = static_cast<uint64_t>(key_at(rw, W, L - k - w, k));
  const int sf = 2 * (k - 1 - off);   // base off in the forward key
  const int sr = 2 * off;             // ... and in the RC key
  const uint64_t f0 = f & ~(uint64_t{3} << sf);
  const uint64_t c0 = c & ~(uint64_t{3} << sr);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int64_t vf = static_cast<int64_t>(f0 | (uint64_t(b) << sf));
    const int64_t vr = static_cast<int64_t>(c0 | (uint64_t(3 - b) << sr));
    q[b] = vr < vf ? vr : vf;
  }
}

// The edit of a window from its variants' membership mask m (kSolid; bit
// b: variant b is solid) and, where they decide, their counts: the new
// base, or -1.
template <bool kSolid, typename Keys>
__device__ __forceinline__ int decide(const CountLookup<Keys>& counts,
                                      const int64_t (&q)[4], unsigned m,
                                      int cur, int threshold) {
  bool want[4] = {true, true, true, true};
  if (kSolid) {
    if (m == 0 || (m >> cur & 1u)) return -1;
    if ((m & (m - 1)) == 0) return __ffs(m) - 1;     // one member
#pragma unroll
    for (int b = 0; b < 4; ++b) want[b] = m >> b & 1u;
  }
  int cnt[4];
  counts.counts(q, want, cnt);
  return rule(cnt, cur, threshold);
}

// One tile (see the header). Dynamic shared memory: the tile's codes (R L
// int32), then its reads' words and their reverse complements' (R W
// uint32 each).
template <bool kSolid, typename Keys>
__device__ __forceinline__ void fix_tile(
    const int32_t* __restrict__ reads, int64_t N, int L, int k, int R,
    const SolidLookup& members, const CountLookup<Keys>& counts,
    int threshold, int off, const int64_t* __restrict__ widx,
    const int64_t* __restrict__ starts, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t code[];
  const int W = (L + 15) / 16;
  const int P = L - k + 1;
  uint32_t* fw = reinterpret_cast<uint32_t*>(code + R * L);
  uint32_t* rw = fw + R * W;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * R;
  const int nr = static_cast<int>(N - r0 < R ? N - r0 : R);
  const int64_t lo = __ldg(reinterpret_cast<const long long*>(starts) +
                           blockIdx.x);
  const int64_t hi = __ldg(reinterpret_cast<const long long*>(starts) +
                           blockIdx.x + 1);
  const int32_t* src = reads + r0 * L;
  int32_t* dst = out + r0 * L;
  const bool vec = (L & 3) == 0;    // rows of whole 16-byte words
  if (vec) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* c4 = reinterpret_cast<int4*>(code);
    for (int i = threadIdx.x; i < nr * L / 4; i += kThreads) {
      c4[i] = __ldcs(s4 + i);
    }
  } else {
    for (int i = threadIdx.x; i < nr * L; i += kThreads) {
      code[i] = __ldcs(src + i);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * W; i += kThreads) {
    const int j = i / W, t = i - j * W;
    pack_word(code + j * L, L, t, fw + j * W + t, rw + j * W + t);
  }
  __syncthreads();
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    const uint32_t x = static_cast<uint32_t>(
        __ldg(reinterpret_cast<const long long*>(widx) + i) - r0 * P);
    const int j = static_cast<int>(x / static_cast<uint32_t>(P));
    const int w = static_cast<int>(x - static_cast<uint32_t>(j) * P);
    int32_t* base = code + j * L + w + off;
    int64_t q[4];
    variants(fw + j * W, rw + j * W, W, L, k, w, off, q);
    const int cur = *base & 3;
    unsigned m = 0;
    if (kSolid) {     // the other three; the current one beside a solid one
      const bool other[4] = {cur != 0, cur != 1, cur != 2, cur != 3};
      bool in[4];
      members.member<4>(q, other, in);
      m = in[0] | in[1] << 1 | in[2] << 2 | in[3] << 3;
      if (m != 0) {
        const int64_t qc[1] = {cur == 0 ? q[0] : cur == 1 ? q[1]
                               : cur == 2 ? q[2] : q[3]};
        const bool live[1] = {true};
        bool at[1];
        members.member<1>(qc, live, at);
        m |= static_cast<unsigned>(at[0]) << cur;
      }
    }
    const int edit = decide<kSolid>(counts, q, m, cur, threshold);
    if (edit >= 0) *base = edit;
  }
  __syncthreads();
  if (vec) {
    const int4* c4 = reinterpret_cast<const int4*>(code);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < nr * L / 4; i += kThreads) {
      __stcs(d4 + i, c4[i]);
    }
  } else {
    for (int i = threadIdx.x; i < nr * L; i += kThreads) {
      __stcs(dst + i, code[i]);
    }
  }
}

template <typename Keys>
__device__ __forceinline__ void fix_tile_by(
    bool solid_ok, const int32_t* __restrict__ reads, int64_t N, int L,
    int k, int R, const SolidLookup& members, const CountLookup<Keys>& counts,
    int threshold, int off, const int64_t* __restrict__ widx,
    const int64_t* __restrict__ starts, int32_t* __restrict__ out) {
  if (solid_ok) {
    fix_tile<true>(reads, N, L, k, R, members, counts, threshold, off, widx,
                   starts, out);
  } else {
    fix_tile<false>(reads, N, L, k, R, members, counts, threshold, off,
                    widx, starts, out);
  }
}

// The lookup structures' headers are read on the card, uniform over the
// grid: the membership table where it was built for this k and
// threshold, K2's packed or int64 entries.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    fix_windows_kernel(const int32_t* __restrict__ reads, int64_t N, int L,
                       int k, int R, const int64_t* __restrict__ table,
                       const int32_t* __restrict__ counts, int64_t T,
                       const int64_t* __restrict__ scratch,
                       const int64_t* __restrict__ solid, int threshold,
                       int off, const int64_t* __restrict__ widx,
                       const int64_t* __restrict__ starts,
                       int32_t* __restrict__ out) {
  SolidLookup members{nullptr, nullptr, 2 * k, 0};
  const bool solid_ok = solid_lookup(solid, k, threshold, &members);
  const BucketSpan span = load_span(scratch);
  const int32_t* dir = dir_of(scratch, T);
  if (ldg_key(scratch + 3)) {
    const CountLookup<PackedKeys> c{
        PackedKeys{packed_of(scratch), suffix_mask(span.shift)}, dir, span};
    fix_tile_by(solid_ok, reads, N, L, k, R, members, c, threshold, off,
                widx, starts, out);
  } else {
    const CountLookup<Int64Keys> c{Int64Keys{table, counts}, dir, span};
    fix_tile_by(solid_ok, reads, N, L, k, R, members, c, threshold, off,
                widx, starts, out);
  }
}

// R reads a tile: at most kMaxTileReads, in about kTileBytes of shared
// memory, at least 1; 0 where one read's codes and words pass smem_max,
// the block's shared memory
inline int tile_reads(int L, int smem_max) {
  const int row = 4 * L + 8 * ((L + 15) / 16);
  if (row > smem_max) return 0;
  const int R = kTileBytes / row;
  return R < 1 ? 1 : R > kMaxTileReads ? kMaxTileReads : R;
}

// tile_reads on the current card
inline cudaError_t card_tile_reads(int L, int* R) {
  int dev = 0, smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  }
  *R = tile_reads(L, smem);
  if (e == cudaSuccess && *R == 0) e = cudaErrorInvalidValue;
  return e;
}

}  // namespace

// *tiles (a host int64): the tiles of N reads of length L, each a block of
// sage2_fix_windows, or -1 where one read of L bases does not fit a
// block's shared memory (about 51,600 bases on an H100).
SAGE2_EXPORT int sage2_fix_tiles(int64_t N, int L, void* tiles) {
  int R = 0;
  const cudaError_t e = card_tile_reads(L, &R);
  if (e != cudaSuccess && e != cudaErrorInvalidValue) {
    return static_cast<int>(e);
  }
  *static_cast<int64_t*>(tiles) = R == 0 ? -1 : (N + R - 1) / R;
  return 0;
}

// widx: (n,) int64 flat window indices r * (L - k + 1) + w of N reads of
// length L, ascending; starts: (tiles + 1,) int64 out (sage2_fix_tiles'
// tiles): each tile's first weak window, then n.
SAGE2_EXPORT int sage2_fix_starts(const void* widx, int64_t n, int64_t N,
                                  int L, int k, void* starts, void* stream) {
  int R = 0;
  const cudaError_t e = card_tile_reads(L, &R);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t tiles = (N + R - 1) / R;
  fix_starts_kernel<<<sage2_blocks(tiles + 1), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(widx), n, N, R, L - k + 1, tiles,
      static_cast<int64_t*>(starts));
  return static_cast<int>(cudaGetLastError());
}

// reads: (N, L) int32 codes 0-3; table: (T,) sorted unique int64
// canonical keys (1 < k <= 31), counts (T,) int32; scratch: the round's
// K2 bucket directory (sage2_lookup_directory); solid: the membership
// table of the solid keys behind it (kernels.table_directory) or NULL,
// used where its header names this k and threshold; widx: (n,) int64 flat
// window indices r * (L - k + 1) + w, ascending and distinct; off: k - 1
// (the window's last base) or 0 (its first); starts: sage2_fix_starts';
// out: (N, L) int32, the reads with the edits. A tile of reads a block.
SAGE2_EXPORT int sage2_fix_windows(const void* reads, int64_t N, int L,
                                   int k, const void* table,
                                   const void* counts, int64_t T,
                                   const void* scratch, const void* solid,
                                   int threshold, int off, const void* widx,
                                   const void* starts, void* out,
                                   void* stream) {
  int R = 0;
  const cudaError_t e = card_tile_reads(L, &R);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int W = (L + 15) / 16;
  const size_t smem = static_cast<size_t>(R) * (4 * L + 8 * W);
  if (smem > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(
        fix_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (a != cudaSuccess) return static_cast<int>(a);
  }
  const int64_t tiles = (N + R - 1) / R;
  fix_windows_kernel<<<static_cast<unsigned>(tiles), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(reads), N, L, k, R,
      static_cast<const int64_t*>(table), static_cast<const int32_t*>(counts),
      T, static_cast<const int64_t*>(scratch),
      static_cast<const int64_t*>(solid), threshold, off,
      static_cast<const int64_t*>(widx),
      static_cast<const int64_t*>(starts), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
