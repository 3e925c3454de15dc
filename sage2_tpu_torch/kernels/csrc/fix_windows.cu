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
// One thread a weak window: it reads the window's k codes from the read
// (the weak windows of a read lie together, so its row comes through L1
// once), builds the forward and RC keys as K1 does, the four variant
// canonical keys (base `off` of the window is k-mer position `off` of the
// forward key and k - 1 - off of the RC key, with complemented codes),
// looks the four up together through the bucket directory of K2
// (bucket_search.cuh; the round's directory, shared with K16), applies
// the rule and writes the edit into the output copy of the reads. Window
// w edits base w + off only, and the weak windows are distinct, so no two
// threads write one base.
//
// Bound: lookups (four random L2 sectors or so a weak window); the
// indices (8 bytes), the k codes and one code out are the bytes.

#include "bucket_search.cuh"
#include "common.cuh"

namespace {

template <typename Keys>
__device__ __forceinline__ void fix_window(
    const Keys& keys, const int32_t* __restrict__ dir, const BucketSpan& span,
    const int32_t* __restrict__ reads, int L, int k, int threshold, int off,
    int64_t idx, int32_t* __restrict__ out) {
  const int P = L - k + 1;
  const int64_t r = idx / P;
  const int w = static_cast<int>(idx - r * P);
  const int32_t* codes = reads + r * L + w;
  uint64_t f = 0, c = 0;
  for (int j = 0; j < k; ++j) {
    const uint64_t b = static_cast<uint64_t>(codes[j]);
    f = (f << 2) | b;
    c |= (3 - b) << (2 * j);
  }
  const int cur = codes[off];
  const int sf = 2 * (k - 1 - off);   // base off in the forward key
  const int sr = 2 * off;             // ... and in the RC key
  const uint64_t f0 = f & ~(uint64_t{3} << sf);
  const uint64_t c0 = c & ~(uint64_t{3} << sr);
  int64_t q[4];
  bool live[4];
  int32_t pos[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int64_t vf = static_cast<int64_t>(f0 | (uint64_t(b) << sf));
    const int64_t vr = static_cast<int64_t>(c0 | (uint64_t(3 - b) << sr));
    q[b] = vr < vf ? vr : vf;
    live[b] = true;
  }
  bucket_find<4>(keys, dir, span, q, live, pos);
  int cnt[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) cnt[b] = pos[b] >= 0 ? keys.count(pos[b]) : 0;
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
  if (cnt[cur] < threshold && m >= threshold && n_at_max == 1) {
    out[r * L + w + off] = best;
  }
}

template <typename Keys>
__device__ __forceinline__ void fix_all(
    const Keys& keys, const int32_t* __restrict__ dir, const BucketSpan& span,
    const int32_t* __restrict__ reads, int L, int k, int threshold, int off,
    const int64_t* __restrict__ widx, int64_t n, int32_t* __restrict__ out) {
  SAGE2_GRID_STRIDE(i, n) {
    fix_window(keys, dir, span, reads, L, k, threshold, off, __ldg(
                   reinterpret_cast<const long long*>(widx) + i), out);
  }
}

__global__ void __launch_bounds__(kThreads)
    fix_windows_kernel(const int32_t* __restrict__ reads, int L, int k,
                       const int64_t* __restrict__ table,
                       const int32_t* __restrict__ counts, int64_t T,
                       const int64_t* __restrict__ scratch, int threshold,
                       int off, const int64_t* __restrict__ widx, int64_t n,
                       int32_t* __restrict__ out) {
  const BucketSpan span = load_span(scratch);
  const int32_t* dir = dir_of(scratch, T);
  if (ldg_key(scratch + 3)) {         // packed (uniform over the grid)
    fix_all(PackedKeys{packed_of(scratch), suffix_mask(span.shift)}, dir,
            span, reads, L, k, threshold, off, widx, n, out);
  } else {
    fix_all(Int64Keys{table, counts}, dir, span, reads, L, k, threshold, off,
            widx, n, out);
  }
}

}  // namespace

// reads: (N, L) int32 codes 0-3; table: (T,) sorted unique int64
// canonical keys (1 < k <= 31), counts (T,) int32, scratch: their bucket
// directory (sage2_lookup_directory); widx: (n,) int64 distinct flat
// window indices r * (L - k + 1) + w; off: k - 1 (the window's last base)
// or 0 (its first); out: a copy of reads, edited in place.
SAGE2_EXPORT int sage2_fix_windows(const void* reads, int L, int k,
                                   const void* table, const void* counts,
                                   int64_t T, const void* scratch,
                                   int threshold, int off, const void* widx,
                                   int64_t n, void* out, void* stream) {
  fix_windows_kernel<<<sage2_blocks(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(reads), L, k,
      static_cast<const int64_t*>(table), static_cast<const int32_t*>(counts),
      T, static_cast<const int64_t*>(scratch), threshold, off,
      static_cast<const int64_t*>(widx), n, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
