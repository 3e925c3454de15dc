// K22: the dense single_window sub-pass of the meshed correction: the
// variant keys of every window, and the verdicts once their counts have
// come back from the k-mer owners.
//
// Replaces sage2_tpu/kmer/correct.py variant_keys_last (:36),
// variant_keys_first (:58) and apply_verdicts (:86), which the meshed
// correction (parallel/sharded.py:321-334) runs between routed lookups.
// On the TPU a window's forward and RC keys were (hi, lo) pairs built by
// static slices and dot products over the whole (N, P) grid, each variant
// an edit of a fixed 2-bit field and a lexicographic min. Here:
//
//   variants  one thread a window: its forward and RC keys (k <= 31, one
//             int64 each) from its k bases, then for b = 0..3 the forward
//             key with the last (first) base set to b and the RC key with
//             the complement set at the other end; each variant's
//             canonical key (the min) is written, 4 int64 a window, so a
//             warp writes one contiguous 1 KB run.
//   verdicts  one thread a base of the output reads: a base that a
//             window judges (window p judges base p + k - 1 for "last",
//             p for "first") reads its window's 4 counts and keeps or
//             replaces itself by the rule (current count below threshold,
//             best count at or above it, the best unique); every other
//             base is copied.
//
// Bound: bytes. The variants read each window's k codes (cached: a
// read's windows share them) and write 32 bytes a window; the verdicts
// read 16 bytes of counts a window and each base once, and write each
// base once.

#include "common.cuh"

namespace {

__global__ void window_variants_kernel(const int32_t* __restrict__ reads,
                                       int64_t N, int L, int k, int last,
                                       int64_t* __restrict__ keys) {
  const int P = L - k + 1;
  const int64_t hi_w = int64_t{1} << (2 * (k - 1));
  SAGE2_GRID_STRIDE(w, N * P) {
    const int64_t r = w / P;
    const int p = static_cast<int>(w % P);
    const int32_t* b = reads + r * L + p;
    int64_t fwd = 0, rc = 0;
    for (int j = 0; j < k; ++j) {
      fwd = fwd * 4 + b[j];
      rc = rc * 4 + (3 - b[k - 1 - j]);
    }
    const int64_t cur = last ? b[k - 1] : b[0];
    const int64_t w_fwd = last ? 1 : hi_w;
    const int64_t w_rc = last ? hi_w : 1;
    int64_t* out = keys + w * 4;
    for (int v = 0; v < 4; ++v) {
      const int64_t vf = fwd + (v - cur) * w_fwd;
      const int64_t vr = rc + (cur - v) * w_rc;
      out[v] = vf < vr ? vf : vr;
    }
  }
}

__global__ void apply_verdicts_kernel(const int32_t* __restrict__ reads,
                                      const int32_t* __restrict__ counts,
                                      int64_t N, int L, int k, int last,
                                      int threshold,
                                      int32_t* __restrict__ out) {
  const int P = L - k + 1;
  const int off = last ? k - 1 : 0;
  SAGE2_GRID_STRIDE(i, N * L) {
    const int64_t r = i / L;
    const int j = static_cast<int>(i % L);
    const int32_t base = reads[i];
    const int p = j - off;
    if (p < 0 || p >= P) {
      out[i] = base;
      continue;
    }
    const int32_t* c = counts + (r * P + p) * 4;
    int32_t m = c[0];
    int best = 0;
    for (int v = 1; v < 4; ++v) {
      if (c[v] > m) {
        m = c[v];
        best = v;
      }
    }
    int n_at_max = 0;
    for (int v = 0; v < 4; ++v) n_at_max += c[v] == m;
    const bool replace =
        c[base] < threshold && m >= threshold && n_at_max == 1;
    out[i] = replace ? best : base;
  }
}

}  // namespace

// reads: (N, L) int32 codes; keys: (N, L - k + 1, 4) int64 output; last:
// 1 for the last base of each window, 0 for the first; 1 < k <= 31.
SAGE2_EXPORT int sage2_window_variants(const void* reads, int64_t N, int L,
                                       int k, int last, void* keys,
                                       void* stream) {
  const int64_t n = N * (L - k + 1);
  window_variants_kernel<<<sage2_blocks(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(reads), N, L, k, last,
      static_cast<int64_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// counts: (N, L - k + 1, 4) int32 counts of the variant keys; out: (N, L)
// int32 output reads.
SAGE2_EXPORT int sage2_apply_verdicts(const void* reads, const void* counts,
                                      int64_t N, int L, int k, int last,
                                      int threshold, void* out,
                                      void* stream) {
  apply_verdicts_kernel<<<sage2_blocks(N * L), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(reads), static_cast<const int32_t*>(counts),
      N, L, k, last, threshold, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
