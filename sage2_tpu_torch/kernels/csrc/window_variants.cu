// K22: the dense variant lookups of the meshed correction: the variant
// keys of every window, and the single_window verdicts once their counts
// have come back from the k-mer owners.
//
// Replaces sage2_tpu/kmer/correct.py variant_keys_last (:36),
// variant_keys_first (:58), apply_verdicts (:86) and the variant keys of
// voting_round (:161-170, set_base + canonicalize_pair at each window
// position j), which the meshed correction (parallel/sharded.py:306-334)
// runs between routed lookups. On the TPU a window's forward and RC keys
// were (hi, lo) pairs built by static slices and dot products over the
// whole (N, P) grid, each variant an edit of a fixed 2-bit field and a
// lexicographic min. Here:
//
//   variants  one thread a window: its forward and RC keys (k <= 31, one
//             int64 each) from its k bases, then for b = 0..3 the forward
//             key with base j set to b (weight 4^(k-1-j)) and the RC key
//             with the complement set at position k - 1 - j (weight
//             4^j); each variant's canonical key (the min) is written, 4
//             int64 a window, so a warp writes one contiguous 1 KB run.
//             j = k - 1 is variant_keys_last, j = 0 variant_keys_first;
//             the voting rule asks for every j.
//   verdicts  one thread a base of the output reads: a base that a
//             window judges (window p judges base p + off, off = k - 1
//             for "last", 0 for "first") reads its window's 4 counts and
//             keeps or replaces itself by the rule (current count below
//             threshold, best count at or above it, the best unique);
//             every other base is copied. Ragged reads (a lengths
//             pointer): a window past its read's end (p >= len - k + 1)
//             judges nothing (window_valid, :99-100).
//
// Bound: bytes. The variants read each window's k codes (cached: a
// read's windows share them) and write 32 bytes a window; the verdicts
// read 16 bytes of counts a window and each base once, and write each
// base once.

#include "common.cuh"

namespace {

__global__ void window_variants_kernel(const int32_t* __restrict__ reads,
                                       int64_t N, int L, int k, int j,
                                       int64_t* __restrict__ keys) {
  const int P = L - k + 1;
  const int64_t w_fwd = int64_t{1} << (2 * (k - 1 - j));
  const int64_t w_rc = int64_t{1} << (2 * j);
  SAGE2_GRID_STRIDE(w, N * P) {
    const int64_t r = w / P;
    const int p = static_cast<int>(w % P);
    const int32_t* b = reads + r * L + p;
    int64_t fwd = 0, rc = 0;
    for (int i = 0; i < k; ++i) {
      fwd = fwd * 4 + b[i];
      rc = rc * 4 + (3 - b[k - 1 - i]);
    }
    const int64_t cur = b[j];
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
                                      const int32_t* __restrict__ lengths,
                                      int64_t N, int L, int k, int off,
                                      int threshold,
                                      int32_t* __restrict__ out) {
  const int P = L - k + 1;
  SAGE2_GRID_STRIDE(i, N * L) {
    const int64_t r = i / L;
    const int j = static_cast<int>(i % L);
    const int32_t base = reads[i];
    const int p = j - off;
    if (p < 0 || p >= P ||
        (lengths != nullptr && p >= lengths[r] - (k - 1))) {
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

// reads: (N, L) int32 codes; keys: (N, L - k + 1, 4) int64 output; j:
// the window position whose base varies, 0 <= j < k; 1 < k <= 31.
SAGE2_EXPORT int sage2_window_variants(const void* reads, int64_t N, int L,
                                       int k, int j, void* keys,
                                       void* stream) {
  const int64_t n = N * (L - k + 1);
  window_variants_kernel<<<sage2_blocks(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(reads), N, L, k, j,
      static_cast<int64_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// counts: (N, L - k + 1, 4) int32 counts of the variant keys; lengths:
// (N,) int32 read lengths, or NULL for fixed-length reads; off: the base
// a window judges, k - 1 ("last") or 0 ("first"); out: (N, L) int32
// output reads.
SAGE2_EXPORT int sage2_apply_verdicts(const void* reads, const void* counts,
                                      const void* lengths, int64_t N, int L,
                                      int k, int off, int threshold,
                                      void* out, void* stream) {
  apply_verdicts_kernel<<<sage2_blocks(N * L), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(reads), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(lengths), N, L, k, off, threshold,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
