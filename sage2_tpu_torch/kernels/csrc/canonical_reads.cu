// K8: per-read canonical orientation for the dedup stage: the reverse
// complement of each read's real bases, the packed words of the read and
// of its reverse complement, and which of the two is the canonical form.
//
// Replaces sage2_tpu/overlap/prepare.py revcomp_ragged (:55) and the
// per-read part of prepare_reads (:67; lines 81-93 and 132-134: the
// zero-padded read, its reverse complement, both packings and the
// words_less choice). On the TPU that was a take_along_axis gather over
// an (N, L) index, two word packings of 16 shifted slices each, and a
// word-by-word compare loop, each a pass over device memory. Here one
// warp owns one read and produces all of it in one pass:
//
//   rc     rc[j] = 3 - read[len - 1 - j] for j < len, 0 past it (with
//          no lengths, len = L: the plain (3 - r).flip);
//   words  lane t builds word t of the read and of its reverse
//          complement (16 bases each, big-endian, the last word
//          left-aligned, zero past the length), as ops/bitpack.py
//          pack_read_words does;
//   take   the first word where the two packings differ decides:
//          take_rc = rc_w < fwd_w there (false when they are equal),
//          found with one warp ballot per 32 words.
//
// Codes past a read's length count as 0 whatever the input holds there.
// With rc_only the words and the choice are not written (the dedup
// stage's second launch, for the reverse-complement rows of the unique
// reads).
//
// Bound: bytes. Each read's codes are read once (twice through L1) and
// the reverse complement, two word rows and one flag are written; the
// arithmetic is a shift and an add per base.

#include "common.cuh"

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = kThreads / kWarp;

__device__ __forceinline__ int64_t pack_word(const int32_t* __restrict__ r,
                                             int len, int t, bool rc) {
  uint32_t w = 0;
  for (int i = 0; i < 16; ++i) {
    const int j = 16 * t + i;
    uint32_t b = 0;
    if (j < len) b = rc ? 3u - static_cast<uint32_t>(r[len - 1 - j])
                        : static_cast<uint32_t>(r[j]);
    w = (w << 2) | b;
  }
  return static_cast<int64_t>(w);
}

__global__ void canonical_reads_kernel(
    const int32_t* __restrict__ reads, const int32_t* __restrict__ lengths,
    int64_t n_reads, int L, int W, int32_t* __restrict__ rc,
    int64_t* __restrict__ fwd_w, int64_t* __restrict__ rc_w,
    bool* __restrict__ take_rc) {
  const int lane = threadIdx.x % kWarp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t r = blockIdx.x * int64_t{kWarpsPerBlock} + threadIdx.x / kWarp;
       r < n_reads; r += warps) {
    const int32_t* read = reads + r * L;
    const int len = lengths == nullptr ? L : min(max(lengths[r], 0), L);
    int32_t* rc_row = rc + r * L;
    for (int j = lane; j < L; j += kWarp) {
      rc_row[j] = j < len ? 3 - read[len - 1 - j] : 0;
    }
    if (fwd_w == nullptr) continue;
    bool decided = false, less = false;
    for (int t0 = 0; t0 < W; t0 += kWarp) {
      const int t = t0 + lane;
      int64_t f = 0, c = 0;
      if (t < W) {
        f = pack_word(read, len, t, false);
        c = pack_word(read, len, t, true);
        fwd_w[r * W + t] = f;
        rc_w[r * W + t] = c;
      }
      const unsigned differ = __ballot_sync(0xffffffffu, t < W && f != c);
      const unsigned lt = __ballot_sync(0xffffffffu, t < W && c < f);
      if (!decided && differ != 0u) {
        decided = true;
        less = (lt >> (__ffs(differ) - 1)) & 1u;
      }
    }
    if (lane == 0) take_rc[r] = less;
  }
}

// reads, rc: (n_reads, L) int32 codes 0-3; lengths: (n_reads,) int32 or
// NULL (every read is L long); fwd_w, rc_w: (n_reads, W) int64 words
// holding uint32 values, W = ceil(L / 16), and take_rc: (n_reads,) bool,
// or all three NULL for the reverse complements alone.
SAGE2_EXPORT int sage2_canonical_reads(const void* reads, const void* lengths,
                                       int64_t n_reads, int L, void* rc,
                                       void* fwd_w, void* rc_w, void* take_rc,
                                       void* stream) {
  const int W = (L + 15) / 16;
  int64_t blocks = (n_reads + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;
  if (blocks < 1) blocks = 1;
  canonical_reads_kernel<<<static_cast<int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(reads),
      static_cast<const int32_t*>(lengths), n_reads, L, W,
      static_cast<int32_t*>(rc), static_cast<int64_t*>(fwd_w),
      static_cast<int64_t*>(rc_w), static_cast<bool*>(take_rc));
  return static_cast<int>(cudaGetLastError());
}
