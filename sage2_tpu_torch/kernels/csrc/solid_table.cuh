// The membership table of a round's solid keys (built by K16,
// weak_windows.cu) and the packed words of reads, shared by K16 and K17
// (fix_windows.cu): K16 asks whether a window's canonical key is absent
// (weak), K17 which of a weak window's four variants are present (solid).
//
//   layout  a header of kSolidHeader int64 words {built, k, threshold,
//           bits}, then 2^bits buckets of one 32-byte sector, eight uint32
//           words. A key x of B = 2k bits goes by its mix h = ((x ^ (x >>
//           B/2)) * kMix) mod 2^B, a bijection of the B-bit keys, to bucket
//           h >> (B - bits), and the bucket holds h's low B - bits bits:
//           exact, and below 2^31 where B - bits <= 31 (else no table is
//           built). Unused words are kEmpty; a bucket of more than eight
//           keys keeps seven and in its last word kLink | the offset of an
//           overflow list (its length, then its other keys), in the uint32
//           words after the buckets.
//
// A probe reads one sector (an overfull bucket's list beside it where the
// key is not among its seven).

#pragma once

#include <cstdint>

#include "common.cuh"

constexpr int kWays = 8;                 // keys a bucket (one sector)
constexpr uint32_t kEmpty = 0xffffffffu;
constexpr uint32_t kLink = 0x80000000u;
constexpr uint64_t kMix = 0x9E3779B97F4A7C15ull;
constexpr int kSolidHeader = 4;          // int64 words: built, k, threshold,
                                         // bits

// The mix of a key of B bits (2 < B <= 62): a bijection of [0, 2^B).
__device__ __forceinline__ uint64_t solid_mix(uint64_t x, int B) {
  x ^= x >> (B / 2);
  return (x * kMix) & ((uint64_t{1} << B) - 1);
}

// bases [q, q + 16) of packed words (W uint32), zero past the last word
__device__ __forceinline__ uint32_t word_at_u32(const uint32_t* w, int W,
                                                int q) {
  const int i = q >> 4, r = q & 15;
  const uint32_t cur = i < W ? w[i] : 0u;
  if (r == 0) return cur;
  const uint32_t nxt = i + 1 < W ? w[i + 1] : 0u;
  return (cur << (2 * r)) | (nxt >> (32 - 2 * r));
}

// the exact 2k-bit key (k <= 31) of the k bases from q of packed words
__device__ __forceinline__ int64_t key_at(const uint32_t* w, int W, int q,
                                          int k) {
  const uint32_t hi = word_at_u32(w, W, q);
  if (k <= 16) return static_cast<int64_t>(hi >> (32 - 2 * k));
  const uint32_t lo = word_at_u32(w, W, q + 16) >> (32 - 2 * (k - 16));
  return static_cast<int64_t>((static_cast<uint64_t>(hi) << (2 * (k - 16))) |
                              lo);
}

// Word t of a read of L codes (`code`, any stride-1 array) and of its
// reverse complement (codes 3 - code[L - 1 - i]): 16 bases a word,
// big-endian, zero past the read.
template <class Code>
__device__ __forceinline__ void pack_word(const Code* code, int L, int t,
                                          uint32_t* f, uint32_t* c) {
  uint32_t a = 0, b = 0;
  for (int i = 0; i < 16; ++i) {
    const int j = 16 * t + i;
    a = (a << 2) | (j < L ? static_cast<uint32_t>(code[j]) : 0u);
    b = (b << 2) | (j < L ? 3u - static_cast<uint32_t>(code[L - 1 - j]) : 0u);
  }
  *f = a;
  *c = b;
}

// Membership of C canonical keys in the table of the solid keys.
struct SolidLookup {
  const uint4* __restrict__ buckets;   // two a bucket
  const uint32_t* __restrict__ lists;  // the overflow lists
  int B, low;                          // key bits, bits kept in a bucket

  // out[c]: live[c] and key q[c] is in the table (the C sectors are read
  // together)
  template <int C>
  __device__ __forceinline__ void member(const int64_t (&q)[C],
                                         const bool (&live)[C],
                                         bool (&out)[C]) const {
    uint4 w0[C], w1[C];
    uint32_t v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint64_t h = solid_mix(static_cast<uint64_t>(q[c]), B);
      const uint64_t b = live[c] ? h >> low : 0;   // a dead key: bucket 0
      v[c] = static_cast<uint32_t>(h & ((uint64_t{1} << low) - 1));
      w0[c] = __ldg(buckets + 2 * b);
      w1[c] = __ldg(buckets + 2 * b + 1);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      bool found = w0[c].x == v[c] || w0[c].y == v[c] || w0[c].z == v[c] ||
                   w0[c].w == v[c] || w1[c].x == v[c] || w1[c].y == v[c] ||
                   w1[c].z == v[c] || w1[c].w == v[c];
      const uint32_t link = w1[c].w;
      if (!found && (link & kLink) && link != kEmpty) {  // an overfull one
        const uint32_t* list = lists + (link & ~kLink);
        const uint32_t n = __ldg(list);
        for (uint32_t i = 1; i <= n && !found; ++i) found = __ldg(list + i) == v[c];
      }
      out[c] = live[c] && found;
    }
  }

  // The weak verdicts: live and absent.
  template <int C>
  __device__ __forceinline__ void weak(const int64_t (&q)[C],
                                       const bool (&live)[C],
                                       bool (&out)[C]) const {
    bool in[C];
    member<C>(q, live, in);
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = live[c] && !in[c];
  }
};

// The lookup of the membership table `solid` (its header first, or NULL)
// where it was built for this k and threshold; false where it was not
// (then the caller looks up through K2's directory).
__device__ __forceinline__ bool solid_lookup(const int64_t* __restrict__ solid,
                                             int k, int threshold,
                                             SolidLookup* out) {
  if (solid == nullptr ||
      __ldg(reinterpret_cast<const long long*>(solid)) != 1 ||
      __ldg(reinterpret_cast<const long long*>(solid) + 1) != k ||
      __ldg(reinterpret_cast<const long long*>(solid) + 2) != threshold) {
    return false;
  }
  const int bits =
      static_cast<int>(__ldg(reinterpret_cast<const long long*>(solid) + 3));
  const auto* buckets = reinterpret_cast<const uint4*>(solid + kSolidHeader);
  *out = SolidLookup{
      buckets, reinterpret_cast<const uint32_t*>(buckets + (2ll << bits)),
      2 * k, 2 * k - bits};
  return true;
}
