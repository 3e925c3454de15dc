// K8: per-read canonical orientation for the dedup stage: the reverse
// complement of each read's real bases, the packed words of the read and
// of its reverse complement, and which of the two is the canonical form.
//
// Replaces sage2_tpu/overlap/prepare.py revcomp_ragged (:55) and the
// per-read part of prepare_reads (:67; lines 81-93 and 132-134: the
// zero-padded read, its reverse complement, both packings and the
// words_less choice). On the TPU that was a take_along_axis gather over
// an (N, L) index, two word packings of 16 shifted slices each, and a
// word-by-word compare loop, each a pass over device memory.
//
// Here a block owns a tile of R consecutive reads (R L codes, about
// kTileCodes), which is one contiguous span of the (N, L) int32 codes:
//
//   load   the span comes in by 16-byte loads (kLoads in flight a
//          thread; the span's unaligned ends by scalar loads) and is
//          packed on arrival into a 2-bit stream in shared memory, 16
//          codes a 32-bit word, the first in the top bits: each 16-byte
//          load becomes one byte of the stream;
//   words  a thread a (read, word) pair of the tile: word t of the read
//          is the stream's 32 bits at the read's base 16 t (two shared
//          words and a funnel shift), that of its reverse complement the
//          32 bits ending at base len - 1 - 16 t with the 2-bit groups
//          reversed (__brev and a swap of each pair's bits) and
//          complemented; codes past the length masked to 0 (the last
//          word left-aligned, as ops/bitpack.py pack_read_words does).
//          The words go out by coalesced 8-byte stores;
//   take   each warp ballots which of its pairs differ and where the
//          reverse complement is the smaller; a thread a read then finds
//          the read's first differing word in those bits: take_rc = rc_w
//          < fwd_w there (false when all are equal);
//   rc     the reverse-complement rows, rc[j] = 3 - read[len - 1 - j]
//          for j < len, 0 past it (with no lengths, len = L: the plain
//          (3 - r).flip), unpacked from the stream and written by 16-byte
//          stores (the rows' unaligned ends by scalar ones).
//
// Codes past a read's length count as 0 whatever the input holds there.
// The three outputs are each optional: a NULL rc writes no rows (the
// dedup's first call where K12 sorts its strings in one pass, and the
// streamed dedup), NULL words no words and no choice (the dedup's second
// call: the reverse-complement rows of the unique reads, written straight
// into the second half of reads2).
//
// Bound: bytes. The codes are read once from device memory; the words,
// the flags and the rows, where asked for, are written once. Packing is a
// few shared-memory operations a word, so a tile's time is its loads and
// stores.

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
// codes a tile holds (R = kTileCodes / L reads, at least 1, at most
// kMaxTileReads)
constexpr int kTileCodes = 4096;
constexpr int kMaxTileReads = 512;
// 16-byte loads a thread keeps in flight
constexpr int kLoads = 4;

struct Geometry {
  int R;          // reads a tile
  int SW;         // shared words of the stream, with a zero word each side
  int D;          // ballot words of the (read, word) pairs
  size_t smem;    // dynamic shared memory of a block
};

Geometry geometry(int L, int W) {
  Geometry g;
  g.R = L > 0 ? kTileCodes / L : kMaxTileReads;
  if (g.R > kMaxTileReads) g.R = kMaxTileReads;
  if (g.R < 1) g.R = 1;
  g.SW = (g.R * L + 18) / 16 + 2;
  g.D = (g.R * W + kWarp - 1) / kWarp;
  g.smem = sizeof(uint32_t) * (g.SW + g.R + 2 * g.D);
  return g;
}

__device__ __forceinline__ uint32_t pack4(int4 v) {
  return ((static_cast<uint32_t>(v.x) & 3u) << 6) |
         ((static_cast<uint32_t>(v.y) & 3u) << 4) |
         ((static_cast<uint32_t>(v.z) & 3u) << 2) |
         (static_cast<uint32_t>(v.w) & 3u);
}

// The 16 codes of stream positions [q, q + 16) as a big-endian word;
// ``s`` is the stream's shared array with its leading zero word, q >= -16.
__device__ __forceinline__ uint32_t window(const uint32_t* s, int q) {
  const int i = (q + 16) >> 4, o = (q + 16) & 15;
  return __funnelshift_l(s[i + 1], s[i], 2 * o);
}

// The word with its 16 2-bit groups in reverse order.
__device__ __forceinline__ uint32_t reverse_groups(uint32_t x) {
  const uint32_t y = __brev(x);
  return ((y >> 1) & 0x55555555u) | ((y & 0x55555555u) << 1);
}

template <bool kWords, bool kRows>
__global__ void __launch_bounds__(kThreads)
    canonical_tile_kernel(const int32_t* __restrict__ reads,
                          const int32_t* __restrict__ lengths,
                          int64_t n_reads, int L, int W, Geometry g,
                          int32_t* __restrict__ rc,
                          int64_t* __restrict__ fwd_w,
                          int64_t* __restrict__ rc_w,
                          bool* __restrict__ take_rc) {
  extern __shared__ uint32_t smem[];
  uint32_t* stream = smem + 1;
  int* s_len = reinterpret_cast<int*>(smem + g.SW);
  uint32_t* s_diff = smem + g.SW + g.R;
  uint32_t* s_lt = s_diff + g.D;

  const int64_t r0 = blockIdx.x * int64_t{g.R};
  const int n = static_cast<int>(min(int64_t{g.R}, n_reads - r0));
  const int cnt = n * L;
  const int32_t* tile = reads + r0 * L;
  // stream position of the tile's first code: its element offset from
  // the 16-byte boundary below it
  const int shift =
      static_cast<int>((reinterpret_cast<uintptr_t>(tile) >> 2) & 3);
  const int4* chunks = reinterpret_cast<const int4*>(tile - shift);
  const int n_chunks = (shift + cnt + 3) >> 2;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(stream);
  for (int c0 = threadIdx.x; c0 < n_chunks; c0 += kLoads * kThreads) {
    int4 v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int c = c0 + k * kThreads;
      const int lo = 4 * c - shift;     // the chunk's first code in the tile
      if (c < n_chunks && lo >= 0 && lo + 4 <= cnt) {
        v[k] = __ldg(chunks + c);
      } else {
        int e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          e[i] = c < n_chunks && lo + i >= 0 && lo + i < cnt
                     ? __ldg(tile + lo + i) : 0;
        }
        v[k] = make_int4(e[0], e[1], e[2], e[3]);
      }
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int c = c0 + k * kThreads;
      // chunk c is byte c of the stream: byte 3 - c % 4 of word c / 4
      if (c < n_chunks) bytes[(c & ~3) | (3 - (c & 3))] = pack4(v[k]);
    }
  }
  for (int r = threadIdx.x; r < n; r += kThreads) {
    s_len[r] =
        lengths == nullptr ? L : min(max(__ldg(lengths + r0 + r), 0), L);
  }
  if (threadIdx.x == 0) {
    smem[0] = 0;            // before the stream, and its last word
    smem[g.SW - 1] = 0;
  }
  __syncthreads();

  if (kWords) {
    const int RW = n * W;
    const int RW32 = (RW + kWarp - 1) & ~(kWarp - 1);
    // every lane of a warp takes the same trips: the ballots are whole
    for (int it = threadIdx.x; it < RW32; it += kThreads) {
      uint32_t f = 0, c = 0;
      if (it < RW) {
        const int r = it / W, t = it - r * W;
        const int len = s_len[r];
        const int fill = min(max(len - 16 * t, 0), 16);  // real codes
        if (fill > 0) {
          const uint32_t keep =
              fill == 16 ? 0xffffffffu : ~(0xffffffffu >> (2 * fill));
          const int q0 = shift + r * L;
          f = window(smem, q0 + 16 * t) & keep;
          c = ~reverse_groups(window(smem, q0 + len - 16 - 16 * t)) & keep;
        }
        fwd_w[r0 * W + it] = f;
        rc_w[r0 * W + it] = c;
      }
      const unsigned differ = __ballot_sync(0xffffffffu, f != c);
      const unsigned less = __ballot_sync(0xffffffffu, c < f);
      if ((threadIdx.x & (kWarp - 1)) == 0) {
        s_diff[it / kWarp] = differ;
        s_lt[it / kWarp] = less;
      }
    }
  }

  if (kRows && cnt > 0) {
    int32_t* out = rc + r0 * L;
    const int oshift =
        static_cast<int>((reinterpret_cast<uintptr_t>(out) >> 2) & 3);
    int4* ochunks = reinterpret_cast<int4*>(out - oshift);
    const int n_out = (oshift + cnt + 3) >> 2;
    for (int c = threadIdx.x; c < n_out; c += kThreads) {
      const int lo = 4 * c - oshift;
      int e = max(lo, 0);
      int r = e / L, j = e - r * L;
      int code[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        code[i] = 0;
        if (lo + i < 0 || lo + i >= cnt) continue;
        const int len = s_len[r];
        if (j < len) {
          const int q = shift + r * L + len - 1 - j;
          code[i] = 3 - static_cast<int>(
                            (stream[q >> 4] >> (30 - 2 * (q & 15))) & 3u);
        }
        if (++j == L) {
          j = 0;
          ++r;
        }
      }
      if (lo >= 0 && lo + 4 <= cnt) {
        ochunks[c] = make_int4(code[0], code[1], code[2], code[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (lo + i >= 0 && lo + i < cnt) out[lo + i] = code[i];
        }
      }
    }
  }

  if (kWords) {
    __syncthreads();
    for (int r = threadIdx.x; r < n; r += kThreads) {
      int pos = r * W;
      const int end = pos + W;
      bool less = false;
      while (pos < end) {
        const int w = pos / kWarp, b = pos % kWarp;
        uint32_t bits = s_diff[w] >> b;
        if (end - pos < kWarp - b) bits &= (1u << (end - pos)) - 1u;
        if (bits != 0u) {
          less = (s_lt[w] >> (b + __ffs(bits) - 1)) & 1u;
          break;
        }
        pos += kWarp - b;
      }
      take_rc[r0 + r] = less;
    }
  }
}

template <bool kWords, bool kRows>
cudaError_t launch(const void* reads, const void* lengths, int64_t n_reads,
                   int L, void* rc, void* fwd_w, void* rc_w, void* take_rc,
                   cudaStream_t stream) {
  const int W = (L + 15) / 16;
  const Geometry g = geometry(L, W);
  const auto kernel = canonical_tile_kernel<kWords, kRows>;
  if (g.smem > 48 * 1024) {
    const cudaError_t rc_attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(g.smem));
    if (rc_attr != cudaSuccess) return rc_attr;
  }
  const int64_t blocks = (n_reads + g.R - 1) / g.R;
  canonical_tile_kernel<kWords, kRows>
      <<<static_cast<unsigned>(blocks), kThreads, g.smem, stream>>>(
      static_cast<const int32_t*>(reads),
      static_cast<const int32_t*>(lengths), n_reads, L, W, g,
      static_cast<int32_t*>(rc), static_cast<int64_t*>(fwd_w),
      static_cast<int64_t*>(rc_w), static_cast<bool*>(take_rc));
  return cudaGetLastError();
}

}  // namespace

// reads: (n_reads, L) int32 codes 0-3; lengths: (n_reads,) int32 or NULL
// (every read is L long); rc: (n_reads, L) int32 rows (any 4-byte
// aligned address: a view into a larger array) or NULL for none; fwd_w,
// rc_w: (n_reads, W) int64 words holding uint32 values, W = ceil(L / 16),
// and take_rc: (n_reads,) bool, or all three NULL for the rows alone.
// n_reads >= 1; 0 <= L <= 2^19 (a read's stream fits a block's shared
// memory).
SAGE2_EXPORT int sage2_canonical_reads(const void* reads, const void* lengths,
                                       int64_t n_reads, int L, void* rc,
                                       void* fwd_w, void* rc_w, void* take_rc,
                                       void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_reads < 1 || L < 0 || L > (1 << 19)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (fwd_w != nullptr && rc != nullptr) {
    err = launch<true, true>(reads, lengths, n_reads, L, rc, fwd_w, rc_w,
                             take_rc, s);
  } else if (fwd_w != nullptr) {
    err = launch<true, false>(reads, lengths, n_reads, L, rc, fwd_w, rc_w,
                              take_rc, s);
  } else if (rc != nullptr) {
    err = launch<false, true>(reads, lengths, n_reads, L, rc, fwd_w, rc_w,
                              take_rc, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
