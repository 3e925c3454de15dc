// K16: the flat indices of the weak windows of a correction sub-pass.
//
// Replaces sage2_tpu/kmer/correct.py _phase1_kernel (:270), phase 1 of
// the two-phase single_window corrector: the forward, RC and canonical
// keys of every window (three (N, P) key arrays), a lookup of every
// canonical key in the pruned count table, the weak mask (count below
// the threshold; for ragged reads only windows inside the read, :279-280)
// and a sort that moved the weak windows' flat indices to the front. At
// phase 4 of chip_smoke.py (2.3 M reads of 100, k = 25) the three key
// arrays alone were 1.4 GB each; here no key leaves the SM.
//
// Three launches around the scan of scan.cuh, over tiles of kTileReads
// reads (one warp takes kReadsPerWarp of them, one at a time):
//
//   mask   the lanes load the read's codes into shared memory (coalesced)
//          and pack the read and its reverse complement into 16-base words
//          (big-endian, as K13 packs); window w's forward key is then the
//          2k bits of the read's words at base w, its RC key those of the
//          RC read's words at base L - k - w (two shifts a word, no rolling),
//          so lane l can take windows l, l + 32, ...: four words of windows
//          a round, their canonical keys looked up together through the
//          bucket directory of K2 (bucket_search.cuh; built once a round by
//          kernels.lookup_directory over the pruned table). A ballot of the
//          weak verdicts is one 32-window word of the read's weak mask;
//          the tile's weak windows are counted;
//   scan   sage2_scan_tiles: each tile's first slot, and the total in a
//          device scalar, which the wrapper reads once to size the output;
//   write  each block recounts its reads' weak windows from their masks,
//          scans them, and each warp writes its read's weak windows'
//          flat indices r * P + w in ascending order (a warp scan of the
//          mask words' popcounts gives each word its first slot).
//
// Bound: lookups, that is random sectors of L2 (the pruned table's
// packed entries and directory, ~49 MB at phase 4); the reads (4 bytes a
// base), the mask (one bit a window, twice) and the indices (8 bytes a
// weak window) are the bytes.

#include "bucket_search.cuh"
#include "scan.cuh"

namespace {

constexpr int kWarpsPerTile = kThreads / 32;
constexpr int kReadsPerWarp = 4;
constexpr int kTileReads = kWarpsPerTile * kReadsPerWarp;
constexpr int kBatch = 4;     // mask words (32 windows each) a round

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

// one warp: the codes of a read into shared memory, then its words and
// its reverse complement's words (codes 3 - read[L - 1 - i])
__device__ __forceinline__ void pack_read(const int32_t* __restrict__ read,
                                          int L, int W, int lane,
                                          uint8_t* code, uint32_t* fw,
                                          uint32_t* rw) {
  for (int p = lane; p < L; p += 32) {
    code[p] = static_cast<uint8_t>(__ldcs(read + p));
  }
  __syncwarp();
  for (int t = lane; t < W; t += 32) {
    uint32_t f = 0, c = 0;
    for (int i = 0; i < 16; ++i) {
      const int j = 16 * t + i;
      f = (f << 2) | (j < L ? code[j] : 0u);
      c = (c << 2) | (j < L ? 3u - code[L - 1 - j] : 0u);
    }
    fw[t] = f;
    rw[t] = c;
  }
  __syncwarp();
}

template <typename Keys>
__device__ __forceinline__ void mask_tile(
    const Keys& keys, const int32_t* __restrict__ dir, const BucketSpan& span,
    const int32_t* __restrict__ reads, const int32_t* __restrict__ lengths,
    int64_t N, int L, int k, int threshold, uint32_t* __restrict__ mask,
    int64_t* __restrict__ tile_counts) {
  extern __shared__ uint32_t smem[];
  __shared__ int tile_weak;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = (L + 15) / 16;
  const int P = L - k + 1;
  const int PW = (P + 31) / 32;
  uint32_t* fw = smem + warp * (2 * W + (L + 3) / 4);
  uint32_t* rw = fw + W;
  uint8_t* code = reinterpret_cast<uint8_t*>(rw + W);
  if (threadIdx.x == 0) tile_weak = 0;
  __syncthreads();
  int n_weak = 0;
  for (int i = 0; i < kReadsPerWarp; ++i) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * kTileReads +
                      warp * kReadsPerWarp + i;
    if (r >= N) break;
    const int len = lengths == nullptr ? L : __ldg(lengths + r);
    const int Pv = len - k + 1 < P ? (len - k + 1 > 0 ? len - k + 1 : 0) : P;
    pack_read(reads + r * L, L, W, lane, code, fw, rw);
    for (int j0 = 0; j0 < PW; j0 += kBatch) {
      int64_t q[kBatch];
      bool live[kBatch];
      int32_t pos[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int w = 32 * (j0 + b) + lane;
        live[b] = w < Pv;
        q[b] = 0;
        if (live[b]) {
          const int64_t f = key_at(fw, W, w, k);
          const int64_t c = key_at(rw, W, L - k - w, k);
          q[b] = c < f ? c : f;
        }
      }
      bucket_find<kBatch>(keys, dir, span, q, live, pos);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const bool weak =
            live[b] && (pos[b] >= 0 ? keys.count(pos[b]) : 0) < threshold;
        const uint32_t bits = __ballot_sync(kFullMask, weak);
        if (j0 + b < PW) {
          if (lane == 0) mask[r * PW + j0 + b] = bits;
          n_weak += __popc(bits);
        }
      }
    }
    __syncwarp();       // the next read overwrites the codes and words
  }
  if (lane == 0) atomicAdd(&tile_weak, n_weak);
  __syncthreads();
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = tile_weak;
}

__global__ void __launch_bounds__(kThreads)
    weak_mask_kernel(const int32_t* __restrict__ reads,
                     const int32_t* __restrict__ lengths, int64_t N, int L,
                     int k, const int64_t* __restrict__ table,
                     const int32_t* __restrict__ counts, int64_t T,
                     const int64_t* __restrict__ scratch, int threshold,
                     uint32_t* __restrict__ mask,
                     int64_t* __restrict__ tile_counts) {
  const BucketSpan span = load_span(scratch);
  const int32_t* dir = dir_of(scratch, T);
  if (ldg_key(scratch + 3)) {         // packed (uniform over the grid)
    mask_tile(PackedKeys{packed_of(scratch), suffix_mask(span.shift)}, dir,
              span, reads, lengths, N, L, k, threshold, mask, tile_counts);
  } else {
    mask_tile(Int64Keys{table, counts}, dir, span, reads, lengths, N, L, k,
              threshold, mask, tile_counts);
  }
}

// Inclusive warp scan of x.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
    weak_write_kernel(const uint32_t* __restrict__ mask, int64_t N, int P,
                      const int64_t* __restrict__ tile_offsets,
                      int64_t* __restrict__ out) {
  __shared__ int read_first[kTileReads];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int PW = (P + 31) / 32;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTileReads;
  // each warp counts its reads' weak windows
  for (int i = 0; i < kReadsPerWarp; ++i) {
    const int t = warp * kReadsPerWarp + i;
    int n = 0;
    if (r0 + t < N) {
      for (int j = lane; j < PW; j += 32) n += __popc(mask[(r0 + t) * PW + j]);
    }
    for (int d = 16; d > 0; d >>= 1) n += __shfl_xor_sync(kFullMask, n, d);
    if (lane == 0) read_first[t] = n;
  }
  __syncthreads();
  if (warp == 0) {    // the tile's reads in order: their first slots
    const int n = read_first[lane];
    read_first[lane] = warp_scan(n, lane) - n;
  }
  __syncthreads();
  const int64_t tile0 = tile_offsets[blockIdx.x];
  for (int i = 0; i < kReadsPerWarp; ++i) {
    const int t = warp * kReadsPerWarp + i;
    const int64_t r = r0 + t;
    if (r >= N) break;
    int64_t slot = tile0 + read_first[t];
    for (int j0 = 0; j0 < PW; j0 += 32) {
      const int j = j0 + lane;
      uint32_t bits = j < PW ? mask[r * PW + j] : 0u;
      const int n = __popc(bits);
      const int incl = warp_scan(n, lane);
      int64_t s = slot + incl - n;
      while (bits) {
        const int b = __ffs(bits) - 1;
        out[s++] = r * P + 32 * j + b;
        bits &= bits - 1;
      }
      slot += __shfl_sync(kFullMask, incl, 31);
    }
  }
}

static inline int64_t weak_tiles(int64_t N) {
  const int64_t t = (N + kTileReads - 1) / kTileReads;
  return t < 1 ? 1 : t;
}

}  // namespace

// reads: (N, L) int32 codes 0-3; lengths: (N,) int32 or NULL; table: (T,)
// sorted unique int64 canonical keys (1 < k <= 31), counts (T,) int32,
// scratch: their bucket directory (bucket_search.cuh, built by
// sage2_lookup_directory); mask: (N, ceil(P / 32)) uint32 out, bit w % 32
// of word w / 32 set where window w is weak; tile_counts: the weak windows
// of each tile of kTileReads reads (scan.cuh).
SAGE2_EXPORT int sage2_weak_mask(const void* reads, const void* lengths,
                                 int64_t N, int L, int k, const void* table,
                                 const void* counts, int64_t T,
                                 const void* scratch, int threshold,
                                 void* mask, void* tile_counts,
                                 void* stream) {
  const int W = (L + 15) / 16;
  const size_t smem =
      kWarpsPerTile * (2 * W + (L + 3) / 4) * sizeof(uint32_t);
  weak_mask_kernel<<<static_cast<unsigned>(weak_tiles(N)), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(reads),
      static_cast<const int32_t*>(lengths), N, L, k,
      static_cast<const int64_t*>(table), static_cast<const int32_t*>(counts),
      T, static_cast<const int64_t*>(scratch), threshold,
      static_cast<uint32_t*>(mask), static_cast<int64_t*>(tile_counts));
  return static_cast<int>(cudaGetLastError());
}

// mask: sage2_weak_mask's; tile_offsets: the scanned tile counts; out:
// (n_weak,) int64, the weak windows' flat indices r * P + w, ascending.
SAGE2_EXPORT int sage2_weak_write(const void* mask, int64_t N, int P,
                                  const void* tile_offsets, void* out,
                                  void* stream) {
  weak_write_kernel<<<static_cast<unsigned>(weak_tiles(N)), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mask), N, P,
      static_cast<const int64_t*>(tile_offsets), static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
