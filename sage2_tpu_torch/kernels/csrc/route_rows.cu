// K19: routing rows to their owner shards, the send side of every
// exchange of the device mesh.
//
// Replaces sage2_tpu/parallel/sharded.py _owner (:49), _route (:73) and
// _route_rows (:128), and the owner hashes of the overlap seeds (:912-916,
// overlap/detect.py:551 _mix32). On the TPU each exchange was a stable
// sort of the owners, a searchsorted of the destination starts, scatters
// of dest/rank/sent_ok back to input order and a scatter of every row
// into a padded (n, cap) buffer, all of it moved by all_to_all whether a
// slot held a row or not. Here the owners are counted by tiles and the
// accepted rows alone are written, destination-major:
//
//   count  one block a tile of kScanTile rows (scan.cuh): each row's
//          owner (the caller's owner array, or the uint32 mix of an
//          int64 key's (hi, lo) words modulo n, a 32-base seed key
//          unflipped first), invalid rows in bin n; the bins' row counts
//          of the tile, packed 12 bits a bin into two words and summed by
//          one block scan, are stored bin-major, (n + 1) x tiles.
//   scan   sage2_scan_tiles over those (n + 1) x tiles counts: each
//          (bin, tile) gets the rows of every earlier bin and of the
//          bin's earlier tiles, which is the row's position in the
//          reference's stable sort by owner. The wrapper reads the n + 1
//          bin starts once (the host sizes the send buffer from them).
//   write  each block recounts its tile, scans the packed bin counts
//          across the block and so ranks every row within its owner in
//          input order: dest = min(bin, n - 1), rank = position - start
//          of dest (an invalid row ranks past the last destination's
//          rows, as in the reference), sent_ok = bin < n and rank < cap.
//          An accepted row's K int32 columns go to the send buffer at the
//          destination's first accepted slot plus its rank; block 0
//          writes each destination's first slot (the route-back offsets).
//
// n <= 8 (bins <= 9, two packed words of 5 bins). Bound: bytes: the owner
// source (4 or 8 bytes a row) and the valid flag are read twice, each
// row's K words once and written once if accepted, dest, rank and sent_ok
// written (9 bytes a row).

#include "scan.cuh"

namespace {

constexpr int kMaxShards = 8;
constexpr int kBinBits = 12;          // a tile's count of one bin <= 1024
constexpr int kBinsPerWord = 5;
constexpr uint64_t kBinMask = (uint64_t{1} << kBinBits) - 1;

struct OwnerSource {
  const int32_t* owner;   // (Q,) int32 owners, or NULL: hash `keys`
  const int64_t* keys;    // (Q,) int64 keys
  int flip;               // 1: seed keys stored with the top bit flipped
  const bool* valid;      // (Q,) or NULL (every row valid)
  int n;

  __device__ __forceinline__ int bin(int64_t i) const {
    if (valid != nullptr && !valid[i]) return n;
    if (owner != nullptr) return owner[i];
    uint64_t key = static_cast<uint64_t>(keys[i]);
    if (flip) key ^= uint64_t{1} << 63;
    const uint32_t hi = static_cast<uint32_t>(key >> 32);
    const uint32_t lo = static_cast<uint32_t>(key);
    uint32_t h = hi * 0x9E3779B1u + lo * 0x85EBCA77u;
    h ^= h >> 16;
    h *= 0x7FEB352Du;
    h ^= h >> 15;
    return static_cast<int>(h % static_cast<uint32_t>(n));
  }
};

__device__ __forceinline__ uint64_t bin_one(int b) {
  return uint64_t{1} << (kBinBits * (b % kBinsPerWord));
}

__device__ __forceinline__ int bin_field(uint64_t w, int b) {
  return static_cast<int>((w >> (kBinBits * (b % kBinsPerWord))) & kBinMask);
}

// This thread's kScanItems rows' bins, and their packed counts.
__device__ __forceinline__ void thread_bins(const OwnerSource& src,
                                            int64_t Q, int64_t i0,
                                            int* bins, uint64_t* w) {
  w[0] = w[1] = 0;
  for (int k = 0; k < kScanItems; ++k) {
    bins[k] = -1;
    if (i0 + k >= Q) continue;
    bins[k] = src.bin(i0 + k);
    w[bins[k] / kBinsPerWord] += bin_one(bins[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
    route_count_kernel(const OwnerSource src, int64_t Q, int64_t tiles,
                       int64_t* __restrict__ tile_counts) {
  int bins[kScanItems];
  uint64_t w[2];
  thread_bins(src, Q, scan_first_item(), bins, w);
  uint64_t t0, t1;
  block_exclusive_scan<uint64_t>(w[0], &t0);
  block_exclusive_scan<uint64_t>(w[1], &t1);
  if (threadIdx.x <= src.n) {
    const int b = threadIdx.x;
    tile_counts[b * tiles + blockIdx.x] =
        bin_field(b < kBinsPerWord ? t0 : t1, b);
  }
}

__global__ void __launch_bounds__(kThreads)
    route_write_kernel(const OwnerSource src, int64_t Q, int cap,
                       const int32_t* __restrict__ rows, int K,
                       const int64_t* __restrict__ tile_offsets,
                       int64_t tiles, int32_t* __restrict__ dest,
                       int32_t* __restrict__ rank,
                       bool* __restrict__ sent_ok,
                       int32_t* __restrict__ send,
                       int64_t* __restrict__ offsets_out) {
  const int n = src.n;
  __shared__ int64_t start[kMaxShards + 2];
  __shared__ int64_t send_off[kMaxShards + 1];
  __shared__ int64_t base[kMaxShards + 1];
  if (threadIdx.x == 0) {
    for (int b = 0; b <= n; ++b) start[b] = tile_offsets[b * tiles];
    start[n + 1] = Q;
    int64_t acc = 0;
    for (int d = 0; d < n; ++d) {
      send_off[d] = acc;
      const int64_t c = start[d + 1] - start[d];
      acc += c < cap ? c : cap;
    }
    if (blockIdx.x == 0) {
      for (int d = 0; d < n; ++d) offsets_out[d] = send_off[d];
    }
  }
  if (threadIdx.x <= n) {
    base[threadIdx.x] = tile_offsets[threadIdx.x * tiles + blockIdx.x];
  }
  const int64_t i0 = scan_first_item();
  int bins[kScanItems];
  uint64_t w[2];
  thread_bins(src, Q, i0, bins, w);
  uint64_t t0, t1;
  uint64_t before[2];
  before[0] = block_exclusive_scan<uint64_t>(w[0], &t0);
  before[1] = block_exclusive_scan<uint64_t>(w[1], &t1);
  __syncthreads();   // start, send_off and base are set
  uint64_t seen[2] = {0, 0};
  for (int k = 0; k < kScanItems; ++k) {
    const int b = bins[k];
    if (b < 0) continue;
    const int word = b / kBinsPerWord;
    const int64_t pos = base[b] + bin_field(before[word], b) +
                        bin_field(seen[word], b);
    seen[word] += bin_one(b);
    const int d = b < n ? b : n - 1;
    const int64_t r = pos - start[d];
    const bool ok = b < n && r < cap;
    const int64_t i = i0 + k;
    dest[i] = d;
    rank[i] = static_cast<int32_t>(r);
    sent_ok[i] = ok;
    if (ok) {
      const int32_t* from = rows + i * K;
      int32_t* to = send + (send_off[d] + r) * K;
      for (int c = 0; c < K; ++c) to[c] = from[c];
    }
  }
}

}  // namespace

// owner: (Q,) int32 owners in [0, n), or NULL with keys: (Q,) int64 keys
// hashed to their owner (flip: 32-base seed keys); valid: (Q,) bool or
// NULL; tile_counts: ((n + 1) * tiles,) int64, tiles = ceil(Q / 1024).
SAGE2_EXPORT int sage2_route_count(const void* owner, const void* keys,
                                   int flip, const void* valid, int64_t Q,
                                   int n, void* tile_counts, void* stream) {
  if (n < 1 || n > kMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  const OwnerSource src{static_cast<const int32_t*>(owner),
                        static_cast<const int64_t*>(keys), flip,
                        static_cast<const bool*>(valid), n};
  const int tiles = scan_tiles_of(Q);
  route_count_kernel<<<tiles, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      src, Q, tiles, static_cast<int64_t*>(tile_counts));
  return static_cast<int>(cudaGetLastError());
}

// rows: (Q, K) int32; tile_offsets: the scanned counts of
// sage2_route_count; dest, rank: (Q,) int32 and sent_ok: (Q,) bool
// outputs; send: (accepted rows, K) int32 output; offsets: (n,) int64
// output, each destination's first row in send.
SAGE2_EXPORT int sage2_route_write(const void* owner, const void* keys,
                                   int flip, const void* valid, int64_t Q,
                                   int n, int cap, const void* rows, int K,
                                   const void* tile_offsets, void* dest,
                                   void* rank, void* sent_ok, void* send,
                                   void* offsets, void* stream) {
  if (n < 1 || n > kMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  const OwnerSource src{static_cast<const int32_t*>(owner),
                        static_cast<const int64_t*>(keys), flip,
                        static_cast<const bool*>(valid), n};
  const int tiles = scan_tiles_of(Q);
  route_write_kernel<<<tiles, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      src, Q, cap, static_cast<const int32_t*>(rows), K,
      static_cast<const int64_t*>(tile_offsets), tiles,
      static_cast<int32_t*>(dest), static_cast<int32_t*>(rank),
      static_cast<bool*>(sent_ok), static_cast<int32_t*>(send),
      static_cast<int64_t*>(offsets));
  return static_cast<int>(cudaGetLastError());
}
