// K19: routing rows to their owner shards, the send side of every
// exchange of the device mesh.
//
// Replaces sage2_tpu/parallel/sharded.py _owner (:49), _route (:73) and
// _route_rows (:128), and the owner hashes of the overlap seeds (:912-916,
// overlap/detect.py:551 _mix32). On the TPU each exchange was a stable
// sort of the owners, a searchsorted of the destination starts, scatters
// of dest/rank/sent_ok back to input order and a scatter of every row
// into a padded (n, cap) buffer, all of it moved by all_to_all whether a
// slot held a row or not. Here the accepted rows alone are written,
// destination-major, in two launches over tiles of kTile rows, a thread
// kItems consecutive rows of a tile:
//
//   histogram  each row's bin (the caller's owner, or the uint32 mix of
//              an int64 key's (hi, lo) words modulo n, a 32-base seed key
//              unflipped first; invalid rows in bin n), a thread's 8
//              owners, flags or keys in vector loads issued together; a
//              tile's bin counts (packed 12 bits a bin, 5 bins a word,
//              summed over the block) become the tile's status words,
//              the look-back's aggregates, and the blocks' totals go to
//              n + 1 global counters, one atomic a bin a block. The
//              wrapper reads the n totals once (the host sizes the send
//              buffer from them).
//   scatter    a single pass with decoupled look-back (Merrill &
//              Garland), a block a tile (blockIdx.x: every tile's count
//              is published before the launch, so no tile waits for one
//              that has not run and the tiles need no ordering): the
//              tile's rows start into shared memory by cp.async
//              (16-byte copies) while its bins are counted again and a
//              block scan ranks every row within its bin in input order;
//              a warp a bin looks back 128 tiles a round trip to the
//              nearest inclusive prefix and publishes its own. That prefix plus the in-tile rank is
//              the row's rank in the reference's stable sort by owner.
//              The rows are placed bin-major and each destination's run
//              of accepted rows (rank < cap) goes to `send` at its first
//              slot plus the run's first rank, four words a thread: a
//              warp's stores write whole 512-byte spans, so no sector is
//              left part written for another store to fill (the cost
//              that held the first form of this kernel back). In the
//              two-way mode each row's dest = min(bin, n - 1), rank (an
//              invalid row ranks past the last destination's rows, as in
//              the reference) and sent_ok = bin < n and rank < cap are
//              written in input order, whole sectors a store (a warp's
//              values exchanged by shuffles); the one-way mode (the
//              exchanges whose answers do not come back) writes none of
//              them and looks back for no invalid bin. Rows wider than
//              kStagedWords are read from device memory as written.
//
// n <= 8 (bins <= 9). Bound: bytes: the owner source (4 or 8 bytes a row)
// and the valid flag read by both launches (the scatter of a key route
// whose rows are its keys hashes the rows it holds: its keys are read
// twice in all, not three times), each row's K words read once and
// written once if accepted, and in the two-way mode dest, rank and
// sent_ok written (9 bytes a row).

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kMaxShards = 8;
constexpr int kItems = 8;             // rows a thread, blocked (bins8)
constexpr int kTile = kThreads * kItems;        // rows a scatter tile
constexpr int kWarps = kThreads / 32;
constexpr int kBinBits = 12;          // a tile's count of one bin <= 2048
constexpr int kBinsPerWord = 5;
constexpr uint64_t kBinMask = (uint64_t{1} << kBinBits) - 1;
constexpr int kHistBlocks = 1056;     // 8 blocks on each of 132 SMs
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kPrefixBit = 0x80000000u;
constexpr uint8_t kNoBin = 0xff;      // past the last row
// rows of at most kStagedWords words wait in shared memory (at most 48
// KB a tile of dynamic memory besides the ~4.4 KB of static arrays, past
// the 48 KB a block gets unasked: the launch opts in); wider rows are
// read from device memory as they are written
constexpr int kStagedWords = 6;
// tiles a look-back round reads: 4 a lane
constexpr int kLookWindow = 128;

__device__ __forceinline__ int hash_bin(uint64_t key, int flip, int n) {
  if (flip) key ^= uint64_t{1} << 63;
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  const uint32_t lo = static_cast<uint32_t>(key);
  uint32_t h = hi * 0x9E3779B1u + lo * 0x85EBCA77u;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  return static_cast<int>(h % static_cast<uint32_t>(n));
}

struct OwnerSource {
  const int32_t* owner;   // (Q,) int32 owners, or NULL: hash `keys`
  const int64_t* keys;    // (Q,) int64 keys
  int flip;               // 1: seed keys stored with the top bit flipped
  const bool* valid;      // (Q,) or NULL (every row valid)
  int n;

  __device__ __forceinline__ bool flag(int64_t i) const {
    return __ldg(reinterpret_cast<const uint8_t*>(valid) + i) != 0;
  }

  // The bins of rows i0 .. i0 + 7 (kNoBin past Q): vector loads where the
  // 8 rows are whole and aligned, else one load a row; every load is
  // issued before any bin is computed. `staged` holds the rows' int64
  // keys where they are the rows (a key route's rows), else NULL.
  __device__ __forceinline__ void bins8(int64_t i0, int64_t Q,
                                        const int32_t* staged,
                                        int* bins) const {
    const int m = Q - i0 < 8 ? static_cast<int>(Q - i0) : 8;
    bool ok[8];
    uint64_t val[8];
    const bool whole = m == 8;
    if (valid == nullptr) {
      for (int k = 0; k < 8; ++k) ok[k] = true;
    } else if (whole && (reinterpret_cast<uintptr_t>(valid + i0) & 7) == 0) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(valid + i0));
      for (int k = 0; k < 8; ++k) {
        ok[k] = ((k < 4 ? v.x : v.y) >> (8 * (k & 3))) & 0xff;
      }
    } else {
      for (int k = 0; k < 8; ++k) ok[k] = k < m && flag(i0 + k);
    }
    if (owner != nullptr) {
      if (whole && (reinterpret_cast<uintptr_t>(owner + i0) & 15) == 0) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(owner + i0));
        const int4 b = __ldg(reinterpret_cast<const int4*>(owner + i0) + 1);
        val[0] = a.x; val[1] = a.y; val[2] = a.z; val[3] = a.w;
        val[4] = b.x; val[5] = b.y; val[6] = b.z; val[7] = b.w;
      } else {
        for (int k = 0; k < 8; ++k) val[k] = k < m ? __ldg(owner + i0 + k) : 0;
      }
    } else if (staged != nullptr) {
      for (int k = 0; k < 8; ++k) {
        val[k] = k < m ? (static_cast<uint64_t>(static_cast<uint32_t>(
                              staged[2 * k + 1])) << 32) |
                             static_cast<uint32_t>(staged[2 * k])
                       : 0;
      }
    } else if (whole && (reinterpret_cast<uintptr_t>(keys + i0) & 15) == 0) {
      const longlong2* k2 = reinterpret_cast<const longlong2*>(keys + i0);
      for (int k = 0; k < 4; ++k) {
        const longlong2 q = __ldg(k2 + k);
        val[2 * k] = static_cast<uint64_t>(q.x);
        val[2 * k + 1] = static_cast<uint64_t>(q.y);
      }
    } else {
      for (int k = 0; k < 8; ++k) {
        val[k] = k < m ? static_cast<uint64_t>(__ldg(keys + i0 + k)) : 0;
      }
    }
    for (int k = 0; k < 8; ++k) {
      const int b = owner != nullptr ? static_cast<int>(val[k])
                                     : hash_bin(val[k], flip, n);
      bins[k] = k >= m ? kNoBin : (ok[k] ? b : n);
    }
  }
};

// The scratch both launches share: n + 1 int64 bin totals, then (n + 1)
// x tiles uint32 status words, bin-major (1 + count: the tile's own
// count; kPrefixBit | count: the rows of the bin in this and every
// earlier tile).
struct Scratch {
  unsigned long long* hist;
  uint32_t* status;
};

__device__ __forceinline__ Scratch scratch_of(int64_t* base, int n) {
  unsigned long long* b = reinterpret_cast<unsigned long long*>(base);
  return {b, reinterpret_cast<uint32_t*>(b + n + 1)};
}

__device__ __forceinline__ void store_release(uint32_t* a, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(a), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t load_relaxed(const uint32_t* a) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ uint64_t bin_one(int b) {
  return uint64_t{1} << (kBinBits * (b % kBinsPerWord));
}

__device__ __forceinline__ int bin_field(uint64_t w, int b) {
  return static_cast<int>((w >> (kBinBits * (b % kBinsPerWord))) & kBinMask);
}

// Exclusive prefix sums of (x, y) over the block's threads, in thread
// order; the block's sums in (*tx, *ty). Every thread calls it.
__device__ __forceinline__ void block_scan2(uint64_t* x, uint64_t* y,
                                            uint64_t* tx, uint64_t* ty,
                                            uint64_t* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t a = *x, b = *y;
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t ya = __shfl_up_sync(kFull, a, d);
    const uint64_t yb = __shfl_up_sync(kFull, b, d);
    if (lane >= d) {
      a += ya;
      b += yb;
    }
  }
  if (lane == 31) {
    warp_sums[warp] = a;
    warp_sums[kWarps + warp] = b;
  }
  __syncthreads();
  uint64_t pa = 0, pb = 0, sa = 0, sb = 0;
  for (int k = 0; k < kWarps; ++k) {
    const uint64_t wa = warp_sums[k], wb = warp_sums[kWarps + k];
    pa += k < warp ? wa : 0;
    pb += k < warp ? wb : 0;
    sa += wa;
    sb += wb;
  }
  *x = pa + a - *x;
  *y = pb + b - *y;
  *tx = sa;
  *ty = sb;
}

// The histogram, tile by tile in the scatter's tiling: each tile's bin
// counts (a thread's 8 rows packed into two words, summed over the
// block) become its status words, the aggregates the scatter's look-back
// reads (tile 0's an inclusive prefix), and a block's totals go to the
// n + 1 global counters by one atomic a bin.
__global__ void __launch_bounds__(kThreads)
    route_hist_kernel(const OwnerSource src, int64_t Q, int64_t tiles,
                      int64_t* __restrict__ scratch) {
  __shared__ uint64_t s_warp[2 * kWarps];
  const int n = src.n;
  const Scratch sc = scratch_of(scratch, n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t mine = 0;                  // thread b <= n: its bin's total
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int bins[kItems];
    src.bins8(tile * kTile + threadIdx.x * kItems, Q, nullptr, bins);
    uint64_t w0 = 0, w1 = 0;
    for (int k = 0; k < kItems; ++k) {
      if (bins[k] == kNoBin) continue;
      if (bins[k] < kBinsPerWord) w0 += bin_one(bins[k]);
      else w1 += bin_one(bins[k]);
    }
    for (int d = 16; d > 0; d >>= 1) {
      w0 += __shfl_xor_sync(kFull, w0, d);
      w1 += __shfl_xor_sync(kFull, w1, d);
    }
    if (lane == 0) {
      s_warp[warp] = w0;
      s_warp[kWarps + warp] = w1;
    }
    __syncthreads();
    if (threadIdx.x <= n) {
      const int b = threadIdx.x;
      const int off = b < kBinsPerWord ? 0 : kWarps;
      uint32_t c = 0;
      for (int k = 0; k < kWarps; ++k) c += bin_field(s_warp[off + k], b);
      sc.status[b * tiles + tile] = tile == 0 ? (kPrefixBit | c) : 1u + c;
      mine += c;
    }
    __syncthreads();                  // s_warp is the next tile's
  }
  if (threadIdx.x <= n && mine) {
    atomicAdd(sc.hist + threadIdx.x, static_cast<unsigned long long>(mine));
  }
}

// The rows of one bin in the tiles before `tile` (one warp, kLookWindow
// tiles a round trip, 4 consecutive a lane, lane 31 the nearest): the
// counts back to the nearest inclusive prefix.
__device__ uint32_t look_back(const uint32_t* status, int64_t tile,
                              int lane) {
  uint32_t run = 0;
  for (int64_t end = tile - 1;; end -= kLookWindow) {
    const int64_t t0 = end - (kLookWindow - 1) + 4 * lane;
    uint32_t w[4];                      // never 0: the histogram's counts
    for (int k = 0; k < 4; ++k) {
      w[k] = kPrefixBit;                // before tile 0: a prefix of 0
      if (t0 + k >= 0) w[k] = load_relaxed(status + t0 + k);
    }
    // this lane's nearest prefix (-1: none), the warp's nearest lane
    int mine = -1;
    for (int k = 0; k < 4; ++k) {
      if (w[k] & kPrefixBit) mine = k;
    }
    const unsigned pm = __ballot_sync(kFull, mine >= 0);
    const int lo = pm ? 31 - __clz(pm) : 0;
    // no prefix: every word; else lanes after lo all four, lane lo from
    // its nearest prefix on, lanes before lo none
    const int first = !pm || lane > lo ? 0 : (lane == lo ? mine : 4);
    uint32_t v = 0;
    for (int k = 0; k < 4; ++k) {
      if (k >= first) {
        v += (w[k] & kPrefixBit) ? (w[k] & ~kPrefixBit) : w[k] - 1u;
      }
    }
    run += __reduce_add_sync(kFull, v);
    if (pm) return run;
  }
}

// KT: the row's words where fixed at compile time, 0 for the runtime K.
template <int KT>
__global__ void __launch_bounds__(kThreads)
    route_scatter_kernel(const OwnerSource src, int64_t Q, int cap,
                         const int32_t* __restrict__ rows, int K_,
                         int key_rows, int64_t* __restrict__ scratch,
                         int64_t tiles, int32_t* __restrict__ dest,
                         int32_t* __restrict__ rank,
                         bool* __restrict__ sent_ok,
                         int32_t* __restrict__ send,
                         int64_t* __restrict__ offsets_out) {
  const int K = KT ? KT : K_;
  const bool staged = K <= kStagedWords;
  const int n = src.n;
  const bool two_way = dest != nullptr;
  const int nb = two_way ? n + 1 : n;   // the bins whose ranks are needed
  const Scratch sc = scratch_of(scratch, n);
  extern __shared__ int4 s_rows4[];          // the tile's rows if staged
  __shared__ uint16_t s_perm[kTile];         // tile rows, bin-major
  __shared__ uint64_t s_warp[2 * kWarps];
  __shared__ int64_t s_prefix[kMaxShards + 1];   // earlier tiles' rows
  __shared__ int64_t s_send[kMaxShards + 1];   // each destination's first
                                               // slot; [n]: the last one's
                                               // rows (invalid rows rank
                                               // past them)
  __shared__ int s_lstart[kMaxShards + 2];   // bin-major starts in a tile
  int32_t* s_rows = reinterpret_cast<int32_t*>(s_rows4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    int64_t acc = 0;
    for (int d = 0; d < n; ++d) {
      s_send[d] = acc;
      const int64_t c = static_cast<int64_t>(sc.hist[d]);
      acc += c < cap ? c : cap;
    }
    s_send[n] = static_cast<int64_t>(sc.hist[n - 1]);
  }
  __syncthreads();
  const int64_t tile = blockIdx.x;
  const int64_t base = tile * kTile;
  const int nrows = static_cast<int>(Q - base < kTile ? Q - base : kTile);
  if (tile == 0 && threadIdx.x < n) offsets_out[threadIdx.x] =
      s_send[threadIdx.x];

  // --- the tile's rows into shared memory: asynchronously where they are
  // 16-byte aligned, so that their loads fly while the bins are counted
  // and the look-back waits --------------------------------------------
  const int32_t* from = rows + base * K;
  if (staged) {
    const int words = nrows * K;
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(rows) & 15) == 0) {
      head = words / 4;
      const int4* f4 = reinterpret_cast<const int4*>(from);
      for (int i = threadIdx.x; i < head; i += kThreads) {
        __pipeline_memcpy_async(s_rows4 + i, f4 + i, sizeof(int4));
      }
      __pipeline_commit();
    }
    for (int i = head * 4 + threadIdx.x; i < words; i += kThreads) {
      s_rows[i] = __ldg(from + i);
    }
  }
  if (key_rows) {                       // the keys are the staged rows
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  const int l0 = threadIdx.x * kItems;  // this thread's first row
  int bins[kItems];
  src.bins8(base + l0, Q, key_rows ? s_rows + 2 * l0 : nullptr, bins);

  // --- in-tile ranks: a block scan of the packed bin counts ------------
  uint64_t before0 = 0, before1 = 0;
  for (int k = 0; k < kItems; ++k) {
    if (bins[k] == kNoBin) continue;
    if (bins[k] < kBinsPerWord) before0 += bin_one(bins[k]);
    else before1 += bin_one(bins[k]);
  }
  uint64_t t0, t1;
  block_scan2(&before0, &before1, &t0, &t1, s_warp);

  if (threadIdx.x == 0) {
    int acc = 0;
    for (int b = 0; b <= n; ++b) {
      s_lstart[b] = acc;
      acc += bin_field(b < kBinsPerWord ? t0 : t1, b);
    }
    s_lstart[n + 1] = acc;
  }
  __syncthreads();

  // --- the look-back for the earlier tiles' rows (a warp a bin; every
  // tile's count is there since the histogram), then each row's place,
  // bin-major in the tile ------------------------------------------------
  for (int b = warp; b < nb; b += kWarps) {
    uint32_t excl = 0;
    if (tile > 0) {
      excl = look_back(sc.status + b * tiles, tile, lane);
      if (lane == 0) {
        const uint32_t c = bin_field(b < kBinsPerWord ? t0 : t1, b);
        store_release(sc.status + b * tiles + tile, kPrefixBit | (excl + c));
      }
    }
    if (lane == 0) s_prefix[b] = excl;
  }
  int local[kItems];                    // each row's rank in its bin here
  {
    uint64_t seen0 = 0, seen1 = 0;
    for (int k = 0; k < kItems; ++k) {
      const int b = bins[k];
      local[k] = 0;
      if (b == kNoBin) continue;
      const bool lo = b < kBinsPerWord;
      local[k] = bin_field(lo ? before0 : before1, b) +
                 bin_field(lo ? seen0 : seen1, b);
      if (lo) seen0 += bin_one(b);
      else seen1 += bin_one(b);
      if (b < n) {
        s_perm[s_lstart[b] + local[k]] = static_cast<uint16_t>(l0 + k);
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();                      // prefixes, places and rows

  // --- two-way: each row's dest, rank and sent_ok in input order -------
  if (two_way) {
    int32_t d8[kItems], r8[kItems];
    uint64_t ok8 = 0;
    for (int k = 0; k < kItems; ++k) {
      const int b = bins[k];
      d8[k] = r8[k] = 0;
      if (b == kNoBin) continue;
      const int64_t r = s_prefix[b] + local[k] + (b < n ? 0 : s_send[n]);
      d8[k] = b < n ? b : n - 1;
      r8[k] = static_cast<int32_t>(r);
      ok8 |= static_cast<uint64_t>(b < n && r < cap) << (8 * k);
    }
    // a warp's 256 rows: each store instruction writes 512 whole bytes
    // (lane t: rows 128q + 4t .. 128q + 4t + 3, held by lane 16q + t / 2)
    const int64_t w0 = base + 256 * warp;
    if (256 * (warp + 1) <= nrows) {
      for (int q = 0; q < 2; ++q) {
        const int from_lane = 16 * q + (lane >> 1);
        int dv[4], rv[4];
        for (int j = 0; j < 4; ++j) {
          const int da = __shfl_sync(kFull, d8[j], from_lane);
          const int db = __shfl_sync(kFull, d8[4 + j], from_lane);
          const int ra = __shfl_sync(kFull, r8[j], from_lane);
          const int rb = __shfl_sync(kFull, r8[4 + j], from_lane);
          dv[j] = lane & 1 ? db : da;
          rv[j] = lane & 1 ? rb : ra;
        }
        const int64_t at = w0 + 128 * q + 4 * lane;
        *reinterpret_cast<int4*>(dest + at) =
            make_int4(dv[0], dv[1], dv[2], dv[3]);
        *reinterpret_cast<int4*>(rank + at) =
            make_int4(rv[0], rv[1], rv[2], rv[3]);
      }
      reinterpret_cast<uint2*>(sent_ok + base + l0)[0] =
          make_uint2(static_cast<uint32_t>(ok8),
                     static_cast<uint32_t>(ok8 >> 32));
    } else {
      const int64_t i0 = base + l0;
      for (int k = 0; k < kItems && l0 + k < nrows; ++k) {
        dest[i0 + k] = d8[k];
        rank[i0 + k] = r8[k];
        sent_ok[i0 + k] = (ok8 >> (8 * k)) & 1;
      }
    }
  }

  // --- each destination's run of accepted rows ------------------------
  for (int d = 0; d < n; ++d) {
    const int64_t p = s_prefix[d];
    const int c = s_lstart[d + 1] - s_lstart[d];
    const int64_t room = cap - p;
    const int take = room <= 0 ? 0 : (room < c ? static_cast<int>(room) : c);
    if (take == 0) continue;
    int32_t* to = send + (s_send[d] + p) * K;
    const uint16_t* perm = s_perm + s_lstart[d];
    const auto word = [&](int i) {
      const int r = i / K;
      const int at = perm[r] * K + (i - r * K);
      return staged ? s_rows[at] : __ldg(from + at);
    };
    // the run's words up to a 16-byte boundary, then 4 a thread (a warp's
    // store instruction writes 512 whole bytes), then the rest
    const int words = take * K;
    int head = static_cast<int>(
        ((16 - (reinterpret_cast<uintptr_t>(to) & 15)) & 15) >> 2);
    head = head < words ? head : words;
    if (threadIdx.x < head) to[threadIdx.x] = word(threadIdx.x);
    const int n4 = (words - head) >> 2;
    int4* to4 = reinterpret_cast<int4*>(to + head);
    for (int j = threadIdx.x; j < n4; j += kThreads) {
      const int i = head + 4 * j;
      to4[j] = make_int4(word(i), word(i + 1), word(i + 2), word(i + 3));
    }
    for (int i = head + 4 * n4 + threadIdx.x; i < words; i += kThreads) {
      to[i] = word(i);
    }
  }
}

template <int KT>
int launch_scatter(const OwnerSource& src, int64_t Q, int cap,
                   const int32_t* rows, int K, int key_rows,
                   int64_t* scratch, int32_t* dest, int32_t* rank,
                   bool* sent_ok, int32_t* send, int64_t* offsets,
                   cudaStream_t stream) {
  const int64_t tiles = (Q + kTile - 1) / kTile;
  const size_t smem =
      K <= kStagedWords ? static_cast<size_t>(kTile) * K * sizeof(int32_t)
                        : 0;
  if (smem) {                 // K = 6: 48 KB besides the static arrays
    const cudaError_t e = cudaFuncSetAttribute(
        route_scatter_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  route_scatter_kernel<KT><<<static_cast<unsigned>(tiles), kThreads, smem,
                             stream>>>(src, Q, cap, rows, K, key_rows,
                                       scratch, tiles, dest, rank, sent_ok,
                                       send, offsets);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// owner: (Q,) int32 owners in [0, n), or NULL with keys: (Q,) int64 keys
// hashed to their owner (flip: 32-base seed keys); valid: (Q,) bool or
// NULL; scratch: n + 1 + ceil((n + 1) * tiles / 2) int64, tiles =
// ceil(Q / 2048); its first n + 1 words, zeroed here, get the bins' row
// counts (bin n: the invalid rows), and every tile's status word of every
// bin is written. Q >= 1.
SAGE2_EXPORT int sage2_route_hist(const void* owner, const void* keys,
                                  int flip, const void* valid, int64_t Q,
                                  int n, void* scratch, void* stream) {
  if (n < 1 || n > kMaxShards || Q < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const OwnerSource src{static_cast<const int32_t*>(owner),
                        static_cast<const int64_t*>(keys), flip,
                        static_cast<const bool*>(valid), n};
  const int64_t tiles = (Q + kTile - 1) / kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(scratch, 0, (n + 1) * sizeof(int64_t), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = static_cast<int>(tiles < kHistBlocks ? tiles
                                                         : kHistBlocks);
  route_hist_kernel<<<grid, kThreads, 0, s>>>(
      src, Q, tiles, static_cast<int64_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// rows: (Q, K) int32 (key_rows: 1 when the rows are the int64 keys
// themselves, K == 2); scratch: sage2_route_hist's; dest, rank: (Q,)
// int32 and sent_ok: (Q,) bool outputs, or all three NULL (one-way);
// send: (accepted rows, K) int32 output; offsets: (n,) int64 output, each
// destination's first row in send.
SAGE2_EXPORT int sage2_route_scatter(const void* owner, const void* keys,
                                     int flip, const void* valid, int64_t Q,
                                     int n, int cap, const void* rows, int K,
                                     int key_rows, void* scratch, void* dest,
                                     void* rank, void* sent_ok, void* send,
                                     void* offsets, void* stream) {
  if (n < 1 || n > kMaxShards || Q < 1 || K < 1 ||
      (key_rows && (K != 2 || keys == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const OwnerSource src{static_cast<const int32_t*>(owner),
                        static_cast<const int64_t*>(keys), flip,
                        static_cast<const bool*>(valid), n};
  const auto args = [&](auto launch) {
    return launch(src, Q, cap, static_cast<const int32_t*>(rows), K,
                  key_rows, static_cast<int64_t*>(scratch),
                  static_cast<int32_t*>(dest), static_cast<int32_t*>(rank),
                  static_cast<bool*>(sent_ok), static_cast<int32_t*>(send),
                  static_cast<int64_t*>(offsets),
                  static_cast<cudaStream_t>(stream));
  };
  switch (K) {
    case 1: return args(launch_scatter<1>);
    case 2: return args(launch_scatter<2>);
    case 3: return args(launch_scatter<3>);
    case 4: return args(launch_scatter<4>);
    default: return args(launch_scatter<0>);
  }
}
