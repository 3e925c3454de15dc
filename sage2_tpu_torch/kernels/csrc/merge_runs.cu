// K11: run accounting over sorted keys: the unique keys and the summed
// weight of each run of equal keys, compacted in order, in one pass.
//
// Replaces the run accounting of sage2_tpu/kmer/count.py count_from_keys
// (:72-95, after its sort) and of sage2_tpu/stream.py _merge_tables
// (:30-49): unique_sorted_pairs' head flags, a cumsum for the head slots,
// two scatters of the heads to the front of a full-size table and a
// segment_sum of the weights, each a pass over the whole key array.
//
// Bound on the H100: bytes. The function must read each key (8 bytes)
// and weight (4) once and write each unique key and its sum (12 bytes):
// 0.506 ms for phase 4's 174.8 M keys at 3.35 TB/s (NVIDIA H100 80GB
// HBM3, 700.00 W).
//
// What the first version lost (same card and limit: 3.053 ms on
// phase 4's keys, 1.428 ms on a 76 M-key count chunk, 0.664 ms on a
// 29.4 M-key weighted merge; torch.unique_consecutive 1.315 / 0.646 ms):
// a head pass writing an int32 flag a key, torch.cumsum of the flags into
// an int32 slot a key, a host read of the count, a zero fill of the sums
// and a write pass reading keys, flags and slots again with two atomics a
// run: 36-40 bytes a key where the function needs 8, in grid-stride loops
// of one key a thread with scalar loads.
//
// This design: a single-pass run-length encoding with decoupled look-back
// (Merrill & Garland, single-pass prefix scan), in persistent blocks.
//
//   Tiles   kTile = 3072 consecutive keys. Tile ids come from an atomicAdd
//           counter, so every predecessor of a tile is held by a running
//           block before anyone waits on it. A block is a software
//           pipeline: 8 row warps and 1 control warp, and three stages of
//           shared memory (3 x 24 KB; 3 x 36 KB weighted), so 3 blocks a
//           SM (2 weighted). In step i the row warps wait for tile i + 1,
//           make its first pass and publish its aggregate while the
//           control warp makes tile i's look-back; then the row warps make
//           tile i's write pass while the control warp starts tile i + 2's
//           copy (its id taken a step before) and takes the next id. A
//           tile's keys, with the two keys before and after it, come by
//           one 1-D TMA bulk copy (cp.async.bulk into shared memory,
//           completion on an mbarrier), its weights by a second. Chosen
//           over 16-byte vector loads into registers: those held 8
//           registers a key, one tile a block, and each tile waited on its
//           id, its loads and its look-back in turn; that version ran
//           slower than torch.unique_consecutive, as did one block a tile
//           through shared memory and a pipeline of one warp kind. The
//           first and the last tile, or a misaligned input, are read in by
//           the threads. ptxas (sm_90a): 53 registers unweighted, 44
//           weighted, 2 barriers, 304 bytes static shared memory, no
//           spills.
//   Rows    each warp owns 384 keys as 6 rows of 64; lane l reads keys 2l
//           and 2l + 1 of a row from shared memory with one 16-byte load.
//           A key is a run head where it differs from the key before it;
//           a row's heads are two warp ballots.
//   Scan    the pair (heads, partial), partial being the weight summed
//           since the last head, under the operator
//             (c1, p1) + (c2, p2) = (c1 + c2, c2 ? p2 : p1 + p2).
//           Unit weights: a lane's pair inside its row comes from the
//           ballots alone (popcounts, and the distance to the last head).
//           Weights: a warp scan by shuffles. One thread combines the 8
//           warps' totals into the tile's aggregate; the look-back gives
//           the tile's exclusive pair: the slot of its first head and the
//           partial sum of the run that enters it. The write pass scans
//           the rows again from shared memory (cheaper than keeping them).
//   Status  one 64-bit word a tile, (partial << 32) | low, low 0 while the
//           tile has published nothing, 1 + heads for its aggregate (at
//           most 3073) and 0x80000000 | heads for its inclusive prefix (at
//           most n - 1 < 2^31), written with st.release and read with
//           ld.relaxed (the word carries everything it publishes). The
//           control warp reads 32 predecessors a round trip, waits until
//           each has published, combines from the nearest inclusive prefix
//           on and moves its window back while there is none. (Windows of
//           128, 256 and 512 a round trip ran slower.)
//   Sums    the lane holding a run's last key writes its sum, so every
//           slot is written once, by plain stores, and no atomics are
//           needed: a run that crosses tile edges gets the partial of its
//           earlier tiles through the look-back's pair. Unweighted runs
//           count 1 a key; weighted sums wrap in int32 as segment_sum.
//
// Gone: torch.cumsum, the per-key flag and slot arrays, the zero fill,
// the second read of the keys and the sums' atomics. Outputs: the wrapper
// hands in upper-bound buffers of n keys and n sums (12 bytes a key); the
// kernel writes the unique count, which the host reads once, and the
// wrapper narrows the buffers to it, as torch.unique_consecutive does.
// The narrowed outputs hold 12 n bytes, not 12 a unique key: kept as they
// are, the count tables of 174.8 M k-mers held 2.1 GB each, two of them
// alive in a correction round, and phase 4's peak rose by 3.0 GiB. So
// count_from_keys (kmer/count.py) copies a table to storage of its own
// size when the buffers hold over twice its bytes (24 bytes a unique key
// moved); a merge of two tables has at least n / 2 unique keys and keeps
// the buffers. Scratch: one int64 a tile plus two (the tile counter, the
// count), zeroed by one cudaMemsetAsync a call.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 6;                         // rows of 64 keys a warp
constexpr int kWarpKeys = kRows * 64;
constexpr int kTile = kWarps * kWarpKeys;        // 3072 keys
constexpr int kThreadsK11 = (kWarps + 1) * 32;   // 8 row warps, 1 control
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kPrefixBit = 0x80000000u;

struct Seg {
  uint32_t c;  // run heads
  uint32_t p;  // weight since the last head (all of it without a head)
};

__device__ __forceinline__ Seg seg_op(Seg x, Seg y) {
  return {x.c + y.c, y.c ? y.p : x.p + y.p};
}

__device__ __forceinline__ Seg shfl_up(Seg s, int o) {
  return {__shfl_up_sync(kFull, s.c, o), __shfl_up_sync(kFull, s.p, o)};
}

__device__ __forceinline__ void store_release(unsigned long long* a,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(a), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* a) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long status_word(Seg s,
                                                          bool prefix) {
  const uint32_t low = prefix ? (kPrefixBit | s.c) : (1u + s.c);
  return (static_cast<unsigned long long>(s.p) << 32) | low;
}

// The tile's exclusive pair from its predecessors' status words (one
// warp): 32 predecessors a round trip, lane 31 the nearest.
__device__ Seg look_back(const unsigned long long* status, int64_t tile,
                         int lane) {
  Seg run = {0, 0};
  for (int64_t end = tile - 1;; end -= 32) {
    const int64_t t = end - 31 + lane;
    unsigned long long w =
        t < 0 ? static_cast<unsigned long long>(kPrefixBit) : 0ull;
    if (t >= 0) w = load_relaxed(status + t);
    while (__any_sync(kFull, static_cast<uint32_t>(w) == 0u)) {
      if (static_cast<uint32_t>(w) == 0u) w = load_relaxed(status + t);
    }
    const uint32_t low = static_cast<uint32_t>(w);
    const bool is_prefix = low & kPrefixBit;
    const unsigned pm = __ballot_sync(kFull, is_prefix);
    const int lo = pm ? 31 - __clz(pm) : 0;     // the nearest prefix
    Seg s = {is_prefix ? (low & ~kPrefixBit) : low - 1u,
             static_cast<uint32_t>(w >> 32)};
    if (lane < lo) s = {0, 0};
    // lanes lo..31 in order: the heads add up; the partial is the sum
    // from the last lane with a head on
    const unsigned hm = __ballot_sync(kFull, s.c != 0);
    const int hl = hm ? 31 - __clz(hm) : 0;
    const Seg win = {__reduce_add_sync(kFull, s.c),
                     __reduce_add_sync(kFull, lane >= hl ? s.p : 0u)};
    run = seg_op(win, run);
    if (pm) return run;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 1-D TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// A stage of shared memory holds one tile: its keys with the key before
// and the key after it (kTile + 4 int64 from tbase - 2, so a bulk copy
// starts 16-byte aligned), then its weights.
constexpr int kStages = 3;
constexpr int kStageKeys = (kTile + 4) * 8;

template <bool kWeighted>
__host__ __device__ constexpr int stage_bytes() {
  return kStageKeys + (kWeighted ? kTile * 4 : 0);
}

// One row of 64 keys of a warp, from shared memory: lane l's keys 2l and
// 2l + 1 (tile index idx and idx + 1, m keys of the tile valid), their
// weights (0 past the end) and the row's head flags as two warp masks,
// ma of the lanes' first keys and mb of their second.
struct Row {
  longlong2 k;
  uint32_t wa, wb;
  unsigned ma, mb;
};

template <bool kWeighted>
__device__ __forceinline__ Row load_row(const int64_t* sk, const int32_t* sw,
                                        int idx, int m, bool first_tile,
                                        int lane) {
  Row r;
  r.k = *reinterpret_cast<const longlong2*>(sk + idx);
  r.wa = r.wb = 1u;
  if (kWeighted) {
    const int2 w2 = *reinterpret_cast<const int2*>(sw + idx);
    r.wa = static_cast<uint32_t>(w2.x);
    r.wb = static_cast<uint32_t>(w2.y);
  }
  if (idx >= m) r.wa = 0u;
  if (idx + 1 >= m) r.wb = 0u;
  int64_t left = __shfl_up_sync(kFull, r.k.y, 1);
  if (lane == 0) left = sk[idx - 1];   // sk[-1]: the key before the tile
  r.ma = __ballot_sync(kFull, idx < m && ((first_tile && idx == 0) ||
                                          r.k.x != left));
  r.mb = __ballot_sync(kFull, idx + 1 < m && r.k.y != r.k.x);
  return r;
}

__device__ __forceinline__ int top_bit(unsigned x) { return 31 - __clz(x); }

// The lane's exclusive pair before its first key, within the row. Weights:
// a segmented scan by shuffles. Unit weights: from the masks alone (heads
// before the key, and its distance from the last of them).
template <bool kWeighted>
__device__ __forceinline__ Seg lane_excl(const Row& r, int lane, Seg* row) {
  const unsigned lt = (1u << lane) - 1u;
  const bool ha = r.ma >> lane & 1u, hb = r.mb >> lane & 1u;
  if (kWeighted) {
    Seg sg = {static_cast<uint32_t>(ha) + static_cast<uint32_t>(hb),
              hb ? r.wb : r.wa + r.wb};
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Seg y = shfl_up(sg, o);
      if (lane >= o) sg = seg_op(y, sg);
    }
    *row = {__shfl_sync(kFull, sg.c, 31), __shfl_sync(kFull, sg.p, 31)};
    Seg ex = shfl_up(sg, 1);
    if (lane == 0) ex = {0, 0};
    return ex;
  }
  // valid keys of the row: a full row, or the lanes whose weights are 1
  const unsigned va = __ballot_sync(kFull, r.wa), vb = __ballot_sync(kFull,
                                                                     r.wb);
  const int valid = __popc(va) + __popc(vb);
  const uint32_t c = __popc(r.ma) + __popc(r.mb);
  const int last = c ? max(r.ma ? 2 * top_bit(r.ma) : -1,
                           r.mb ? 2 * top_bit(r.mb) + 1 : -1)
                     : -1;
  *row = {c, static_cast<uint32_t>(valid - last - (c ? 0 : 1))};
  const unsigned la = r.ma & lt, lb = r.mb & lt;
  const int before = max(la ? 2 * top_bit(la) : -1,
                         lb ? 2 * top_bit(lb) + 1 : -1);
  return {static_cast<uint32_t>(__popc(la) + __popc(lb)),
          static_cast<uint32_t>(before >= 0 ? 2 * lane - before
                                            : 2 * lane)};
}

// The 8 row warps' barrier (named barrier 1), without the control warp.
__device__ __forceinline__ void rows_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kWarps * 32) : "memory");
}

// Persistent blocks, each a software pipeline over the tiles it takes
// from the counter, three stages of shared memory deep, with 8 row warps
// and one control warp. In step i the row warps wait for tile i + 1's
// data, make its first pass and publish its aggregate while the control
// warp makes tile i's look-back; then the row warps make tile i's write
// pass while the control warp starts tile i + 2's TMA (its id taken in
// step i - 1) and takes the id of tile i + 3. A tile's aggregate is out
// one step before its look-back, and its data has a step to arrive.
template <bool kWeighted>
__global__ void __launch_bounds__(kThreadsK11, kWeighted ? 2 : 3)
merge_runs_kernel(const int64_t* __restrict__ keys,
                  const int32_t* __restrict__ weights, int64_t n,
                  int64_t tiles, int aligned,
                  unsigned long long* __restrict__ status,
                  unsigned int* __restrict__ counter,
                  int64_t* __restrict__ n_unique,
                  int64_t* __restrict__ out_keys,
                  int32_t* __restrict__ out_sums) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t s_bar[kStages];
  __shared__ int64_t s_tile[kStages];
  __shared__ int64_t s_next;           // the id taken for the next stage
  __shared__ int s_bulk[kStages];      // the stage's tile comes by TMA
  __shared__ Seg s_warp[kStages][kWarps];
  __shared__ Seg s_agg[kStages];
  __shared__ Seg s_prefix;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool control = warp == kWarps;
  const int wofs = warp * kWarpKeys;
  auto stage_keys = [&](int st) {      // [-1] the key before, [kTile] after
    return reinterpret_cast<int64_t*>(smem + st * stage_bytes<kWeighted>()) +
           2;
  };
  auto stage_weights = [&](int st) {
    return reinterpret_cast<int32_t*>(smem + st * stage_bytes<kWeighted>() +
                                      kStageKeys);
  };
  // the control warp's lane 0: tile t into stage st, by bulk copies
  auto start_copy = [&](int st, int64_t t) {
    s_tile[st] = t;
    s_bulk[st] = t > 0 && t < tiles && aligned && (t + 1) * kTile + 2 <= n;
    if (s_bulk[st]) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              smem_addr(&s_bar[st])),
          "r"(stage_bytes<kWeighted>())
          : "memory");
      bulk_copy(stage_keys(st) - 2, keys + t * kTile - 2, kStageKeys,
                &s_bar[st]);
      if (kWeighted)
        bulk_copy(stage_weights(st), weights + t * kTile, kTile * 4,
                  &s_bar[st]);
    }
  };
  uint32_t parity = 0;                 // bit st: the phase stage st awaits
  // the row warps: stage st's tile in shared memory
  auto ready = [&](int st) {
    if (s_bulk[st]) {
      mbar_wait(&s_bar[st], parity >> st & 1u);
      parity ^= 1u << st;
      return;
    }
    const int64_t tbase = s_tile[st] * kTile;
    int64_t* sk = stage_keys(st);
    int32_t* sw = stage_weights(st);
    for (int k = static_cast<int>(threadIdx.x) - 1; k <= kTile;
         k += kWarps * 32) {
      const bool v = tbase + k >= 0 && tbase + k < n;
      sk[k] = v ? keys[tbase + k] : 0;
      if (kWeighted && k >= 0 && k < kTile) sw[k] = v ? weights[tbase + k] : 0;
    }
    rows_sync();
  };
  // the row warps, pass 1: the warps' totals, the tile's aggregate out
  auto first_pass = [&](int st) {
    const int64_t tile = s_tile[st];
    const int64_t tbase = tile * kTile;
    const int m = tbase + kTile <= n ? kTile : static_cast<int>(n - tbase);
    const int64_t* sk = stage_keys(st);
    const int32_t* sw = stage_weights(st);
    Seg run = {0, 0};
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const Row r = load_row<kWeighted>(sk, sw, wofs + j * 64 + 2 * lane, m,
                                        tile == 0, lane);
      Seg row;
      lane_excl<kWeighted>(r, lane, &row);
      run = seg_op(run, row);
    }
    if (lane == 0) s_warp[st][warp] = run;
    rows_sync();
    if (threadIdx.x == 0) {
      Seg agg = {0, 0};
      for (int w = 0; w < kWarps; ++w) {
        const Seg x = s_warp[st][w];
        s_warp[st][w] = agg;           // now the warp's exclusive pair
        agg = seg_op(agg, x);
      }
      s_agg[st] = agg;
      store_release(status + tile, status_word(agg, tile == 0));
    }
  };

  if (control && lane == 0) {
    for (int st = 0; st < kStages; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(&s_bar[st]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    start_copy(0, atomicAdd(counter, 1u));
    start_copy(1, atomicAdd(counter, 1u));
    s_next = atomicAdd(counter, 1u);
  }
  __syncthreads();
  if (!control && s_tile[0] < tiles) {
    ready(0);
    first_pass(0);
  }
  __syncthreads();
  for (int it = 0;; ++it) {
    const int cur = it % kStages, nxt = (it + 1) % kStages,
              nn = (it + 2) % kStages;
    const int64_t tile = s_tile[cur];
    if (tile >= tiles) break;
    if (control) {                     // tile i's look-back
      Seg prefix = {0, 0};
      if (tile > 0) prefix = look_back(status, tile, lane);
      if (lane == 0) {
        const Seg incl = seg_op(prefix, s_agg[cur]);
        if (tile > 0) store_release(status + tile, status_word(incl, true));
        s_prefix = prefix;
        if (tile == tiles - 1) *n_unique = incl.c;
      }
    } else if (s_tile[nxt] < tiles) {  // tile i + 1's first pass
      ready(nxt);
      first_pass(nxt);
    }
    __syncthreads();
    if (control) {                     // tile i + 2 on its way
      if (lane == 0) {
        start_copy(nn, s_next);
        s_next = atomicAdd(counter, 1u);
      }
    } else {
      // pass 2, the rows again: each head writes its key, each run's
      // last key its sum
      const int64_t tbase = tile * kTile;
      const int m = tbase + kTile <= n ? kTile : static_cast<int>(n - tbase);
      const int64_t* sk = stage_keys(cur);
      const int32_t* sw = stage_weights(cur);
      Seg run = seg_op(s_prefix, s_warp[cur][warp]);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int idx = wofs + j * 64 + 2 * lane;
        const Row r = load_row<kWeighted>(sk, sw, idx, m, tile == 0, lane);
        Seg row;
        const Seg x = seg_op(run, lane_excl<kWeighted>(r, lane, &row));
        run = seg_op(run, row);
        const bool ha = r.ma >> lane & 1u, hb = r.mb >> lane & 1u;
        bool next_head;                // the key after the lane's second
        if (lane < 31)
          next_head = r.ma >> (lane + 1) & 1u;
        else
          next_head = sk[idx + 2] != r.k.y;
        const int64_t i = tbase + idx; // the last key of all ends its run
        const bool end_a = i < n && (hb || i + 1 == n);
        const bool end_b = i + 1 < n && (i + 2 == n || next_head);
        uint32_t c = x.c, p = x.p;
        if (ha) {
          out_keys[c] = r.k.x;
          p = r.wa;
          ++c;
        } else {
          p += r.wa;
        }
        if (end_a) out_sums[c - 1] = static_cast<int32_t>(p);
        if (hb) {
          out_keys[c] = r.k.y;
          p = r.wb;
          ++c;
        } else {
          p += r.wb;
        }
        if (end_b) out_sums[c - 1] = static_cast<int32_t>(p);
      }
    }
    __syncthreads();                   // stage cur is free
  }
}

template <bool kWeighted>
int launch(const int64_t* keys, const int32_t* weights, int64_t n,
           unsigned long long* words, int64_t* out_keys, int32_t* out_sums,
           cudaStream_t stream) {
  static int wave = 0, device = -1;
  constexpr int kSmem = kStages * stage_bytes<kWeighted>();
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev != device) {
    int sms = 0, per_sm = 0;
    rc = cudaFuncSetAttribute(merge_runs_kernel<kWeighted>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaFuncSetAttribute(merge_runs_kernel<kWeighted>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, merge_runs_kernel<kWeighted>, kThreadsK11, kSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    wave = per_sm * sms;
    device = dev;
  }
  const int64_t tiles = (n + kTile - 1) / kTile;
  rc = cudaMemsetAsync(words, 0, (tiles + 2) * 8, stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int aligned = reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(weights) % 16 == 0;
  const int64_t blocks = tiles < wave ? tiles : wave;
  merge_runs_kernel<kWeighted>
      <<<static_cast<unsigned>(blocks), kThreadsK11, kSmem, stream>>>(
          keys, weights, n, tiles, aligned, words,
          reinterpret_cast<unsigned int*>(words + tiles),
          reinterpret_cast<int64_t*>(words + tiles + 1), out_keys,
          out_sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys: (n,) sorted int64, 0 < n < 2^31; weights: (n,) int32 or NULL (1
// each); scratch: (tiles + 2,) int64, tiles = ceil(n / 4096), zeroed
// here; out_keys (n,) int64 and out_sums (n,) int32 upper-bound outputs,
// their first scratch[tiles + 1] entries written.
SAGE2_EXPORT int sage2_merge_runs(const void* keys, const void* weights,
                                  int64_t n, void* scratch, void* out_keys,
                                  void* out_sums, void* stream) {
  const auto k = static_cast<const int64_t*>(keys);
  const auto w = static_cast<const int32_t*>(weights);
  auto* words = static_cast<unsigned long long*>(scratch);
  const auto s = static_cast<cudaStream_t>(stream);
  if (w != nullptr)
    return launch<true>(k, w, n, words, static_cast<int64_t*>(out_keys),
                        static_cast<int32_t*>(out_sums), s);
  return launch<false>(k, w, n, words, static_cast<int64_t*>(out_keys),
                       static_cast<int32_t*>(out_sums), s);
}
