// The single-pass decoupled look-back scan (Merrill & Garland) over tiles
// handed out in ticket order: each block publishes its tile's aggregate,
// sums its predecessors' published values (32 a warp round trip) and
// publishes its inclusive prefix. Shared by the bucketed sort of K13 and
// K14 (bucket_sort.cuh), K3's run accounting (overlap_join.cu) and K16's
// tile offsets (weak_windows.cu).
//
// A status word is (flag << 62 | value): flag 0 not yet published, 1 the
// tile's aggregate, 2 its inclusive prefix; values stay below 2^62. The
// status words (one a tile) and the ticket counter are zeroed before the
// launch, on its stream.

#pragma once

#include <cstdint>

#include "common.cuh"

namespace lookback {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kAggregate = uint64_t{1} << 62;
constexpr uint64_t kPrefix = uint64_t{2} << 62;
constexpr uint64_t kValue = kAggregate - 1;

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

// The sum of the values of the tiles before `tile` (one whole warp; 32
// kPer predecessors a round trip, lane 0's first the nearest). Where many
// small tiles are in flight, the nearest published prefix lies hundreds
// of tiles back, and a round trip of L2 latency covers 32 kPer of them.
template <int kPer = 1>
__device__ inline uint64_t look_back(const unsigned long long* status,
                                     int64_t tile, int lane) {
  uint64_t run = 0;
  for (int64_t end = tile - 1;; end -= 32 * kPer) {
    unsigned long long w[kPer];
    bool ready = true, prefix = false;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int64_t t = end - lane * kPer - p;
      w[p] = kPrefix;                        // before tile 0: a prefix of 0
      if (t >= 0) w[p] = load_relaxed(status + t);
    }
    for (;;) {
      ready = true;
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        if ((w[p] >> 62) == 0) {
          const int64_t t = end - lane * kPer - p;
          w[p] = load_relaxed(status + t);
          ready = ready && (w[p] >> 62) != 0;
        }
      }
      if (__all_sync(kFull, ready)) break;
    }
    // the nearest prefix of this lane's words, then of the warp's
    int stop_p = kPer;
#pragma unroll
    for (int p = kPer - 1; p >= 0; --p) {
      if ((w[p] >> 62) == 2) stop_p = p;
    }
    prefix = stop_p < kPer;
    const unsigned pm = __ballot_sync(kFull, prefix);
    const int stop = pm ? __ffs(pm) - 1 : 31;
    uint64_t v = 0;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      if (lane < stop || (lane == stop && p <= stop_p)) v += w[p] & kValue;
    }
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    run += v;
    if (pm) return run;
  }
}

// Publishes this block's `aggregate` as tile `tile` of a decoupled
// look-back (a window of 32 kPer tiles a round trip) and returns the
// tiles before it, to every thread. The tiles
// are handed out by a ticket, so every earlier tile's block has started
// and none waits on a later one. Every thread of the block calls it.
template <int kPer = 1>
__device__ inline uint64_t tile_prefix(unsigned long long* status,
                                       int64_t tile, uint64_t aggregate) {
  __shared__ uint64_t s_excl;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint64_t excl = 0;
    if (tile == 0) {
      if (lane == 0) store_release(status, kPrefix | aggregate);
    } else {
      if (lane == 0) store_release(status + tile, kAggregate | aggregate);
      excl = look_back<kPer>(status, tile, lane);
      if (lane == 0) store_release(status + tile, kPrefix | (excl + aggregate));
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  const uint64_t excl = s_excl;
  __syncthreads();
  return excl;
}

// The block's ticket from counter `t` (every thread gets it).
__device__ __forceinline__ unsigned block_ticket(unsigned* t) {
  __shared__ unsigned s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(t, 1u);
  __syncthreads();
  const unsigned v = s_ticket;
  __syncthreads();
  return v;
}

}  // namespace lookback
