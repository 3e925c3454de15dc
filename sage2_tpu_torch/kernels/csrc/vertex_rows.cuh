// The vertex row table of an edge list sorted by src first: row[i] = the
// first row whose src >= vbase + i, i in [0, v_d], so that vertex vbase +
// i's rows are [row[i], row[i + 1]). Shared by K21's rows launch
// (reduce_requests.cu, a shard's table, int64) and K6's (reduce_counts.cu,
// the whole graph's, int32, with each vertex's largest sl beside it).
//
// A warp takes 32 vertices [vlo, vhi]: their first row by one 32-way
// search, then the rows from there, 32 x kRowsPer a batch (lane l rows l,
// l + 32, ...: each load instruction reads 256 contiguous bytes), until a
// src past vhi; row i starts the chunk's vertices after row i - 1's src up
// to its own, so a vertex's row is read about once and every start
// written once, and row E (src: the table's end) those after the last
// src. A batch of one vertex's rows (a hub) jumps to the run's end by
// another search; a run of vertices without edges costs a warp at most
// its 32. Keys past the table (padding, INT32_MAX) end it like row E.

#pragma once

#include <cstdint>

#include "common.cuh"

namespace vertex_rows {

constexpr int kRowsPer = 4;           // rows a lane of a batch
constexpr unsigned kFull = 0xffffffffu;

// a + #{i in [a, b): pred(i)} for a predicate true on a prefix of [a, b):
// one warp, 32 probes a round (all lanes call it; the result is uniform).
template <typename Pred>
__device__ __forceinline__ int64_t warp_partition(int64_t a, int64_t b,
                                                  const Pred& pred) {
  const int lane = threadIdx.x & 31;
  while (b - a > 32) {
    const int64_t n = b - a;
    const int64_t probe = a + n * (lane + 1) / 32 - 1;    // lane 31: b - 1
    const int t = __popc(__ballot_sync(kFull, pred(probe)));
    // probe t - 1 holds, probe t does not: the cut is in between
    const int64_t lo = t == 0 ? a : a + n * t / 32;
    const int64_t hi = t == 32 ? b : a + n * (t + 1) / 32 - 1;
    a = lo;
    b = hi;
  }
  const bool in = a + lane < b && pred(a + lane);
  return a + __popc(__ballot_sync(kFull, in));
}

// The table of [vbase, vbase + v_d] over keys (E,) int64 sorted src << 32
// | sl, by a grid-stride loop of whole warps over blocks of kThreads
// (every lane of a warp calls it). kMaxSl: also maxsl[i] = the sl (low
// word) of vertex vbase + i's last key, or -1 for a vertex without rows,
// i in [0, v_d): the row before a vertex's first row is its
// predecessor's last, so a warp reads on to the first src past vhi, one
// row further than the table needs.
template <typename Row, bool kMaxSl>
__device__ __forceinline__ void build(const int64_t* __restrict__ keys,
                                      int64_t E, int64_t vbase, int64_t v_d,
                                      Row* __restrict__ row,
                                      int32_t* __restrict__ maxsl) {
  const int lane = threadIdx.x & 31;
  const int64_t vend = vbase + v_d;   // the table's end: past every src
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t u0 = ((blockIdx.x * static_cast<int64_t>(kThreads) +
                      threadIdx.x) >> 5) * 32;
       u0 <= v_d; u0 += warps * 32) {
    const int64_t vlo = vbase + u0;
    const int64_t vhi = vbase + (u0 + 31 < v_d ? u0 + 31 : v_d);
    // the warp reads until a src reaches stop: past vhi for maxsl (the
    // end of vhi's run), else vhi
    const int64_t stop = kMaxSl ? (vhi + 1 < vend ? vhi + 1 : vend) : vhi;
    int64_t w0 = warp_partition(0, E, [&](int64_t i) {
      return __ldg(keys + i) < (vlo << 32);
    });
    int64_t last = vlo - 1;           // the src of row w0 - 1, clipped
    int64_t last_key = 0;             // its key (kMaxSl, where last >= vlo)
    while (last < stop) {             // warp-uniform: a shuffled value
      int64_t key[kRowsPer], src[kRowsPer];
      for (int k = 0; k < kRowsPer; ++k) {
        const int64_t i = w0 + 32 * k + lane;
        key[k] = i < E ? __ldg(keys + i) : 0;
        src[k] = i < E ? key[k] >> 32 : vend;
      }
      const int64_t head = __shfl_sync(kFull, src[0], 0);
      for (int k = 0; k < kRowsPer; ++k) {
        int64_t prev = __shfl_up_sync(kFull, src[k], 1);
        if (lane == 0) prev = last;
        last = __shfl_sync(kFull, src[k], 31);
        int64_t prev_key = 0;
        if (kMaxSl) {
          prev_key = __shfl_up_sync(kFull, key[k], 1);
          if (lane == 0) prev_key = last_key;
          last_key = __shfl_sync(kFull, key[k], 31);
        }
        const int64_t i = w0 + 32 * k + lane;
        if (i > E) continue;
        const int64_t a = prev + 1 > vlo ? prev + 1 : vlo;
        const int64_t b = src[k] < vhi ? src[k] : vhi;
        for (int64_t v = a; v <= b; ++v) {
          row[v - vbase] = static_cast<Row>(i);
          // a vertex before row i's src has no rows
          if (kMaxSl && v < src[k] && v < vend) maxsl[v - vbase] = -1;
        }
        // row i - 1 is the last of prev's run
        if (kMaxSl && prev < src[k] && prev >= vlo && prev <= vhi &&
            prev < vend) {
          maxsl[prev - vbase] =
              static_cast<int32_t>(prev_key & 0xffffffffLL);
        }
      }
      w0 += 32 * kRowsPer;
      if (head == last && last < stop) {  // inside one vertex's run
        const int64_t next = (last + 1) << 32;
        w0 = warp_partition(w0, E, [&](int64_t i) {
          return __ldg(keys + i) < next;
        });
        if (kMaxSl) last_key = __ldg(keys + w0 - 1);
      }
    }
  }
}

}  // namespace vertex_rows
