// K7: the expansion and membership-probe half of the device transitive
// reduction, over one range [j0, j1) of the expansion slots.
//
// Replaces sage2_tpu/graph/reduce.py _chunk_kernel (:520, jitted at :521;
// the same arithmetic as lines 93-118 of the in-core
// transitive_reduction). On the TPU each chunk materialised its slots
// with expand_by_counts (a scatter and a cummax over the chunk capacity)
// and then probed them in whole-array bisection steps. Here nothing is
// materialised. For slot j:
//
//   e1   = the edge whose expansion holds j: the first edge with
//          offsets[e1] > j in the inclusive int64 prefix sum of the
//          per-edge counts (K6);
//   rank = j - (offsets[e1] - counts[e1]), e2 = start[dst[e1]] + rank:
//          the rank-th out-edge of w = dst[e1] in the (src, sl) order;
//   x    = ss_dst[e2]; the path v -> w -> x with v = src[e1] is skipped
//          when x == v; otherwise x is bisected in v's out-run of the
//          (src, dst) order, dst[startd[v] : startd[v + 1]], and a hit
//          with len(v) - ovl[pos] == sl[e1] + ss_sl[e2] marks
//          removed[pos] = 1, where sl[e1] = len(v) - ovl[e1]. len(v)
//          (the read length, or the reference's c_plen for ragged reads,
//          :551) is on both sides, so the test is ovl[e1] - ss_sl[e2] ==
//          ovl[pos] (exactly, in int32 too), and the kernel needs no
//          lengths.
//
// Finding e1 is what a search per slot made slow (27 dependent loads of
// the 96 M-entry offsets at the E. coli scale, repeated by neighbouring
// threads). Here it is a load-balanced search (moderngpu's): the edges
// whose ends fall in the range and the range's slots are merged as two
// sorted lists (an edge's end offsets[e] before slot j when offsets[e] <=
// j), and the merged list is cut into tiles of kTile items. So a tile
// holds at most kTile edge ends and slots together: a run of zero-count
// edges costs one item each and cannot overflow the tile, and a hub edge
// whose slots span many tiles is cut like any other. For each tile:
//
//   1. one warp finds the tile's end on the merge path by a 32-way search
//      (32 probes of offsets a round) between the tile's start, which
//      the block's last tile ended at, and kTile edges further: 3 rounds;
//   2. the block stages the tile's segment of offsets, one edge before it
//      included (the first edge's start), in shared memory;
//   3. each thread finds its kSlotsPerThread-item stretch of the merge
//      path by a bisection of the staged segment and walks it, writing
//      each slot's edge into shared memory; then each edge's first
//      out-edge of w = dst[e] in the (src, sl) order, start[w], takes its
//      place in the staged segment, less the edge's first slot, so that
//      a slot's e2 is one addition;
//   4. the threads probe the tile's slots, neighbouring threads on
//      neighbouring slots: they share e1 and v, so v's run bounds and
//      v's out-run are loaded once for a warp.
//
// Once per block the range's first and last edges, and its first tile's
// start, are found the same way over the whole offsets array; blocks are
// persistent and each takes a run of consecutive tiles (the tiles hold
// equal numbers of items). Racing stores write the same 1, so the marks
// do not depend on the order of the threads. The wrapper launches the
// slot space in ranges of at most 2^24 slots; the in-core form ends the
// last range at its capacity. The slot space is counted in int64: at E.
// coli scale it is within 2x of 2^31.
//
// Bound: random sectors of device memory. Each expanded edge reads its
// w's run of ss_dst and ss_sl (~10 rows, 2-4 sectors), and the runs of
// the in-edges of one w lie far apart in the edge order, so L2 does not
// keep them: ~200 MB of random 32-byte sectors a 2^24-slot range at the
// E. coli scale, with ss_sl's row read only at a hit. The search that
// found e1 (27 dependent loads a slot before) and v's membership
// bisection (L1 hits: neighbouring slots share v) are no longer what the
// time goes to.

#include "common.cuh"

constexpr int kSlotsPerThread = 8;
constexpr int kTile = kThreads * kSlotsPerThread;   // merge-path items

// a + #{i in [a, b): pred(i)} for a predicate true on a prefix of [a, b):
// one warp, 32 probes a round (all lanes call it; the result is uniform).
template <typename Pred>
__device__ __forceinline__ int64_t warp_partition(int64_t a, int64_t b,
                                                  const Pred& pred) {
  const int lane = threadIdx.x & 31;
  while (b - a > 32) {
    const int64_t n = b - a;
    const int64_t probe = a + n * (lane + 1) / 32 - 1;    // lane 31: b - 1
    const int t = __popc(__ballot_sync(0xffffffffu, pred(probe)));
    // probe t - 1 holds, probe t does not: the cut is in between
    const int64_t lo = t == 0 ? a : a + n * t / 32;
    const int64_t hi = t == 32 ? b : a + n * (t + 1) / 32 - 1;
    a = lo;
    b = hi;
  }
  const bool in = a + lane < b && pred(a + lane);
  return a + __popc(__ballot_sync(0xffffffffu, in));
}

__global__ void __launch_bounds__(kThreads) reduce_marks_kernel(
    uint8_t* __restrict__ removed, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ ovl, const int32_t* __restrict__ ss_sl,
    const int32_t* __restrict__ ss_dst, const int32_t* __restrict__ start,
    const int32_t* __restrict__ startd, int64_t E, int64_t j0, int64_t j1) {
  // s_end[i]: the end offsets[e - 1] of the edge before e = the tile's
  // first edge + i, then (step 3) e's start[dst[e]] less it
  __shared__ int64_t s_end[kTile + 1];
  __shared__ int32_t s_edge[kTile];        // each slot's edge in the tile
  __shared__ int64_t s_cut[4];        // a tile's cuts; the range's edges
  const int warp = threadIdx.x >> 5;

  // the range's edges: A = the ends offsets[e] of e in [e_first, e_last),
  // all <= j1 - 1; e_first holds slot j0, e_last slot j1 - 1
  if (warp < 2) {
    const int64_t j = warp == 0 ? j0 : j1 - 1;
    const int64_t e = warp_partition(0, E, [&](int64_t i) {
      return __ldg(offsets + i) <= j;
    });
    if ((threadIdx.x & 31) == 0) s_cut[2 + warp] = e;
  }
  __syncthreads();
  const int64_t e_first = s_cut[2];
  const int64_t nA = s_cut[3] - e_first;
  const int64_t nB = j1 - j0;
  const int64_t n_items = nA + nB;
  const int64_t n_tiles = (n_items + kTile - 1) / kTile;
  // this block's tiles, consecutive, so that each tile's first cut is
  // the last one's end
  const int64_t per_block = (n_tiles + gridDim.x - 1) / gridDim.x;
  const int64_t t_begin = blockIdx.x * per_block;
  const int64_t t_end = t_begin + per_block < n_tiles ? t_begin + per_block
                                                      : n_tiles;
  // A[i] <= B[d - 1 - i]: the i-th edge end comes before the (d - 1 -
  // i)-th slot, so the merge path's first d items hold more than i ends
  const int64_t* A = offsets + e_first;
  const auto cut = [&](int64_t d, int64_t lo, int64_t hi) {
    return warp_partition(lo, hi, [&](int64_t i) {
      return __ldg(A + i) <= j0 + d - 1 - i;
    });
  };
  int64_t a0 = 0;
  if (warp == 0 && t_begin < t_end) {
    const int64_t d = t_begin * kTile;
    a0 = cut(d, d - nB > 0 ? d - nB : 0, d < nA ? d : nA);
  }

  for (int64_t tile = t_begin; tile < t_end; ++tile) {
    const int64_t d0 = tile * kTile;
    const int64_t d1 = d0 + kTile < n_items ? d0 + kTile : n_items;
    // 1. the tile's end on the merge path: between a0 and a0 + kTile ends
    if (warp == 0) {
      const int64_t lo = d1 - nB > a0 ? d1 - nB : a0;
      const int64_t most = a0 + (d1 - d0);
      const int64_t a1 = cut(d1, lo, most < nA ? most : nA);
      if ((threadIdx.x & 31) == 0) {
        s_cut[0] = a0;
        s_cut[1] = a1;
      }
      a0 = a1;
    }
    __syncthreads();
    const int64_t ta = s_cut[0];
    const int nAt = static_cast<int>(s_cut[1] - ta);
    const int64_t b0 = d0 - ta;                     // first slot, from j0
    const int nBt = static_cast<int>(d1 - s_cut[1] - b0);
    const int64_t jt = j0 + b0;
    // 2. s_end[i] = the end of edge e_first + ta + i - 1 (0 before edge 0)
    for (int i = threadIdx.x; i <= nAt; i += kThreads) {
      const int64_t e = e_first + ta + i - 1;
      s_end[i] = e >= 0 ? __ldg(offsets + e) : 0;
    }
    __syncthreads();
    // 3. this thread's stretch of the merge path, walked
    {
      const int n = nAt + nBt;
      const int dt = threadIdx.x * kSlotsPerThread < n
                         ? threadIdx.x * kSlotsPerThread : n;
      int a = dt - nBt > 0 ? dt - nBt : 0;
      int hi = dt < nAt ? dt : nAt;
      while (a < hi) {
        const int mid = (a + hi) >> 1;
        if (s_end[mid + 1] <= jt + dt - 1 - mid) {
          a = mid + 1;
        } else {
          hi = mid;
        }
      }
      int b = dt - a;
      const int stop = dt + kSlotsPerThread < n ? dt + kSlotsPerThread : n;
      for (int d = dt; d < stop; ++d) {
        if (a < nAt && (b >= nBt || s_end[a + 1] <= jt + b)) {
          ++a;
        } else {
          s_edge[b++] = a;
        }
      }
    }
    __syncthreads();
    //    and each edge's first out-edge of w = dst[e] in the (src, sl)
    //    order, less its first slot: e2 = s_end[a] + j (once an edge,
    //    not once a slot)
    for (int i = threadIdx.x; i <= nAt; i += kThreads) {
      const int64_t e = e_first + ta + i;
      s_end[i] = __ldg(start + __ldg(dst + e)) - s_end[i];
    }
    __syncthreads();
    // 4. the probes of the tile's slots
    for (int i = threadIdx.x; i < nBt; i += kThreads) {
      const int a = s_edge[i];
      const int64_t e1 = e_first + ta + a;
      const int64_t e2 = s_end[a] + (jt + i);
      const int32_t v = __ldg(src + e1);
      const int32_t x = __ldg(ss_dst + e2);
      if (x == v) continue;
      int64_t lo = __ldg(startd + v), hi = __ldg(startd + v + 1);
      const int64_t end = hi;
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (__ldg(dst + mid) < x) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      if (lo == end || __ldg(dst + lo) != x) continue;
      // a hit: only now the offsets (ss_sl's row is a random sector)
      if (__ldg(ovl + e1) - __ldg(ss_sl + e2) == __ldg(ovl + lo)) {
        removed[lo] = 1;
      }
    }
    __syncthreads();
  }
}

// removed: (E,) uint8, marks added in place; offsets: (E,) int64 inclusive
// prefix sum of the expansion counts; src, dst, ovl: (E,) int32 in (src,
// dst) order; ss_sl, ss_dst: (E,) int32 in (src, sl) order; start: (V,)
// int32; startd: (V + 1,) int32; 0 <= j0 < j1 <= offsets[E - 1].
SAGE2_EXPORT int sage2_reduce_marks(void* removed, const void* offsets,
                                    const void* src, const void* dst,
                                    const void* ovl, const void* ss_sl,
                                    const void* ss_dst, const void* start,
                                    const void* startd, int64_t E,
                                    int64_t j0, int64_t j1, void* stream) {
  // persistent blocks: as many as stay resident, at most one a tile
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reduce_marks_kernel, kThreads, 0);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  // the tiles: at most (j1 - j0 + E) / kTile
  const int64_t most = (j1 - j0 + E + kTile - 1) / kTile;
  const int grid = static_cast<int>(most < resident ? most : resident);
  reduce_marks_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(removed), static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(ovl), static_cast<const int32_t*>(ss_sl),
      static_cast<const int32_t*>(ss_dst),
      static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(startd), E, j0, j1);
  return static_cast<int>(cudaGetLastError());
}
