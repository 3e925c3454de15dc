// K21: the two local phases of the meshed transitive reduction.
//
// Replaces phase 2 (:493-508) and phase 4 (:518-537) of
// sage2_tpu/parallel/sharded.py sharded_transitive_reduction (:394). On
// the TPU, phase 2 was two lexicographic (uint32, uint32) binary searches
// a request (lex_searchsorted's fixed-step loop) over the shard's whole
// adjacency, a cumsum and the expand_by_counts scatter + cummax over the
// whole candidate capacity, and three gathers a candidate; phase 4 a
// lexicographic search a candidate over the whole edge list and a
// scatter of the removal marks. Here the pairs are int64 composite keys
// (src << 32 | sl, src << 32 | dst; every value is a non-negative int32,
// so int64 order is the reference's unsigned lexicographic order,
// INT32_MAX padding included), and the searches start from the vertex's
// own run:
//
//   rows    the shard's vertex row table, once a reduction pass: row[i]
//           = the first adjacency row whose src >= vbase + i, i in [0,
//           v_d] (the loop of vertex_rows.cuh, which K6 shares). A
//           warp 32 vertices: their first row by one 32-way search,
//           then the rows from there in coalesced batches of 128 (each
//           row's predecessor from the lane before) until a src past
//           the warp's vertices: row i writes the starts of
//           the vertices after row i - 1's src up to its own, so a
//           vertex's row is read about once and every start written
//           once; a batch inside one vertex's run (a hub) jumps to its
//           end by another search, and a run of vertices without edges
//           costs a warp at most its 32. The (src, sl) and the (src,
//           dst) orders both sort by src first with the padding last,
//           so one table gives w's run in the first and v's run in the
//           second.
//   ranges  one thread a received request [v, w, sl_vw, bound]: w's run
//           [row[w - vbase], row[w - vbase + 1]) and in it the rows with
//           sl_wx <= bound (a bisection of the run only): the first slot
//           and the count. Requests and candidates are routed to the
//           owner of their vertex, and a shard holds the edges of its own
//           vertices only, so a vertex outside [vbase, vbase + v_d) has
//           no rows here: its run is empty.
//   scan    torch.cumsum of the counts in the wrapper, and one host read
//           of the total (the reference's n_expansions, and the size of
//           the candidate buffer, at most cand_cap).
//   expand  a load-balanced (merge-path) split of the candidate slots
//           over the requests (K7's, reduce_marks.cu): the requests whose
//           ends fall before the last slot and the slots are merged as
//           two sorted lists and cut into tiles of kTile items, so a run
//           of zero-count requests costs an item each and a hub request
//           is cut like any other. A block stages its tile's request
//           ends, adjacency starts, v and sl_vw in shared memory; each
//           slot's request comes from a walk of the merge path; then
//           neighbouring threads make neighbouring slots [v, x, sl_vw +
//           sl_wx], read from neighbouring ss_dst/ss_key rows, up to
//           cand_cap: the reference's candidate order; ok where x != v.
//           A warp writes its 32 slots' 96 words as three contiguous
//           128-byte stores (the words exchanged by shuffles), not 12-byte
//           strided ones that leave sectors part written.
//           Persistent blocks take runs of consecutive tiles; slots are
//           counted in int64.
//   probe   at v's owner, one thread a received candidate [v, x, sl]:
//           v's run of the (src, dst)-sorted edges from the table, a
//           bisection for x in it; an edge of offset len(v) - ovl == sl
//           is marked removed. Racing marks store the same 1. len(v)
//           is read_len, or for ragged reads lens[clip(v - vbase, 0, v_d
//           - 1)] from the shard's own (v_d,) lengths of its vertex range
//           (:524-527; the vertex's owner holds its length, so nothing
//           more is routed).
//
// Bound: bytes. The table: the keys up to the table's end read once
// (the padding is not needed), each of its v_d + 1 starts written once
// and read by the requests and candidates at most once each; each
// request row read once and the rows of its range read once; each
// candidate written once (12 bytes + ok), and read once by the probe
// with its vertex's run of dst (and ovl at a hit).

#include "common.cuh"
#include "vertex_rows.cuh"

namespace {

constexpr int kSlotsPerThread = 8;
constexpr int kTile = kThreads * kSlotsPerThread;   // merge-path items
constexpr unsigned kFull = 0xffffffffu;

using vertex_rows::warp_partition;

// [lo, hi): the rows of vertex v in an order sorted by src first, from
// the table of [vbase, vbase + v_d); empty for a vertex outside it.
__device__ __forceinline__ void run_of(const int64_t* __restrict__ row,
                                       int64_t vbase, int64_t v_d,
                                       int64_t v, int64_t* lo, int64_t* hi) {
  const int64_t i = v - vbase;
  *lo = *hi = 0;
  if (i >= 0 && i < v_d) {
    *lo = __ldg(row + i);
    *hi = __ldg(row + i + 1);
  }
}

__global__ void reduce_rows_kernel(const int64_t* __restrict__ ss_key,
                                   int64_t E, int64_t vbase, int64_t v_d,
                                   int64_t* __restrict__ row) {
  // the table's loop of vertex_rows.cuh, shared with K6
  vertex_rows::build<int64_t, false>(ss_key, E, vbase, v_d, row, nullptr);
}

__global__ void reduce_ranges_kernel(const int64_t* __restrict__ ss_key,
                                     const int64_t* __restrict__ row,
                                     int64_t vbase, int64_t v_d,
                                     const int32_t* __restrict__ req,
                                     int64_t R, int64_t* __restrict__ start,
                                     int64_t* __restrict__ counts) {
  SAGE2_GRID_STRIDE(j, R) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(req) + j);
    int64_t lo, hi;
    run_of(row, vbase, v_d, q.y, &lo, &hi);
    // the run's first row with sl > bound (sl: the key's low word)
    int64_t a = lo, b = hi;
    while (a < b) {
      const int64_t mid = (a + b) >> 1;
      const int32_t sl = static_cast<int32_t>(__ldg(ss_key + mid) &
                                              0xffffffffLL);
      if (sl <= q.w) a = mid + 1; else b = mid;
    }
    const int64_t c = a - lo;
    start[j] = lo;
    counts[j] = c;
  }
}

__global__ void __launch_bounds__(kThreads) reduce_expand_kernel(
    const int64_t* __restrict__ ss_key, const int32_t* __restrict__ ss_dst,
    const int32_t* __restrict__ req, int64_t R,
    const int64_t* __restrict__ start, const int64_t* __restrict__ ends,
    int64_t C, int32_t* __restrict__ cand, bool* __restrict__ ok) {
  // s_end[i]: the end ends[e - 1] of the request before e = the tile's
  // first request + i (its first slot), then e's first adjacency row
  // less it, so that a slot's row is one addition
  __shared__ int64_t s_end[kTile + 1];
  __shared__ int32_t s_v[kTile + 1];
  __shared__ int32_t s_sl[kTile + 1];
  __shared__ int32_t s_req[kTile];        // each slot's request in the tile
  __shared__ int64_t s_cut[4];            // a tile's cuts; the requests
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the requests: A = the ends ends[e] of e in [e_first, e_last), all <=
  // C - 1; e_first holds slot 0, e_last slot C - 1
  if (warp < 2) {
    const int64_t j = warp == 0 ? 0 : C - 1;
    const int64_t e = warp_partition(0, R, [&](int64_t i) {
      return __ldg(ends + i) <= j;
    });
    if ((threadIdx.x & 31) == 0) s_cut[2 + warp] = e;
  }
  __syncthreads();
  const int64_t e_first = s_cut[2];
  const int64_t nA = s_cut[3] - e_first;
  const int64_t nB = C;
  const int64_t n_items = nA + nB;
  const int64_t n_tiles = (n_items + kTile - 1) / kTile;
  const int64_t per_block = (n_tiles + gridDim.x - 1) / gridDim.x;
  const int64_t t_begin = blockIdx.x * per_block;
  const int64_t t_end = t_begin + per_block < n_tiles ? t_begin + per_block
                                                      : n_tiles;
  // A[i] <= B[d - 1 - i]: the i-th request end comes before slot d - 1 -
  // i, so the merge path's first d items hold more than i ends
  const int64_t* A = ends + e_first;
  const auto cut = [&](int64_t d, int64_t lo, int64_t hi) {
    return warp_partition(lo, hi, [&](int64_t i) {
      return __ldg(A + i) <= d - 1 - i;
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
    const int64_t jt = d0 - ta;                     // the tile's first slot
    const int nBt = static_cast<int>(d1 - s_cut[1] - jt);
    // 2. s_end[i] = the end of request e_first + ta + i - 1 (0 before 0)
    for (int i = threadIdx.x; i <= nAt; i += kThreads) {
      const int64_t e = e_first + ta + i - 1;
      s_end[i] = e >= 0 ? __ldg(ends + e) : 0;
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
          s_req[b++] = a;
        }
      }
    }
    __syncthreads();
    //    and each request's first adjacency row less its first slot, its
    //    v and sl_vw (once a request, not once a slot)
    for (int i = threadIdx.x; i <= nAt; i += kThreads) {
      const int64_t e = e_first + ta + i;
      if (e < R) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(req) + e);
        s_end[i] = __ldg(start + e) - s_end[i];
        s_v[i] = q.x;
        s_sl[i] = q.z;
      }
    }
    __syncthreads();
    // 4. the tile's slots, a warp 32 neighbouring ones at a time: first
    //    every adjacency row of the warp's slots is loaded (up to
    //    kSlotsPerThread independent loads a lane), then the warp writes
    //    each 32 slots' 96 candidate words as three runs of 128 bytes (a
    //    lane's word comes from the lane of its slot), so no store leaves
    //    a sector part written for a later one to fill
    int32_t xs[kSlotsPerThread], sls[kSlotsPerThread];
    for (int j = 0; j < kSlotsPerThread; ++j) {
      const int i = 32 * warp + kThreads * j + lane;
      xs[j] = sls[j] = 0;
      if (i < nBt) {
        const int64_t e2 = s_end[s_req[i]] + (jt + i);
        xs[j] = __ldg(ss_dst + e2);
        sls[j] = static_cast<int32_t>(__ldg(ss_key + e2) & 0xffffffffLL);
      }
    }
    for (int j = 0; j < kSlotsPerThread; ++j) {
      const int i0 = 32 * warp + kThreads * j;
      if (i0 >= nBt) break;
      const int i = i0 + lane;
      int32_t v = 0, x = xs[j], sl = 0;
      if (i < nBt) {
        const int a = s_req[i];
        v = s_v[a];
        sl = s_sl[a] + sls[j];
        ok[jt + i] = x != v;
      }
      const int words = 3 * (nBt - i0 < 32 ? nBt - i0 : 32);
      int32_t* out = cand + (jt + i0) * 3;
      for (int q = 0; q < 3; ++q) {
        const int w = 32 * q + lane;
        const int from = w / 3, c = w - 3 * from;
        const int32_t cv = __shfl_sync(kFull, v, from);
        const int32_t cx = __shfl_sync(kFull, x, from);
        const int32_t cs = __shfl_sync(kFull, sl, from);
        if (w < words) out[w] = c == 0 ? cv : (c == 1 ? cx : cs);
      }
    }
    __syncthreads();
  }
}

__global__ void reduce_probe_kernel(const int32_t* __restrict__ dst,
                                    const int32_t* __restrict__ ovl,
                                    const int64_t* __restrict__ row,
                                    int64_t vbase, int64_t v_d,
                                    const int32_t* __restrict__ cand,
                                    int64_t C, int read_len,
                                    const int32_t* __restrict__ lens,
                                    int64_t n_lens,
                                    uint8_t* __restrict__ removed) {
  SAGE2_GRID_STRIDE(j, C) {
    const int32_t v = __ldg(cand + j * 3), x = __ldg(cand + j * 3 + 1);
    const int32_t sl = __ldg(cand + j * 3 + 2);
    const int64_t i = static_cast<int64_t>(v) - vbase;
    int64_t lo, hi;
    run_of(row, vbase, v_d, v, &lo, &hi);
    // x in v's run, bisected
    int64_t pos = -1;
    const int64_t end = hi;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(dst + mid) < x) lo = mid + 1; else hi = mid;
    }
    if (lo < end && __ldg(dst + lo) == x) pos = lo;
    if (pos >= 0) {
      int len = read_len;
      if (lens != nullptr) {
        const int64_t k = i < 0 ? 0 : (i > n_lens - 1 ? n_lens - 1 : i);
        len = __ldg(lens + k);
      }
      if (len - __ldg(ovl + pos) == sl) removed[pos] = 1;
    }
  }
}

}  // namespace

// ss_key: (E,) int64 sorted src << 32 | sl (src >= 0); row: (v_d + 1,)
// int64 output, row[i] = the first index with src >= vbase + i.
SAGE2_EXPORT int sage2_reduce_rows(const void* ss_key, int64_t E,
                                   int64_t vbase, int64_t v_d, void* row,
                                   void* stream) {
  reduce_rows_kernel<<<sage2_blocks((v_d / 32 + 1) * 32), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ss_key), E, vbase, v_d,
      static_cast<int64_t*>(row));
  return static_cast<int>(cudaGetLastError());
}

// row: sage2_reduce_rows' table of [vbase, vbase + v_d); req: (R, 4)
// int32 [v, w, sl_vw, bound] (bound >= 0), 16-byte aligned; start,
// counts: (R,) int64 outputs.
SAGE2_EXPORT int sage2_reduce_ranges(const void* ss_key, const void* row,
                                     int64_t vbase, int64_t v_d,
                                     const void* req, int64_t R, void* start,
                                     void* counts, void* stream) {
  if (row == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  reduce_ranges_kernel<<<sage2_blocks(R), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ss_key),
      static_cast<const int64_t*>(row), vbase, v_d,
      static_cast<const int32_t*>(req), R, static_cast<int64_t*>(start),
      static_cast<int64_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// ss_dst: (E,) int32 beside ss_key; start: the ranges' first rows; ends:
// (R,) int64 the inclusive cumsum of the counts; C = min(total, cap) >=
// 1 slots; cand: (C, 3) int32 and ok: (C,) bool outputs.
SAGE2_EXPORT int sage2_reduce_expand(const void* ss_key, const void* ss_dst,
                                     const void* req, int64_t R,
                                     const void* start, const void* ends,
                                     int64_t C, void* cand, void* ok,
                                     void* stream) {
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
          &per_sm, reduce_expand_kernel, kThreads, 0);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  // the tiles: at most (C + R) / kTile
  const int64_t most = (C + R + kTile - 1) / kTile;
  const int grid = static_cast<int>(most < resident ? most : resident);
  reduce_expand_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ss_key),
      static_cast<const int32_t*>(ss_dst), static_cast<const int32_t*>(req),
      R, static_cast<const int64_t*>(start),
      static_cast<const int64_t*>(ends), C, static_cast<int32_t*>(cand),
      static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

// dst, ovl: (E,) int32 local edges sorted by (src, dst) (padding
// INT32_MAX); row: the shard's table of [vbase, vbase + v_d), their src
// runs; cand: (C, 3) int32 [v, x, sl]; lens: (n_lens,) int32 lengths of
// the vertices [vbase, vbase + n_lens) (n_lens >= 1), or NULL for
// read_len; removed: (E,) uint8, zeroed by the caller, set where an edge
// is removed.
SAGE2_EXPORT int sage2_reduce_probe(const void* dst, const void* ovl,
                                    const void* row, int64_t vbase,
                                    int64_t v_d, const void* cand, int64_t C,
                                    int read_len, const void* lens,
                                    int64_t n_lens, void* removed,
                                    void* stream) {
  if (row == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  reduce_probe_kernel<<<sage2_blocks(C), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(dst), static_cast<const int32_t*>(ovl),
      static_cast<const int64_t*>(row), vbase, v_d,
      static_cast<const int32_t*>(cand), C, read_len,
      static_cast<const int32_t*>(lens), n_lens,
      static_cast<uint8_t*>(removed));
  return static_cast<int>(cudaGetLastError());
}
