// K6: the prep half of the device transitive reduction: per-vertex run
// bounds of the two edge orders, and each edge's expansion count.
//
// Replaces sage2_tpu/graph/reduce.py _reduce_prep (:133, jitted; the same
// arithmetic as lines 66-91 of the in-core transitive_reduction, and as
// _reduce_prep_host :162). There the (src, sl) adjacency order came from a
// two-key sort, the run starts from lexicographic binary searches over
// (hi, lo) uint32 pairs of the whole adjacency and maxsl from a
// segment_max. Here the wrapper's caller sorts the composite int64 keys
// src << 32 | sl stably (one torch.sort), and two launches read them:
//
//   table   the vertex row table over the sorted keys, row[v] = the first
//           key whose src >= v, v in [0, V] (row[V]: the real edges,
//           padding after them), built by the loop of vertex_rows.cuh
//           that K21's rows launch runs (a warp 32 vertices: their first
//           row by one 32-way search, then their keys in coalesced
//           batches; a hub's run jumped by another search), with
//           maxsl[v] = the sl of v's last key (the key before its
//           successor's first), or -1 without edges. The (src, sl) and
//           the (src, dst) orders both sort by src first with the
//           padding (INT32_MAX) last, so one table is both start
//           (row[:V]) and startd (row: the membership probe's run table,
//           row[V] the end of the last run). Then each real key's sl in
//           8 bits, saturated at 255 (sl8, coalesced);
//   counts  one thread an edge e of the (src, dst) order: with sl =
//           len(src) - ovl[e] and bound = maxsl[src] - sl, the number of
//           dst's out-edges with sl <= bound, from dst's own run [row[w],
//           row[w + 1]) alone:
//             bound < 255   the run's bytes of sl8 in aligned 16-byte
//                           chunks, four loads at once (a saturated byte
//                           stands for an sl > bound, as the sl does),
//                           four compares a word; a run past 128 rows (a
//                           hub) bisected;
//             bound >= 255  the keys' low words of the run, bisected
//                           (reads longer than 255 bases);
//           0 for negative bounds, and 0 unread for the rows past row[V]
//           (the padding: the (src, dst) order holds as many real rows
//           first). len(v) is the scalar read length, or lens[v] for
//           ragged reads (the reference's (V,) read_len, :139-143); the
//           caller's keys carry the same sl. This is the upper bound of
//           (w, bound) in the whole adjacency less start[w], as before:
//           keys before the run are smaller, keys after it larger.
//
// Bound: bytes. The real rows' keys and edge arrays read once, every count
// and the tables written once (the padding need not be read). Each edge's
// run is a random read, ~18 bytes of sl8 on an E. coli graph (one or two
// sectors, and one of the row table): those reads, not the streams, hold
// the counts launch (PERF.md), where a whole-array search of the int64
// keys took about a dozen dependent sectors.

#include "common.cuh"
#include "vertex_rows.cuh"

namespace {

constexpr int32_t kI32Max = 0x7fffffff;
constexpr int32_t kScanRun = 128;     // runs up to this long are read whole
constexpr uint32_t kSat = 0xff;       // sl8 saturates here

// The rows of real edges: the first key whose src >= V (padding, or E).
__device__ __forceinline__ int64_t real_rows(const int64_t* __restrict__ keys,
                                             int64_t E, int64_t V) {
  return vertex_rows::warp_partition(0, E, [&](int64_t i) {
    return __ldg(keys + i) < (V << 32);
  });
}

__global__ void reduce_table_kernel(const int64_t* __restrict__ keys,
                                    int64_t E, int64_t V,
                                    int32_t* __restrict__ row,
                                    int32_t* __restrict__ maxsl,
                                    uint8_t* __restrict__ sl8) {
  __shared__ int64_t s_real;
  if (threadIdx.x < 32) {
    const int64_t r = real_rows(keys, E, V);
    if (threadIdx.x == 0) s_real = r;
  }
  vertex_rows::build<int32_t, true>(keys, E, 0, V, row, maxsl);
  __syncthreads();
  // the real rows' sl in 8 bits, saturated, up to their last 16-byte
  // chunk (the padding after them is never read)
  const int64_t n = (s_real + 15) & ~int64_t{15};
  SAGE2_GRID_STRIDE(i, n) {
    const uint32_t sl =
        i < E ? static_cast<uint32_t>(__ldcs(keys + i)) : kSat;
    sl8[i] = static_cast<uint8_t>(sl < kSat ? sl : kSat);
  }
}

// #{i in [lo, hi): sl[i] <= cut} of a run sorted by sl, cut < kSat, from
// the saturated copy (a saturated sl is > cut, as the sl it stands for): a
// run of up to kScanRun rows by its aligned 16-byte chunks, loaded four
// at once and compared four bytes a word; a longer run (a hub) bisected.
__device__ __forceinline__ int32_t count_run(const uint8_t* __restrict__ sl8,
                                             int32_t lo, int32_t hi,
                                             uint32_t cut) {
  if (hi - lo > kScanRun) {
    int32_t a = lo, b = hi;
    while (a < b) {
      const int32_t mid = static_cast<int32_t>(
          (static_cast<uint32_t>(a) + static_cast<uint32_t>(b)) >> 1);
      if (__ldg(sl8 + mid) <= cut) a = mid + 1; else b = mid;
    }
    return a - lo;
  }
  const uint4* q = reinterpret_cast<const uint4*>(sl8);
  const uint32_t cut4 = cut * 0x01010101u;
  const int32_t c1 = (hi + 15) >> 4;
  int32_t n = 0;
  for (int32_t c0 = lo >> 4; c0 < c1; c0 += 4) {
    uint4 x[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      x[t] = c0 + t < c1 ? __ldg(q + c0 + t) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      // the chunk's bytes inside [lo, hi), one bit each
      const int32_t base = (c0 + t) << 4;
      const int32_t a = lo - base > 0 ? lo - base : 0;
      const int32_t b = hi - base < 16 ? hi - base : 16;
      const uint32_t in = b > a ? ((1u << b) - 1) & ~((1u << a) - 1) : 0;
      const uint32_t w[4] = {x[t].x, x[t].y, x[t].z, x[t].w};
      uint32_t le = 0;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        // 0xff in each byte <= cut, gathered to one bit a byte
        const uint32_t m = __vcmpleu4(w[h], cut4) & 0x80808080u;
        le |= ((m >> 7 | m >> 14 | m >> 21 | m >> 28) & 0xfu) << (4 * h);
      }
      n += __popc(le & in);
    }
  }
  return n;
}

__global__ void reduce_edge_kernel(const int64_t* __restrict__ keys,
                                   const uint8_t* __restrict__ sl8,
                                   const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ dst,
                                   const int32_t* __restrict__ ovl,
                                   int64_t E, int64_t V, int read_len,
                                   const int32_t* __restrict__ lens,
                                   const int32_t* __restrict__ row,
                                   const int32_t* __restrict__ maxsl,
                                   int32_t* __restrict__ counts) {
  // the (src, dst) order holds the real edges first, as many as the
  // (src, sl) keys: past them every count is 0 and nothing is read
  const int64_t real = __ldg(row + V);
  SAGE2_GRID_STRIDE(e, E) {
    int32_t n = 0;
    if (e < real) {
      // dst's run and v's maxsl are loaded side by side: a bound is
      // rarely negative (never from the caller's own keys)
      const int32_t v = __ldcs(src + e), w = __ldcs(dst + e);
      const int32_t lo = __ldg(row + w), hi = __ldg(row + w + 1);
      const int len_v = lens == nullptr ? read_len : __ldg(lens + v);
      const int64_t bound = static_cast<int64_t>(__ldg(maxsl + v)) -
                            (len_v - __ldcs(ovl + e));
      if (bound >= 0 && bound < kSat) {
        n = count_run(sl8, lo, hi, static_cast<uint32_t>(bound));
      } else if (bound >= kSat) {   // past the 8-bit copy: the keys
        const uint32_t cut = static_cast<uint32_t>(bound);
        int32_t a = lo, b = hi;
        while (a < b) {
          const int32_t mid = static_cast<int32_t>(
              (static_cast<uint32_t>(a) + static_cast<uint32_t>(b)) >> 1);
          if (static_cast<uint32_t>(__ldg(keys + mid)) <= cut) {
            a = mid + 1;
          } else {
            b = mid;
          }
        }
        n = a - lo;
      }
    }
    __stcs(counts + e, n);
  }
}

}  // namespace

// keys: (E,) sorted int64 src << 32 | sl, padding (src INT32_MAX) at the
// tail, E < 2^31; row: (V + 1,) int32 output, row[v] = the first key
// whose src >= v; maxsl: (V,) int32 output, the sl of v's last key or -1;
// sl8: (E rounded up to 16,) uint8 output, 16-byte aligned, each real
// key's sl saturated at 255 (the counts read whole 16-byte chunks).
SAGE2_EXPORT int sage2_reduce_table(const void* keys, int64_t E, int64_t V,
                                    void* row, void* maxsl, void* sl8,
                                    void* stream) {
  // a warp 32 vertices, and a thread at most 16 keys a round to convert
  const int64_t threads = (V / 32 + 1) * 32 > E / 16 ? (V / 32 + 1) * 32
                                                     : E / 16;
  reduce_table_kernel<<<sage2_blocks(threads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), E, V, static_cast<int32_t*>(row),
      static_cast<int32_t*>(maxsl), static_cast<uint8_t*>(sl8));
  return static_cast<int>(cudaGetLastError());
}

// src, dst, ovl: (E,) int32 in (src, dst) order, padding src == INT32_MAX
// at the tail; row, maxsl, sl8: sage2_reduce_table's; counts: (E,) int32
// output; lens: (V,) int32 per-vertex read lengths, or NULL (every read is
// read_len long).
SAGE2_EXPORT int sage2_reduce_counts(const void* keys, const void* sl8,
                                     const void* src, const void* dst,
                                     const void* ovl, int64_t E, int64_t V,
                                     int read_len, const void* lens,
                                     const void* row, const void* maxsl,
                                     void* counts, void* stream) {
  reduce_edge_kernel<<<sage2_blocks(E), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const uint8_t*>(sl8),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(ovl), E, V, read_len,
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(row),
      static_cast<const int32_t*>(maxsl), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
