// K21: the two local phases of the meshed transitive reduction.
//
// Replaces phase 2 (:493-508) and phase 4 (:518-537) of
// sage2_tpu/parallel/sharded.py sharded_transitive_reduction (:394). On
// the TPU, phase 2 was two lexicographic (uint32, uint32) binary searches
// a request (lex_searchsorted's fixed-step loop), a cumsum and the
// expand_by_counts scatter + cummax over the whole candidate capacity,
// and three gathers a candidate; phase 4 a lexicographic search a
// candidate and a scatter of the removal marks. Here the pairs are int64
// composite keys (src << 32 | sl, src << 32 | dst; every value is a
// non-negative int32, so int64 order is the reference's unsigned
// lexicographic order, INT32_MAX padding included):
//
//   ranges  one thread a received request [v, w, sl_vw, bound]: its
//           range of w's local adjacency (sorted by src << 32 | sl) with
//           sl_wx <= bound: the first slot and the count.
//   scan    torch.cumsum of the counts in the wrapper, and one host read
//           of the total (the reference's n_expansions, and the size of
//           the candidate buffer, at most cand_cap).
//   expand  one thread a request writes its candidates [v, x, sl_vw +
//           sl_wx] at its first slot, in rank order, up to cand_cap: the
//           reference's candidate order; ok where x != v.
//   probe   at v's owner, one thread a received candidate [v, x, sl]:
//           a binary search for (v, x) among the local edges (sorted by
//           src << 32 | dst, read as two int32 arrays); an edge of
//           offset len(v) - ovl == sl is marked removed. Racing marks
//           store the same 1. len(v) is read_len, or for ragged reads
//           lens[clip(v - vbase, 0, v_d - 1)] from the shard's own
//           (v_d,) lengths of its vertex range (:524-527; the vertex's
//           owner holds its length, so nothing more is routed).
//
// Bound: bytes. Each request row is read once and its two searches touch
// O(log E) sectors; each candidate written once (12 bytes + ok), and read
// once by the probe with its search.

#include "common.cuh"

namespace {

__device__ __forceinline__ int64_t lower_bound64(const int64_t* a, int64_t n,
                                                 int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void reduce_ranges_kernel(const int64_t* __restrict__ ss_key,
                                     int64_t E,
                                     const int32_t* __restrict__ req,
                                     int64_t R, int64_t* __restrict__ start,
                                     int64_t* __restrict__ counts) {
  SAGE2_GRID_STRIDE(j, R) {
    const int64_t w = req[j * 4 + 1];
    const int64_t bound = req[j * 4 + 3];
    const int64_t s = lower_bound64(ss_key, E, w << 32);
    const int64_t u = lower_bound64(ss_key, E, (w << 32) | (bound + 1));
    start[j] = s;
    counts[j] = u - s;
  }
}

__global__ void reduce_expand_kernel(const int64_t* __restrict__ ss_key,
                                     const int32_t* __restrict__ ss_dst,
                                     const int32_t* __restrict__ req,
                                     int64_t R,
                                     const int64_t* __restrict__ start,
                                     const int64_t* __restrict__ counts,
                                     const int64_t* __restrict__ ends,
                                     int64_t cap, int32_t* __restrict__ cand,
                                     bool* __restrict__ ok) {
  SAGE2_GRID_STRIDE(j, R) {
    const int64_t c = counts[j];
    const int64_t slot0 = ends[j] - c;
    if (c == 0 || slot0 >= cap) continue;
    const int64_t n_out = slot0 + c <= cap ? c : cap - slot0;
    const int32_t v = req[j * 4];
    const int32_t sl_vw = req[j * 4 + 2];
    const int64_t e0 = start[j];
    for (int64_t r = 0; r < n_out; ++r) {
      const int64_t e = e0 + r;
      const int32_t x = ss_dst[e];
      const int64_t slot = slot0 + r;
      cand[slot * 3] = v;
      cand[slot * 3 + 1] = x;
      cand[slot * 3 + 2] =
          sl_vw + static_cast<int32_t>(ss_key[e] & 0xffffffffLL);
      ok[slot] = x != v;
    }
  }
}

__global__ void reduce_probe_kernel(const int32_t* __restrict__ src,
                                    const int32_t* __restrict__ dst,
                                    const int32_t* __restrict__ ovl,
                                    int64_t E,
                                    const int32_t* __restrict__ cand,
                                    int64_t C, int read_len,
                                    const int32_t* __restrict__ lens,
                                    int64_t v_d, int64_t vbase,
                                    uint8_t* __restrict__ removed) {
  SAGE2_GRID_STRIDE(j, C) {
    const int32_t v = cand[j * 3], x = cand[j * 3 + 1];
    const int32_t sl = cand[j * 3 + 2];
    int64_t lo = 0, hi = E;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      const int32_t s = src[mid];
      if (s < v || (s == v && dst[mid] < x)) lo = mid + 1; else hi = mid;
    }
    if (lo < E && src[lo] == v && dst[lo] == x) {
      int len = read_len;
      if (lens != nullptr) {
        int64_t i = v - vbase;
        i = i < 0 ? 0 : (i > v_d - 1 ? v_d - 1 : i);
        len = lens[i];
      }
      if (len - ovl[lo] == sl) removed[lo] = 1;
    }
  }
}

}  // namespace

// ss_key: (E,) int64 sorted src << 32 | sl; req: (R, 4) int32 [v, w,
// sl_vw, bound] (bound >= 0); start, counts: (R,) int64 outputs.
SAGE2_EXPORT int sage2_reduce_ranges(const void* ss_key, int64_t E,
                                     const void* req, int64_t R, void* start,
                                     void* counts, void* stream) {
  reduce_ranges_kernel<<<sage2_blocks(R), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ss_key), E,
      static_cast<const int32_t*>(req), R, static_cast<int64_t*>(start),
      static_cast<int64_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// ss_dst: (E,) int32 beside ss_key; ends: (R,) int64 the inclusive
// cumsum of counts; cand: (min(total, cap), 3) int32 and ok: (min(total,
// cap),) bool outputs.
SAGE2_EXPORT int sage2_reduce_expand(const void* ss_key, const void* ss_dst,
                                     const void* req, int64_t R,
                                     const void* start, const void* counts,
                                     const void* ends, int64_t cap,
                                     void* cand, void* ok, void* stream) {
  reduce_expand_kernel<<<sage2_blocks(R), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ss_key),
      static_cast<const int32_t*>(ss_dst), static_cast<const int32_t*>(req),
      R, static_cast<const int64_t*>(start),
      static_cast<const int64_t*>(counts), static_cast<const int64_t*>(ends),
      cap, static_cast<int32_t*>(cand), static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

// src, dst, ovl: (E,) int32 local edges sorted by (src, dst) (padding
// INT32_MAX); cand: (C, 3) int32 [v, x, sl]; lens: (v_d,) int32 lengths
// of the vertices [vbase, vbase + v_d) (v_d >= 1), or NULL for read_len;
// removed: (E,) uint8, zeroed by the caller, set where an edge is
// removed.
SAGE2_EXPORT int sage2_reduce_probe(const void* src, const void* dst,
                                    const void* ovl, int64_t E,
                                    const void* cand, int64_t C,
                                    int read_len, const void* lens,
                                    int64_t v_d, int64_t vbase,
                                    void* removed, void* stream) {
  reduce_probe_kernel<<<sage2_blocks(C), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(ovl), E, static_cast<const int32_t*>(cand),
      C, read_len, static_cast<const int32_t*>(lens), v_d, vbase,
      static_cast<uint8_t*>(removed));
  return static_cast<int>(cudaGetLastError());
}
