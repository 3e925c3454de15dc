// K3: the overlap join after the seed-row sort: each query row's entry
// range, candidate expansion, and the word-wise suffix-prefix verify.
//
// Replaces sage2_tpu/overlap/detect.py fused_join_core (:863) minus its
// sort (which stays torch.sort), with the row layout of build_seed_rows
// / _row_payload (:642, :562). On the TPU the run accounting was two
// cummax scans, the expansion a scatter plus a cummax over the whole
// candidate capacity, and the verify two wide row gathers; every step
// was shaped by the TPU's fixed cost per gather and scatter. Here:
//
//   count pass  one thread per sorted row; the thread at a run head walks
//               its run once (entries sort before queries in a run) and
//               writes each row's candidate count (= entries in its run
//               for a query, 0 otherwise) and the run's first row.
//   scan        an exclusive prefix sum of the counts gives each query's
//               first candidate slot and the total (torch.cumsum in the
//               wrapper, between the two launches).
//   write pass  one thread per query row loops over its run's entries,
//               verifies each (query, entry) pair from the two payload
//               rows, and writes (ok, a, b, ovl) at its slot. Slots come
//               in sorted-query order, rank order within a query: the
//               reference's candidate order exactly.
//
// Precondition: rows are sorted by key and, within a key, entries (slot
// t < g of a read) before queries, each by row id. Dead rows (invalid
// reads) are not passed at all.
//
// Bound: bytes. The count pass reads each key and row id about twice;
// the write pass reads one payload row per query and one per candidate
// (Wt + 2 words each) and writes 13 bytes per candidate.

#include "common.cuh"

__global__ void join_count_kernel(const int64_t* __restrict__ keys,
                                  const int32_t* __restrict__ rows,
                                  int64_t n, int R, int g,
                                  int32_t* __restrict__ counts,
                                  int32_t* __restrict__ ebase) {
  SAGE2_GRID_STRIDE(i, n) {
    const int64_t key = keys[i];
    if (i > 0 && keys[i - 1] == key) continue;  // not a run head
    int64_t j = i;
    for (; j < n && keys[j] == key && rows[j] % R < g; ++j) {
      counts[j] = 0;
      ebase[j] = static_cast<int32_t>(i);
    }
    const int32_t n_entries = static_cast<int32_t>(j - i);
    for (; j < n && keys[j] == key; ++j) {
      counts[j] = rows[j] % R < g ? 0 : n_entries;
      ebase[j] = static_cast<int32_t>(i);
    }
  }
}

__global__ void join_write_kernel(
    const int32_t* __restrict__ rows, const uint32_t* __restrict__ payload,
    int W2, int64_t n, const int32_t* __restrict__ counts,
    const int32_t* __restrict__ ebase, const int64_t* __restrict__ starts,
    int R, int g, int trim, int min_overlap, bool* __restrict__ ok,
    int32_t* __restrict__ cand_a, int32_t* __restrict__ cand_b,
    int32_t* __restrict__ cand_ovl) {
  const int Wt = W2 - 2;  // payload row: [Wt words, prev/first word, len]
  SAGE2_GRID_STRIDE(i, n) {
    const int c = counts[i];
    if (c == 0) continue;
    const int32_t qid = rows[i];
    const int32_t a = qid / R;
    const int p = (qid % R - g + 1) * g;  // query probe position in read a
    const uint32_t* pa = payload + static_cast<int64_t>(qid) * W2;
    const int len_a = static_cast<int>(pa[Wt + 1]);
    const uint32_t apw = pa[Wt];  // bases [p-16, p) of a, right-aligned
    const int64_t slot0 = starts[i];
    const int64_t e0 = ebase[i];
    for (int r = 0; r < c; ++r) {
      const int32_t eid = rows[e0 + r];
      const int32_t b = eid / R;
      const int o = eid % R;  // entry offset inside read b's prefix
      const uint32_t* pb = payload + static_cast<int64_t>(eid) * W2;
      const int len_b = static_cast<int>(pb[Wt + 1]);
      const int ovl = len_a - (p - o);
      bool match = a != b;
      // words past the seed (the first `trim` words are equal by the
      // key sort), compared over min(len_a - p, len_b - o) bases
      const int lc2 = 2 * min(len_a - p, len_b - o);
      for (int t = 0; t < Wt; ++t) {
        int vb = lc2 - (t + trim) * 32;
        vb = vb < 0 ? 0 : (vb > 32 ? 32 : vb);
        if (vb > 0 && ((pa[t] ^ pb[t]) >> (32 - vb)) != 0u) match = false;
      }
      // the o bases of a before p equal b's first o bases
      const uint32_t lhs = apw & ((1u << (2 * o)) - 1u);
      const uint32_t rhs = o == 0 ? 0u : (pb[Wt] >> (32 - 2 * o));
      match = match && lhs == rhs;
      const int64_t slot = slot0 + r;
      ok[slot] = match && ovl < len_b && ovl >= min_overlap;
      cand_a[slot] = a;
      cand_b[slot] = b;
      cand_ovl[slot] = ovl;
    }
  }
}

// keys: (n,) sorted int64; rows: (n,) int32 row ids (read * R + slot);
// counts, ebase: (n,) int32 outputs.
SAGE2_EXPORT int sage2_join_count(const void* keys, const void* rows,
                                  int64_t n, int R, int g, void* counts,
                                  void* ebase, void* stream) {
  join_count_kernel<<<sage2_blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int32_t*>(rows),
      n, R, g, static_cast<int32_t*>(counts), static_cast<int32_t*>(ebase));
  return static_cast<int>(cudaGetLastError());
}

// payload: (n_rows_total, W2) int32 words indexed by row id; starts: (n,)
// int64 first slot of each query; ok/cand_*: (total,) outputs.
SAGE2_EXPORT int sage2_join_write(const void* rows, const void* payload,
                                  int W2, int64_t n, const void* counts,
                                  const void* ebase, const void* starts,
                                  int R, int g, int trim, int min_overlap,
                                  void* ok, void* cand_a, void* cand_b,
                                  void* cand_ovl, void* stream) {
  join_write_kernel<<<sage2_blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows),
      static_cast<const uint32_t*>(payload), W2, n,
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(ebase),
      static_cast<const int64_t*>(starts), R, g, trim, min_overlap,
      static_cast<bool*>(ok), static_cast<int32_t*>(cand_a),
      static_cast<int32_t*>(cand_b), static_cast<int32_t*>(cand_ovl));
  return static_cast<int>(cudaGetLastError());
}
