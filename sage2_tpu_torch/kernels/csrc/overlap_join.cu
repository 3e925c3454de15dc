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
// reads, and for ragged reads the seeds that pass a read's end) are not
// passed at all.
//
// Ragged reads: each payload row carries its read's length, and the
// verify compares min(len_a - p, len_b - o) bases, so nothing past either
// read's end takes part. The write pass then also marks containments
// (the reference's ok_contained, :1011, scattered at :836-843): a
// verified pair with len_b <= ovl stores contained[b] = 1. Racing stores
// write the same 1, so the marks need no atomics and no candidate-sized
// array. Fixed-length reads pass no `contained` (len_b == L > ovl
// always). Only slots below `slot_limit` are written and marked: the
// reference's candidate capacity, when the caller keeps fewer slots than
// there are candidates.
//
// The streamed join (sage2_tpu/stream.py:835-887) joins an entry slab
// with one query chunk: its rows carry global ids (read * R + t), but the
// payload rows lie in two arrays, the slab's entries ((read - entry
// base) * g + t) and the chunk's queries ((read - query base) * n_pos +
// t - g). The write pass finds a row's payload through that two-segment
// map; the in-core join passes one payload with both bases 0 and both
// strides R, which is the row id itself.
//
// The meshed join (parallel/sharded.py:921-929) joins the rows a hash
// owner received from every shard: their ids are global and their
// payload rows lie in received order, so the wrapper passes the sort's
// permutation and the payload row of sorted row i is perm[i].
//
// The fixed-capacity mode (find_overlaps_stacked, detect.py:1108) reads
// no count on the host: the rows come as K13's fixed buffer of M * R,
// the live rows first and the live count in device memory, and the count
// pass stops there (a live all-T seed and a dead row share the key
// INT64_MAX). The write pass reads the total (the last offset) from
// device memory and writes exactly `capacity` slots: the candidates
// below min(total, capacity), then not-ok slots (a, b, ovl 0). Nothing
// waits on the host.
//
// Bound: bytes. The count pass reads each key and row id about twice;
// the write pass reads one payload row per query and one per candidate
// (Wt + 2 words each) and writes 13 bytes per candidate.

#include "common.cuh"

// n_live: NULL (every row live), or the live rows at the front of the n
// in device memory; the rows behind them count 0.
__global__ void join_count_kernel(const int64_t* __restrict__ keys,
                                  const int32_t* __restrict__ rows,
                                  int64_t n_rows,
                                  const int64_t* __restrict__ n_live,
                                  int R, int g,
                                  int32_t* __restrict__ counts,
                                  int32_t* __restrict__ ebase) {
  const int64_t n = n_live == nullptr ? n_rows : *n_live;
  SAGE2_GRID_STRIDE(i, n_rows) {
    if (i >= n) {       // a dead row of the fixed buffer
      counts[i] = 0;
      ebase[i] = 0;
      continue;
    }
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

// Where the payload row of a seed row lies: entry rows (t < g) in `ent`
// at (read - ent_base) * ent_stride + t, query rows in `qry` at (read -
// qry_base) * qry_stride + t - qry_off; W2 int32 words a row. With `perm`
// the row of sorted row `pos` is qry's row perm[pos].
struct PayloadMap {
  const uint32_t* ent;
  int64_t ent_base;
  int ent_stride;
  const uint32_t* qry;
  int64_t qry_base;
  int qry_stride;
  int qry_off;
  int W2;
  const int64_t* perm;

  __device__ __forceinline__ const uint32_t* row(int32_t id, int64_t pos,
                                                 int R, int g) const {
    if (perm != nullptr) return qry + perm[pos] * W2;
    const int64_t read = id / R;
    const int t = id % R;
    if (t < g) return ent + ((read - ent_base) * ent_stride + t) * W2;
    return qry + ((read - qry_base) * qry_stride + t - qry_off) * W2;
  }
};

__global__ void join_write_kernel(
    const int32_t* __restrict__ rows, const PayloadMap pm, int64_t n,
    const int32_t* __restrict__ counts,
    const int32_t* __restrict__ ebase, const int64_t* __restrict__ starts,
    int R, int g, int trim, int min_overlap, int64_t slot_limit,
    const int64_t* __restrict__ total,
    bool* __restrict__ ok, int32_t* __restrict__ cand_a,
    int32_t* __restrict__ cand_b, int32_t* __restrict__ cand_ovl,
    uint8_t* __restrict__ contained) {
  const int Wt = pm.W2 - 2;  // payload row: [Wt words, prev/first word, len]
  if (total != nullptr) {    // fixed capacity: the slots past the total
    const int64_t used = *total;
    SAGE2_GRID_STRIDE(j, slot_limit) {
      if (j >= used) {
        ok[j] = false;
        cand_a[j] = 0;
        cand_b[j] = 0;
        cand_ovl[j] = 0;
      }
    }
  }
  SAGE2_GRID_STRIDE(i, n) {
    const int c = counts[i];
    if (c == 0) continue;
    const int32_t qid = rows[i];
    const int32_t a = qid / R;
    const int p = (qid % R - g + 1) * g;  // query probe position in read a
    const uint32_t* pa = pm.row(qid, i, R, g);
    const int len_a = static_cast<int>(pa[Wt + 1]);
    const uint32_t apw = pa[Wt];  // bases [p-16, p) of a, right-aligned
    const int64_t slot0 = starts[i];
    const int64_t e0 = ebase[i];
    int64_t n_slots = slot_limit - slot0;  // slots below the limit
    if (n_slots > c) n_slots = c;
    for (int r = 0; r < n_slots; ++r) {
      const int32_t eid = rows[e0 + r];
      const int32_t b = eid / R;
      const int o = eid % R;  // entry offset inside read b's prefix
      const uint32_t* pb = pm.row(eid, e0 + r, R, g);
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
      if (contained != nullptr && match && len_b <= ovl) contained[b] = 1;
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
      n, nullptr, R, g, static_cast<int32_t*>(counts),
      static_cast<int32_t*>(ebase));
  return static_cast<int>(cudaGetLastError());
}

// The fixed-capacity mode: n rows, of which the first *n_live (int64 in
// device memory) are live.
SAGE2_EXPORT int sage2_join_count_fixed(const void* keys, const void* rows,
                                        int64_t n, const void* n_live, int R,
                                        int g, void* counts, void* ebase,
                                        void* stream) {
  join_count_kernel<<<sage2_blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int32_t*>(rows),
      n, static_cast<const int64_t*>(n_live), R, g,
      static_cast<int32_t*>(counts), static_cast<int32_t*>(ebase));
  return static_cast<int>(cudaGetLastError());
}

// ent_payload, qry_payload: (rows, W2) int32 payload words, a row's at
// PayloadMap::row (in core: one payload indexed by row id, bases 0,
// strides R, qry_off 0; meshed: `perm` (n,) int64, the payload row of
// each sorted row in qry_payload, else NULL); starts: (n,) int64 first
// slot of each query;
// ok/cand_*: (min(total, slot_limit),) outputs; contained: (reads,)
// uint8 marks, or NULL.
SAGE2_EXPORT int sage2_join_write(const void* rows, const void* ent_payload,
                                  int64_t ent_base, int ent_stride,
                                  const void* qry_payload, int64_t qry_base,
                                  int qry_stride, int qry_off, int W2,
                                  int64_t n, const void* counts,
                                  const void* ebase, const void* starts,
                                  int R, int g, int trim, int min_overlap,
                                  int64_t slot_limit, void* ok, void* cand_a,
                                  void* cand_b, void* cand_ovl,
                                  void* contained, const void* perm,
                                  void* stream) {
  const PayloadMap pm{static_cast<const uint32_t*>(ent_payload), ent_base,
                      ent_stride, static_cast<const uint32_t*>(qry_payload),
                      qry_base, qry_stride, qry_off, W2,
                      static_cast<const int64_t*>(perm)};
  join_write_kernel<<<sage2_blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), pm, n,
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(ebase),
      static_cast<const int64_t*>(starts), R, g, trim, min_overlap,
      slot_limit, nullptr, static_cast<bool*>(ok),
      static_cast<int32_t*>(cand_a), static_cast<int32_t*>(cand_b),
      static_cast<int32_t*>(cand_ovl), static_cast<uint8_t*>(contained));
  return static_cast<int>(cudaGetLastError());
}

// The fixed-capacity mode of the in-core join (one payload at the row
// ids, no containment marks): total (int64 in device memory, the last
// offset) candidates, of which the first min(total, capacity) slots are
// written; the slots behind them up to capacity are not ok, with a, b
// and ovl 0.
SAGE2_EXPORT int sage2_join_write_fixed(const void* rows, const void* payload,
                                        int W2, int64_t n, const void* counts,
                                        const void* ebase, const void* starts,
                                        const void* total, int R, int g,
                                        int trim, int min_overlap,
                                        int64_t capacity, void* ok,
                                        void* cand_a, void* cand_b,
                                        void* cand_ovl, void* stream) {
  const PayloadMap pm{static_cast<const uint32_t*>(payload), 0, R,
                      static_cast<const uint32_t*>(payload), 0, R, 0, W2,
                      nullptr};
  const int64_t grid = n > capacity ? n : capacity;
  join_write_kernel<<<sage2_blocks(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), pm, n,
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(ebase),
      static_cast<const int64_t*>(starts), R, g, trim, min_overlap, capacity,
      static_cast<const int64_t*>(total), static_cast<bool*>(ok),
      static_cast<int32_t*>(cand_a), static_cast<int32_t*>(cand_b),
      static_cast<int32_t*>(cand_ovl), nullptr);
  return static_cast<int>(cudaGetLastError());
}
