// K10: the query side of the streamed overlap join, one read chunk
// against one seed table: probe, candidate expansion, slab decode and the
// exact suffix-prefix verify.
//
// Replaces sage2_tpu/stream.py:240-270 (and :402-428 for entry blocks):
// detect.seed_keys_from_words0 at positions g (j + 1)
// (overlap/detect.py:258), detect.probe_seed_table (:476),
// ops/sort.py expand_with_payload (:143: a scatter-max and a cummax over
// the whole candidate capacity), the slab row gather, the cand_b / cand_p0
// decode and validity, and detect.verify_candidates_words0 (:287, a
// static select loop over word offsets on (capacity, W) arrays). Here:
//
//   count pass  one thread per (read, probe position j): the probe seed
//               word at g (j + 1) from the read's unshifted words, its
//               bucket's [start, count] from the table (count 0 for an
//               invalid read).
//   scan        an inclusive prefix sum of the counts (torch.cumsum in
//               the wrapper); the host reads the total once, for the
//               reference's fail-fast rule total > capacity.
//   write pass  one thread per candidate slot: a binary search of the
//               prefix sum finds the slot's probe and its rank in the
//               bucket; the slab row at start + rank gives the entry
//               (read b, offset o) and b's words; the overlap start is
//               p0 = g (j + 1) - o; a[p0:] == b[:L - p0] is checked word
//               by word with a's words shifted in registers. The thread
//               writes (ok, a, b, L - p0) at its slot: the reference's
//               slot order (probes in row-major (read, position) order,
//               rank within a probe), so the arrays compare slot for slot.
//
// Bound: bytes. The count pass reads each read's words and one table row
// per probe; the write pass reads one slab row ((1 + W) * 4 bytes) and
// one words row of a per candidate, and writes 13 bytes; the search of
// the prefix sum stays in L2 for a chunk.

#include "common.cuh"

__global__ void probe_count_kernel(const int64_t* __restrict__ words0,
                                   const bool* __restrict__ valid,
                                   int64_t m, int W, int s, int g, int n_pos,
                                   int B, const int32_t* __restrict__ table,
                                   int32_t* __restrict__ lo_idx,
                                   int32_t* __restrict__ counts) {
  const uint32_t mask = s < 16 ? (0xFFFFFFFFu << (32 - 2 * s)) : 0xFFFFFFFFu;
  SAGE2_GRID_STRIDE(q, m * n_pos) {
    const int64_t r = q / n_pos;
    const int j = static_cast<int>(q - r * n_pos);
    const uint32_t hi = word_at(words0 + r * W, W, g * (j + 1)) & mask;
    const int64_t b = hi >> (32 - B);
    lo_idx[q] = table[2 * b];
    counts[q] = valid[r] ? table[2 * b + 1] : 0;
  }
}

__global__ void probe_write_kernel(
    const int64_t* __restrict__ words0, int64_t m, int W, int g, int n_pos,
    int pa, int L, int64_t base, const int32_t* __restrict__ slab,
    const int32_t* __restrict__ lo_idx, const int32_t* __restrict__ counts,
    const int64_t* __restrict__ offsets, int64_t n_out,
    bool* __restrict__ ok, int32_t* __restrict__ cand_a,
    int32_t* __restrict__ cand_b, int32_t* __restrict__ cand_ovl) {
  const int64_t Q = m * n_pos;
  SAGE2_GRID_STRIDE(t, n_out) {
    // the probe holding slot t: the first q with offsets[q] > t
    int64_t lo = 0, hi = Q;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (offsets[mid] > t) hi = mid; else lo = mid + 1;
    }
    const int64_t q = lo;
    const int64_t rank = t - (offsets[q] - counts[q]);
    const int64_t a_local = q / n_pos;
    const int cand_p = (static_cast<int>(q - a_local * n_pos) + 1) * g;
    const int32_t* row = slab + (static_cast<int64_t>(lo_idx[q]) + rank) *
                                    (W + 1);
    const int32_t e_b = row[0];
    const int32_t b = e_b / g;
    const int p0 = cand_p - (e_b - b * g);
    const int32_t a = static_cast<int32_t>(base + a_local);
    bool match = a != b && p0 <= pa;
    const int p = p0 < 1 ? 1 : (p0 > pa ? pa : p0);
    // a's bases from p on, 16 a word, against b's words
    const int64_t* aw = words0 + a_local * W;
    const int w0 = p >> 4, r2 = 2 * (p & 15);
    uint32_t cur = w0 < W ? static_cast<uint32_t>(aw[w0]) : 0u;
    for (int u = 0; u < W && match; ++u) {
      const uint32_t nxt =
          w0 + u + 1 < W ? static_cast<uint32_t>(aw[w0 + u + 1]) : 0u;
      const uint32_t al = r2 ? (cur << r2) | (nxt >> (32 - r2)) : cur;
      int vb = 2 * (L - p) - 32 * u;
      vb = vb < 0 ? 0 : (vb > 32 ? 32 : vb);
      if (vb > 0 && ((al ^ static_cast<uint32_t>(row[u + 1])) >> (32 - vb)))
        match = false;
      cur = nxt;
    }
    ok[t] = match;
    cand_a[t] = a;
    cand_b[t] = b;
    cand_ovl[t] = L - p;
  }
}

// words0: (m, W) int64 words of the chunk's reads; valid: (m,) bool;
// table: (2^B, 2) int32; lo_idx, counts: (m * n_pos,) int32 outputs.
SAGE2_EXPORT int sage2_probe_count(const void* words0, const void* valid,
                                   int64_t m, int W, int s, int g, int n_pos,
                                   int B, const void* table, void* lo_idx,
                                   void* counts, void* stream) {
  probe_count_kernel<<<sage2_blocks(m * n_pos), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(words0), static_cast<const bool*>(valid), m,
      W, s, g, n_pos, B, static_cast<const int32_t*>(table),
      static_cast<int32_t*>(lo_idx), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// slab: (T, W + 1) int32; offsets: (m * n_pos,) int64 inclusive prefix
// sum of counts; ok, cand_a, cand_b, cand_ovl: (n_out,) outputs.
SAGE2_EXPORT int sage2_probe_write(const void* words0, int64_t m, int W,
                                   int g, int n_pos, int pa, int L,
                                   int64_t base, const void* slab,
                                   const void* lo_idx, const void* counts,
                                   const void* offsets, int64_t n_out,
                                   void* ok, void* cand_a, void* cand_b,
                                   void* cand_ovl, void* stream) {
  probe_write_kernel<<<sage2_blocks(n_out), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(words0), m, W, g, n_pos, pa, L, base,
      static_cast<const int32_t*>(slab), static_cast<const int32_t*>(lo_idx),
      static_cast<const int32_t*>(counts),
      static_cast<const int64_t*>(offsets), n_out, static_cast<bool*>(ok),
      static_cast<int32_t*>(cand_a), static_cast<int32_t*>(cand_b),
      static_cast<int32_t*>(cand_ovl));
  return static_cast<int>(cudaGetLastError());
}
