// K20: the routed gather of the device mesh: the request dedup, the
// owner's row gather, and the answers' way back to the asker.
//
// Replaces sage2_tpu/parallel/sharded.py _route_back (:120),
// _route_back_rows (:564) and _dedup_routed_gather (:575), which run at
// every lookup of the meshed correction and at every pointer-doubling
// step of the meshed unitig labeling. On the TPU the answers came back as
// a padded (n, cap, K) all_to_all and were gathered at [dest, rank]; the
// dedup was a cummax scan of run heads and a scatter to input order.
// Here (K19 moves only the accepted rows, so the answers an asker gets
// back lie exactly as its send buffer did):
//
//   heads   over the requests sorted by torch.sort (invalid ones
//           INT32_MAX at the end), one thread a sorted request: a run
//           head keeps its key in `uniq` (INT32_MAX elsewhere), and every
//           request's input position gets the position of its run's head
//           (`pos_of_orig`, by binary search for the run's first key:
//           the reference's cummax of head positions).
//   gather  at the owner, one thread a received request: row j holds
//           t[idx_j // n] (clipped to the shard) of one or two
//           cyclically partitioned int32 tables.
//   back    at the asker, one thread an input: the answer row of input p
//           (= pos[i], or i) is back[offsets[dest[p]] + rank[p]] where it
//           was sent, else 0; 0 where valid[i] is false.
//
// Bound: bytes: each array read once and each output written once
// (the heads' binary searches stay in the cache lines of their run).

#include "common.cuh"

namespace {

constexpr int32_t kI32Max = 0x7fffffff;

__device__ __forceinline__ int64_t lower_bound32(const int32_t* a, int64_t n,
                                                 int32_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void dedup_heads_kernel(const int32_t* __restrict__ s_key,
                                   const int64_t* __restrict__ s_ord,
                                   int64_t Q, int32_t* __restrict__ uniq,
                                   int32_t* __restrict__ pos_of_orig) {
  SAGE2_GRID_STRIDE(j, Q) {
    const int32_t key = s_key[j];
    const bool head = key != kI32Max && (j == 0 || s_key[j - 1] != key);
    uniq[j] = head ? key : kI32Max;
    int64_t head_pos;
    if (key != kI32Max) {
      head_pos = lower_bound32(s_key, j + 1, key);
    } else {      // the cummax over heads: the last valid run's head
      const int64_t first_max = lower_bound32(s_key, j + 1, kI32Max);
      head_pos = first_max == 0
                     ? 0 : lower_bound32(s_key, first_max,
                                         s_key[first_max - 1]);
    }
    pos_of_orig[s_ord[j]] = static_cast<int32_t>(head_pos);
  }
}

__global__ void gather_rows_kernel(const int32_t* __restrict__ t0,
                                   const int32_t* __restrict__ t1,
                                   int64_t v_d,
                                   const int32_t* __restrict__ idx,
                                   int64_t R, int n,
                                   int32_t* __restrict__ out) {
  const int K = t1 == nullptr ? 1 : 2;
  SAGE2_GRID_STRIDE(j, R) {
    int64_t slot = idx[j] / n;
    slot = slot < 0 ? 0 : (slot >= v_d ? v_d - 1 : slot);
    out[j * K] = v_d > 0 ? t0[slot] : 0;
    if (K == 2) out[j * K + 1] = v_d > 0 ? t1[slot] : 0;
  }
}

__global__ void route_back_kernel(const int32_t* __restrict__ back, int K,
                                  const int32_t* __restrict__ dest,
                                  const int32_t* __restrict__ rank,
                                  const bool* __restrict__ sent_ok,
                                  const int64_t* __restrict__ offsets,
                                  const int32_t* __restrict__ pos,
                                  const bool* __restrict__ valid, int64_t Q,
                                  int32_t* __restrict__ out) {
  SAGE2_GRID_STRIDE(i, Q) {
    const int64_t p = pos == nullptr ? i : pos[i];
    const bool take = (valid == nullptr || valid[i]) && sent_ok[p];
    const int32_t* from =
        take ? back + (offsets[dest[p]] + rank[p]) * K : nullptr;
    for (int c = 0; c < K; ++c) out[i * K + c] = take ? from[c] : 0;
  }
}

}  // namespace

// s_key: (Q,) int32 sorted requests; s_ord: (Q,) int64 their input
// positions; uniq, pos_of_orig: (Q,) int32 outputs.
SAGE2_EXPORT int sage2_dedup_heads(const void* s_key, const void* s_ord,
                                   int64_t Q, void* uniq, void* pos_of_orig,
                                   void* stream) {
  dedup_heads_kernel<<<sage2_blocks(Q), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s_key), static_cast<const int64_t*>(s_ord),
      Q, static_cast<int32_t*>(uniq), static_cast<int32_t*>(pos_of_orig));
  return static_cast<int>(cudaGetLastError());
}

// t0, t1: (v_d,) int32 tables (t1 may be NULL); idx: (R,) int32 vertex
// ids; out: (R, 1 or 2) int32.
SAGE2_EXPORT int sage2_gather_rows(const void* t0, const void* t1,
                                   int64_t v_d, const void* idx, int64_t R,
                                   int n, void* out, void* stream) {
  gather_rows_kernel<<<sage2_blocks(R), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(t0), static_cast<const int32_t*>(t1), v_d,
      static_cast<const int32_t*>(idx), R, n, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// back: (A, K) int32 answers laid out as the asker's send buffer;
// dest, rank: (Q0,) int32, sent_ok: (Q0,) bool and offsets: (n,) int64
// of its K19 route; pos: (Q,) int32 indices into the routed inputs, or
// NULL (Q = Q0); valid: (Q,) bool or NULL; out: (Q, K) int32.
SAGE2_EXPORT int sage2_route_back(const void* back, int K, const void* dest,
                                  const void* rank, const void* sent_ok,
                                  const void* offsets, const void* pos,
                                  const void* valid, int64_t Q, void* out,
                                  void* stream) {
  route_back_kernel<<<sage2_blocks(Q), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(back), K,
      static_cast<const int32_t*>(dest), static_cast<const int32_t*>(rank),
      static_cast<const bool*>(sent_ok),
      static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(pos), static_cast<const bool*>(valid), Q,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
