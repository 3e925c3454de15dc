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
//           INT32_MAX at the end), a block a tile of kHeadTile
//           consecutive requests, four a thread by 16-byte loads: a
//           request is a run head where its key differs from the one
//           before it (-1 before the first, as the reference's) and is
//           not INT32_MAX; a head keeps its key in `uniq` (INT32_MAX
//           elsewhere); every request's input position gets the position
//           of the last head at or before it, 0 where there is none
//           (`pos_of_orig`: the reference's cummax of head positions), by
//           a block max-scan of the heads' positions from the head of the
//           run that enters the tile, which one warp finds in the 32 keys
//           before the tile, or by a 32-way search of the keys before
//           them where the run is longer (the run before it too where the
//           tile starts in the INT32_MAX tail).
//   gather  at the owner, one thread a received request: row j holds
//           t[idx_j // n] (clipped to the shard) of one or two
//           cyclically partitioned int32 tables.
//   back    at the asker, one thread an input: the answer row of input p
//           (= pos[i], or i) is back[offsets[dest[p]] + rank[p]] where it
//           was sent, else 0; 0 where valid[i] is false.
//
// Bound: bytes: each array read once and each output written once. The
// heads' scatter to input order is a 4-byte store a request in a random
// 32-byte sector, and the sectors set its floor: with the input positions
// in order the same launch takes about half the time
// (scripts/probe_prune_heads_ab.py).

#include "scan.cuh"

namespace {

constexpr int32_t kI32Max = 0x7fffffff;

constexpr int kHeadTile = kThreads * 4;    // requests a tile, four a thread

// The first index of the sorted a[lo, hi) whose value is not below v (hi
// where there is none), by one whole warp: each round trip the lanes
// probe 32 evenly spaced keys of the range and keep the stretch between
// the last probe below v and the next.
__device__ int64_t warp_lower_bound(const int32_t* __restrict__ a,
                                    int64_t lo, int64_t hi, int32_t v,
                                    int lane) {
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + lane * step;
    const unsigned below = __ballot_sync(kFullMask, p < hi && a[p] < v);
    const int c = __popc(below);         // the probes below v lead
    if (c == 0) return lo;
    const int64_t next_lo = lo + (c - 1) * step + 1;
    if (step == 1) return next_lo;
    hi = min64(hi, lo + c * step);
    lo = next_lo;
  }
  return lo;
}

// The first index of the run of a[end - 1] in the sorted a[0, end), end
// > 0 (one warp): the 32 keys before end in one round trip, where the run
// is shorter, else the 32-way search of the keys before them.
__device__ int64_t run_start(const int32_t* __restrict__ a, int64_t end,
                             int lane) {
  const int32_t v = a[end - 1];
  const int64_t p = end - 1 - lane;
  const unsigned other = __ballot_sync(kFullMask, p < 0 || a[p] != v);
  if (other) return end - (__ffs(other) - 1);
  return warp_lower_bound(a, 0, end - 32, v, lane);
}

// The position of the last run head before j0 > 0, or 0 (one warp): the
// first key of the run that ends at j0 - 1, or, where that run is the
// INT32_MAX tail, of the run before it (a head, or position 0).
__device__ int64_t head_before(const int32_t* __restrict__ s_key, int64_t j0,
                               int lane) {
  const int64_t start = run_start(s_key, j0, lane);
  if (s_key[j0 - 1] != kI32Max) return start;
  return start == 0 ? 0 : run_start(s_key, start, lane);
}

// vec: s_key, s_ord, uniq 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
    dedup_heads_kernel(const int32_t* __restrict__ s_key,
                       const int64_t* __restrict__ s_ord, int64_t Q,
                       bool vec, int32_t* __restrict__ uniq,
                       int32_t* __restrict__ pos_of_orig) {
  __shared__ int32_t s_last[kThreads + 1];   // [t + 1]: thread t's last key
  __shared__ int64_t s_carry;
  const int64_t j0 = blockIdx.x * static_cast<int64_t>(kHeadTile);
  const int64_t j = j0 + 4 * threadIdx.x;    // this thread's four requests
  int32_t key[4];
  int64_t ord[4];
  if (vec && j + 4 <= Q) {
    const int4 k4 = __ldcs(reinterpret_cast<const int4*>(s_key + j));
    const longlong2* o2 = reinterpret_cast<const longlong2*>(s_ord + j);
    const longlong2 o0 = __ldcs(o2), o1 = __ldcs(o2 + 1);
    key[0] = k4.x; key[1] = k4.y; key[2] = k4.z; key[3] = k4.w;
    ord[0] = o0.x; ord[1] = o0.y; ord[2] = o1.x; ord[3] = o1.y;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool in = j + q < Q;
      key[q] = in ? __ldcs(s_key + j + q) : kI32Max;
      ord[q] = in ? __ldcs(reinterpret_cast<const long long*>(s_ord) + j + q)
                  : 0;
    }
  }
  s_last[threadIdx.x + 1] = key[3];
  if (threadIdx.x == 0) s_last[0] = j0 > 0 ? s_key[j0 - 1] : -1;
  if (threadIdx.x < 32) {
    const int64_t carry =
        j0 > 0 ? head_before(s_key, j0, threadIdx.x) : 0;
    if (threadIdx.x == 0) s_carry = carry;
  }
  __syncthreads();
  // a head's position, -1 elsewhere, max-scanned from the entering run's
  // head; uniq the heads' keys
  int32_t prev = s_last[threadIdx.x];
  int32_t u[4];
  int64_t at[4];
  int64_t mine = -1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool head = key[q] != kI32Max && key[q] != prev;
    prev = key[q];
    u[q] = head ? key[q] : kI32Max;
    if (head) mine = j + q;
    at[q] = mine;
  }
  int64_t all;
  int64_t run = block_exclusive_scan<int64_t>(mine, int64_t{-1}, ScanMax(),
                                              &all);
  run = run < s_carry ? s_carry : run;
  if (vec && j + 4 <= Q) {
    *reinterpret_cast<int4*>(uniq + j) = make_int4(u[0], u[1], u[2], u[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j + q < Q) uniq[j + q] = u[q];
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (j + q < Q) {
      pos_of_orig[ord[q]] = static_cast<int32_t>(at[q] > run ? at[q] : run);
    }
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

// *tile (a host int64): the requests a tile of sage2_dedup_heads.
SAGE2_EXPORT int sage2_heads_tile(void* tile) {
  *static_cast<int64_t*>(tile) = kHeadTile;
  return 0;
}

// s_key: (Q,) int32 sorted requests; s_ord: (Q,) int64 their input
// positions; uniq, pos_of_orig: (Q,) int32 outputs; Q < 2^31.
SAGE2_EXPORT int sage2_dedup_heads(const void* s_key, const void* s_ord,
                                   int64_t Q, void* uniq, void* pos_of_orig,
                                   void* stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(s_key) |
                    reinterpret_cast<uintptr_t>(s_ord) |
                    reinterpret_cast<uintptr_t>(uniq)) % 16 == 0;
  const int64_t tiles = (Q + kHeadTile - 1) / kHeadTile;
  dedup_heads_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s_key), static_cast<const int64_t*>(s_ord),
      Q, vec, static_cast<int32_t*>(uniq),
      static_cast<int32_t*>(pos_of_orig));
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
