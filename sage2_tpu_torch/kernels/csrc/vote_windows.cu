// K5: one round of the covering-window voting corrector.
//
// Replaces sage2_tpu/kmer/correct.py voting_round (:134), jitted as
// _correct_voting_impl (:190, :215). On the TPU that round materialised,
// for each of the k window positions, the (4, N, P) variant keys and
// looked them up in one combined sort, then added the solid verdicts into
// a (4, N, L) vote array by shifted slice-adds. Here one thread block
// owns one read at a time and keeps everything of that read on chip:
//
//   1. the read's codes go to shared memory; each window's forward and
//      reverse-complement keys are built from them (K1's arithmetic), and
//      the window's own canonical key is looked up once;
//   2. one thread per (window w, position j) builds the canonical keys of
//      the three variants with another base at j (an O(1) edit of both
//      keys: position j of the forward key, position k-1-j of the RC key
//      with complemented codes), binary-searches the table for each, and
//      adds the solid verdicts (count >= threshold) to votes[w + j][b] in
//      shared memory with integer atomics (exact, so deterministic). The
//      variant b == current base is the window's own key: its verdict
//      from step 1 is added instead of a fourth search;
//   3. each base applies the replace rule: replace iff the maximum vote
//      beats the current base's vote and is attained by one base only;
//      the replacement is the argmax (the lowest base among ties, which
//      the rule excludes anyway).
//
// Ragged reads (a length per read): a window that runs past the read's
// end (w >= len - k + 1) casts no vote, and a base at or past the end is
// never replaced (the reference's :152-153 and :185-186). Without
// lengths every read is L long.
//
// The table may be pruned to its solid entries (prune_table_for_
// correction): a sub-threshold entry and an absent key give the same
// verdict, so the result does not change.
//
// Bound: operations. A read of length L costs (3k + 1)(L - k + 1) binary
// searches of ~log2(T) dependent loads each (the upper levels of the
// table stay in L2); the reads and the result are 8 bytes a base. No
// (N, P) key array and no (4, N, L) vote array goes to device memory.

#include "common.cuh"

__device__ __forceinline__ int32_t table_count(const int64_t* __restrict__ t,
                                               const int32_t* __restrict__ c,
                                               int64_t T, int64_t key) {
  int64_t lo = 0, hi = T;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (t[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return (lo < T && t[lo] == key) ? c[lo] : 0;
}

__global__ void vote_windows_kernel(const int32_t* __restrict__ reads,
                                    const int32_t* __restrict__ lengths,
                                    int64_t n_reads, int L, int k,
                                    const int64_t* __restrict__ table,
                                    const int32_t* __restrict__ counts,
                                    int64_t T, int threshold,
                                    int32_t* __restrict__ out) {
  extern __shared__ int64_t smem[];
  const int P = L - k + 1;
  int64_t* s_fwd = smem;                                       // P
  int64_t* s_rc = s_fwd + P;                                   // P
  int32_t* s_votes = reinterpret_cast<int32_t*>(s_rc + P);     // 4 L
  int32_t* s_base = s_votes + 4 * L;                           // L
  int32_t* s_solid = s_base + L;                               // P

  for (int64_t r = blockIdx.x; r < n_reads; r += gridDim.x) {
    const int32_t* read = reads + r * L;
    const int len = lengths == nullptr ? L : lengths[r];
    const int P_r = len - k + 1;  // windows inside the read (may be <= 0)
    for (int p = threadIdx.x; p < L; p += blockDim.x) {
      s_base[p] = read[p];
      s_votes[4 * p] = s_votes[4 * p + 1] = 0;
      s_votes[4 * p + 2] = s_votes[4 * p + 3] = 0;
    }
    __syncthreads();
    for (int w = threadIdx.x; w < P; w += blockDim.x) {
      uint64_t f = 0, c = 0;
      for (int j = 0; j < k; ++j) {
        const uint64_t b = static_cast<uint64_t>(s_base[w + j]);
        f = f * 4 + b;
        c += (3 - b) << (2 * j);
      }
      const int64_t fs = static_cast<int64_t>(f);
      const int64_t cs = static_cast<int64_t>(c);
      s_fwd[w] = fs;
      s_rc[w] = cs;
      s_solid[w] = table_count(table, counts, T, cs < fs ? cs : fs) >=
                   threshold;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < P * k; i += blockDim.x) {
      const int w = i / k;
      const int j = i - w * k;
      if (w >= P_r) continue;  // past the read's end: no vote
      const int64_t cur = s_base[w + j];
      const int sf = 2 * (k - 1 - j);   // position j of the forward key
      const int sr = 2 * j;             // position k-1-j of the RC key
      const int64_t f0 = s_fwd[w] & ~(int64_t{3} << sf);
      const int64_t r0 = s_rc[w] & ~(int64_t{3} << sr);
      int32_t* votes = s_votes + 4 * (w + j);
      for (int b = 0; b < 4; ++b) {
        int solid;
        if (b == cur) {
          solid = s_solid[w];
        } else {
          const int64_t vf = f0 | (int64_t{b} << sf);
          const int64_t vr = r0 | (int64_t{3 - b} << sr);
          solid = table_count(table, counts, T, vr < vf ? vr : vf) >=
                  threshold;
        }
        if (solid) atomicAdd(votes + b, 1);
      }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < L; p += blockDim.x) {
      const int32_t* v = s_votes + 4 * p;
      const int32_t cur = s_base[p];
      int32_t m = v[0];
      int best = 0;
      for (int b = 1; b < 4; ++b) {
        if (v[b] > m) {
          m = v[b];
          best = b;
        }
      }
      int n_at_max = 0;
      for (int b = 0; b < 4; ++b) n_at_max += v[b] == m;
      out[r * L + p] = (m > v[cur] && n_at_max == 1 && p < len) ? best : cur;
    }
    __syncthreads();
  }
}

// Dynamic shared memory of one block for reads of length L (the wrapper
// repeats this sum to refuse reads too long for one block).
static int64_t vote_windows_smem(int L, int k) {
  const int64_t P = L - k + 1;
  return 20 * P + 20 * int64_t{L};
}

// reads, out: (n_reads, L) int32 codes 0-3; lengths: (n_reads,) int32 or
// NULL; table: (T,) sorted unique int64 canonical keys (1 < k <= 31);
// counts: (T,) int32.
SAGE2_EXPORT int sage2_vote_windows(const void* reads, const void* lengths,
                                    int64_t n_reads, int L,
                                    int k, const void* table,
                                    const void* counts, int64_t T,
                                    int threshold, void* out, void* stream) {
  const int64_t smem = vote_windows_smem(L, k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vote_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t grid = n_reads < (int64_t{1} << 20) ? n_reads
                                                    : (int64_t{1} << 20);
  vote_windows_kernel<<<static_cast<int>(grid), kThreads,
                        static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(reads),
      static_cast<const int32_t*>(lengths), n_reads, L, k,
      static_cast<const int64_t*>(table), static_cast<const int32_t*>(counts),
      T, threshold, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
