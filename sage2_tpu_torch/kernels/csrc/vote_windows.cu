// K5: one round of the covering-window voting corrector.
//
// Replaces sage2_tpu/kmer/correct.py voting_round (:134), jitted as
// _correct_voting_impl (:190, :215). On the TPU that round materialised,
// for each of the k window positions, the (4, N, P) variant keys and
// looked them up in one combined sort, then added the solid verdicts into
// a (4, N, L) vote array by shifted slice-adds.
//
// What bounds it here is lookups in the count table: a read of length L
// has P = L - k + 1 windows, and the rule asks for 3 variant keys at each
// of the k positions of each window, (3k + 1) P lookups in all (5,776 a
// 100 bp read at k = 25), each a random place in a table of ~5.1 M keys
// at the E. coli scale. Two things cut that:
//
//   * the skip (exact): a base p is replaced only if some base b gets more
//     votes than its current base, and its current base's vote is the
//     number of valid covering windows whose own k-mer is solid, while no
//     base can get more votes than there are valid covering windows. So a
//     base all of whose valid covering windows are solid keeps its base,
//     and its variant lookups need not be made. Only the (window w,
//     position j) pairs whose base w + j has a weak valid covering window
//     are looked up: at 0.5% error most reads have none;
//   * K2's bucket directory (bucket_search.cuh): a lookup is a directory
//     pair and a search inside one bucket, 2-3 dependent sectors, in place
//     of a ~23-step binary search of the whole table. The directory and
//     the packed entries (~49 MB at 5.1 M keys) are the hot set of L2; the
//     reads stream past it (evict-first loads and stores).
//
// Two launches: the directory (bucket_directory_launch), then the vote.
// One warp owns one read at a time and keeps everything of it in shared
// memory, with __syncwarp between its steps:
//
//   1. the codes come in and the votes go to 0;
//   2. each lane owns a run of consecutive windows: it builds the first
//      window's forward and reverse-complement keys (K1's arithmetic) and
//      rolls them along the run, and looks up each window's canonical key
//      (four at a time); a warp scan turns the solid verdicts into a
//      prefix count over the windows, solid[w] = solid valid windows
//      before w;
//   3. for each base p, from that prefix: its valid covering windows
//      [max(0, p - k + 1), min(p, P_r - 1)] and how many are solid; a base
//      with a weak one is marked, and gets one (w, j) pair for each of
//      its valid covering windows. A warp scan over the bases gives each
//      marked base its first pair;
//   4. the lanes take the pairs in order, two at a time (six lookups in
//      flight): a pair's base is found by a search of the bases' first
//      pairs in shared memory, its three variant keys (another base at j:
//      position j of the forward key, k - 1 - j of the RC key with
//      complemented codes) are looked up, and each solid verdict adds one
//      to the base's vote for b, four 8-bit counters in one int32 (at most
//      k <= 31 windows vote), by a shared-memory atomic (exact);
//   5. each marked base applies the replace rule: replace iff the maximum
//      vote beats the current base's vote (its solid covering windows)
//      and is attained by one base only; the replacement is the argmax.
//      Every other base keeps its code.
//
// Ragged reads (a length per read): a window that runs past the read's
// end (w >= P_r = len - k + 1) casts no vote and a base at or past the end
// is never replaced (the reference's :152-153 and :185-186): such a base
// has no valid covering window, so it is never marked. Without lengths
// every read is L long.
//
// The table may be pruned to its solid entries (prune_table_for_
// correction): a sub-threshold entry and an absent key give the same
// verdict, so the result does not change. An empty table (T = 0) makes
// every window weak for threshold > 0, in the same code.
//
// Shared memory of one read (vote_windows_smem, repeated by the wrapper):
// the int64 forward and RC keys (16 P), the window prefix (4 (P + 1)),
// the bases' first pairs (4 (L + 1)), the votes (4 L) and the codes (L),
// rounded up to 8 bytes: 3.7 KB at L = 150, k = 25. A block holds up to
// eight reads (warps), fewer where eight do not fit its shared memory.
//
// Bound: lookups, that is random sectors of L2; the reads and the result
// are 8 bytes a base. No (N, P) key array and no (4, N, L) vote array
// goes to device memory.
//
// The routed mode (the meshed voting rule, sage2_tpu/parallel/
// sharded.py:306-320): the counts come from the k-mer owners, not from a
// table on this card, so the lookups leave K5 and the round becomes k
// vote launches and one apply launch, with K22 building each position's
// variant keys and the routed lookup (K19, K2, K20) between them:
//
//   vote_add    window position j: a warp a read (its valid window count
//               lengths[r] - (k - 1), or P, loaded once), a lane its
//               windows w = lane, lane + 32, ...: the read and window
//               come from the warp's and lane's 32-bit coordinates, not
//               from a division of a flat (read, window) index (64-bit
//               division is a software routine of tens of instructions
//               on the card). A lane loads up to 4 windows' counts (16
//               bytes each, coalesced, evict-first) before it writes,
//               and adds each window's 4 solid verdicts, one byte each,
//               to the packed votes of base w + j (four uint8 counters
//               in one 32-bit word; at most k <= 31 windows vote, so no
//               byte carries). For a fixed j each (read, window) owns its
//               base: no atomics. A window past its read's end reads no
//               counts and adds nothing.
//   vote_apply  one thread a base: the replace rule of step 5 on its
//               votes. A base at or past a ragged read's end has no valid
//               covering window, so vote_add left its votes 0 and it
//               keeps its code with no mask.
//
// Bound: bytes. vote_add reads 16 bytes of counts a valid window and
// reads and writes 4 bytes of votes (24 bytes: 0.357 ms for the ~49.8 M
// valid windows of a 13b shard's call at 3.35 TB/s); vote_apply reads the
// base and its votes and writes the base.

#include "bucket_search.cuh"
#include "common.cuh"

constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kOwnBatch = 4;     // own-window lookups a lane steps together
constexpr int kPairBatch = 2;    // (w, j) pairs a lane steps together
// Blocks an SM must hold at once: caps the registers at 64 (128 without),
// so that 32 reads an SM keep their lookups in flight; that is worth a
// small stack frame.
constexpr int kMinBlocks = 4;

constexpr int64_t kMaxSmem = 232448;   // a block's dynamic shared memory

// Bytes of shared memory of one read, a multiple of 8 (the wrapper
// repeats this sum to refuse reads too long for one warp's share).
static int64_t vote_windows_smem(int L, int k) {
  const int64_t P = L - k + 1;
  const int64_t bytes = 16 * P + 4 * (P + 1) + 4 * (int64_t{L} + 1) +
                        4 * int64_t{L} + L;
  return (bytes + 7) / 8 * 8;
}

// Inclusive warp scan of x.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Solid verdicts (count >= threshold, 0 where absent) of C keys.
template <int C, typename Keys>
__device__ __forceinline__ void solid_verdicts(
    const Keys& keys, const int32_t* __restrict__ dir, const BucketSpan& span,
    const int64_t (&q)[C], const bool (&live)[C], int threshold,
    bool (&solid)[C]) {
  int32_t pos[C];
  bucket_find<C>(keys, dir, span, q, live, pos);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    solid[c] = (pos[c] >= 0 ? keys.count(pos[c]) : 0) >= threshold;
  }
}

// The valid covering windows [lo, hi] of base p (empty where hi < lo).
__device__ __forceinline__ void covering(int p, int k, int Pv, int& lo,
                                         int& hi) {
  lo = p - k + 1 > 0 ? p - k + 1 : 0;
  hi = p < Pv - 1 ? p : Pv - 1;
}

template <typename Keys>
__device__ __forceinline__ void vote_reads(
    const Keys& keys, const int32_t* __restrict__ dir, const BucketSpan& span,
    const int32_t* __restrict__ reads, const int32_t* __restrict__ lengths,
    int64_t n_reads, int L, int k, int threshold, int64_t smem_words,
    int32_t* __restrict__ out) {
  extern __shared__ int64_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int P = L - k + 1;
  int64_t* s_fwd = smem + warp * smem_words;                  // P
  int64_t* s_rc = s_fwd + P;                                  // P
  int32_t* s_solid = reinterpret_cast<int32_t*>(s_rc + P);    // P + 1
  int32_t* s_pair = s_solid + P + 1;                          // L + 1
  int32_t* s_votes = s_pair + L + 1;                          // L
  uint8_t* s_code = reinterpret_cast<uint8_t*>(s_votes + L);  // L
  const uint64_t mask = (uint64_t{1} << (2 * k)) - 1;
  const int top = 2 * (k - 1);
  const int run = (P + 31) / 32;        // windows a lane owns

  for (int64_t r = static_cast<int64_t>(blockIdx.x) * warps + warp;
       r < n_reads; r += static_cast<int64_t>(gridDim.x) * warps) {
    const int32_t* read = reads + r * L;
    const int len = lengths == nullptr ? L : __ldg(lengths + r);
    const int Pv = len - k + 1 < P ? (len - k + 1 > 0 ? len - k + 1 : 0) : P;
    // 1. codes in, votes to 0
    for (int p = lane; p < L; p += 32) {
      s_code[p] = static_cast<uint8_t>(__ldcs(read + p));
      s_votes[p] = 0;
    }
    __syncwarp();

    // 2. own windows [w0, w1) of this lane: keys, verdicts, prefix
    const int w0 = lane * run < Pv ? lane * run : Pv;
    const int w1 = w0 + run < Pv ? w0 + run : Pv;
    uint64_t f = 0, c = 0;
    if (w0 < w1) {
      for (int j = 0; j < k; ++j) {
        const uint64_t b = s_code[w0 + j];
        f = (f << 2) | b;
        c |= (3 - b) << (2 * j);
      }
    }
    int n_solid = 0;
    for (int wb = w0; wb < w1; wb += kOwnBatch) {
      int64_t q[kOwnBatch];
      bool live[kOwnBatch], solid[kOwnBatch];
#pragma unroll
      for (int t = 0; t < kOwnBatch; ++t) {
        const int w = wb + t;
        live[t] = w < w1;
        q[t] = 0;
        if (live[t]) {
          if (w > w0) {
            const uint64_t b = s_code[w + k - 1];
            f = ((f << 2) & mask) | b;
            c = (c >> 2) | ((3 - b) << top);
          }
          s_fwd[w] = static_cast<int64_t>(f);
          s_rc[w] = static_cast<int64_t>(c);
          q[t] = static_cast<int64_t>(c < f ? c : f);
        }
      }
      solid_verdicts<kOwnBatch>(keys, dir, span, q, live, threshold, solid);
#pragma unroll
      for (int t = 0; t < kOwnBatch; ++t) {
        if (live[t]) {
          n_solid += solid[t];
          s_solid[wb + t + 1] = n_solid;     // within the run for now
        }
      }
    }
    const int before = warp_scan(n_solid, lane) - n_solid;
    for (int w = w0; w < w1; ++w) s_solid[w + 1] += before;
    if (lane == 0) s_solid[0] = 0;
    __syncwarp();

    // 3. marked bases and their first pairs
    int carry = 0;
    for (int p0 = 0; p0 < L; p0 += 32) {
      const int p = p0 + lane;
      int n = 0;
      if (p < L) {
        int lo, hi;
        covering(p, k, Pv, lo, hi);
        if (hi >= lo && s_solid[hi + 1] - s_solid[lo] < hi - lo + 1) {
          n = hi - lo + 1;
        }
      }
      const int incl = warp_scan(n, lane);
      if (p < L) s_pair[p] = carry + incl - n;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) s_pair[L] = carry;
    __syncwarp();

    // 4. the variant lookups of the marked bases' pairs
    const int n_pairs = carry;
    for (int i0 = 0; i0 < n_pairs; i0 += 32 * kPairBatch) {
      constexpr int C = 3 * kPairBatch;
      int64_t q[C];
      bool live[C], solid[C];
      int base[kPairBatch], code[kPairBatch];
#pragma unroll
      for (int t = 0; t < kPairBatch; ++t) {
        const int i = i0 + 32 * t + lane;
        const bool on = i < n_pairs;
        base[t] = 0;
        code[t] = 0;
        if (on) {
          int a = 0, b = L - 1;      // the last base whose first pair <= i
          while (a < b) {
            const int mid = (a + b + 1) >> 1;
            if (s_pair[mid] <= i) {
              a = mid;
            } else {
              b = mid - 1;
            }
          }
          const int p = a;
          const int w = (p - k + 1 > 0 ? p - k + 1 : 0) + (i - s_pair[p]);
          const int j = p - w;
          const int cur = s_code[p];
          const int sf = 2 * (k - 1 - j);
          const int sr = 2 * j;
          const int64_t f0 = s_fwd[w] & ~(int64_t{3} << sf);
          const int64_t r0 = s_rc[w] & ~(int64_t{3} << sr);
          base[t] = p;
          code[t] = cur;
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            const int bb = v + (v >= cur);     // the three other bases
            const int64_t vf = f0 | (int64_t{bb} << sf);
            const int64_t vr = r0 | (int64_t{3 - bb} << sr);
            q[3 * t + v] = vr < vf ? vr : vf;
            live[3 * t + v] = true;
          }
        } else {
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            q[3 * t + v] = 0;
            live[3 * t + v] = false;
          }
        }
      }
      solid_verdicts<C>(keys, dir, span, q, live, threshold, solid);
#pragma unroll
      for (int t = 0; t < kPairBatch; ++t) {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          if (live[3 * t + v] && solid[3 * t + v]) {
            const int bb = v + (v >= code[t]);
            atomicAdd(s_votes + base[t], 1 << (8 * bb));
          }
        }
      }
    }
    __syncwarp();

    // 5. the replace rule at the marked bases
    for (int p = lane; p < L; p += 32) {
      const int cur = s_code[p];
      int o = cur;
      if (s_pair[p + 1] > s_pair[p]) {
        int lo, hi;
        covering(p, k, Pv, lo, hi);
        const int vcur = s_solid[hi + 1] - s_solid[lo];
        const int packed = s_votes[p];
        int v[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          v[b] = b == cur ? vcur : (packed >> (8 * b)) & 0xff;
        }
        int m = v[0], best = 0;
#pragma unroll
        for (int b = 1; b < 4; ++b) {
          if (v[b] > m) {
            m = v[b];
            best = b;
          }
        }
        int n_at_max = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) n_at_max += v[b] == m;
        if (m > vcur && n_at_max == 1) o = best;
      }
      __stcs(out + r * L + p, o);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    vote_windows_kernel(const int32_t* __restrict__ reads,
                        const int32_t* __restrict__ lengths, int64_t n_reads,
                        int L, int k, const int64_t* __restrict__ table,
                        const int32_t* __restrict__ counts, int64_t T,
                        const int64_t* __restrict__ scratch, int threshold,
                        int64_t smem_words, int32_t* __restrict__ out) {
  const BucketSpan span = load_span(scratch);
  const int32_t* dir = dir_of(scratch, T);
  if (ldg_key(scratch + 3)) {         // packed (uniform over the grid)
    vote_reads(PackedKeys{packed_of(scratch), suffix_mask(span.shift)}, dir,
               span, reads, lengths, n_reads, L, k, threshold, smem_words,
               out);
  } else {
    vote_reads(Int64Keys{table, counts}, dir, span, reads, lengths, n_reads,
               L, k, threshold, smem_words, out);
  }
}

// The bucket directory over table and counts (bucket_search.cuh): the
// first of K5's two launches.
SAGE2_EXPORT int sage2_vote_directory(const void* table, const void* counts,
                                      int64_t T, int bits, void* scratch,
                                      void* stream) {
  return bucket_directory_launch(table, counts, T, bits, scratch, stream);
}

// reads, out: (n_reads, L) int32 codes 0-3; lengths: (n_reads,) int32 or
// NULL; table: (T,) sorted unique int64 canonical keys (1 < k <= 31), T <
// 2^31; counts: (T,) int32; scratch as sage2_vote_directory left it.
SAGE2_EXPORT int sage2_vote_windows(const void* reads, const void* lengths,
                                    int64_t n_reads, int L, int k,
                                    const void* table, const void* counts,
                                    int64_t T, const void* scratch,
                                    int threshold, void* out, void* stream) {
  const int64_t per = vote_windows_smem(L, k);
  int64_t warps = kMaxSmem / per;
  if (warps > kWarpsPerBlock) warps = kWarpsPerBlock;
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = warps * per;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vote_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int64_t grid = (n_reads + warps - 1) / warps;
  if (grid > (int64_t{1} << 20)) grid = int64_t{1} << 20;
  vote_windows_kernel<<<static_cast<int>(grid),
                        static_cast<int>(warps * 32),
                        static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(reads),
      static_cast<const int32_t*>(lengths), n_reads, L, k,
      static_cast<const int64_t*>(table), static_cast<const int32_t*>(counts),
      T, static_cast<const int64_t*>(scratch), threshold, per / 8,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

namespace {

constexpr int kVoteBatch = 4;    // windows a lane of vote_add loads at once

// A warp a read: its valid window count loaded once, then its windows in
// steps of 32 x kVoteBatch, the batch's counts loaded before any vote is
// written (kVoteBatch independent 16-byte loads a lane in flight).
__global__ void __launch_bounds__(kThreads) vote_add_kernel(
    uint32_t* __restrict__ votes, const int4* __restrict__ counts,
    const int32_t* __restrict__ lengths, int64_t n_reads, int L, int k,
    int j, int threshold) {
  const int lane = threadIdx.x & 31;
  const int P = L - k + 1;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                   (threadIdx.x >> 5);
       r < n_reads; r += static_cast<int64_t>(gridDim.x) * kWarpsPerBlock) {
    int Pv = P;
    if (lengths != nullptr) {
      const int n = __ldg(lengths + r) - (k - 1);
      if (n < Pv) Pv = n;
    }
    const int4* c = counts + r * P;
    uint32_t* out = votes + r * L + j;
    for (int w0 = lane; w0 < Pv; w0 += 32 * kVoteBatch) {
      int4 x[kVoteBatch];
#pragma unroll
      for (int t = 0; t < kVoteBatch; ++t) {
        const int w = w0 + 32 * t;
        x[t] = w < Pv ? __ldcs(c + w) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int t = 0; t < kVoteBatch; ++t) {
        const int w = w0 + 32 * t;
        if (w >= Pv) break;
        const uint32_t add =
            static_cast<uint32_t>(x[t].x >= threshold) |
            static_cast<uint32_t>(x[t].y >= threshold) << 8 |
            static_cast<uint32_t>(x[t].z >= threshold) << 16 |
            static_cast<uint32_t>(x[t].w >= threshold) << 24;
        if (add) out[w] += add;
      }
    }
  }
}

__global__ void vote_apply_kernel(const int32_t* __restrict__ reads,
                                  const uint32_t* __restrict__ votes,
                                  int64_t n, int32_t* __restrict__ out) {
  SAGE2_GRID_STRIDE(i, n) {
    const int32_t cur = reads[i];
    const uint32_t packed = votes[i];
    int v[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) v[b] = (packed >> (8 * b)) & 0xff;
    int m = v[0], best = 0;
#pragma unroll
    for (int b = 1; b < 4; ++b) {
      if (v[b] > m) {
        m = v[b];
        best = b;
      }
    }
    int n_at_max = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) n_at_max += v[b] == m;
    out[i] = m > v[cur] && n_at_max == 1 ? best : cur;
  }
}

}  // namespace

// The routed mode's vote at window position j: votes (n_reads, L, 4)
// uint8, updated in place; counts (n_reads, L - k + 1, 4) int32, the
// owners' counts of the variant keys of base j of every window; lengths
// (n_reads,) int32 or NULL.
SAGE2_EXPORT int sage2_vote_add(void* votes, const void* counts,
                                const void* lengths, int64_t n_reads, int L,
                                int k, int j, int threshold, void* stream) {
  int64_t grid = (n_reads + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (grid > (int64_t{1} << 20)) grid = int64_t{1} << 20;
  if (grid < 1) grid = 1;
  vote_add_kernel<<<static_cast<int>(grid), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(votes), static_cast<const int4*>(counts),
      static_cast<const int32_t*>(lengths), n_reads, L, k, j, threshold);
  return static_cast<int>(cudaGetLastError());
}

// The routed mode's replace rule: reads, out (n_reads, L) int32; votes
// (n_reads, L, 4) uint8.
SAGE2_EXPORT int sage2_vote_apply(const void* reads, const void* votes,
                                  int64_t n_reads, int L, void* out,
                                  void* stream) {
  vote_apply_kernel<<<sage2_blocks(n_reads * L), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(reads), static_cast<const uint32_t*>(votes),
      n_reads * L, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
