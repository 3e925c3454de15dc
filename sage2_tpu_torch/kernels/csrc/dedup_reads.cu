// K12: the dedup of equal canonical reads: their sort keys, the groups of
// equal keys, each group's representative row, its multiplicity and each
// input read's vertex.
//
// Replaces sage2_tpu/overlap/prepare.py prepare_reads (:67), lines 97-133:
// the multi-operand sort of the canonical words (the length first for
// ragged reads), the head flags, the group ids (a cumsum), the
// representatives and multiplicities (scatters), the canonical rows of
// the representatives and vertex_of_read. K8 (canonical_reads.cu) still
// gives each read's words, its reverse complement and the canonical
// choice, and the reverse-complement rows of the unique reads.
//
//   keys     the canonical words of a read (rc_w where take_rc, else
//            fwd_w), led for ragged reads by its length (clamped to
//            [0, L]) in lb = bit_length(L) bits, are one bit string; it
//            is cut into 64-bit keys, top bit flipped so that signed
//            order is unsigned order. The string has 2 L + lb significant
//            bits, so ceil((2 L + lb) / 64) keys order it: 4 at L = 100,
//            5 at L = 150 with or without lengths, where one sort a
//            32-bit word and one for the length took 7 and 11.
//            sage2_dedup_keys builds key c of each row through the
//            current order (composing the previous order with the last
//            sort's permutation), and torch.sort orders it stably: the
//            chain from the last key to the first gives the reference's
//            order, ties by input index.
//   heads    sage2_dedup_heads composes the final order and flags each
//            row whose length or any word differs from the row before it,
//            counting the flags of its tile; sage2_scan_tiles (scan.cuh)
//            turns the counts into offsets and writes n_unique.
//   assign   each row's group id is its tile's offset plus the flags
//            before it; a head writes its position, each read its vertex
//            (group id, plus N where it was flipped).
//   rows     one warp a group: the representative is the row at the
//            group's head; its canonical codes (rc or the read by
//            take_rc, zero past its length), the group's size (the next
//            head minus this one) and its length; zero rows from
//            n_unique on. The (N, L) canonical copy of every read is
//            never made.
//
// Bound: bytes. Each key launch reads a row's canonical words (W int64)
// and writes 16 bytes; torch.sort's radix passes dominate the chain. The
// grouping reads two rows' words a row (the second hits L1 or L2) and
// writes the unique rows; the arithmetic is a few shifts a word.

#include "scan.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kRowWarps = kThreads / kWarp;

struct Canon {
  const int64_t* fwd_w;
  const int64_t* rc_w;
  const bool* take_rc;
  const int32_t* lengths;  // NULL: every read is L long
  int W, L;

  __device__ __forceinline__ uint32_t word(int64_t r, int t) const {
    if (t < 0 || t >= W) return 0u;
    return static_cast<uint32_t>((take_rc[r] ? rc_w : fwd_w)[r * W + t]);
  }
  __device__ __forceinline__ int len(int64_t r) const {
    return lengths == nullptr ? L : min(max(lengths[r], 0), L);
  }
  // word k of read r's key string (lb bits of length, then the words)
  __device__ __forceinline__ uint32_t string_word(int64_t r, int lb,
                                                  int k) const {
    if (lb == 0) return word(r, k);
    const uint32_t prev = k == 0 ? static_cast<uint32_t>(len(r))
                                 : word(r, k - 1);
    return (prev << (32 - lb)) | (word(r, k) >> lb);
  }
  __device__ __forceinline__ int64_t key(int64_t r, int lb, int c) const {
    const uint64_t hi = string_word(r, lb, 2 * c) ^ 0x80000000u;
    return static_cast<int64_t>((hi << 32) | string_word(r, lb, 2 * c + 1));
  }
  __device__ __forceinline__ bool differ(int64_t r, int64_t q) const {
    if (len(r) != len(q)) return true;
    for (int t = 0; t < W; ++t) {
      if (word(r, t) != word(q, t)) return true;
    }
    return false;
  }
};

__global__ void dedup_keys_kernel(Canon cn, int64_t n, int lb, int c,
                                  const int64_t* __restrict__ order_in,
                                  const int64_t* __restrict__ perm,
                                  int64_t* __restrict__ order_out,
                                  int64_t* __restrict__ col) {
  SAGE2_GRID_STRIDE(i, n) {
    const int64_t r = perm == nullptr ? i : order_in[perm[i]];
    order_out[i] = r;
    col[i] = cn.key(r, lb, c);
  }
}

__global__ void __launch_bounds__(kThreads)
    dedup_heads_kernel(Canon cn, int64_t n,
                       const int64_t* __restrict__ order_in,
                       const int64_t* __restrict__ perm,
                       int64_t* __restrict__ s_order,
                       uint8_t* __restrict__ heads,
                       int64_t* __restrict__ tile_counts) {
  const int64_t i0 = scan_first_item();
  int count = 0;
  for (int k = 0; k < kScanItems && i0 + k < n; ++k) {
    const int64_t i = i0 + k;
    const int64_t r = order_in[perm[i]];
    s_order[i] = r;
    const bool head = i == 0 || cn.differ(r, order_in[perm[i - 1]]);
    heads[i] = head;
    count += head;
  }
  int total;
  block_exclusive_scan<int>(count, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    dedup_assign_kernel(const int64_t* __restrict__ s_order,
                        const uint8_t* __restrict__ heads,
                        const int64_t* __restrict__ tile_offsets,
                        const bool* __restrict__ take_rc, int64_t n,
                        int64_t* __restrict__ head_pos,
                        int32_t* __restrict__ vertex_of_read) {
  const int64_t i0 = scan_first_item();
  int count = 0;
  for (int k = 0; k < kScanItems && i0 + k < n; ++k) count += heads[i0 + k];
  int total;
  int64_t seen = tile_offsets[blockIdx.x] +
                 block_exclusive_scan<int>(count, &total);
  for (int k = 0; k < kScanItems && i0 + k < n; ++k) {
    const int64_t i = i0 + k;
    if (heads[i]) head_pos[seen++] = i;
    const int64_t r = s_order[i];
    vertex_of_read[r] = static_cast<int32_t>(seen - 1 + (take_rc[r] ? n : 0));
  }
}

__global__ void dedup_rows_kernel(Canon cn, int64_t n,
                                  const int64_t* __restrict__ s_order,
                                  const int64_t* __restrict__ head_pos,
                                  const int64_t* __restrict__ n_unique,
                                  const int32_t* __restrict__ reads,
                                  const int32_t* __restrict__ rc,
                                  int32_t* __restrict__ uniq,
                                  int32_t* __restrict__ mult,
                                  int32_t* __restrict__ lens_u) {
  const int lane = threadIdx.x % kWarp;
  const int64_t n_u = *n_unique;
  const int L = cn.L;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kRowWarps;
  for (int64_t g = blockIdx.x * int64_t{kRowWarps} + threadIdx.x / kWarp;
       g < n; g += warps) {
    int32_t* out = uniq + g * L;
    if (g >= n_u) {
      for (int j = lane; j < L; j += kWarp) out[j] = 0;
      if (lane == 0) {
        mult[g] = 0;
        if (lens_u != nullptr) lens_u[g] = 0;
      }
      continue;
    }
    const int64_t h = head_pos[g];
    const int64_t r = s_order[h];
    const int len = cn.len(r);
    const int32_t* src = (cn.take_rc[r] ? rc : reads) + r * L;
    for (int j = lane; j < L; j += kWarp) out[j] = j < len ? src[j] : 0;
    if (lane == 0) {
      mult[g] = static_cast<int32_t>((g + 1 < n_u ? head_pos[g + 1] : n) - h);
      if (lens_u != nullptr) lens_u[g] = cn.lengths[r];
    }
  }
}

Canon make_canon(const void* fwd_w, const void* rc_w, const void* take_rc,
                 const void* lengths, int W, int L) {
  return Canon{static_cast<const int64_t*>(fwd_w),
               static_cast<const int64_t*>(rc_w),
               static_cast<const bool*>(take_rc),
               static_cast<const int32_t*>(lengths), W, L};
}

}  // namespace

// fwd_w, rc_w: (n, W) int64 words holding uint32 (K8's); take_rc: (n,)
// bool; lengths: (n,) int32 or NULL; lb: bits of the length in the key
// string (0 without lengths); c: the key to build. order_in and perm:
// the previous order and the permutation its key's sort gave (both NULL
// for the first key: the identity). order_out (n,) int64 gets the
// composed order, col (n,) int64 key c of each row in it.
SAGE2_EXPORT int sage2_dedup_keys(const void* fwd_w, const void* rc_w,
                                  const void* take_rc, const void* lengths,
                                  int64_t n, int W, int L, int lb, int c,
                                  const void* order_in, const void* perm,
                                  void* order_out, void* col, void* stream) {
  dedup_keys_kernel<<<sage2_blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      make_canon(fwd_w, rc_w, take_rc, lengths, W, L), n, lb, c,
      static_cast<const int64_t*>(order_in),
      static_cast<const int64_t*>(perm), static_cast<int64_t*>(order_out),
      static_cast<int64_t*>(col));
  return static_cast<int>(cudaGetLastError());
}

// s_order (n,) int64 := order_in[perm]; heads (n,) uint8 the group heads
// in that order; tile_counts (tiles of scan.cuh) the heads of each tile.
SAGE2_EXPORT int sage2_dedup_heads(const void* order_in, const void* perm,
                                   const void* fwd_w, const void* rc_w,
                                   const void* take_rc, const void* lengths,
                                   int64_t n, int W, int L, void* s_order,
                                   void* heads, void* tile_counts,
                                   void* stream) {
  dedup_heads_kernel<<<scan_tiles_of(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      make_canon(fwd_w, rc_w, take_rc, lengths, W, L), n,
      static_cast<const int64_t*>(order_in),
      static_cast<const int64_t*>(perm), static_cast<int64_t*>(s_order),
      static_cast<uint8_t*>(heads), static_cast<int64_t*>(tile_counts));
  return static_cast<int>(cudaGetLastError());
}

// tile_offsets: the scanned tile counts. head_pos (n,) int64: the sorted
// position of group g's head at g < n_unique; vertex_of_read (n,) int32.
SAGE2_EXPORT int sage2_dedup_assign(const void* s_order, const void* heads,
                                    const void* tile_offsets,
                                    const void* take_rc, int64_t n,
                                    void* head_pos, void* vertex_of_read,
                                    void* stream) {
  dedup_assign_kernel<<<scan_tiles_of(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(s_order),
      static_cast<const uint8_t*>(heads),
      static_cast<const int64_t*>(tile_offsets),
      static_cast<const bool*>(take_rc), n,
      static_cast<int64_t*>(head_pos), static_cast<int32_t*>(vertex_of_read));
  return static_cast<int>(cudaGetLastError());
}

// n_unique: the device scalar sage2_scan_tiles wrote; reads, rc: (n, L)
// int32; uniq (n, L), mult (n,) and lens_u (n,) int32 (lens_u NULL
// without lengths).
SAGE2_EXPORT int sage2_dedup_rows(const void* s_order, const void* head_pos,
                                  const void* n_unique, const void* reads,
                                  const void* rc, const void* take_rc,
                                  const void* lengths, int64_t n, int L,
                                  void* uniq, void* mult, void* lens_u,
                                  void* stream) {
  int64_t blocks = (n + kRowWarps - 1) / kRowWarps;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;
  if (blocks < 1) blocks = 1;
  dedup_rows_kernel<<<static_cast<int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      make_canon(nullptr, nullptr, take_rc, lengths, 0, L), n,
      static_cast<const int64_t*>(s_order),
      static_cast<const int64_t*>(head_pos),
      static_cast<const int64_t*>(n_unique),
      static_cast<const int32_t*>(reads), static_cast<const int32_t*>(rc),
      static_cast<int32_t*>(uniq), static_cast<int32_t*>(mult),
      static_cast<int32_t*>(lens_u));
  return static_cast<int>(cudaGetLastError());
}
