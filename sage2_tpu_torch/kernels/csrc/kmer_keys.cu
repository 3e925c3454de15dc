// K1: forward, reverse-complement and canonical k-mer keys of every window.
//
// Replaces sage2_tpu/ops/bitpack.py kmer_keys / revcomp_kmer_keys /
// canonical_kmer_keys (:126, :144, :159; the shifted word packs of :169
// are not needed here). On the TPU those were static slices over 16
// shifted word packings with (hi, lo) uint32 key pairs; here one thread
// builds one window's 64-bit key from the codes directly.
//
// Key layout: the exact 2k-bit big-endian base-4 value (== hi << 32 | lo
// of the reference) for k <= 31. A 32-base key needs all 64 bits and is
// stored with its top bit flipped, so signed int64 order is the
// unsigned order of the value.
//
// Bound: bytes. Each window reads k codes (shared with its neighbours
// through L1) and writes three int64 keys; the arithmetic is a few
// integer ops per base.

#include "common.cuh"

__global__ void kmer_keys_kernel(const int32_t* __restrict__ reads,
                                 int64_t n_reads, int L, int k,
                                 int64_t* __restrict__ fwd,
                                 int64_t* __restrict__ rc,
                                 int64_t* __restrict__ canon) {
  const int P = L - k + 1;
  const int64_t total = n_reads * P;
  const uint64_t flip = (k == 32) ? (uint64_t{1} << 63) : 0;
  SAGE2_GRID_STRIDE(i, total) {
    const int64_t r = i / P;
    const int p = static_cast<int>(i - r * P);
    const int32_t* w = reads + r * L + p;
    uint64_t f = 0, c = 0;
    for (int j = 0; j < k; ++j) {
      const uint64_t b = static_cast<uint64_t>(w[j]);
      f = f * 4 + b;
      // base j of the window is base k-1-j of its reverse complement
      c += (3 - b) << (2 * j);
    }
    const int64_t fs = static_cast<int64_t>(f ^ flip);
    const int64_t cs = static_cast<int64_t>(c ^ flip);
    fwd[i] = fs;
    rc[i] = cs;
    canon[i] = cs < fs ? cs : fs;
  }
}

// reads: (n_reads, L) int32 codes 0-3; fwd/rc/canon: (n_reads, L-k+1) int64.
SAGE2_EXPORT int sage2_kmer_keys(const void* reads, int64_t n_reads, int L,
                                 int k, void* fwd, void* rc, void* canon,
                                 void* stream) {
  const int64_t total = n_reads * (L - k + 1);
  kmer_keys_kernel<<<sage2_blocks(total), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(reads), n_reads, L, k,
      static_cast<int64_t*>(fwd), static_cast<int64_t*>(rc),
      static_cast<int64_t*>(canon));
  return static_cast<int>(cudaGetLastError());
}
