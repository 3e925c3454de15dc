// K11: run accounting over sorted keys: the unique keys and the summed
// weight of each run of equal keys, compacted in order.
//
// Replaces the run accounting of sage2_tpu/kmer/count.py count_from_keys
// (:72, after its sort) and of sage2_tpu/stream.py _merge_tables (:30):
// unique_sorted_pairs' head flags, a cumsum for the head slots, two
// scatters of the heads to the front of a full-size table and a
// segment_sum of the weights. On the TPU every one of those was a pass
// over the whole key array, and the table stayed padded to the input
// length. Here:
//
//   head pass   one thread per key: flags[i] = 1 where the key differs
//               from its predecessor (the first key always);
//   scan        an inclusive prefix sum of the flags gives each head its
//               output slot plus one, and the last entry the unique count
//               (torch.cumsum in the wrapper, between the two launches;
//               the host reads the count once to size the outputs);
//   write pass  one thread per key, into sums zeroed by the wrapper: a
//               head writes its key at its slot. With weights, every key
//               adds its weight to its run's slot (an integer atomicAdd,
//               so the sum does not depend on the order). Without them, a
//               run's count is its end minus its start: the head adds
//               -i and the last key of the run adds i + 1. No thread
//               walks a run, so a k-mer of high count (a repeat) costs
//               its run no more than two atomics.
//
// Keys are int64 in ascending order (signed). Weights are int32 and the
// sums are taken in int32, as the reference's segment_sum.
//
// Bound: bytes. Each key is read once or twice (its successor's thread,
// through L1) and each weight once; one flag and one slot are written
// and read per key, and 12 bytes per unique key.

#include "common.cuh"

__global__ void run_heads_kernel(const int64_t* __restrict__ keys, int64_t n,
                                 int32_t* __restrict__ flags) {
  SAGE2_GRID_STRIDE(i, n) {
    flags[i] = (i == 0 || keys[i] != keys[i - 1]) ? 1 : 0;
  }
}

__global__ void run_write_kernel(const int64_t* __restrict__ keys,
                                 const int32_t* __restrict__ weights,
                                 int64_t n, const int32_t* __restrict__ flags,
                                 const int32_t* __restrict__ pos,
                                 int64_t* __restrict__ out_keys,
                                 int32_t* __restrict__ out_sums) {
  SAGE2_GRID_STRIDE(i, n) {
    const int32_t slot = pos[i] - 1;
    if (flags[i]) out_keys[slot] = keys[i];
    if (weights != nullptr) {
      atomicAdd(out_sums + slot, weights[i]);
      continue;
    }
    if (flags[i]) atomicAdd(out_sums + slot, -static_cast<int32_t>(i));
    if (i + 1 == n || keys[i + 1] != keys[i])
      atomicAdd(out_sums + slot, static_cast<int32_t>(i + 1));
  }
}

// keys: (n,) sorted int64; flags: (n,) int32 output.
SAGE2_EXPORT int sage2_run_heads(const void* keys, int64_t n, void* flags,
                                 void* stream) {
  run_heads_kernel<<<sage2_blocks(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), n, static_cast<int32_t*>(flags));
  return static_cast<int>(cudaGetLastError());
}

// weights: (n,) int32 or NULL (1 each); flags, pos: (n,) int32, pos the
// inclusive prefix sum of flags; out_keys (n_unique,) int64 and out_sums
// (n_unique,) int32 outputs, out_sums zeroed.
SAGE2_EXPORT int sage2_run_write(const void* keys, const void* weights,
                                 int64_t n, const void* flags,
                                 const void* pos, void* out_keys,
                                 void* out_sums, void* stream) {
  run_write_kernel<<<sage2_blocks(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys),
      static_cast<const int32_t*>(weights), n,
      static_cast<const int32_t*>(flags), static_cast<const int32_t*>(pos),
      static_cast<int64_t*>(out_keys), static_cast<int32_t*>(out_sums));
  return static_cast<int>(cudaGetLastError());
}
