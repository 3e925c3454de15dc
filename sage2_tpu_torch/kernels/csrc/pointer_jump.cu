// K4: one pointer-doubling step over a vertex array.
//
// Replaces the doubling loops of sage2_tpu/graph/traverse.py
// contract_unitigs (`double` :81, `min_prop` :88, `dist_body` :114),
// which were lax.fori_loop bodies of whole-array gathers. Each launch is
// one step, reading only the input buffers and writing separate output
// buffers, so a step sees exactly the previous step's arrays as the
// functional JAX loop does; the wrapper launches it ceil(log2 V) + 1
// times per loop and swaps buffers.
//
//   p_out[i] = p[p[i]]
//   op 0: no value; op 1: v_out[i] = min(v[i], v[p[i]]);
//   op 2: v_out[i] = v[i] + v[p[i]] (two's-complement wrap, as int32)
//
// Bound: bytes (16 bytes a vertex with a value, 8 without); the gather
// p[p[i]] is random, so the step runs at the card's random-access rate.

#include "common.cuh"

__global__ void pointer_jump_kernel(const int32_t* __restrict__ p,
                                    int32_t* __restrict__ p_out,
                                    const int32_t* __restrict__ v,
                                    int32_t* __restrict__ v_out, int64_t V,
                                    int op) {
  SAGE2_GRID_STRIDE(i, V) {
    const int32_t pi = p[i];
    p_out[i] = p[pi];
    if (op == 1) {
      const int32_t a = v[i], b = v[pi];
      v_out[i] = a < b ? a : b;
    } else if (op == 2) {
      v_out[i] = static_cast<int32_t>(static_cast<uint32_t>(v[i]) +
                                      static_cast<uint32_t>(v[pi]));
    }
  }
}

// p, p_out: (V,) int32 with 0 <= p[i] < V; v, v_out: (V,) int32 or NULL
// when op == 0.
SAGE2_EXPORT int sage2_pointer_jump(const void* p, void* p_out,
                                    const void* v, void* v_out, int64_t V,
                                    int op, void* stream) {
  pointer_jump_kernel<<<sage2_blocks(V), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(p), static_cast<int32_t*>(p_out),
      static_cast<const int32_t*>(v), static_cast<int32_t*>(v_out), V, op);
  return static_cast<int>(cudaGetLastError());
}
