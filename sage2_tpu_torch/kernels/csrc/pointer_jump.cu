// K4: a whole pointer-doubling loop over a vertex array, in one
// cooperative launch.
//
// Replaces the doubling loops of sage2_tpu/graph/traverse.py
// contract_unitigs (`double` :81, `min_prop` :88, `dist_body` :114;
// lax.fori_loops of whole-array gathers, :79-118). Step s computes, from
// step s - 1's arrays only,
//
//   p'[i] = p[p[i]]
//   op 0: no value; op 1: v'[i] = min(v[i], v[p[i]]);
//   op 2: v'[i] = v[i] + v[p[i]] (two's-complement wrap, as int32)
//
// and the kernel runs `steps` of them (the reference's ceil(log2 V) + 1,
// with no early exit: for op 2 a step past convergence is not a no-op
// unless roots hold 0). A step never updates in place: in-place jumping
// reaches the root by another route and gives other distances for op 2.
// Step s reads the inputs (the first) or one half of a ping-pong pair of
// scratch buffers and writes the other half, or the outputs (the last);
// the inputs are never written.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700.00 W): bytes, 8 a vertex
// a step (p read and written; 16 with a value), 0.011 ms a step at 4.6 M
// vertices. At that size the arrays (18.4 MB each) live in the 50 MB L2,
// so a step is its gathers: p[p[i]] (and v[p[i]]) is one random 32-byte
// L2 sector for 4 useful bytes, 147 MB of sector traffic a step.
//
// What the first version lost (same card and limit): one launch a
// step, a fresh output a step and a ctypes call from a Python loop, 96
// launches a contraction (48 none, 24 min, 24 add at 24 steps); 0.053 ms
// a step for op 0 at phase 4's 4.6 M vertices against 0.044 ms for one
// torch.index_select(p, 0, p), with one vertex a thread and scalar loads.
//
// This design: one persistent cooperative launch (cudaLaunchCooperative-
// Kernel) a loop, at most as many blocks as fit on the card at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), with
// cooperative_groups::this_grid().sync() between steps instead of a
// launch. A thread takes four consecutive vertices with 16-byte loads of
// p and v (a ragged tail, or a misaligned input, element by element).
// Between the first and the last step, (p, v) live as one array of pairs,
// so a gather of both is one 8-byte load and one L2 sector, not two.
// Loads are cached in L1 (ld.global.ca): as the pointers converge, many
// vertices gather the same few roots. The grid barrier ends in an
// acquire at gpu scope, which invalidates the SM's L1 (its SASS holds
// MEMBAR.ALL.GPU and CCTL.IVALL), so no step reads a line that an earlier
// step left in L1. No L2 access-policy window is set. ptxas (sm_90a):
// 32 registers (op 0), 40 (ops 1, 2), 1 barrier, no spills.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kJumpThreads = 256;

template <int kOp>
__device__ __forceinline__ int32_t jump_val(int32_t a, int32_t b) {
  if (kOp == 1) return a < b ? a : b;
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// One step of vertex k. Op 0: ps/pd are p arrays. Ops 1, 2: the step reads
// separate (p, v) arrays, or one (p, v) pair array when `in_pair`, and
// writes likewise by `out_pair`.
template <int kOp>
__device__ __forceinline__ void jump1(const int32_t* ps, const int32_t* vs,
                                      const int2* qs, int32_t* pd,
                                      int32_t* vd, int2* qd, int64_t k,
                                      bool in_pair, bool out_pair) {
  if (kOp == 0) {
    pd[k] = __ldca(ps + __ldca(ps + k));
    return;
  }
  int32_t pp, vv;
  if (in_pair) {
    const int2 q = __ldca(qs + k);
    const int2 g = __ldca(qs + q.x);   // one 8-byte gather: one L2 sector
    pp = g.x;
    vv = jump_val<kOp>(q.y, g.y);
  } else {
    const int32_t pk = __ldca(ps + k);
    pp = __ldca(ps + pk);
    vv = jump_val<kOp>(__ldca(vs + k), __ldca(vs + pk));
  }
  if (out_pair) {
    qd[k] = make_int2(pp, vv);
  } else {
    pd[k] = pp;
    vd[k] = vv;
  }
}

// The same for the four vertices [i, i + 4), with 16-byte accesses (all
// arrays 16-byte aligned).
template <int kOp>
__device__ __forceinline__ void jump4(const int32_t* ps, const int32_t* vs,
                                      const int2* qs, int32_t* pd,
                                      int32_t* vd, int2* qd, int64_t i,
                                      bool in_pair, bool out_pair) {
  if (kOp == 0) {
    const int4 a = __ldca(reinterpret_cast<const int4*>(ps + i));
    *reinterpret_cast<int4*>(pd + i) =
        make_int4(__ldca(ps + a.x), __ldca(ps + a.y), __ldca(ps + a.z),
                  __ldca(ps + a.w));
    return;
  }
  int4 p4, v4;                         // own p and v
  if (in_pair) {
    const int4 a = __ldca(reinterpret_cast<const int4*>(qs + i));
    const int4 b = __ldca(reinterpret_cast<const int4*>(qs + i + 2));
    p4 = make_int4(a.x, a.z, b.x, b.z);
    v4 = make_int4(a.y, a.w, b.y, b.w);
  } else {
    p4 = __ldca(reinterpret_cast<const int4*>(ps + i));
    v4 = __ldca(reinterpret_cast<const int4*>(vs + i));
  }
  int4 pp, vv;                         // the parents' p and v
  if (in_pair) {
    const int2 g0 = __ldca(qs + p4.x), g1 = __ldca(qs + p4.y);
    const int2 g2 = __ldca(qs + p4.z), g3 = __ldca(qs + p4.w);
    pp = make_int4(g0.x, g1.x, g2.x, g3.x);
    vv = make_int4(g0.y, g1.y, g2.y, g3.y);
  } else {
    pp = make_int4(__ldca(ps + p4.x), __ldca(ps + p4.y), __ldca(ps + p4.z),
                   __ldca(ps + p4.w));
    vv = make_int4(__ldca(vs + p4.x), __ldca(vs + p4.y), __ldca(vs + p4.z),
                   __ldca(vs + p4.w));
  }
  vv = make_int4(jump_val<kOp>(v4.x, vv.x), jump_val<kOp>(v4.y, vv.y),
                 jump_val<kOp>(v4.z, vv.z), jump_val<kOp>(v4.w, vv.w));
  if (out_pair) {
    reinterpret_cast<int4*>(qd + i)[0] = make_int4(pp.x, vv.x, pp.y, vv.y);
    reinterpret_cast<int4*>(qd + i)[1] = make_int4(pp.z, vv.z, pp.w, vv.w);
  } else {
    *reinterpret_cast<int4*>(pd + i) = pp;
    *reinterpret_cast<int4*>(vd + i) = vv;
  }
}

// Step s (0-based) reads the inputs (s = 0) or scratch half (s - 1) & 1,
// and writes the outputs (s = steps - 1) or scratch half s & 1. Scratch
// holds p (op 0) or (p, v) pairs (ops 1, 2).
template <int kOp>
__global__ void __launch_bounds__(kJumpThreads)
pointer_jump_kernel(const int32_t* p0, const int32_t* v0, void* t0, void* t1,
                    int32_t* p_out, int32_t* v_out, int64_t V, int steps,
                    int vec) {
  cg::grid_group grid = cg::this_grid();
  const int64_t quads = (V + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  for (int s = 0; s < steps; ++s) {
    const bool in_pair = kOp != 0 && s > 0;
    const bool out_pair = kOp != 0 && s + 1 < steps;
    void* src = s == 0 ? nullptr : ((s - 1) & 1 ? t1 : t0);
    void* dst = s + 1 == steps ? nullptr : (s & 1 ? t1 : t0);
    const int32_t* ps = src ? static_cast<const int32_t*>(src) : p0;
    int32_t* pd = dst ? static_cast<int32_t*>(dst) : p_out;
    const bool aligned = vec || s > 0;
    const auto* qs = static_cast<const int2*>(src);
    auto* qd = static_cast<int2*>(dst);
    for (int64_t q = first; q < quads; q += stride) {
      const int64_t i = 4 * q;
      if (aligned && i + 4 <= V) {
        jump4<kOp>(ps, v0, qs, pd, v_out, qd, i, in_pair, out_pair);
      } else {
        for (int64_t k = i; k < i + 4 && k < V; ++k)
          jump1<kOp>(ps, v0, qs, pd, v_out, qd, k, in_pair, out_pair);
      }
    }
    if (s + 1 < steps) grid.sync();
  }
}

template <int kOp>
int launch(const void* p0, const void* v0, void* t0, void* t1, void* p_out,
           void* v_out, int64_t V, int steps, cudaStream_t stream) {
  static int wave = 0, device = -1;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev != device) {
    int coop = 0, sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pointer_jump_kernel<kOp>, kJumpThreads, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    wave = per_sm * sms;
    device = dev;
  }
  const int64_t quads = (V + 3) / 4;
  int64_t blocks = (quads + kJumpThreads - 1) / kJumpThreads;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  int vec = reinterpret_cast<uintptr_t>(p0) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(v0) % 16 == 0;
  void* args[] = {&p0, &v0, &t0, &t1, &p_out, &v_out, &V, &steps, &vec};
  rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pointer_jump_kernel<kOp>),
      dim3(static_cast<unsigned>(blocks)), dim3(kJumpThreads), args, 0,
      stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p0: (V,) int32 with 0 <= p0[i] < V; v0: (V,) int32, or NULL when op ==
// 0 (none; 1 min, 2 add); t0, t1: scratch of V int32 (op 0) or V int32
// pairs (ops 1, 2), t0 needed from 2 steps on and t1 from 3 (else NULL);
// p_out, v_out: (V,) int32 outputs, v_out NULL when op == 0. Returns
// cudaErrorNotSupported when the device cannot launch cooperatively.
SAGE2_EXPORT int sage2_pointer_jump(const void* p0, const void* v0, void* t0,
                                    void* t1, void* p_out, void* v_out,
                                    int64_t V, int op, int steps,
                                    void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (op == 1) return launch<1>(p0, v0, t0, t1, p_out, v_out, V, steps, s);
  if (op == 2) return launch<2>(p0, v0, t0, t1, p_out, v_out, V, steps, s);
  return launch<0>(p0, v0, t0, t1, p_out, v_out, V, steps, s);
}
