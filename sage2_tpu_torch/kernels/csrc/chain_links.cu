// K18: the chain links of unitig labeling, and the cut of its cycles.
//
// Replaces the non-doubling part of sage2_tpu/graph/traverse.py
// contract_unitigs (:40-77 and :96-107): two segment sums (the degrees),
// three scatters (each vertex's successor, its overlap and its
// predecessor), the chain masks, the initial parent array, and after the
// doubling loops the cycle cut. The doubling loops themselves are K4's.
//
//   links  one cooperative launch (cudaLaunchCooperativeKernel, as K4),
//          three steps with a grid barrier between them:
//            1. the degrees go to 0;
//            2. one thread an edge row (src == INT32_MAX is padding):
//               outdeg[src] and indeg[dst] by atomics, succ[src] = dst,
//               succ_ovl[src] = ovl, pred[dst] = src by plain stores.
//               A vertex of degree > 1 keeps any writer: step 3 only
//               reads succ where outdeg == 1 and pred where indeg == 1,
//               where there is one writer, so every output is exact;
//            3. one thread a vertex: the chain edge out of v (outdeg(v) ==
//               1 and indeg(succ) == 1) gives nxt and ovl_next, the chain
//               edge into v (indeg(v) == 1 and outdeg(pred) == 1) the
//               parent p = pred, else p = v.
//   cut    after K4's `none` loop (pf, the roots) and `min` loop (m, the
//          least id over each vertex's backward closure), one thread a
//          vertex: v is a cycle's breaker when p[pf[v]] != pf[v] (its
//          root is no root: a cycle) and m[v] == v; a breaker becomes its
//          own parent, and the chain edge into it is dissolved: nxt and
//          ovl_next of p[v] (its predecessor: a vertex on a cycle has a
//          chain edge in) become -1 and 0. The cut reads p and writes a
//          new parent array, so no thread reads a parent another has cut;
//          it also writes the distance array that K4's `add` loop starts
//          from, d0 = (p' != v).
//
// Bound: bytes and L2 sectors. The edge rows (12 bytes) are read once and
// scatter 2 atomics and 3 stores each; a vertex reads its degrees and
// neighbours and two random degrees, and writes five arrays (links) or
// reads four and writes two (cut).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int32_t kInt32Max = 0x7FFFFFFF;

__global__ void __launch_bounds__(kThreads)
    chain_links_kernel(const int32_t* __restrict__ src,
                       const int32_t* __restrict__ dst,
                       const int32_t* __restrict__ ovl, int64_t E, int64_t V,
                       int32_t* outdeg, int32_t* indeg, int32_t* succ,
                       int32_t* succ_ovl, int32_t* pred,
                       int32_t* __restrict__ nxt,
                       int32_t* __restrict__ ovl_next,
                       int32_t* __restrict__ p) {
  cg::grid_group grid = cg::this_grid();
  SAGE2_GRID_STRIDE(v, V) {
    outdeg[v] = 0;
    indeg[v] = 0;
  }
  grid.sync();
  SAGE2_GRID_STRIDE(e, E) {
    const int32_t s = src[e];
    if (s == kInt32Max) continue;
    const int32_t d = dst[e];
    atomicAdd(outdeg + s, 1);
    atomicAdd(indeg + d, 1);
    succ[s] = d;
    succ_ovl[s] = ovl[e];
    pred[d] = s;
  }
  grid.sync();
  SAGE2_GRID_STRIDE(v, V) {
    const bool chain_out = outdeg[v] == 1 && indeg[succ[v]] == 1;
    nxt[v] = chain_out ? succ[v] : -1;
    ovl_next[v] = chain_out ? succ_ovl[v] : 0;
    const bool chain_in = indeg[v] == 1 && outdeg[pred[v]] == 1;
    p[v] = chain_in ? pred[v] : static_cast<int32_t>(v);
  }
}

__global__ void chain_cut_kernel(const int32_t* __restrict__ p,
                                 const int32_t* __restrict__ pf,
                                 const int32_t* __restrict__ m, int64_t V,
                                 int32_t* __restrict__ nxt,
                                 int32_t* __restrict__ ovl_next,
                                 int32_t* __restrict__ p_out,
                                 int32_t* __restrict__ d0) {
  SAGE2_GRID_STRIDE(v, V) {
    const int32_t q = p[v];
    const int32_t f = pf[v];
    const bool breaker = p[f] != f && m[v] == v;
    if (breaker) {
      nxt[q] = -1;
      ovl_next[q] = 0;
    }
    const int32_t pv = breaker ? static_cast<int32_t>(v) : q;
    p_out[v] = pv;
    d0[v] = pv != v;
  }
}

}  // namespace

// src, dst, ovl: (E,) int32 edge rows, padding src == INT32_MAX, real
// ids below V; outdeg, indeg, nxt, ovl_next, p: (V,) int32 outputs;
// succ, succ_ovl, pred: (V,) int32 scratch. Returns
// cudaErrorNotSupported when the device cannot launch cooperatively.
SAGE2_EXPORT int sage2_chain_links(const void* src, const void* dst,
                                   const void* ovl, int64_t E, int64_t V,
                                   void* outdeg, void* indeg, void* succ,
                                   void* succ_ovl, void* pred, void* nxt,
                                   void* ovl_next, void* p, void* stream) {
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
        &per_sm, chain_links_kernel, kThreads, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    wave = per_sm * sms;
    device = dev;
  }
  const int64_t n = E > V ? E : V;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  void* args[] = {&src, &dst, &ovl, &E, &V, &outdeg, &indeg, &succ,
                  &succ_ovl, &pred, &nxt, &ovl_next, &p};
  rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(chain_links_kernel),
      dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// p: (V,) int32 parents from sage2_chain_links; pf, m: K4's `none` and
// `min` results over p; nxt, ovl_next: edited in place; p_out, d0: (V,)
// int32 outputs, the cut parents and (p_out != v).
SAGE2_EXPORT int sage2_chain_cut(const void* p, const void* pf, const void* m,
                                 int64_t V, void* nxt, void* ovl_next,
                                 void* p_out, void* d0, void* stream) {
  chain_cut_kernel<<<sage2_blocks(V), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(p), static_cast<const int32_t*>(pf),
      static_cast<const int32_t*>(m), V, static_cast<int32_t*>(nxt),
      static_cast<int32_t*>(ovl_next), static_cast<int32_t*>(p_out),
      static_cast<int32_t*>(d0));
  return static_cast<int>(cudaGetLastError());
}
