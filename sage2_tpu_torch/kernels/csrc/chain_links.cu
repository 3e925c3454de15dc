// K18: the chain links of unitig labeling, and the cut of its cycles.
//
// Replaces the non-doubling part of sage2_tpu/graph/traverse.py
// contract_unitigs (:40-77 and :96-107): two segment sums (the degrees),
// three scatters (each vertex's successor, its overlap and its
// predecessor), the chain masks, the initial parent array, and after the
// doubling loops the cycle cut. The doubling loops themselves are K4's.
//
//   links  the degree counters zeroed (cudaMemsetAsync), then four
//          launches, each a pass over rows or vertices (16-byte loads and
//          stores where the arrays are aligned; the edge rows' loads
//          marked evict-first, so that the counters stay in L2):
//            in        a thread four edge rows (src == INT32_MAX is
//                      padding): in_word[dst] += (src << 32) | 1, one
//                      64-bit atomic an edge: its low half counts the
//                      in-edges, its high half sums their sources, which
//                      is the predecessor itself where indeg == 1;
//            out       the same rows: outdeg[src] by an atomic, and
//                      succ[src] = (dst, ovl) as one 8-byte store (any
//                      writer where outdeg > 1: only read where it is 1);
//            flags     a thread a vertex: indeg from in_word, and two bit
//                      maps by warp ballots, outdeg == 1 and indeg == 1
//                      (V / 8 bytes each: they stay in cache for the
//                      random tests below);
//            vertices  a thread four vertices: the chain edge out of v
//                      (outdeg(v) == 1 and indeg(succ) == 1, a bit of the
//                      in map) gives nxt and ovl_next, the chain edge into
//                      v (indeg(v) == 1 and outdeg(pred) == 1) the parent
//                      p = pred, else p = v.
//          Every output is exact whatever the rows' order: nothing reads a
//          scatter target where more than one row wrote it. The main path
//          passes the reduced graph's real rows alone (pipeline.py's
//          traverse stage); padding rows anywhere cost a load of their src.
//   cut    after K4's `none` loop (pf, the roots) and `min` loop (m, the
//          least id over each vertex's backward closure), a thread four
//          vertices: v is a cycle's breaker when m[v] == v and p[pf[v]]
//          != pf[v] (its root is no root: a cycle; the random read only
//          where m[v] == v); a breaker becomes its own parent, and the
//          chain edge into it is dissolved: nxt and ovl_next of p[v] (its
//          predecessor: a vertex on a cycle has a chain edge in) become -1
//          and 0. The cut reads p and writes a new parent array, so no
//          thread reads a parent another has cut; it also writes the
//          distance array that K4's `add` loop starts from, d0 = (p' != v).
//
// Bound: bytes and L2 sectors. The edge rows (12 bytes) are read once by
// the formula (src and dst twice here), and each makes one random 64-bit
// atomic (in_word, 8 bytes a vertex) and an atomic and a store at its
// source (sequential for (src, dst)-sorted rows); a vertex's counters and
// links are read twice and its five outputs written once; the random
// tests of the vertex pass read two bit maps. The cut reads three arrays
// and one random parent and writes two.

#include "common.cuh"

namespace {

constexpr int32_t kInt32Max = 0x7FFFFFFF;

struct Links {
  int32_t* outdeg;
  int32_t* indeg;
  unsigned long long* in_word;  // (sum of sources << 32) | in-edge count
  unsigned long long* succ;     // (dst, ovl) of the last writer
  uint32_t* out1;               // bit v: outdeg(v) == 1
  uint32_t* in1;                // bit v: indeg(v) == 1
};

__device__ __forceinline__ void add_in(const Links& k, int32_t s, int32_t d) {
  if (s == kInt32Max) return;
  atomicAdd(k.in_word + d,
            (static_cast<unsigned long long>(static_cast<uint32_t>(s)) << 32)
                | 1ull);
}

__device__ __forceinline__ void add_out(const Links& k, int32_t s, int32_t d,
                                        int32_t o) {
  if (s == kInt32Max) return;
  atomicAdd(k.outdeg + s, 1);
  k.succ[s] = static_cast<uint32_t>(d) |
              (static_cast<unsigned long long>(static_cast<uint32_t>(o))
               << 32);
}

// The in or the out pass over the edge rows: four rows a thread where
// the rows are 16-byte aligned, else one.
template <bool kOut, bool kVec>
__global__ void __launch_bounds__(kThreads)
    chain_edges_kernel(const int32_t* __restrict__ src,
                       const int32_t* __restrict__ dst,
                       const int32_t* __restrict__ ovl, int64_t E, Links k) {
  const int64_t i = blockIdx.x * int64_t{kThreads} + threadIdx.x;
  const int64_t e0 = kVec ? 4 * i : i;
  if (e0 >= E) return;
  if (kVec && e0 + 4 <= E) {
    const int4 s = __ldcs(reinterpret_cast<const int4*>(src) + i);
    if ((s.x & s.y & s.z & s.w) == kInt32Max) return;   // four padding rows
    const int4 d = __ldcs(reinterpret_cast<const int4*>(dst) + i);
    if (kOut) {
      const int4 o = __ldcs(reinterpret_cast<const int4*>(ovl) + i);
      add_out(k, s.x, d.x, o.x);
      add_out(k, s.y, d.y, o.y);
      add_out(k, s.z, d.z, o.z);
      add_out(k, s.w, d.w, o.w);
    } else {
      add_in(k, s.x, d.x);
      add_in(k, s.y, d.y);
      add_in(k, s.z, d.z);
      add_in(k, s.w, d.w);
    }
    return;
  }
  const int64_t end = kVec ? E : e0 + 1;
  for (int64_t e = e0; e < end; ++e) {
    const int32_t s = __ldcs(src + e);
    if (kOut) {
      add_out(k, s, __ldcs(dst + e), __ldcs(ovl + e));
    } else {
      add_in(k, s, __ldcs(dst + e));
    }
  }
}

// A thread a vertex: indeg, and the bit maps of degree one.
__global__ void __launch_bounds__(kThreads)
    chain_flags_kernel(Links k, int64_t V) {
  const int64_t v = blockIdx.x * int64_t{kThreads} + threadIdx.x;
  bool out1 = false, in1 = false;
  if (v < V) {
    const int32_t id = static_cast<int32_t>(k.in_word[v]);
    k.indeg[v] = id;
    out1 = k.outdeg[v] == 1;
    in1 = id == 1;
  }
  const unsigned o = __ballot_sync(0xffffffffu, out1);
  const unsigned n = __ballot_sync(0xffffffffu, in1);
  if ((threadIdx.x & 31) == 0 && v < V) {
    k.out1[v >> 5] = o;
    k.in1[v >> 5] = n;
  }
}

__device__ __forceinline__ bool bit(const uint32_t* __restrict__ map,
                                    int32_t v) {
  return (__ldg(map + (v >> 5)) >> (v & 31)) & 1u;
}

// One vertex's links (nxt, ovl_next, p), given its own flags.
__device__ __forceinline__ int3 vertex_links(const Links& k, int32_t v,
                                             bool out1, bool in1) {
  int3 out = make_int3(-1, 0, v);
  if (out1) {
    const unsigned long long u = k.succ[v];
    const int32_t d = static_cast<int32_t>(static_cast<uint32_t>(u));
    if (bit(k.in1, d)) {
      out.x = d;
      out.y = static_cast<int32_t>(u >> 32);
    }
  }
  if (in1) {
    const int32_t q = static_cast<int32_t>(k.in_word[v] >> 32);
    if (bit(k.out1, q)) out.z = q;
  }
  return out;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    chain_vertices_kernel(Links k, int64_t V, int32_t* __restrict__ nxt,
                          int32_t* __restrict__ ovl_next,
                          int32_t* __restrict__ p) {
  const int64_t i = blockIdx.x * int64_t{kThreads} + threadIdx.x;
  const int64_t v0 = kVec ? 4 * i : i;
  if (v0 >= V) return;
  if (kVec && v0 + 4 <= V) {
    // v0 is a multiple of 4: its four flags are one nibble of a map word
    const int sh = static_cast<int>(v0 & 31);
    const unsigned o = __ldg(k.out1 + (v0 >> 5)) >> sh;
    const unsigned n = __ldg(k.in1 + (v0 >> 5)) >> sh;
    const int32_t v = static_cast<int32_t>(v0);
    const int3 a = vertex_links(k, v, o & 1u, n & 1u);
    const int3 b = vertex_links(k, v + 1, (o >> 1) & 1u, (n >> 1) & 1u);
    const int3 c = vertex_links(k, v + 2, (o >> 2) & 1u, (n >> 2) & 1u);
    const int3 d = vertex_links(k, v + 3, (o >> 3) & 1u, (n >> 3) & 1u);
    reinterpret_cast<int4*>(nxt)[i] = make_int4(a.x, b.x, c.x, d.x);
    reinterpret_cast<int4*>(ovl_next)[i] = make_int4(a.y, b.y, c.y, d.y);
    reinterpret_cast<int4*>(p)[i] = make_int4(a.z, b.z, c.z, d.z);
    return;
  }
  const int64_t end = kVec ? V : v0 + 1;
  for (int64_t v = v0; v < end; ++v) {
    const int32_t w = static_cast<int32_t>(v);
    const int3 l = vertex_links(k, w, bit(k.out1, w), bit(k.in1, w));
    nxt[v] = l.x;
    ovl_next[v] = l.y;
    p[v] = l.z;
  }
}

// One vertex's cut: writes nxt and ovl_next of its predecessor where it
// is a breaker; returns its new parent.
__device__ __forceinline__ int32_t cut_vertex(const int32_t* __restrict__ p,
                                              int32_t v, int32_t q, int32_t f,
                                              int32_t mv, int32_t* nxt,
                                              int32_t* ovl_next) {
  if (mv != v || __ldg(p + f) == f) return q;
  nxt[q] = -1;
  ovl_next[q] = 0;
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    chain_cut_kernel(const int32_t* __restrict__ p,
                     const int32_t* __restrict__ pf,
                     const int32_t* __restrict__ m, int64_t V,
                     int32_t* __restrict__ nxt,
                     int32_t* __restrict__ ovl_next,
                     int32_t* __restrict__ p_out,
                     int32_t* __restrict__ d0) {
  const int64_t i = blockIdx.x * int64_t{kThreads} + threadIdx.x;
  const int64_t v0 = kVec ? 4 * i : i;
  if (v0 >= V) return;
  if (kVec && v0 + 4 <= V) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p) + i);
    const int4 f = __ldg(reinterpret_cast<const int4*>(pf) + i);
    const int4 mm = __ldg(reinterpret_cast<const int4*>(m) + i);
    const int32_t v = static_cast<int32_t>(v0);
    const int4 out = make_int4(
        cut_vertex(p, v, q.x, f.x, mm.x, nxt, ovl_next),
        cut_vertex(p, v + 1, q.y, f.y, mm.y, nxt, ovl_next),
        cut_vertex(p, v + 2, q.z, f.z, mm.z, nxt, ovl_next),
        cut_vertex(p, v + 3, q.w, f.w, mm.w, nxt, ovl_next));
    reinterpret_cast<int4*>(p_out)[i] = out;
    reinterpret_cast<int4*>(d0)[i] =
        make_int4(out.x != v, out.y != v + 1, out.z != v + 2, out.w != v + 3);
    return;
  }
  const int64_t end = kVec ? V : v0 + 1;
  for (int64_t v = v0; v < end; ++v) {
    const int32_t pv = cut_vertex(p, static_cast<int32_t>(v), __ldg(p + v),
                                  __ldg(pf + v), __ldg(m + v), nxt, ovl_next);
    p_out[v] = pv;
    d0[v] = pv != v;
  }
}

bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

unsigned grid(int64_t n, bool vec) {
  const int64_t threads = vec ? (n + 3) / 4 : n;
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// src, dst, ovl: (E,) int32 edge rows in any order, padding src ==
// INT32_MAX, real ids below V; outdeg, indeg, nxt, ovl_next, p: (V,)
// int32 outputs; in_word, succ: (V,) int64 scratch; bits: 2 ceil(V / 32)
// int32 scratch (the two bit maps). V >= 1. Launches the edge passes
// only where E > 0.
SAGE2_EXPORT int sage2_chain_links(const void* src, const void* dst,
                                   const void* ovl, int64_t E, int64_t V,
                                   void* outdeg, void* indeg, void* in_word,
                                   void* succ, void* bits, void* nxt,
                                   void* ovl_next, void* p, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t words = (V + 31) / 32;
  const Links k{static_cast<int32_t*>(outdeg), static_cast<int32_t*>(indeg),
                static_cast<unsigned long long*>(in_word),
                static_cast<unsigned long long*>(succ),
                static_cast<uint32_t*>(bits),
                static_cast<uint32_t*>(bits) + words};
  cudaError_t rc = cudaMemsetAsync(outdeg, 0, V * sizeof(int32_t), s);
  if (rc == cudaSuccess) {
    rc = cudaMemsetAsync(in_word, 0, V * sizeof(unsigned long long), s);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (E > 0) {
    const auto* s32 = static_cast<const int32_t*>(src);
    const auto* d32 = static_cast<const int32_t*>(dst);
    const auto* o32 = static_cast<const int32_t*>(ovl);
    const bool vec = aligned16(src) && aligned16(dst) && aligned16(ovl);
    if (vec) {
      chain_edges_kernel<false, true><<<grid(E, true), kThreads, 0, s>>>(
          s32, d32, o32, E, k);
    } else {
      chain_edges_kernel<false, false><<<grid(E, false), kThreads, 0, s>>>(
          s32, d32, o32, E, k);
    }
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (vec) {
      chain_edges_kernel<true, true><<<grid(E, true), kThreads, 0, s>>>(
          s32, d32, o32, E, k);
    } else {
      chain_edges_kernel<true, false><<<grid(E, false), kThreads, 0, s>>>(
          s32, d32, o32, E, k);
    }
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  chain_flags_kernel<<<grid(V, false), kThreads, 0, s>>>(k, V);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  auto* n32 = static_cast<int32_t*>(nxt);
  auto* o32 = static_cast<int32_t*>(ovl_next);
  auto* p32 = static_cast<int32_t*>(p);
  if (aligned16(nxt) && aligned16(ovl_next) && aligned16(p)) {
    chain_vertices_kernel<true><<<grid(V, true), kThreads, 0, s>>>(
        k, V, n32, o32, p32);
  } else {
    chain_vertices_kernel<false><<<grid(V, false), kThreads, 0, s>>>(
        k, V, n32, o32, p32);
  }
  return static_cast<int>(cudaGetLastError());
}

// p: (V,) int32 parents from sage2_chain_links; pf, m: K4's `none` and
// `min` results over p; nxt, ovl_next: edited in place; p_out, d0: (V,)
// int32 outputs, the cut parents and (p_out != v). V >= 1.
SAGE2_EXPORT int sage2_chain_cut(const void* p, const void* pf, const void* m,
                                 int64_t V, void* nxt, void* ovl_next,
                                 void* p_out, void* d0, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* p32 = static_cast<const int32_t*>(p);
  const auto* f32 = static_cast<const int32_t*>(pf);
  const auto* m32 = static_cast<const int32_t*>(m);
  auto* n32 = static_cast<int32_t*>(nxt);
  auto* o32 = static_cast<int32_t*>(ovl_next);
  auto* q32 = static_cast<int32_t*>(p_out);
  auto* d32 = static_cast<int32_t*>(d0);
  if (aligned16(p) && aligned16(pf) && aligned16(m) && aligned16(p_out) &&
      aligned16(d0)) {
    chain_cut_kernel<true><<<grid(V, true), kThreads, 0, s>>>(
        p32, f32, m32, V, n32, o32, q32, d32);
  } else {
    chain_cut_kernel<false><<<grid(V, false), kThreads, 0, s>>>(
        p32, f32, m32, V, n32, o32, q32, d32);
  }
  return static_cast<int>(cudaGetLastError());
}
