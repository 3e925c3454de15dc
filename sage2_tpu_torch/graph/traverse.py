"""Unitig contraction on the device: unambiguous-path labeling by pointer
doubling (port of sage2_tpu/graph/traverse.py).

A chain edge u->v satisfies outdeg(u) == 1 and indeg(v) == 1. Each vertex
is labeled with its chain head and its distance from it in O(log V)
doubling steps (kernel K4). Cycles are broken deterministically at their
minimum vertex id, matching refmodel.oracle.oracle_unitigs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sage2_tpu_torch import kernels
from sage2_tpu_torch.ops.sort import I32_MAX


class UnitigLabels(NamedTuple):
    """Per-vertex chain labels (int32 arrays of size V on the device).

    head: chain head vertex id; dist: position within the chain (0 at
    head); nxt: chain successor (-1 at chain tails); ovl_next: overlap
    length of the chain edge out of v (0 where nxt == -1); outdeg/indeg:
    degrees in the reduced graph.
    """

    head: torch.Tensor
    dist: torch.Tensor
    nxt: torch.Tensor
    ovl_next: torch.Tensor
    outdeg: torch.Tensor
    indeg: torch.Tensor


def contract_unitigs(
    src: torch.Tensor, dst: torch.Tensor, ovl: torch.Tensor, n_vertices: int
) -> UnitigLabels:
    """Label unambiguous chains of the reduced string graph (int32 edge
    arrays, padding rows src == INT32_MAX)."""
    V = n_vertices
    dev = src.device
    i32 = torch.int32
    is_edge = src != I32_MAX
    e_src = src[is_edge].to(torch.int64)
    e_dst = dst[is_edge].to(torch.int64)
    e_ovl = ovl[is_edge]
    outdeg = torch.bincount(e_src, minlength=V).to(i32)
    indeg = torch.bincount(e_dst, minlength=V).to(i32)

    # single out-/in-neighbours (meaningful only where the degree is 1:
    # with degree > 1 an arbitrary writer wins and is masked out below)
    succ = torch.full((V,), -1, dtype=i32, device=dev)
    succ[e_src] = e_dst.to(i32)
    succ_ovl = torch.zeros((V,), dtype=i32, device=dev)
    succ_ovl[e_src] = e_ovl
    pred = torch.full((V,), -1, dtype=i32, device=dev)
    pred[e_dst] = e_src.to(i32)

    succ_c = succ.clamp(min=0).to(torch.int64)
    chain_out = (outdeg == 1) & (succ >= 0) & (indeg[succ_c] == 1)
    nxt = torch.where(chain_out, succ, -1).to(i32)
    ovl_next = torch.where(chain_out, succ_ovl, 0).to(i32)
    pred_c = pred.clamp(min=0)
    chain_in = (indeg == 1) & (pred >= 0) & (outdeg[pred_c.to(torch.int64)] == 1)
    ids = torch.arange(V, dtype=i32, device=dev)
    p = torch.where(chain_in, pred_c, ids)

    steps = max(1, math.ceil(math.log2(max(V, 2))) + 1)

    def double(p, val=None, op="none"):
        for _ in range(steps):
            p, val = kernels.pointer_jump(p, val, op)
        return p, val

    pf, _ = double(p)
    in_cycle = p[pf.to(torch.int64)] != pf
    _, m = double(p, ids, "min")          # min id over the backward closure
    breaker = in_cycle & (m == ids)       # min vertex of each cycle
    p = torch.where(breaker, ids, p)
    # the chain edge into the breaker is dissolved
    bpred = pred_c[breaker].to(torch.int64)
    nxt[bpred] = -1
    ovl_next[bpred] = 0

    head, _ = double(p)
    _, dist = double(p, (p != ids).to(i32), "add")
    return UnitigLabels(head, dist, nxt, ovl_next, outdeg, indeg)
