"""Unitig contraction on the device: unambiguous-path labeling by pointer
doubling (port of sage2_tpu/graph/traverse.py).

A chain edge u->v satisfies outdeg(u) == 1 and indeg(v) == 1. Each vertex
is labeled with its chain head and its distance from it in O(log V)
doubling steps (kernel K4, one launch a loop). Cycles are broken
deterministically at their minimum vertex id, matching
refmodel.oracle.oracle_unitigs. Kernel K18 computes the rest: the
degrees, the chain links and the initial parents (``chain_links``), and
the cycle cut between K4's loops (``chain_cut``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sage2_tpu_torch import kernels


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
    arrays in any order; padding rows src == INT32_MAX change no label,
    and the pipeline passes the real rows alone)."""
    V = n_vertices
    outdeg, indeg, nxt, ovl_next, p = kernels.chain_links(src, dst, ovl, V)
    steps = max(1, math.ceil(math.log2(max(V, 2))) + 1)
    ids = torch.arange(V, dtype=torch.int32, device=src.device)
    pf, _ = kernels.pointer_jump(p, None, "none", steps)
    # the least id over each vertex's backward closure: a cycle's breaker
    _, m = kernels.pointer_jump(p, ids, "min", steps)
    p, d0 = kernels.chain_cut(p, pf, m, nxt, ovl_next)
    head, _ = kernels.pointer_jump(p, None, "none", steps)
    _, dist = kernels.pointer_jump(p, d0, "add", steps)
    return UnitigLabels(head, dist, nxt, ovl_next, outdeg, indeg)
