"""Plain PyTorch versions of the four CUDA kernels.

Each function has the signature of its kernel's wrapper in
``sage2_tpu_torch.kernels`` and returns bit-identical results. The
wrappers run these for tensors on the CPU (the tests, and
``device="cpu"``); on the card, ``chip_smoke.py`` holds each kernel
against its plain version. They repeat the kernel's arithmetic with
whole-tensor ops and are no yardstick of speed.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from sage2_tpu_torch.ops.sort import expand_by_counts

_U32 = 0xFFFFFFFF


def _forward_keys(reads: torch.Tensor, k: int) -> torch.Tensor:
    """Forward keys of every window, int64, top bit flipped when k == 32.

    The value is accumulated as a high part (first k - n_lo bases) and a
    low part (last n_lo <= 16 bases), each below 2**32, so no int64
    arithmetic overflows: for k <= 31 the key is hi * 4**n_lo + lo; for
    k == 32 it is (hi - 2**31) * 2**32 + lo, the value with its top bit
    flipped.
    """
    L = reads.shape[-1]
    P = L - k + 1
    r = reads.to(torch.int64)
    n_lo = min(k, 16)

    def value(first: int, n: int) -> torch.Tensor:
        acc = torch.zeros(r.shape[:-1] + (P,), dtype=torch.int64,
                          device=r.device)
        for j in range(first, first + n):
            acc = acc * 4 + r[..., j : j + P]
        return acc

    hi = value(0, k - n_lo)
    lo = value(k - n_lo, n_lo)
    if k == 32:
        return (hi - (1 << 31)) * (1 << 32) + lo
    return hi * (1 << (2 * n_lo)) + lo


def kmer_keys(
    reads: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(fwd, rc, canonical) int64 keys of every length-k window.

    Window p's reverse complement is window P-1-p of the reverse-
    complemented read, so the RC keys are that read's forward keys with
    the window axis reversed (sage2_tpu/ops/bitpack.py:144).
    """
    fwd = _forward_keys(reads, k)
    rc = _forward_keys((3 - reads).flip(-1), k).flip(-1)
    return fwd, rc, torch.minimum(fwd, rc)


def lookup_counts(
    table: torch.Tensor, counts: torch.Tensor, queries: torch.Tensor
) -> torch.Tensor:
    """counts[i] where table[i] == query, else 0; any query shape.

    A whole-array lower-bound binary search with a fixed step count.
    """
    T = table.shape[0]
    q = queries.reshape(-1)
    if T == 0:
        return torch.zeros(queries.shape, dtype=torch.int32,
                           device=queries.device)
    lo = torch.zeros_like(q)
    hi = torch.full_like(q, T)
    for _ in range(math.ceil(math.log2(T + 1)) + 1):
        active = lo < hi
        mid = (lo + hi) >> 1
        right = table[mid.clamp(max=T - 1)] < q
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    at = lo.clamp(max=T - 1)
    found = (lo < T) & (table[at] == q)
    out = torch.where(found, counts[at], torch.zeros_like(counts[at]))
    return out.to(torch.int32).reshape(queries.shape)


def overlap_join(
    s_keys: torch.Tensor,
    s_rows: torch.Tensor,
    payload: torch.Tensor,
    R: int,
    g: int,
    trim: int,
    min_overlap: int,
):
    """(ok, cand_a, cand_b, ovl, total) of the sorted seed rows.

    ``s_keys``/``s_rows``: live seed rows sorted by key, entries before
    queries within a key; ``payload``: (rows, Wt + 2) int32 indexed by
    row id. One candidate per (query, entry of its run), in sorted
    query order and entry order within a query.
    """
    dev = s_keys.device
    n = s_keys.shape[0]
    idx = torch.arange(n, device=dev)
    is_head = torch.ones(n, dtype=torch.bool, device=dev)
    is_head[1:] = s_keys[1:] != s_keys[:-1]
    is_entry = (s_rows % R) < g
    run = torch.cumsum(is_head.to(torch.int64), 0) - 1
    run_start = idx[is_head]
    n_entries = torch.zeros(run_start.shape[0], dtype=torch.int64,
                            device=dev).index_add_(
        0, run, is_entry.to(torch.int64))
    counts = torch.where(is_entry, 0, n_entries[run])
    total = int(counts.sum())

    qi, rank, _ = expand_by_counts(counts, total)
    ei = run_start[run[qi]] + rank
    qid = s_rows[qi].to(torch.int64)
    eid = s_rows[ei].to(torch.int64)
    pa = payload[qid].to(torch.int64) & _U32
    pb = payload[eid].to(torch.int64) & _U32
    Wt = payload.shape[1] - 2

    cand_a = qid // R
    p = (qid % R - g + 1) * g
    cand_b = eid // R
    o = eid % R
    len_a = pa[:, Wt + 1]
    len_b = pb[:, Wt + 1]
    ovl = len_a - (p - o)
    match = cand_a != cand_b
    lc2 = 2 * torch.minimum(len_a - p, len_b - o)
    for t in range(Wt):
        vb = (lc2 - (t + trim) * 32).clamp(0, 32)
        diff = (pa[:, t] ^ pb[:, t]) >> (32 - vb).clamp(max=31)
        match &= (vb == 0) | (diff == 0)
    lhs = pa[:, Wt] & (torch.bitwise_left_shift(torch.ones_like(o), 2 * o) - 1)
    rhs = torch.where(o == 0, 0, pb[:, Wt] >> (32 - 2 * o).clamp(0, 31))
    match &= lhs == rhs
    ok = match & (ovl < len_b) & (ovl >= min_overlap)
    i32 = torch.int32
    return ok, cand_a.to(i32), cand_b.to(i32), ovl.to(i32), total


def pointer_jump(
    p: torch.Tensor, val: Optional[torch.Tensor] = None, op: str = "none"
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One doubling step: (p[p], op(val, val[p])) with op in
    "none" | "min" | "add" (int32, wrapping)."""
    pl = p.to(torch.int64)
    p_new = p[pl]
    if op == "none":
        return p_new, None
    if op == "min":
        return p_new, torch.minimum(val, val[pl])
    if op == "add":
        return p_new, val + val[pl]
    raise ValueError(f"unknown pointer_jump op {op!r}")
