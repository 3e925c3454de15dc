"""Exact canonical k-mer counting (port of sage2_tpu/kmer/count.py).

Canonical keys of every window (kernel K1), one ``torch.sort``, and run
accounting give a sorted table of unique keys with their counts;
queries against it are binary searches (kernel K2).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sage2_tpu_torch import kernels
from sage2_tpu_torch.ops import bitpack
from sage2_tpu_torch.ops.sort import unique_sorted_pairs


class KmerTable(NamedTuple):
    """Sorted canonical k-mer count table on the device.

    keys: (n_unique,) int64 canonical keys, ascending (the reference's
    first n_unique (hi, lo) rows; it pads to a static capacity, the port
    does not); count: (n_unique,) int32.
    """

    keys: torch.Tensor
    count: torch.Tensor
    n_unique: int
    k: int


def count_kmers(
    reads: torch.Tensor, k: int, lengths: Optional[torch.Tensor] = None
) -> KmerTable:
    """Count canonical k-mers of (N, L) int32 reads."""
    if lengths is not None:
        raise NotImplementedError(
            "ragged reads are not ported yet (ROADMAP Queue 1 item 10)")
    if not 1 < k <= 31:
        raise ValueError(f"k must be in (1, 31], got {k}")
    _, _, canon = bitpack.kmer_keys(reads, k)
    return count_from_keys(canon.reshape(-1), k)


def count_from_keys(keys: torch.Tensor, k: int,
                    valid: Optional[torch.Tensor] = None) -> KmerTable:
    """Build a sorted count table from raw canonical keys (invalid ones
    masked out by ``valid``)."""
    if valid is not None:
        keys = keys[valid]
    s = torch.sort(keys).values
    is_head, group_id = unique_sorted_pairs(
        s, torch.ones_like(s, dtype=torch.bool))
    counts = torch.bincount(group_id, minlength=int(is_head.sum()))
    return KmerTable(s[is_head], counts.to(torch.int32), counts.shape[0], k)


def lookup_counts(table: KmerTable, queries: torch.Tensor) -> torch.Tensor:
    """Counts of canonical query keys (0 where absent); any query shape.

    The reference joined table and queries in one combined sort; on the
    card each query binary-searches the sorted table (kernel K2)."""
    return kernels.lookup_counts(table.keys, table.count, queries)
