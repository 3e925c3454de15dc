"""Exact canonical k-mer counting (port of sage2_tpu/kmer/count.py).

Canonical keys of every window (kernel K1), one ``torch.sort``, and the
run accounting of kernel K11 give a sorted table of unique keys with
their counts; queries against it are binary searches (kernel K2).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sage2_tpu_torch import kernels
from sage2_tpu_torch.ops import bitpack


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
    """Count canonical k-mers of (N, L) int32 reads. ``lengths``: (N,)
    per-read lengths of ragged (0-padded) reads; windows past a read's
    end are not counted."""
    if not 1 < k <= 31:
        raise ValueError(f"k must be in (1, 31], got {k}")
    _, _, canon = bitpack.kmer_keys(reads, k)
    valid = None
    if lengths is not None:
        valid = window_mask(lengths, reads.shape[1], k).reshape(-1)
    return count_from_keys(canon.reshape(-1), k, valid)


def window_mask(lengths: torch.Tensor, L: int, k: int) -> torch.Tensor:
    """(N, L - k + 1) bool: window p lies inside its read, p < len - k
    + 1 (sage2_tpu/kmer/count.py:47-50)."""
    P = L - k + 1
    return (torch.arange(P, device=lengths.device)[None, :]
            < lengths.to(torch.int64)[:, None] - (k - 1))


def count_from_keys(keys: torch.Tensor, k: int,
                    valid: Optional[torch.Tensor] = None) -> KmerTable:
    """Build a sorted count table from raw canonical keys (invalid ones
    masked out by ``valid``): one torch.sort, then each run's key and
    length (kernel K11)."""
    if valid is not None:
        keys = keys[valid]
    uniq, counts = kernels.merge_runs(torch.sort(keys).values)
    # K11's outputs sit in buffers as long as its input; a count table
    # lives through a correction round, so it gets storage of its own
    # size once that holds over twice its bytes (24 bytes a unique key
    # copied, 12 a key of the input freed)
    if uniq.untyped_storage().nbytes() > 2 * uniq.nbytes:
        uniq, counts = uniq.clone(), counts.clone()
    return KmerTable(uniq, counts, uniq.shape[0], k)


def lookup_counts(table: KmerTable, queries: torch.Tensor) -> torch.Tensor:
    """Counts of canonical query keys (0 where absent); any query shape.

    The reference joined table and queries in one combined sort; on the
    card kernel K2 builds a bucket directory over the sorted table, then
    each query searches only its bucket."""
    return kernels.lookup_counts(table.keys, table.count, queries)
