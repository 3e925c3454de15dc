"""Read deduplication and both-strand augmentation (port of
sage2_tpu/overlap/prepare.py, fixed-length and ragged reads).

The vertex set is {each unique read, its reverse complement}: for
capacity N, vertex i in [0, N) is unique read i forward and vertex
i + N its reverse complement. Duplicate reads (including a read equal
to another's reverse complement) collapse into one vertex with a
multiplicity. Kernel K8 gives each read's packed words and canonical
choice in one pass (its reverse complement too where K12 needs it);
kernel K12 sorts and groups the canonical reads into the first half of
reads2, and K8 writes their reverse complements into the second half.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sage2_tpu_torch import kernels
from sage2_tpu_torch.utils.metrics import mark_part


class ReadSet(NamedTuple):
    """Deduplicated, RC-augmented read set (static capacity 2N).

    reads2: (2N, L) codes — row i: unique read i, row i+N: its RC; rows
    >= n_unique (mod N) are padding. valid2: (2N,) bool. multiplicity:
    (2N,) int32 input copies collapsed into each vertex (mirrored for RC
    rows). n_unique: unique canonical reads. vertex_of_read: (N,) vertex
    of each input read in its own orientation. lengths2: (2N,) int32
    per-vertex read lengths for ragged inputs (0 on padding rows), None
    for fixed-length reads.
    """

    reads2: torch.Tensor
    valid2: torch.Tensor
    multiplicity: torch.Tensor
    n_unique: int
    vertex_of_read: torch.Tensor
    lengths2: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.reads2.shape[0] // 2


def prepare_reads(
    reads: torch.Tensor, lengths: Optional[torch.Tensor] = None, split=None
) -> ReadSet:
    """Collapse exact/RC duplicate reads and add RC rows.

    The canonical form of a read is the word-lexicographic min of the
    read and its reverse complement; a stable sort of the canonical
    words groups duplicates, and each group keeps its first input read
    in canonical orientation (kernel K12 over K8's canonical words). For
    ragged reads (``lengths`` (N,) int32; codes past a length count as
    0) the length is the leading sort key, so a read is a duplicate only
    of an equal-length read; containments are the overlap stage's.
    ``split`` (utils.metrics.DeviceSplit) gets the ends of K8, the sort
    chain, the grouping and the reverse-complement rows.
    """
    N, L = reads.shape
    if lengths is not None:
        lengths = lengths.to(torch.int32)
    # K8's rows only where K12 reads them (its strings sorted in passes);
    # the arguments positional, as chip_smoke.py's capture keeps them
    words_only = not kernels.dedup_reads_rc(L, lengths is not None)
    rc, fwd_w, rc_w, take_rc = kernels.canonical_reads(reads, lengths,
                                                       False, words_only)
    mark_part(split, "k8")
    reads2 = torch.empty((2 * N, L), dtype=reads.dtype, device=reads.device)
    uniq, mult, vertex_of_read, n_unique, lens_u = kernels.dedup_reads(
        reads, lengths, rc, fwd_w, rc_w, take_rc, reads2[:N], split=split)
    del rc, fwd_w, rc_w, take_rc
    valid = torch.arange(N, device=reads.device) < n_unique
    # the unique rows' reverse complements, straight into reads2
    kernels.canonical_reads(uniq, lens_u, True, False, reads2[N:])
    mark_part(split, "rc_rows")
    return ReadSet(reads2, torch.cat([valid, valid]), torch.cat([mult, mult]),
                   n_unique, vertex_of_read,
                   None if lens_u is None else torch.cat([lens_u, lens_u]))
