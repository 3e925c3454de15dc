"""Read deduplication and both-strand augmentation (port of
sage2_tpu/overlap/prepare.py, fixed-length and ragged reads).

The vertex set is {each unique read, its reverse complement}: for
capacity N, vertex i in [0, N) is unique read i forward and vertex
i + N its reverse complement. Duplicate reads (including a read equal
to another's reverse complement) collapse into one vertex with a
multiplicity. Kernel K8 gives each read's reverse complement, both
packings and the canonical choice in one pass.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sage2_tpu_torch import kernels


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


def _sort_rows(words: torch.Tensor,
               lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable order of rows by (length, words...) lexicographically
    (by the words alone without lengths): chained stable sorts from the
    last word to the first, the length last."""
    order = torch.arange(words.shape[0], device=words.device)
    for j in reversed(range(words.shape[1])):
        order = order[torch.sort(words[order, j], stable=True).indices]
    if lengths is not None:
        order = order[torch.sort(lengths[order], stable=True).indices]
    return order


def prepare_reads(
    reads: torch.Tensor, lengths: Optional[torch.Tensor] = None
) -> ReadSet:
    """Collapse exact/RC duplicate reads and add RC rows.

    The canonical form of a read is the word-lexicographic min of the
    read and its reverse complement; a stable sort of the canonical
    words groups duplicates, and each group keeps its first input read
    in canonical orientation. For ragged reads (``lengths`` (N,) int32,
    padding zeroed here) the length is the leading sort key, so a read
    is a duplicate only of an equal-length read; containments are the
    overlap stage's.
    """
    N, L = reads.shape
    dev = reads.device
    if lengths is not None:
        lengths = lengths.to(torch.int32)
        reads = torch.where(
            torch.arange(L, device=dev)[None, :] < lengths[:, None],
            reads, 0)
    rc, fwd_w, rc_w, take_rc = kernels.canonical_reads(reads, lengths)
    canon_w = torch.where(take_rc[:, None], rc_w, fwd_w)
    canon = torch.where(take_rc[:, None], rc, reads)

    s_order = _sort_rows(canon_w, lengths)
    s_w = canon_w[s_order]
    neq = torch.ones(N, dtype=torch.bool, device=dev)
    neq[1:] = (s_w[1:] != s_w[:-1]).any(dim=1)
    if lengths is not None:
        s_len = lengths[s_order]
        neq[1:] |= s_len[1:] != s_len[:-1]
    group_id = torch.cumsum(neq.to(torch.int64), 0) - 1
    n_unique = int(group_id[-1]) + 1 if N else 0

    rep = s_order[neq]                                  # (n_unique,)
    mult = torch.zeros(N, dtype=torch.int32, device=dev)
    mult[:n_unique] = torch.bincount(group_id, minlength=n_unique).to(
        torch.int32)
    uniq = torch.zeros_like(reads)
    uniq[:n_unique] = canon[rep]
    valid = torch.arange(N, device=dev) < n_unique

    gid = torch.empty(N, dtype=torch.int64, device=dev)
    gid[s_order] = group_id
    vertex_of_read = (gid + take_rc.to(torch.int64) * N).to(torch.int32)

    lengths2 = lens_u = None
    if lengths is not None:
        lens_u = torch.zeros_like(lengths)
        lens_u[:n_unique] = lengths[rep]
        lengths2 = torch.cat([lens_u, lens_u])
    rc_u = kernels.canonical_reads(uniq, lens_u, True)[0]   # RC only
    reads2 = torch.cat([uniq, rc_u], dim=0)
    return ReadSet(reads2, torch.cat([valid, valid]), torch.cat([mult, mult]),
                   n_unique, vertex_of_read, lengths2)
