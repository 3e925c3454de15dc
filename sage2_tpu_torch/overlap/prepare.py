"""Read deduplication and both-strand augmentation (port of
sage2_tpu/overlap/prepare.py, fixed-length reads).

The vertex set is {each unique read, its reverse complement}: for
capacity N, vertex i in [0, N) is unique read i forward and vertex
i + N its reverse complement. Duplicate reads (including a read equal
to another's reverse complement) collapse into one vertex with a
multiplicity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sage2_tpu_torch.ops import bitpack
from sage2_tpu_torch.ops.sort import words_less


class ReadSet(NamedTuple):
    """Deduplicated, RC-augmented read set (static capacity 2N).

    reads2: (2N, L) codes — row i: unique read i, row i+N: its RC; rows
    >= n_unique (mod N) are padding. valid2: (2N,) bool. multiplicity:
    (2N,) int32 input copies collapsed into each vertex (mirrored for RC
    rows). n_unique: unique canonical reads. vertex_of_read: (N,) vertex
    of each input read in its own orientation.
    """

    reads2: torch.Tensor
    valid2: torch.Tensor
    multiplicity: torch.Tensor
    n_unique: int
    vertex_of_read: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.reads2.shape[0] // 2


def _sort_rows(words: torch.Tensor) -> torch.Tensor:
    """Stable order of rows by their words (lexicographic): chained
    stable sorts from the last word to the first."""
    order = torch.arange(words.shape[0], device=words.device)
    for j in reversed(range(words.shape[1])):
        order = order[torch.sort(words[order, j], stable=True).indices]
    return order


def prepare_reads(
    reads: torch.Tensor, lengths: Optional[torch.Tensor] = None
) -> ReadSet:
    """Collapse exact/RC duplicate reads and add RC rows.

    The canonical form of a read is the word-lexicographic min of the
    read and its reverse complement; a stable sort of the canonical
    words groups duplicates, and each group keeps its first input read
    in canonical orientation.
    """
    if lengths is not None:
        raise NotImplementedError(
            "ragged reads are not ported yet (ROADMAP Queue 1 item 10)")
    N, L = reads.shape
    dev = reads.device
    rc = bitpack.revcomp_codes(reads)
    fwd_w = bitpack.pack_read_words(reads)
    rc_w = bitpack.pack_read_words(rc)
    take_rc = words_less(rc_w, fwd_w)
    canon_w = torch.where(take_rc[:, None], rc_w, fwd_w)
    canon = torch.where(take_rc[:, None], rc, reads)

    s_order = _sort_rows(canon_w)
    s_w = canon_w[s_order]
    neq = torch.ones(N, dtype=torch.bool, device=dev)
    neq[1:] = (s_w[1:] != s_w[:-1]).any(dim=1)
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

    reads2 = torch.cat([uniq, bitpack.revcomp_codes(uniq)], dim=0)
    return ReadSet(reads2, torch.cat([valid, valid]), torch.cat([mult, mult]),
                   n_unique, vertex_of_read)
