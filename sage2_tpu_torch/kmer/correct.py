"""Spectrum-based read error correction (port of
sage2_tpu/kmer/correct.py): ``correct_reads`` with both rules.

``rule="single_window"`` runs the two-phase path (:245-425), which
gives the dense corrector's result bit for bit (the reference proves it,
tests/test_correct.py::test_twophase_matches_dense, and argues it at
:217-243). ``rule="vote_all_windows"`` runs the covering-window voting
rule (voting_round :134, _correct_voting_impl :190), one launch of
kernel K5 a round.

Single window: a base is corrected when the k-mer covering it is weak
(count below threshold) and exactly one alternative base makes that
k-mer solid.
Each round recounts, prunes the table to its solid entries (kernel K15),
builds the pruned table's bucket directory once (K2's first launch) and
beside it a membership table of its solid keys (K16's build), and runs a
FORWARD sub-pass (variants of each window's last base) and then a
BACKWARD sub-pass (first base), each in two phases:

  phase 1  the flat indices of the weak windows (kernel K16: each
           window's canonical key from the read, its membership among the
           solid keys, the weak mask, the indices in order);
  phase 2  the 4 variant keys of each weak window, their lookups, the
           replacement rule and the edits (kernel K17).

Both cuts of the reference (lookups only for weak windows; a table
without sub-threshold entries) leave every verdict unchanged, so the
result is bit-identical to the dense corrector.

Ragged reads (``lengths``): windows past a read's end are never weak
(single_window) and cast no vote (vote_all_windows, K5 with a length per
read), and the recounts mask them out of the table.
"""

from __future__ import annotations

from typing import Optional

import torch

from sage2_tpu_torch import kernels
from sage2_tpu_torch.kmer.count import KmerTable, count_kmers


def prune_table_for_correction(table: KmerTable, threshold: int) -> KmerTable:
    """Drop sub-threshold entries (they can change no verdict); the
    kept entries stay sorted (kernel K15). On the card the result's keys
    and counts are views of one buffer of ``table``'s size
    (kernels.prune_table): a caller done with ``table`` drops it before
    the round, as ``correct_reads`` and stream.correct_reads_chunked do."""
    keys, count = kernels.prune_table(table.keys, table.count, threshold)
    return KmerTable(keys, count, keys.shape[0], table.k)


def _phase1_kernel(reads: torch.Tensor, pruned: KmerTable, threshold: int,
                   lengths: Optional[torch.Tensor] = None,
                   directory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat (row-major) indices of the weak windows, ascending; with
    ``lengths`` only windows inside their read (kernel K16).
    ``directory``: the pruned table's bucket directory and membership
    table (kernels.table_directory), shared by the round's sub-passes."""
    return kernels.weak_windows(reads, lengths, pruned.keys, pruned.count,
                                directory, pruned.k, threshold)


def _phase2_kernel(reads: torch.Tensor, pruned: KmerTable, threshold: int,
                   which: str, widx: torch.Tensor,
                   directory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply the replacement rule to the weak windows ``widx``; window w
    edits base w + (k - 1 if which == "last" else 0) (kernel K17)."""
    return kernels.fix_windows(reads, widx, pruned.keys, pruned.count,
                               directory, pruned.k, threshold, which)


def twophase_round(reads: torch.Tensor, pruned: KmerTable, k: int,
                   threshold: int,
                   lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One forward + backward round of the single_window rule against an
    already-pruned table: K16 and K17 for each sub-pass, around one
    bucket directory of the table and K16's membership table of its
    solid keys."""
    if pruned.k != k:
        raise ValueError(f"table of {pruned.k}-mers for k = {k}")
    if lengths is not None:
        lengths = lengths.to(torch.int32).contiguous()
    directory = kernels.table_directory(pruned.keys, pruned.count, k,
                                        threshold)
    for which in ("last", "first"):
        widx = _phase1_kernel(reads, pruned, threshold, lengths, directory)
        reads = _phase2_kernel(reads, pruned, threshold, which, widx,
                               directory)
    return reads


def correct_reads_twophase(
    reads: torch.Tensor,
    k: int,
    threshold: int,
    rounds: int,
    table: Optional[KmerTable] = None,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Correct (N, L) int32 reads; ``table``: the first round's count
    table (later rounds recount); ``lengths``: (N,) per-read lengths of
    ragged reads."""
    return _rounds(twophase_round, reads, k, threshold, rounds, table,
                   lengths)


def voting_round(reads: torch.Tensor, table: KmerTable, k: int,
                 threshold: int,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One round of the covering-window voting rule (semantics pinned by
    oracle_correct_voting): for each base and each candidate base b, the
    number of covering windows whose k-mer with b there is solid; the
    base becomes the unique best-voted base when that beats its own
    vote. Kernel K5 (its bucket directory, then the vote) against the
    table pruned to its solid entries (which changes no verdict).
    ``lengths``: (N,) per-read lengths of ragged reads, or None."""
    return voting_round_pruned(reads, prune_table_for_correction(
        table, threshold), k, threshold, lengths)


def voting_round_pruned(reads: torch.Tensor, pruned: KmerTable, k: int,
                        threshold: int,
                        lengths: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``voting_round`` against an already-pruned table."""
    if lengths is not None:
        lengths = lengths.to(torch.int32).contiguous()
    return kernels.vote_windows(reads, pruned.keys, pruned.count, k,
                                threshold, lengths)


def correct_reads(
    reads: torch.Tensor,
    k: int,
    threshold: int,
    rounds: int,
    table: Optional[KmerTable] = None,
    lengths: Optional[torch.Tensor] = None,
    rule: str = "single_window",
) -> torch.Tensor:
    """Correct (N, L) int32 reads; ``table``: the first round's count
    table (later rounds recount). ``rule``: "single_window" (forward
    and backward sub-passes, one covering window per base) or
    "vote_all_windows" (voting across every covering window).
    ``lengths``: (N,) per-read lengths of ragged (0-padded) reads."""
    if rule not in ("single_window", "vote_all_windows"):
        raise ValueError(f"unknown correction rule {rule!r}")
    return _rounds(twophase_round if rule == "single_window"
                   else voting_round_pruned, reads, k, threshold, rounds,
                   table, lengths)


def _rounds(round_fn, reads, k, threshold, rounds, table, lengths):
    for _ in range(rounds):
        if table is None:
            table = count_kmers(reads, k, lengths)
        # the pruned entries are views of a buffer of the table's size
        # (kernels.prune_table): neither table outlives its round
        pruned, table = prune_table_for_correction(table, threshold), None
        reads = round_fn(reads, pruned, k, threshold, lengths)
        del pruned
    return reads
