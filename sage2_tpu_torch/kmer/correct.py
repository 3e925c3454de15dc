"""Spectrum-based read error correction, the two-phase single_window
path (port of sage2_tpu/kmer/correct.py:245-425).

A base is corrected when the k-mer covering it is weak (count below
threshold) and exactly one alternative base makes that k-mer solid.
Each round recounts, prunes the table to its solid entries, and runs a
FORWARD sub-pass (variants of each window's last base) and then a
BACKWARD sub-pass (first base), each in two phases:

  phase 1  canonical key of every window (K1), table lookup (K2), and
           the flat indices of the weak windows;
  phase 2  the 4 variant keys of each weak window, one lookup (K2) of
           all of them, the replacement rule, and the edits.

Both cuts of the reference (lookups only for weak windows; a table
without sub-threshold entries) leave every verdict unchanged, so the
result is bit-identical to the dense corrector.
"""

from __future__ import annotations

from typing import Optional

import torch

from sage2_tpu_torch.kmer.count import KmerTable, count_kmers, lookup_counts
from sage2_tpu_torch.ops import bitpack


def prune_table_for_correction(table: KmerTable, threshold: int) -> KmerTable:
    """Drop sub-threshold entries (they can change no verdict); the
    kept entries stay sorted."""
    keep = table.count >= threshold
    keys = table.keys[keep]
    return KmerTable(keys, table.count[keep], keys.shape[0], table.k)


def _phase1_kernel(canon: torch.Tensor, pruned: KmerTable,
                   threshold: int) -> torch.Tensor:
    """Flat (row-major) indices of the weak windows, ascending."""
    weak = lookup_counts(pruned, canon) < threshold
    return torch.nonzero(weak.reshape(-1)).reshape(-1)


def _phase2_kernel(reads: torch.Tensor, fwd: torch.Tensor, rc: torch.Tensor,
                   pruned: KmerTable, k: int, threshold: int, which: str,
                   widx: torch.Tensor) -> torch.Tensor:
    """Apply the replacement rule to the weak windows ``widx``; window w
    edits base w + (k - 1 if which == "last" else 0)."""
    N, L = reads.shape
    P = L - k + 1
    off = k - 1 if which == "last" else 0
    row = widx // P
    target = row * L + widx % P + off
    flat = reads.reshape(-1)
    cur = flat[target].to(torch.int64)
    wf = fwd.reshape(-1)[widx]
    wr = rc.reshape(-1)[widx]
    # the window's base at k-mer position `pos` is base k-1-pos of its
    # reverse complement, with the complemented code
    pos = k - 1 if which == "last" else 0
    variants = []
    for b in range(4):
        vf = bitpack.set_base(wf, k, pos, cur, torch.full_like(cur, b))
        vr = bitpack.set_base(wr, k, k - 1 - pos, 3 - cur,
                              torch.full_like(cur, 3 - b))
        variants.append(torch.minimum(vf, vr))
    cnt4 = lookup_counts(pruned, torch.stack(variants, dim=1))  # (n, 4)
    m = cnt4.max(dim=1).values
    n_at_max = (cnt4 == m[:, None]).sum(dim=1)
    cur_cnt = cnt4.gather(1, cur[:, None]).reshape(-1)
    best = cnt4.argmax(dim=1).to(reads.dtype)
    replace = (cur_cnt < threshold) & (m >= threshold) & (n_at_max == 1)
    # edit targets are unique within a sub-pass (weak windows are
    # distinct, window w edits base w + off)
    new = reads.clone()
    new.reshape(-1)[target[replace]] = best[replace]
    return new


def twophase_round(reads: torch.Tensor, pruned: KmerTable, k: int,
                   threshold: int) -> torch.Tensor:
    """One forward + backward round of the single_window rule against an
    already-pruned table."""
    for which in ("last", "first"):
        fwd, rc, canon = bitpack.kmer_keys(reads, k)
        widx = _phase1_kernel(canon, pruned, threshold)
        reads = _phase2_kernel(reads, fwd, rc, pruned, k, threshold, which,
                               widx)
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
    table (later rounds recount)."""
    if lengths is not None:
        raise NotImplementedError(
            "ragged reads are not ported yet (ROADMAP Queue 1 item 10)")
    for r in range(rounds):
        t = table if (r == 0 and table is not None) else count_kmers(reads, k)
        reads = twophase_round(reads, prune_table_for_correction(t, threshold),
                               k, threshold)
    return reads
