"""Assembly statistics: contig counts, N50/L50, and alignment-based
reference validation (genome fraction, misassembly count).

Matches the reference's final reporting stage (SURVEY.md §2
"Output/stats") plus the QUAST-style reference metrics the acceptance
configs ask for (BASELINE.json configs #1/#5: N50/misassembly parity on
noisy data). Round 1 used exact-substring matching, which reads 0 the
moment a contig carries one residual error; round 2 replaces it with a
seed-and-extend alignment built on the repo's own k-mer machinery:
anchor k-mers vote for diagonals (substitution-only alignment — the
pipeline and simulator introduce no indels), and each sufficiently
identical diagonal block contributes its MATCHING positions to genome
coverage. On exact assemblies the numbers coincide with the exact
method (every base of a verbatim contig matches on one diagonal).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def nx_metric(lengths: List[int], x: float = 0.5) -> int:
    """Nx: largest l such that contigs >= l cover >= x of total bases."""
    if not lengths:
        return 0
    arr = np.sort(np.asarray(lengths))[::-1]
    csum = np.cumsum(arr)
    target = x * csum[-1]
    idx = int(np.searchsorted(csum, target))
    return int(arr[min(idx, len(arr) - 1)])


def assembly_stats(contigs: List[np.ndarray],
                   genome: Optional[np.ndarray] = None) -> Dict[str, float]:
    lengths = [len(c) for c in contigs]
    total = int(sum(lengths))
    out: Dict[str, float] = {
        "n_contigs": len(contigs),
        "total_bases": total,
        "max_contig": max(lengths) if lengths else 0,
        "n50": nx_metric(lengths, 0.5),
        "n90": nx_metric(lengths, 0.9),
    }
    if genome is not None:
        out["genome_len"] = int(len(genome))
        out["genome_fraction"] = genome_fraction(contigs, genome)
    return out


# --------------------------------------------------------------------------
# seed-and-extend alignment (substitution-only)
# --------------------------------------------------------------------------

_ALIGN_K = 21          # anchor k-mer length (42 bits in uint64)
_ANCHOR_STRIDE = 64    # one anchor every this many contig bases
_MAX_HITS = 8          # genome occurrences considered per anchor
_MAX_DIAGONALS = 16    # diagonals evaluated per contig strand


def _pack_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """uint64 values of all k-mers (big-endian base-4)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    v = np.zeros(n, np.uint64)
    c = codes.astype(np.uint64)
    for j in range(k):
        v = (v << np.uint64(2)) | c[j : j + n]
    return v


class GenomeIndex:
    """Sorted k-mer index of a reference genome (host side)."""

    def __init__(self, genome: np.ndarray, k: int = _ALIGN_K):
        self.genome = np.asarray(genome, dtype=np.int8)
        self.k = k
        v = _pack_kmers(self.genome, k)
        self.order = np.argsort(v, kind="stable").astype(np.int64)
        self.sorted_v = v[self.order]

    def lookup(self, kval: np.uint64, max_hits: int = _MAX_HITS):
        lo = int(np.searchsorted(self.sorted_v, kval, side="left"))
        hi = int(np.searchsorted(self.sorted_v, kval, side="right"))
        return self.order[lo : min(hi, lo + max_hits)]


def _align_strand(
    seq: np.ndarray, idx: GenomeIndex, min_identity: float
) -> Tuple[float, List[Tuple[int, np.ndarray]]]:
    """Best single-diagonal contig coverage + identity-gated blocks.

    Returns (best_fraction_of_contig_matched, blocks) where each block
    is (genome_start, matched_mask) for a diagonal whose overlap-region
    identity >= min_identity.
    """
    g = idx.genome
    k = idx.k
    m = len(seq) - k + 1
    if m <= 0:
        return 0.0, []
    kv = _pack_kmers(seq, k)
    anchors = list(range(0, m, _ANCHOR_STRIDE))
    if anchors[-1] != m - 1:
        anchors.append(m - 1)
    votes: Dict[int, int] = {}
    for a in anchors:
        for gpos in idx.lookup(kv[a]):
            d = int(gpos) - a
            votes[d] = votes.get(d, 0) + 1
    best_frac = 0.0
    blocks: List[Tuple[int, np.ndarray]] = []
    top = sorted(votes.items(), key=lambda kvp: (-kvp[1], kvp[0]))
    for d, _n in top[:_MAX_DIAGONALS]:
        c_lo = max(0, -d)
        c_hi = min(len(seq), len(g) - d)
        if c_hi - c_lo < k:
            continue
        cseg = seq[c_lo:c_hi]
        gseg = g[c_lo + d : c_hi + d]
        match = cseg == gseg
        identity = float(match.mean())
        frac = float(match.sum()) / len(seq)
        best_frac = max(best_frac, frac)
        if identity >= min_identity:
            blocks.append((c_lo + d, match))
    return best_frac, blocks


def genome_fraction(
    contigs: List[np.ndarray],
    genome: np.ndarray,
    min_identity: float = 0.95,
) -> float:
    """Fraction of genome positions matched by an aligned contig block.

    Seed-and-extend: anchor k-mers vote diagonals; every diagonal block
    with identity >= min_identity marks its MATCHING genome positions.
    Equals the exact-substring fraction on exact assemblies; degrades
    gracefully (per-base) when contigs carry residual errors.
    """
    if len(genome) == 0:
        return 0.0
    idx = GenomeIndex(np.asarray(genome, dtype=np.int8))
    covered = np.zeros(len(genome), bool)
    for c in contigs:
        c = np.asarray(c, dtype=np.int8)
        for seq in (c, (3 - c)[::-1]):
            _frac, blocks = _align_strand(seq, idx, min_identity)
            for gstart, match in blocks:
                covered[gstart : gstart + len(match)] |= match
    return float(covered.mean())


def count_misassembled(
    contigs: List[np.ndarray],
    genome: np.ndarray,
    min_identity: float = 0.95,
) -> int:
    """Contigs with no single-diagonal placement explaining them.

    A contig is misassembled when neither strand has one diagonal whose
    matches cover >= min_identity of its length — i.e. it cannot be laid
    onto the reference in one piece (relocation / chimeric join), even
    allowing substitution errors. Alignment-based stand-in for QUAST
    misassembly counting (SURVEY.md §4); agrees with the round-1 exact
    check on exact assemblies.
    """
    idx = GenomeIndex(np.asarray(genome, dtype=np.int8))
    bad = 0
    for c in contigs:
        c = np.asarray(c, dtype=np.int8)
        best = 0.0
        for seq in (c, (3 - c)[::-1]):
            frac, _blocks = _align_strand(seq, idx, min_identity)
            best = max(best, frac)
        if best < min_identity:
            bad += 1
    return bad
