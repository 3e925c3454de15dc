"""Synthetic genome / Illumina-read simulation.

The environment has no network and the reference mount is empty
(SURVEY.md §0), so the acceptance datasets (E. coli, S. aureus GAGE-B,
...) cannot be downloaded. This module generates reproducible stand-ins:
random (optionally repeat-seeded) genomes and uniform-coverage error-prone
fixed-length reads from both strands, written as arrays or FASTQ.
"""

from __future__ import annotations

import gzip
from typing import Optional, Tuple

import numpy as np


def simulate_genome(
    length: int,
    seed: int = 0,
    repeat_fraction: float = 0.0,
    repeat_len: int = 500,
) -> np.ndarray:
    """Random genome as 2-bit codes, with optional exact repeats.

    ``repeat_fraction`` of the genome is covered by copies of a single
    repeat unit, emulating the repetitive structure that stresses the
    overlap graph (bubbles / tangles).
    """
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=length, dtype=np.int8)
    if repeat_fraction > 0:
        unit = rng.integers(0, 4, size=repeat_len, dtype=np.int8)
        n_copies = max(1, int(length * repeat_fraction / repeat_len))
        for _ in range(n_copies):
            pos = int(rng.integers(0, max(1, length - repeat_len)))
            g[pos : pos + repeat_len] = unit[: max(0, min(repeat_len, length - pos))]
    return g.astype(np.int8)


def simulate_complex_genome(
    total_length: int,
    seed: int = 0,
    n_chromosomes: int = 2,
    dispersed_families: int = 3,
    dispersed_copies: int = 20,
    dispersed_len: int = 800,
    tandem_loci: int = 10,
    tandem_unit: int = 150,
    tandem_copies: int = 5,
    divergence: float = 0.0,
) -> list:
    """Repeat-rich multi-chromosome genome (BASELINE.json config #5
    complexity rehearsal: human-like repeat structure at reduced scale).

    Structure: ``n_chromosomes`` random chromosomes summing to
    ``total_length``; ``dispersed_families`` repeat families, each
    planted at ``dispersed_copies`` random loci across ALL chromosomes
    (interspersed LINE/SINE-like repeats — the classic assembly
    tangles); ``tandem_loci`` sites per genome where a short unit is
    repeated ``tandem_copies`` times consecutively (satellite-like).
    ``divergence`` mutates each planted copy independently (0 = exact
    copies, the hardest case for an overlap graph).

    Returns a list of int8 code arrays (one per chromosome).
    """
    rng = np.random.default_rng(seed)
    lens = np.full(n_chromosomes, total_length // n_chromosomes)
    lens[0] += total_length - lens.sum()
    chroms = [
        rng.integers(0, 4, size=int(ln), dtype=np.int8) for ln in lens
    ]

    def mutate(unit):
        if divergence <= 0:
            return unit
        m = rng.random(unit.shape) < divergence
        shift = rng.integers(1, 4, size=unit.shape)
        return np.where(m, (unit + shift) % 4, unit).astype(np.int8)

    # dispersed families planted across chromosomes
    for _ in range(dispersed_families):
        unit = rng.integers(0, 4, size=dispersed_len, dtype=np.int8)
        for _ in range(dispersed_copies):
            c = int(rng.integers(0, n_chromosomes))
            g = chroms[c]
            if len(g) <= dispersed_len:
                continue
            pos = int(rng.integers(0, len(g) - dispersed_len))
            g[pos : pos + dispersed_len] = mutate(unit)

    # tandem (satellite-like) arrays
    for _ in range(tandem_loci):
        unit = rng.integers(0, 4, size=tandem_unit, dtype=np.int8)
        arr = np.concatenate([mutate(unit) for _ in range(tandem_copies)])
        c = int(rng.integers(0, n_chromosomes))
        g = chroms[c]
        if len(g) <= len(arr):
            continue
        pos = int(rng.integers(0, len(g) - len(arr)))
        g[pos : pos + len(arr)] = arr
    return chroms


def simulate_reads(
    genome: np.ndarray,
    read_len: int = 100,
    coverage: float = 30.0,
    error_rate: float = 0.0,
    seed: int = 1,
    both_strands: bool = True,
    circular: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform-coverage fixed-length reads with substitution errors.

    Returns (reads (N, read_len) int8 codes, true_positions (N,) int64).
    Positions of reverse-strand reads refer to the forward genome
    coordinate of the read's first sampled base.
    """
    rng = np.random.default_rng(seed)
    G = len(genome)
    if circular:
        n_reads = int(np.ceil(coverage * G / read_len))
        starts = rng.integers(0, G, size=n_reads)
        idx = (starts[:, None] + np.arange(read_len)[None, :]) % G
        reads = genome[idx].astype(np.int8)
    else:
        span = G - read_len + 1
        if span <= 0:
            raise ValueError("genome shorter than read length")
        n_reads = int(np.ceil(coverage * G / read_len))
        starts = rng.integers(0, span, size=n_reads)
        idx = starts[:, None] + np.arange(read_len)[None, :]
        reads = genome[idx].astype(np.int8)
    if both_strands:
        flip = rng.random(n_reads) < 0.5
        reads[flip] = (3 - reads[flip])[:, ::-1]
    if error_rate > 0:
        err = rng.random(reads.shape) < error_rate
        shift = rng.integers(1, 4, size=reads.shape)
        reads = np.where(err, (reads + shift) % 4, reads).astype(np.int8)
    return reads, starts.astype(np.int64)


def simulate_read_pairs(
    genome: np.ndarray,
    read_len: int = 100,
    coverage: float = 30.0,
    insert_mean: int = 400,
    insert_sd: int = 30,
    error_rate: float = 0.0,
    seed: int = 1,
    both_strands: bool = True,
    exclude: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Paired-end (FR) Illumina-like reads (BASELINE.json config #1:
    "Illumina 100bp paired").

    Fragments of ~``insert_mean`` bases are sampled uniformly; each yields
    R1 = the fragment's left ``read_len`` bases read forward and R2 = the
    reverse complement of its right ``read_len`` bases — both mates'
    stored orientations point INTO the fragment. ``both_strands`` flips
    whole fragments (swapping which mate is leftmost on the forward
    genome). ``exclude``: an (start, end) genome window; fragments whose
    READS overlap it are dropped (reads spanning it only via the insert
    gap survive) — used to manufacture a coverage gap that breaks
    assembly into two contigs joinable only by mate pairs.

    Returns (reads (2N, read_len) int8, mate_of (2N,) int64, frag_starts
    (N,) int64): mate rows are i and i + N, mate_of matches
    io.load_read_pairs' convention.
    """
    rng = np.random.default_rng(seed)
    G = len(genome)
    n_pairs = int(np.ceil(coverage * G / (2 * read_len)))
    inserts = np.clip(
        np.rint(rng.normal(insert_mean, insert_sd, n_pairs)).astype(np.int64),
        2 * read_len, None,
    )
    span = G - inserts
    if np.any(span < 1):
        raise ValueError("genome shorter than insert size")
    starts = (rng.random(n_pairs) * span).astype(np.int64)
    if exclude is not None:
        lo, hi = exclude
        r1_bad = (starts < hi) & (starts + read_len > lo)
        r2_lo = starts + inserts - read_len
        r2_bad = (r2_lo < hi) & (r2_lo + read_len > lo)
        keep = ~(r1_bad | r2_bad)
        starts, inserts = starts[keep], inserts[keep]
        n_pairs = len(starts)
    idx = np.arange(read_len)[None, :]
    r1 = genome[starts[:, None] + idx].astype(np.int8)
    r2_fwd = genome[(starts + inserts - read_len)[:, None] + idx]
    r2 = (3 - r2_fwd)[:, ::-1].astype(np.int8)
    if both_strands:
        flip = rng.random(n_pairs) < 0.5
        r1f, r2f = r1[flip].copy(), r2[flip].copy()
        # flipping the fragment strand swaps the mates' roles
        r1[flip], r2[flip] = r2f, r1f
    reads = np.concatenate([r1, r2], axis=0)
    if error_rate > 0:
        err = rng.random(reads.shape) < error_rate
        shift = rng.integers(1, 4, size=reads.shape)
        reads = np.where(err, (reads + shift) % 4, reads).astype(np.int8)
    mate_of = np.concatenate([
        np.arange(n_pairs, 2 * n_pairs), np.arange(n_pairs)
    ]).astype(np.int64)
    return reads, mate_of, starts


def write_fastq(
    path: str, reads: np.ndarray, quality: int = 40, name_prefix: str = "sim"
) -> None:
    """Write code-array reads as (optionally gzipped) FASTQ."""
    from sage2_tpu_torch.ops.bitpack import decode_to_ascii

    opener = gzip.open if path.endswith(".gz") else open
    q = chr(quality + 33) * reads.shape[1]
    with opener(path, "wt") as f:
        for i, r in enumerate(reads):
            f.write(
                f"@{name_prefix}_{i}\n{decode_to_ascii(r).tobytes().decode()}\n+\n{q}\n"
            )
