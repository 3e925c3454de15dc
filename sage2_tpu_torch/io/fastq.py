"""FASTA/FASTQ(.gz) ingest: parse -> code arrays (port of
sage2_tpu/io/fastq.py). ``read_fastq`` takes the native C++ parser
(``io.native``) where a compiler is installed, the pure-Python reader
below otherwise; ``read_fasta`` and the ragged loader are Python, as in
the reference (the native FASTA parser keeps spaces around sequence
lines and drops sequence text before the first header; the Python
reader strips the one and keeps the other).

Fixed-length reads become (N, L) int8 code arrays ('N' -> A, matching
encode_ascii); ragged inputs are either trimmed/filtered to the
dominant length or rejected, per ``length_policy``.
"""

from __future__ import annotations

import gzip
from collections import Counter
from typing import List, Sequence

import numpy as np

from sage2_tpu_torch.ops.bitpack import encode_ascii


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _parse_fastq_py(data: bytes) -> List[bytes]:
    seqs = []
    lines = data.split(b"\n")
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i]
        if not line:
            i += 1
            continue
        if not line.startswith(b"@"):
            raise ValueError(f"malformed FASTQ at line {i}: {line[:30]!r}")
        if i + 1 >= n:
            break
        seqs.append(lines[i + 1].strip())
        i += 4
    return seqs


def _parse_fasta_py(data: bytes) -> List[bytes]:
    seqs = []
    cur: List[bytes] = []
    for line in data.split(b"\n"):
        if line.startswith(b">"):
            if cur:
                seqs.append(b"".join(cur))
                cur = []
        elif line.startswith(b";"):
            continue  # legacy FASTA comment line
        elif line:
            cur.append(line.strip())
    if cur:
        seqs.append(b"".join(cur))
    return seqs


def _to_array(
    seqs: Sequence[bytes], length_policy: str = "strict"
) -> np.ndarray:
    if not seqs:
        return np.zeros((0, 0), np.int8)
    lens = Counter(len(s) for s in seqs)
    if len(lens) > 1:
        if length_policy == "strict":
            raise ValueError(
                f"mixed read lengths {sorted(lens)}; use length_policy="
                "'trim' or 'filter'"
            )
        # dominant length; ties broken toward the smaller length (same
        # rule as the native parser)
        max_count = max(lens.values())
        target = min(l for l, c in lens.items() if c == max_count)
        if length_policy == "trim":
            seqs = [s[:target] for s in seqs if len(s) >= target]
        elif length_policy == "filter":
            seqs = [s for s in seqs if len(s) == target]
        else:
            raise ValueError(length_policy)
    buf = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    arr = buf.reshape(len(seqs), len(seqs[0]))
    return encode_ascii(arr).astype(np.int8)


def _to_ragged(seqs: Sequence[bytes]):
    """(reads padded with 0 to the max length, lengths) — the lossless
    ingest mode for mixed-length inputs (length_policy='pad';
    SURVEY.md §7 ragged idiom: pad-to-tile + masks)."""
    if not seqs:
        return np.zeros((0, 0), np.int8), np.zeros(0, np.int32)
    lens = np.array([len(s) for s in seqs], np.int32)
    Lmax = int(lens.max())
    arr = np.zeros((len(seqs), Lmax), np.int8)
    for i, s in enumerate(seqs):
        arr[i, : len(s)] = encode_ascii(
            np.frombuffer(s, dtype=np.uint8)
        ).astype(np.int8)
    return arr, lens


def _is_fasta(path: str) -> bool:
    """Format detection by CONTENT (first record byte: '>' FASTA,
    '@' FASTQ), with the extension as tie-break for empty files.
    Extension-only detection mis-parsed FASTQ content under a .fasta
    name as one giant record (quality lines glued into the sequence).
    Scans line by line past blank lines and legacy ';' FASTA comment
    lines (ADVICE r4: a fixed 64-byte head missed records behind long
    leading whitespace or ';' comments)."""
    with _open(path) as f:
        for _ in range(64):  # bounded: don't scan a huge malformed file
            line = f.readline(1 << 16)
            if not line:
                break
            s = line.strip()
            if not s:
                continue
            if s.startswith(b";"):  # legacy FASTA comment line
                return True
            if s.startswith(b">"):
                return True
            if s.startswith(b"@"):
                return False
            break  # first non-blank line is neither — fall to extension
    base = path[:-3] if path.endswith(".gz") else path
    return base.endswith((".fa", ".fasta", ".fna"))


def load_reads_ragged(paths: Sequence[str]):
    """Load FASTQ/FASTA files preserving every read at its own length.

    Returns (reads (N, Lmax) 0-padded int8, lengths (N,) int32). The
    lossless alternative to length_policy='trim'/'filter' (round-1 gap:
    those discard data on mixed-length inputs).
    """
    seqs: List[bytes] = []
    for p in paths:
        with _open(p) as f:
            data = f.read()
        if _is_fasta(p):
            seqs.extend(_parse_fasta_py(data))
        else:
            seqs.extend(_parse_fastq_py(data))
    return _to_ragged(seqs)


def read_fastq(path: str, length_policy: str = "strict") -> np.ndarray:
    """FASTQ(.gz) -> (N, L) int8 codes. Prefers the native C++ parser."""
    from sage2_tpu_torch.io import native

    if native.available():
        return native.parse_fastq(path, length_policy)
    with _open(path) as f:
        return _to_array(_parse_fastq_py(f.read()), length_policy)


def read_fasta(path: str, length_policy: str = "strict") -> np.ndarray:
    """FASTA(.gz) -> (N, L) int8 codes (the Python reader)."""
    with _open(path) as f:
        return _to_array(_parse_fasta_py(f.read()), length_policy)


def load_reads(
    paths: Sequence[str], length_policy: str = "strict"
) -> np.ndarray:
    """Load and concatenate reads from FASTQ/FASTA files (gz ok);
    format detected from content (see _is_fasta)."""
    parts = []
    for p in paths:
        if _is_fasta(p):
            parts.append(read_fasta(p, length_policy))
        else:
            parts.append(read_fastq(p, length_policy))
    parts = [p for p in parts if p.size]
    if not parts:
        return np.zeros((0, 0), np.int8)
    L = {p.shape[1] for p in parts}
    if len(L) > 1:
        raise ValueError(f"input files have different read lengths: {L}")
    return np.concatenate(parts, axis=0)


def load_read_pairs(
    paths: Sequence[str], length_policy: str = "strict"
):
    """Load paired FASTQ/FASTA files (R1_a, R2_a, R1_b, R2_b, ...).

    The reference's headline dataset is paired (BASELINE.json config #1
    "Illumina 100bp paired"); pairing information must survive ingest
    even though the v2 pipeline does not yet scaffold with it
    (SURVEY.md §10). Files are consumed in (R1, R2) pairs; mates must
    have equal counts per pair. Returns (reads (N, L), mate_of (N,)):
    mate_of[i] is the row index of read i's mate.
    """
    if len(paths) % 2:
        raise ValueError(
            f"paired input needs an even number of files, got {len(paths)}"
        )
    blocks = []
    mates = []
    base = 0
    for j in range(0, len(paths), 2):
        r1 = load_reads(paths[j : j + 1], length_policy)
        r2 = load_reads(paths[j + 1 : j + 2], length_policy)
        if r1.shape[0] != r2.shape[0]:
            raise ValueError(
                f"mate files {paths[j]} / {paths[j + 1]} have "
                f"{r1.shape[0]} vs {r2.shape[0]} reads"
            )
        n = r1.shape[0]
        blocks.extend([r1, r2])
        m = np.empty(2 * n, np.int64)
        m[:n] = base + n + np.arange(n)
        m[n:] = base + np.arange(n)
        mates.append(m)
        base += 2 * n
    reads = np.concatenate(blocks, axis=0) if blocks else np.zeros(
        (0, 0), np.int8
    )
    mate_of = np.concatenate(mates) if mates else np.zeros(0, np.int64)
    return reads, mate_of


def load_read_pairs_ragged(paths: Sequence[str]):
    """Paired loading with every read kept at its own length
    (--paired --length-policy pad). Returns (reads (N, Lmax) 0-padded
    int8, lengths (N,) int32, mate_of (N,)). Mate files must have equal
    read counts per (R1, R2) pair; lengths may differ freely (real
    post-trimming Illumina data is ragged AND paired)."""
    if len(paths) % 2:
        raise ValueError(
            f"paired input needs an even number of files, got {len(paths)}"
        )
    blocks = []
    lens_blocks = []
    mates = []
    base = 0
    for j in range(0, len(paths), 2):
        r1, l1 = load_reads_ragged(paths[j : j + 1])
        r2, l2 = load_reads_ragged(paths[j + 1 : j + 2])
        if r1.shape[0] != r2.shape[0]:
            raise ValueError(
                f"mate files {paths[j]} / {paths[j + 1]} have "
                f"{r1.shape[0]} vs {r2.shape[0]} reads"
            )
        n = r1.shape[0]
        blocks.extend([r1, r2])
        lens_blocks.extend([l1, l2])
        m = np.empty(2 * n, np.int64)
        m[:n] = base + n + np.arange(n)
        m[n:] = base + np.arange(n)
        mates.append(m)
        base += 2 * n
    if not blocks:
        return (np.zeros((0, 0), np.int8), np.zeros(0, np.int32),
                np.zeros(0, np.int64))
    Lmax = max(b.shape[1] for b in blocks)
    padded = []
    for b in blocks:
        if b.shape[1] < Lmax:
            b = np.concatenate(
                [b, np.zeros((b.shape[0], Lmax - b.shape[1]), b.dtype)],
                axis=1,
            )
        padded.append(b)
    return (np.concatenate(padded, axis=0),
            np.concatenate(lens_blocks).astype(np.int32),
            np.concatenate(mates))
