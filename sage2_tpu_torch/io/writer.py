"""Contig FASTA output (SURVEY.md §2 "Output/stats")."""

from __future__ import annotations

import gzip
from typing import List

import numpy as np

from sage2_tpu_torch.ops.bitpack import decode_to_ascii


def write_fasta(
    path: str, contigs: List[np.ndarray], prefix: str = "contig", width: int = 80
) -> None:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        for i, c in enumerate(contigs):
            seq = decode_to_ascii(c).tobytes().decode()
            f.write(f">{prefix}_{i} len={len(seq)}\n")
            for j in range(0, len(seq), width):
                f.write(seq[j : j + width] + "\n")
