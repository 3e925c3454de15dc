"""Command-line interface of the port (``python -m sage2_tpu_torch``).

  assemble  — full pipeline: reads -> contigs.fasta + stats.json
  simulate  — synthetic genome + reads (no-network stand-in)

Example:
  python -m sage2_tpu_torch assemble -o out/ --k 25 --min-overlap 40 reads.fastq.gz

``assemble`` runs on the GPU (``--device cuda``, the default) and fails
when there is none; ``--device cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np


def _config(args):
    from sage2_tpu_torch.config import AssemblyConfig

    return AssemblyConfig(
        k=args.k,
        min_overlap=args.min_overlap,
        solid_threshold=args.solid_threshold,
        correction_rounds=args.correction_rounds,
        min_contig_len=args.min_contig_len,
        traversal=args.traversal,
    )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="sage2_tpu_torch",
        description="Overlap-graph assembler (SAGE2 method) on PyTorch/CUDA",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("assemble", help="full pipeline: reads -> contigs")
    p.add_argument("--k", type=int, default=25, help="k-mer length (<=31)")
    p.add_argument("--min-overlap", type=int, default=40)
    p.add_argument("--solid-threshold", type=int, default=2)
    p.add_argument("--correction-rounds", type=int, default=2)
    p.add_argument("--min-contig-len", type=int, default=200)
    p.add_argument("--traversal", choices=["unitig", "mincost"],
                   default="mincost")
    p.add_argument("--length-policy", choices=["strict", "trim", "filter"],
                   default="strict",
                   help="how to handle mixed read lengths at ingest")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch versions)")
    p.add_argument("-o", "--outdir", required=True)
    p.add_argument("--resume-from",
                   choices=["correct", "overlap", "reduce", "traverse",
                            "finish"])
    p.add_argument("reads", nargs="+", help="FASTQ/FASTA files (gz ok)")

    p = sub.add_parser("simulate", help="synthetic genome + reads")
    p.add_argument("-o", "--output", required=True, help="FASTQ out (.gz ok)")
    p.add_argument("--genome-out", help="also write the genome FASTA")
    p.add_argument("--genome-len", type=int, default=100_000)
    p.add_argument("--read-len", type=int, default=100)
    p.add_argument("--coverage", type=float, default=40.0)
    p.add_argument("--error-rate", type=float, default=0.005)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--circular", action="store_true")

    args = ap.parse_args(argv)

    if args.cmd == "simulate":
        from sage2_tpu_torch.data import (
            simulate_genome,
            simulate_reads,
            write_fastq,
        )
        from sage2_tpu_torch.io.writer import write_fasta

        genome = simulate_genome(args.genome_len, seed=args.seed)
        reads, _ = simulate_reads(
            genome, read_len=args.read_len, coverage=args.coverage,
            error_rate=args.error_rate, seed=args.seed + 1,
            circular=args.circular,
        )
        if args.output.endswith((".fa", ".fasta", ".fna")):
            write_fasta(args.output, [r for r in reads.astype(np.int8)],
                        prefix="read")
        else:
            write_fastq(args.output, reads)
        print(f"wrote {reads.shape[0]} reads x {args.read_len} bp "
              f"to {args.output}", file=sys.stderr)
        if args.genome_out:
            write_fasta(args.genome_out, [genome.astype(np.int8)],
                        prefix="genome")
        return 0

    from sage2_tpu_torch.io import load_reads
    from sage2_tpu_torch.pipeline import assemble

    reads = load_reads(args.reads, length_policy=args.length_policy)
    if reads.size == 0:
        print("no reads loaded", file=sys.stderr)
        return 1
    contigs, stats = assemble(
        reads, _config(args), outdir=args.outdir,
        resume_from=args.resume_from, device=args.device,
    )
    print(json.dumps(stats, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
