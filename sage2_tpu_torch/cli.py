"""Command-line interface of the port (``python -m sage2_tpu_torch``).

  assemble  — full pipeline: reads -> contigs.fasta + stats.json
  correct   — k-mer counting + spectrum correction only
  overlap   — overlap graph (+ optional transitive reduction)
  simulate  — synthetic genome + reads (no-network stand-in)

Example:
  python -m sage2_tpu_torch assemble -o out/ --k 25 --min-overlap 40 reads.fastq.gz

``assemble``, ``correct`` and ``overlap`` run on the GPU (``--device
cuda``, the default) and fail when there is none; ``--device cpu`` runs
the plain PyTorch versions. ``--length-policy pad`` keeps every read at
its own length (ragged reads; a file whose reads all have one length
takes the fixed-length path). ``--max-device-reads N`` streams the
assembly in chunks of N reads (``--entry-block-reads``, ``--spill-dir``:
the streamed join's entry blocks and the host spill store); ``--mesh N``
shards the in-core assembly over N shards, under either
``--correction-rule`` and with ``--length-policy pad``;
``correct`` and ``overlap`` take these flags and run in core on one
device, as the reference's do. ``correct`` and ``overlap`` write what the
reference's subcommands write, quirks included: both correct with the
single_window rule whatever ``--correction-rule`` says, and ``overlap``
reduces in core with ``--reduce-capacity`` and writes the result
without checking its overflow flag; under ``--length-policy pad`` both
take the zero-padded reads without their lengths.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--k", type=int, default=25, help="k-mer length (<=31)")
    p.add_argument("--min-overlap", type=int, default=40)
    p.add_argument("--solid-threshold", type=int, default=2)
    p.add_argument("--correction-rounds", type=int, default=2)
    p.add_argument("--correction-rule",
                   choices=["single_window", "vote_all_windows"],
                   default="single_window",
                   help="spectrum-correction verdict rule: one covering"
                        " window per sub-pass (default) or voting across"
                        " all covering windows")
    p.add_argument("--min-contig-len", type=int, default=200)
    p.add_argument("--traversal", choices=["unitig", "mincost"],
                   default="mincost")
    p.add_argument("--candidate-capacity", type=int, default=1 << 20)
    p.add_argument("--reduce-capacity", type=int, default=1 << 20)
    p.add_argument("--reduce-backend",
                   choices=["auto", "device", "native"], default="auto",
                   help="transitive-reduction backend: host C++ (native),"
                        " device kernels (device), or by edge-list"
                        " residency (auto: the host, where the pipeline"
                        " keeps the edges)")
    p.add_argument("--length-policy",
                   choices=["strict", "trim", "filter", "pad"],
                   default="strict",
                   help="how to handle mixed read lengths at ingest;"
                        " 'pad' keeps every read at its own length"
                        " (lossless ragged mode)")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="shard stages over an N-shard mesh (assemble, in"
                        " core or with --max-device-reads, either"
                        " correction rule, ragged reads too; shard d on"
                        " device d % the device count, so N shards may"
                        " share one card)")
    p.add_argument("--max-device-reads", type=int, default=None,
                   metavar="N",
                   help="stream count/correct/dedup/overlap in chunks of"
                        " N reads when the input is larger (bounds device"
                        " memory; bit-identical to in-core)")
    p.add_argument("--spill-dir", default=None, metavar="DIR",
                   help="spill the streamed pipeline's big host arrays"
                        " (corrected reads, read store, edge list) to"
                        " memmaps under DIR, bounding host RSS by"
                        " O(chunk + reduced graph); bit-identical"
                        " results (requires --max-device-reads;"
                        " single-device path)")
    p.add_argument("--entry-block-reads", type=int, default=None,
                   metavar="N",
                   help="streamed overlap: also stream the ENTRY side in"
                        " blocks of N reads (block-nested join) — lifts"
                        " the single-device HBM ceiling; default: auto"
                        " above the measured ceiling; bit-identical")
    p.add_argument("--paired", action="store_true",
                   help="paired reads: not ported yet (ROADMAP Queue 1"
                        " item 14)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch versions)")


def _config(args):
    from sage2_tpu_torch.config import AssemblyConfig

    return AssemblyConfig(
        k=args.k,
        min_overlap=args.min_overlap,
        solid_threshold=args.solid_threshold,
        correction_rounds=args.correction_rounds,
        correction_rule=args.correction_rule,
        min_contig_len=args.min_contig_len,
        traversal=args.traversal,
        candidate_capacity=args.candidate_capacity,
        reduce_capacity=args.reduce_capacity,
        reduce_backend=args.reduce_backend,
        mesh_shape=(args.mesh,) if args.mesh else None,
        max_device_reads=args.max_device_reads,
        spill_dir=args.spill_dir,
        entry_block_reads=args.entry_block_reads,
    )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="sage2_tpu_torch",
        description="Overlap-graph assembler (SAGE2 method) on PyTorch/CUDA",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("assemble", help="full pipeline: reads -> contigs")
    _add_common(p)
    p.add_argument("-o", "--outdir", required=True)
    p.add_argument("--resume-from",
                   choices=["correct", "overlap", "reduce", "traverse",
                            "finish"])
    p.add_argument("reads", nargs="+", help="FASTQ/FASTA files (gz ok)")

    p = sub.add_parser("correct", help="count + spectrum-correct only")
    _add_common(p)
    p.add_argument("-o", "--output", required=True,
                   help="corrected reads FASTA (.gz ok)")
    p.add_argument("reads", nargs="+")

    p = sub.add_parser("overlap", help="overlap graph (+ reduction)")
    _add_common(p)
    p.add_argument("-o", "--output", required=True, help="edge TSV output")
    p.add_argument("--no-reduce", action="store_true",
                   help="skip transitive reduction")
    p.add_argument("--no-correct", action="store_true",
                   help="skip error correction")
    p.add_argument("reads", nargs="+")

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

    if args.paired:
        print("--paired: not ported yet: paired reads and scaffolding "
              "(ROADMAP Queue 1 item 14)", file=sys.stderr)
        return 2

    read_lengths = None
    if args.length_policy == "pad":
        from sage2_tpu_torch.io.fastq import load_reads_ragged

        reads, read_lengths = load_reads_ragged(args.reads)
        if reads.size and (read_lengths == read_lengths[0]).all():
            read_lengths = None        # uniform after all: fixed path
    else:
        from sage2_tpu_torch.io import load_reads

        reads = load_reads(args.reads, length_policy=args.length_policy)
    if reads.size == 0:
        print("no reads loaded", file=sys.stderr)
        return 1
    cfg = _config(args)

    if args.cmd == "assemble":
        from sage2_tpu_torch.pipeline import assemble

        contigs, stats = assemble(
            reads, cfg, outdir=args.outdir,
            resume_from=args.resume_from, device=args.device,
            lengths=read_lengths,
        )
        print(json.dumps(stats, indent=1))
        return 0

    import torch

    from sage2_tpu_torch.kmer import correct_reads
    from sage2_tpu_torch.utils.device import resolve_device

    r = torch.from_numpy(reads.astype(np.int32)).to(
        resolve_device(args.device))

    if args.cmd == "correct":
        from sage2_tpu_torch.io.writer import write_fasta

        corrected = correct_reads(r, cfg.k, cfg.solid_threshold,
                                  cfg.correction_rounds)
        corrected = corrected.to(torch.int8).cpu().numpy()
        write_fasta(args.output, list(corrected), prefix="read")
        print(f"wrote {corrected.shape[0]} corrected reads", file=sys.stderr)
        return 0

    if args.cmd == "overlap":
        from sage2_tpu_torch.graph.reduce import transitive_reduction
        from sage2_tpu_torch.overlap import find_overlaps, prepare_reads

        if not args.no_correct:
            r = correct_reads(r, cfg.k, cfg.solid_threshold,
                              cfg.correction_rounds)
        rs = prepare_reads(r)
        res = find_overlaps(
            rs.reads2, rs.valid2, cfg.min_overlap,
            cfg.effective_seed_len, capacity=cfg.candidate_capacity,
        )
        if res.overflow:
            print("candidate capacity overflow; raise --candidate-capacity",
                  file=sys.stderr)
            return 2
        src, dst, ovl = res.src, res.dst, res.ovl
        if not args.no_reduce:
            red = transitive_reduction(
                src, dst, ovl, rs.reads2.shape[0], reads.shape[1],
                capacity=cfg.reduce_capacity,
            )
            src, dst, ovl = red.src, red.dst, red.ovl
        src, dst, ovl = (a.cpu().numpy() for a in (src, dst, ovl))
        keep = src != 2**31 - 1
        with open(args.output, "w") as f:
            f.write("#src\tdst\toverlap\n")
            f.writelines(f"{a}\t{b}\t{o}\n" for a, b, o in
                         zip(src[keep], dst[keep], ovl[keep]))
        print(f"wrote edges to {args.output}", file=sys.stderr)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
