#!/usr/bin/env python3
"""A/B of the PyTorch port's K5 (vote_windows) and K7 (reduce_marks) CUDA
kernels against another checkout's, on one GPU, at the E. coli scale.

    python3 scripts/probe_vote_marks_ab.py [--baseline DIR] [--only k5|k7]

DIR is the root of another checkout (e.g. `git archive <commit>`
unpacked under a gitignored directory) from before K5's bucket
directory: its K5 is one launch with no scratch argument, its K7 also
takes the read length and lengths. Without DIR only this checkout's kernels
are timed; ``--only`` times one of the two.

Inputs (chip_smoke.py's phase 5, made on the host from its seeds): the
4.6 Mbp genome's 2.3 M reads of 100 bp at error 0.005; K5 takes round 1
of the voting corrector (the reads and their count table pruned at 2);
K7 the graph that phase 5's path reduces (two voting rounds, dedup, the
overlap join), its first and its middle 2^24-slot range.

Prints nvcc -Xptxas -v for both checkouts' sources, then one line a
measurement: median of 5 CUDA-event timings after a warm-up (a "device
time" line enqueues each run behind a spin of the card, which hides the
host's launch cost; a "bare launch" line calls the C interface without
the wrapper's checks), and whether the output equals this checkout's
kernel's (K5's also the plain version's, once). The card's name and
power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import ECOLI, device_ms, time_ms, vote_pairs  # noqa: E402

CSRC = os.path.join("sage2_tpu_torch", "kernels", "csrc")
P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def build(root: str, name: str, outdir: str):
    from sage2_tpu_torch.kernels import nvcc_command

    src = os.path.join(root, CSRC, name + ".cu")
    so = os.path.join(outdir, f"{name}-{abs(hash(root))}.so")
    cmd = nvcc_command() + ["-Xptxas", "-v", "-o", so, src]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"nvcc {src}: {res.stderr}")
    for line in res.stderr.splitlines():
        if "registers" in line or "Compiling entry" in line or (
                "spill" in line and " 0 bytes spill stores" not in line):
            print(f"  ptxas {name} ({root}): {line.strip()}")
    return ctypes.CDLL(so)


def report(what: str, ms: float, equal: bool) -> None:
    print(f"{what}: {ms:.4f} ms, equal to this checkout's kernel: {equal}",
          flush=True)


def time_k5(old, reads, k: int, threshold: int, stream) -> None:
    """K5 on round 1's input (the reads and their table pruned at the
    threshold): this checkout's wrapper and its directory launch, then
    the old kernel."""
    import torch

    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.kernels import plain
    from sage2_tpu_torch.kmer.correct import prune_table_for_correction
    from sage2_tpu_torch.kmer.count import count_kmers

    t = prune_table_for_correction(count_kmers(reads, k), threshold)
    table, counts = t.keys, t.count
    args = (reads, table, counts, k, threshold)
    n_windows, pairs, all_pairs = vote_pairs(args)
    print(f"K5 input: {reads.shape[0]} reads, table {table.numel()} keys, "
          f"{n_windows} windows, {pairs} of {all_pairs} pairs left by the "
          f"skip ({pairs / all_pairs:.4f})", flush=True)
    want = kernels.vote_windows(*args)
    print(f"K5 new equals the plain version: "
          f"{bool(torch.equal(want, plain.vote_windows(*args)))}", flush=True)
    report("K5 new (directory + vote)",
           time_ms(lambda: kernels.vote_windows(*args)), True)
    report("K5 new directory launch", time_ms(
        lambda: kernels.lookup_directory(table, counts, "vote_windows")),
        True)
    if old is None:
        return
    N, L = reads.shape
    out = torch.zeros_like(reads)
    ms = time_ms(lambda: old.sage2_vote_windows(
        reads.data_ptr(), None, N, L, k, table.data_ptr(), counts.data_ptr(),
        table.numel(), threshold, out.data_ptr(), stream))
    report("K5 old", ms, bool(torch.equal(out, want)))


def time_k7(old, reads, k: int, threshold: int, read_len: int,
            stream) -> None:
    """K7 on the graph of phase 5's path, its first and middle 2^24-slot
    ranges: this checkout's wrapper (host and device clock, then the
    device's alone), its bare launch, then the old kernel."""
    import torch

    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.kmer.correct import correct_reads
    from sage2_tpu_torch.ops.sort import sort_by_pair
    from sage2_tpu_torch.overlap import find_overlaps_auto, prepare_reads

    rs = prepare_reads(correct_reads(reads, k, threshold, 2,
                                     rule="vote_all_windows"))
    res = find_overlaps_auto(rs.reads2, rs.valid2, 40, 32)
    src, dst, ovl, V = res.src, res.dst, res.ovl, rs.reads2.shape[0]
    del res, rs
    keys, order = sort_by_pair(
        src, torch.where(src != 2**31 - 1, read_len - ovl, 2**31 - 1))
    start, _, startd, counts = kernels.reduce_counts(keys, src, dst, ovl, V,
                                                     read_len)
    offsets = torch.cumsum(counts, 0, dtype=torch.int64)
    rest = (offsets, src, dst, ovl, (keys & 0xFFFFFFFF).to(torch.int32),
            dst[order], start, startd)
    del keys, order, counts
    total, E = int(offsets[-1]), src.shape[0]
    print(f"K7 input: {E} edge rows, {total} slots "
          f"({-(-total // (1 << 24))} ranges of 2^24)", flush=True)
    new = kernels.load_all()["reduce_marks"]
    for j0 in sorted({0, (total // 2) >> 24 << 24}):
        j1 = min(j0 + (1 << 24), total)
        removed = torch.zeros(E, dtype=torch.uint8, device=src.device)
        want = kernels.reduce_marks(removed.clone(), *rest, read_len, j0, j1)
        tag = f"K7 [{j0}, {j1})"

        def wrapper():
            kernels.reduce_marks(removed, *rest, read_len, j0, j1)

        report(f"{tag} new", time_ms(wrapper), True)
        report(f"{tag} new, device time", device_ms(wrapper), True)
        # the old interface also takes the read length and lengths
        for label, lib, lens in (("new, bare launch", new, ()),
                                 ("old", old, (read_len, None))):
            if lib is None:
                continue
            got = torch.zeros_like(removed)
            ms = time_ms(lambda: lib.sage2_reduce_marks(
                got.data_ptr(), *(a.data_ptr() for a in rest), E, *lens, j0,
                j1, stream))
            report(f"{tag} {label}", ms, bool(torch.equal(got, want)))


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="root of another checkout")
    ap.add_argument("--only", choices=("k5", "k7"),
                    help="time one of the two kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.data import simulate_genome, simulate_reads

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernels.load_all()
    tmp = tempfile.mkdtemp()
    old = {}
    for name in ("vote_windows", "reduce_marks"):
        build(ROOT, name, tmp)
        if args.baseline:
            old[name] = build(args.baseline, name, tmp)
    if old:
        old["vote_windows"].sage2_vote_windows.argtypes = [
            P, P, I64, I, I, P, P, I64, I, P, P]
        old["reduce_marks"].sage2_reduce_marks.argtypes = [
            P, P, P, P, P, P, P, P, P, I64, I, P, I64, I64, P]
    stream = torch.cuda.current_stream().cuda_stream
    e = ECOLI
    genome = simulate_genome(e["genome_len"], seed=e["seeds"][0])
    reads, _ = simulate_reads(genome, read_len=e["read_len"],
                              coverage=e["coverage"],
                              error_rate=e["error_rate"], seed=e["seeds"][1])
    reads = torch.from_numpy(reads.astype(np.int32)).cuda()
    if args.only != "k7":
        time_k5(old.get("vote_windows"), reads, 25, 2, stream)
    if args.only != "k5":
        time_k7(old.get("reduce_marks"), reads, 25, 2, e["read_len"], stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
