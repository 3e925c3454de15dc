#!/usr/bin/env python3
"""A/B of the PyTorch port's K6 (reduce_counts) and K5's routed vote_add
(vote_windows) CUDA kernels against another checkout's, on one GPU.

    python3 scripts/probe_vote_reduce_ab.py [--baseline DIR] [--seed S]
                                            [--only k6|vote]

DIR is the root of another checkout (e.g. `git archive <commit>
sage2_tpu_torch | tar -x -C .smoke_checkout/parent`); both checkouts'
reduce_counts.cu and vote_windows.cu are compiled with the same nvcc
flags (-Xptxas -v printed for each) and called through their own C
interface, which the script tells apart by its symbols:

  K6 old: a vertex pass (three whole-array binary searches a vertex:
      start, the run's end for maxsl, startd) and an edge pass (one
      whole-array search an edge); new: the vertex row table with maxsl
      (kernels/csrc/vertex_rows.cuh, K21's loop) and each real key's sl
      in 8 bits, saturated, then the counts from each edge's dst run
      alone
      (`sage2_reduce_table`, `sage2_reduce_counts`);
  vote_add old: one thread a flat (read, window) index, its read and
      window by a 64-bit division; new: a warp a read (the same symbol
      and arguments).

Inputs, made on the card:

  K6  phase 5's graph (chip_smoke.py: the 4.6 Mbp genome's 2.3 M reads
      of 100 bp at error 0.005 from its seeds, two voting rounds, the
      dedup and the overlap join; ~96 M rows); 8b's shape, ragged (4.5
      M vertices of lengths in [75, 150], 7.46 M random edges sorted by
      (src, dst), padded to 163,840,000 rows; from --seed); a hub (4.6
      M vertices, 20 M random edges, one vertex with 10^6 out-edges and
      2 M edges into it; from --seed);
  vote_add 13b's shard (562,223 reads of 150 bp, k = 25: 126 windows a
      read; counts uniform in [0, 6) against threshold 2), with lengths
      (90% uniform in [75, 150], 10% in [47, 72], as 8b's reads with
      their contained ones) and without, at j = 0, 12 and 24.

Each launch is timed apart (median of 5 CUDA-event timings after a
warm-up), old and new in turns (new, old, old, new), then the whole
call; every output is compared bit for bit, old to new and both to the
plain version (kernels/plain.py, run on the card). Beside them the
bound (chip_smoke.work: bytes over 3.35 TB/s or operations over 67 T/s,
the larger). The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ROOT))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    ECOLI, HBM_BYTES_PER_S, OPS_PER_S, valid_windows, work)
from probe_route_reduce_ab import split_ms  # noqa: E402
from probe_seed_edges_ab import call, ptr, stream  # noqa: E402

CSRC = os.path.join("sage2_tpu_torch", "kernels", "csrc")
P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
I32_MAX = 2**31 - 1
SIGS = {
    # the old K6
    "sage2_reduce_vertices": [P, P, I64, I64, P, P, P, P],
    "sage2_reduce_edges": [P, P, P, P, I64, I, P, P, P, P, P],
    # the new K6
    "sage2_reduce_table": [P, I64, I64, P, P, P, P],
    "sage2_reduce_counts": [P, P, P, P, P, I64, I64, I, P, P, P, P, P],
    # both
    "sage2_vote_add": [P, P, P, I64, I, I, I, I, P],
}


def build(root: str, name: str, outdir: str, tag: str):
    from sage2_tpu_torch.kernels import nvcc_command

    src = os.path.join(root, CSRC, name + ".cu")
    so = os.path.join(outdir, f"{name}-{tag}.so")
    cmd = nvcc_command() + ["-Xptxas", "-v", "-o", so, src]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"nvcc {src}: {res.stderr}")
    for line in res.stderr.splitlines():
        if "registers" in line or "Compiling entry" in line or (
                "spill" in line and " 0 bytes spill" not in line):
            print(f"  ptxas {tag} {name}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(so)
    for fn, sig in SIGS.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = sig
            getattr(lib, fn).restype = I
    return lib


def bound_ms(key: str, args: tuple) -> float:
    nbytes, ops = work(key, args)
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3


# --- K6 ---------------------------------------------------------------------

def k6_steps(lib, keys, src, dst, ovl, V, read_len):
    """One checkout's K6 call as (part, fn) steps and its outputs (start,
    maxsl, startd, counts)."""
    import torch

    E = src.shape[0]
    L, lens = (0, read_len) if isinstance(read_len, torch.Tensor) else (
        read_len, None)

    def empty(n):
        return torch.empty(n, dtype=torch.int32, device=src.device)

    maxsl, startd, counts = empty(V), empty(V + 1), empty(E)
    if hasattr(lib, "sage2_reduce_table"):
        start = startd[:V]
        sl8 = torch.empty(-(-E // 16) * 16, dtype=torch.uint8,
                          device=src.device)
        steps = [("table", lambda: call(
            lib, "sage2_reduce_table", ptr(keys), E, V, ptr(startd),
            ptr(maxsl), ptr(sl8), stream())),
                 ("counts", lambda: call(
                     lib, "sage2_reduce_counts", ptr(keys), ptr(sl8),
                     ptr(src), ptr(dst), ptr(ovl), E, V, L, ptr(lens),
                     ptr(startd), ptr(maxsl), ptr(counts), stream()))]
    else:
        start = empty(V)
        steps = [("vertices", lambda: call(
            lib, "sage2_reduce_vertices", ptr(keys), ptr(src), E, V,
            ptr(start), ptr(maxsl), ptr(startd), stream())),
                 ("edges", lambda: call(
                     lib, "sage2_reduce_edges", ptr(keys), ptr(src),
                     ptr(dst), ptr(ovl), E, L, ptr(lens), ptr(start),
                     ptr(maxsl), ptr(counts), stream()))]
    return steps, (start, maxsl, startd, counts)


def run_k6(libs, tags, turns, label, src, dst, ovl, V, read_len):
    import torch

    from sage2_tpu_torch.kernels import plain
    from sage2_tpu_torch.ops.sort import sort_by_pair

    real = src != I32_MAX
    length = (read_len[src.clamp(0, V - 1).long()]
              if isinstance(read_len, torch.Tensor) else read_len)
    keys, _ = sort_by_pair(src, torch.where(real, length - ovl, I32_MAX))
    args = (keys, src, dst, ovl, V, read_len)
    got = {}
    for t in tags:
        steps, out = k6_steps(libs[t], *args)
        for _, fn in steps:
            fn()
        torch.cuda.synchronize()
        got[t] = out
    want = plain.reduce_counts(*args)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    new = got["new"]
    eq_old = "-" if len(tags) == 1 else same(new, got["old"])
    eq_plain = same(new, want)
    E, counts = src.shape[0], new[3]
    run = new[2][1:] - new[2][:-1]
    print(f"K6 {label}: {E} rows, {int(real.sum())} edges, V {V}, longest "
          f"run {int(run.max())}, mean run {float(run.float().mean()):.2f}, "
          f"{int(counts.sum(dtype=torch.int64))} expansion slots; new "
          f"equal to old {eq_old}, to plain {eq_plain}; bound "
          f"{bound_ms('reduce_counts', args):.4f} ms", flush=True)
    if eq_old is False or not eq_plain:
        raise AssertionError(f"K6 {label}: outputs differ")
    del got, want, new
    torch.cuda.empty_cache()
    for t in turns:
        steps, _ = k6_steps(libs[t], *args)
        parts = split_ms(steps)
        print(f"K6 {label} {t}: " + ", ".join(
            f"{p} {ms:.4f} ms" for p, ms in parts.items()), flush=True)
        del steps
        torch.cuda.empty_cache()


def phase5_graph():
    """(src, dst, ovl, V) of phase 5's path: the voting corrector, the
    dedup and the overlap join of chip_smoke.py's E. coli reads."""
    import numpy as np
    import torch

    from sage2_tpu_torch.data import simulate_genome, simulate_reads
    from sage2_tpu_torch.kmer.correct import correct_reads
    from sage2_tpu_torch.overlap import find_overlaps_auto, prepare_reads

    e = ECOLI
    genome = simulate_genome(e["genome_len"], seed=e["seeds"][0])
    reads, _ = simulate_reads(genome, read_len=e["read_len"],
                              coverage=e["coverage"],
                              error_rate=e["error_rate"], seed=e["seeds"][1])
    reads = torch.from_numpy(reads.astype(np.int32)).cuda()
    rs = prepare_reads(correct_reads(reads, 25, 2, 2,
                                     rule="vote_all_windows"))
    res = find_overlaps_auto(rs.reads2, rs.valid2, 40, 32)
    return res.src, res.dst, res.ovl, rs.reads2.shape[0]


def random_graph(gen, V, n, pad_to=None, hub=None, lens=None):
    """n random edges over V vertices sorted by (src, dst) (a hub: 10^6
    out-edges of one vertex and 2 M edges into it), sl uniform in [1,
    60], padded with (INT32_MAX, INT32_MAX, 0) rows to pad_to."""
    import torch

    dev = torch.device("cuda")
    s = torch.randint(0, V, (n,), generator=gen, device=dev)
    d = torch.randint(0, V, (n,), generator=gen, device=dev)
    if hub is not None:
        s = torch.cat([s, torch.full((10**6,), hub, device=dev),
                       torch.randint(0, V, (2 * 10**6,), generator=gen,
                                     device=dev)])
        d = torch.cat([d, torch.randint(0, V, (10**6,), generator=gen,
                                        device=dev),
                       torch.full((2 * 10**6,), hub, device=dev)])
    order = torch.argsort((s << 32) | d)
    s, d = s[order].int(), d[order].int()
    sl = torch.randint(1, 61, s.shape, generator=gen, dtype=torch.int32,
                       device=dev)
    length = 100 if lens is None else lens[s.long()]
    ovl = (length - sl).int()
    pad = (pad_to or s.shape[0]) - s.shape[0]
    fill = torch.full((pad,), I32_MAX, dtype=torch.int32, device=dev)
    return (torch.cat([s, fill]), torch.cat([d, fill]),
            torch.cat([ovl, torch.zeros_like(fill)]))


# --- vote_add ---------------------------------------------------------------

def run_vote(libs, tags, turns, label, counts, lengths, j, k, thr):
    import torch

    from sage2_tpu_torch.kernels import plain

    N, Pw = counts.shape[:2]
    L = Pw + k - 1
    base = torch.randint(0, 4, (N, L, 4), dtype=torch.uint8,
                         device=counts.device)

    def launch(lib, votes):
        return lambda: call(lib, "sage2_vote_add", ptr(votes), ptr(counts),
                            ptr(lengths), N, L, k, j, thr, stream())

    got = {}
    for t in tags:
        votes = base.clone()
        launch(libs[t], votes)()
        got[t] = votes
    want = plain.vote_add(base.clone(), counts, j, k, thr, lengths)
    new = got["new"]
    eq_old = "-" if len(tags) == 1 else torch.equal(new, got["old"])
    eq_plain = torch.equal(new, want)
    W = valid_windows(lengths, N, Pw, k)
    bound = bound_ms("vote_windows:routed",
                     (base, counts, j, k, thr, lengths))
    print(f"vote_add {label} j={j}: {N} reads x {Pw} windows, {W} valid; "
          f"new equal to old {eq_old}, to plain {eq_plain}; bound "
          f"{bound:.4f} ms", flush=True)
    if eq_old is False or not eq_plain:
        raise AssertionError(f"vote_add {label} j={j}: outputs differ")
    del got, want, new
    votes = torch.zeros_like(base)
    for t in turns:
        parts = split_ms([("vote_add", launch(libs[t], votes))])
        print(f"vote_add {label} j={j} {t}: {parts['vote_add']:.4f} ms",
              flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="root of another checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("k6", "vote"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from sage2_tpu_torch import kernels

    kernels.load_all()
    tmp = tempfile.mkdtemp()
    checkouts = [("new", os.path.dirname(ROOT))] + (
        [("old", args.baseline)] if args.baseline else [])
    tags = [t for t, _ in checkouts]
    turns = tags + tags[::-1] if len(tags) > 1 else tags
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    dev = torch.device("cuda")
    if args.only in (None, "vote"):
        libs = {t: build(root, "vote_windows", tmp, t)
                for t, root in checkouts}
        N, L, k, thr = 562_223, 150, 25, 2
        counts = torch.randint(0, 6, (N, L - k + 1, 4), generator=gen,
                               dtype=torch.int32, device=dev)
        lens = torch.randint(75, 151, (N,), generator=gen, dtype=torch.int32,
                             device=dev)
        short = torch.rand(N, generator=gen, device=dev) < 0.1
        lens = torch.where(short, torch.randint(
            47, 73, (N,), generator=gen, dtype=torch.int32, device=dev),
            lens)
        for label, ln in (("ragged", lens), ("fixed", None)):
            for j in (0, 12, 24):
                run_vote(libs, tags, turns, label, counts, ln, j, k, thr)
        del counts, lens
        torch.cuda.empty_cache()
    if args.only in (None, "k6"):
        libs = {t: build(root, "reduce_counts", tmp, t)
                for t, root in checkouts}
        src, dst, ovl, V = phase5_graph()
        torch.cuda.empty_cache()
        run_k6(libs, tags, turns, "phase 5's graph", src, dst, ovl, V, 100)
        del src, dst, ovl
        torch.cuda.empty_cache()
        V = 4_500_000
        lens = torch.randint(75, 151, (V,), generator=gen, dtype=torch.int32,
                             device=dev)
        src, dst, ovl = random_graph(gen, V, 7_462_642, 163_840_000,
                                     lens=lens)
        run_k6(libs, tags, turns, "ragged at 8b's shape", src, dst, ovl, V,
               lens)
        del src, dst, ovl, lens
        torch.cuda.empty_cache()
        V = 4_600_000
        src, dst, ovl = random_graph(gen, V, 20_000_000, hub=V // 2)
        run_k6(libs, tags, turns, "hub (10^6 out-edges, 2 M in)", src, dst,
               ovl, V, 100)
    return 0


if __name__ == "__main__":
    sys.exit(main())
