#!/usr/bin/env python3
"""A/B of the PyTorch port's K17 (fix_windows), K12 (dedup_reads) and K16
(weak_windows) CUDA kernels against another checkout's, on one GPU.

    python3 scripts/probe_fix_dedup_ab.py [--baseline DIR]
        [--only k17|k12|k16] [--variants kernel=tag:DIR,...]

DIR is the root of another checkout (e.g. `git archive <commit>
sage2_tpu_torch | tar -x -C .smoke_checkout/parent`); both checkouts'
fix_windows.cu, dedup_reads.cu and weak_windows.cu are compiled with the
same nvcc flags (-Xptxas -v printed for each) and called through their
own C interface, which the script tells apart by its symbols and source:

  K17 old: a copy of the reads (torch.clone), then one thread a weak
      window, its codes gathered base by base and its four variants looked
      up through K2's bucket directory; new: each tile's range of the weak
      windows, then a tile of reads a block, the copy inside it, the
      variants probed in K16's membership table (the three other than
      the current base's, the current one only beside a solid one) and
      K2's directory read only where two or more are solid;
  K12 old: a key launch and a stable torch.sort for each 64-bit key of
      the key string, then heads, the one-block scan, assignment and rows;
      new: the whole string sorted once by bucket_sort.cuh (range, which
      builds the elements, hist, scan, scatter, split, big, sort, whose
      blocks write the groups, then rows, which unpacks the unique rows);
  K16 the same interface in both (its mask and write launches timed on
      one membership table, built by this checkout): held to the old one
      where its probe and packing moved into solid_table.cuh.

Inputs, made on the card from chip_smoke.py's seeds:

  phase 4  the 4.6 Mbp genome's 2.3 M reads of 100 bp at error 0.005: K17
      at round 1's sub-passes (k = 25, threshold 2, the pruned table of
      the reads' 25-mers, K16's weak windows), "last" and "first", and
      "last" through K2's directory alone (no membership table); K16 at
      round 1 (the same table); K12 on
      the reads after the two-phase corrector's two rounds, as the
      assembly's dedup gets them;
  8a       the same genome's ragged reads (75-150 bp, 10% contained reads
      of 47-72 bp, zero-padded to 150): K17 "last" and K16 at round 1
      with lengths, K12 with lengths (the reads uncorrected);
  skew     phase 4's corrected reads with the first 32 bases of every
      tenth read set to A: 230,000 reads share their first 64-bit key
      word, a run of equal leading words far past a block.

Each launch is timed apart (median of 5 CUDA-event timings after a
warm-up), old and new in turns (new, old, old, new), then the whole call;
every output is compared bit for bit, old to new and both to the plain
version (kernels/plain.py, run on the card). --variants builds other
checkouts' sources of a kernel and times them once each after the turns
(K17 and K12 in the new interface). Beside them the bound
(chip_smoke.work: bytes over 3.35 TB/s or operations over 67 T/s, the
larger). The card's name and power limit come first.
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
    ECOLI, ECOLI_RAGGED, HBM_BYTES_PER_S, OPS_PER_S, work)
from probe_route_reduce_ab import split_ms  # noqa: E402
from probe_seed_edges_ab import call, ptr, stream  # noqa: E402

CSRC = os.path.join("sage2_tpu_torch", "kernels", "csrc")
P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
K, THRESHOLD = 25, 2
LAYOUT = [P, P, P, P, P, I64, I, I, I, I, I, I, P, P, I]
OLD_SIGS = {
    # the old K12 (its rows launch shares the new one's name)
    "sage2_dedup_keys": [P, P, P, P, I64, I, I, I, I, P, P, P, P, P],
    "sage2_dedup_heads": [P, P, P, P, P, P, I64, I, I, P, P, P, P],
    "sage2_scan_tiles": [P, I64, P, P],
    "sage2_dedup_assign": [P, P, P, P, I64, P, P, P],
    "sage2_dedup_rows": [P, P, P, P, P, P, P, I64, I, P, P, P, P],
    "sage2_fix_windows": [P, I, I, P, P, I64, P, I, I, P, I64, P, P],
}
NEW_SIGS = {
    # the new K12
    "sage2_dedup_range": LAYOUT + [P, P],
    "sage2_dedup_hist": [P, I64, I, P, P, I, P],
    "sage2_dedup_scan": [P, I, P],
    "sage2_dedup_scatter": [P, I64, I, P, P, I, P, P],
    "sage2_dedup_split": [P, P, I, I, P, P, P],
    "sage2_dedup_big": [P, P, P, I, I64, I, P],
    "sage2_dedup_sort": [P, P, P, I, I64, I, P, I64, P, P, P, P, P, P],
    "sage2_dedup_rows": [P, P, I, P, P, P, I64, I, I, I, P, P, P, P],
    # the new K17
    "sage2_fix_starts": [P, I64, I64, I, I, P, P],
    "sage2_fix_windows": [P, I64, I, I, P, P, I64, P, P, I, I, P, P, P, P],
}
K16_SIGS = {    # K16's C interface, the same in both
    "sage2_weak_mask": [P, P, I64, I, I, P, P, I64, P, P, I, P, P, P],
    "sage2_weak_write": [P, I64, I, P, P, P],
}


def build(root: str, name: str, outdir: str, tag: str):
    """(lib, new): one checkout's kernel library, and whether it is the
    new kernel (K17 tiled, K12 sorted once)."""
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
    with open(src) as f:
        new = "fix_tile" in f.read() or hasattr(lib, "sage2_dedup_sort")
    for fn, sig in {**(NEW_SIGS if new else OLD_SIGS), **K16_SIGS}.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = sig
            getattr(lib, fn).restype = I
    return lib, new


def bound_ms(key: str, args: tuple, total=0) -> float:
    nbytes, ops = work(key, args, total)
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3


# --- K17 --------------------------------------------------------------------

def k17_steps(lib, new, reads, widx, table, counts, directory, k, thr, off,
              out):
    """One checkout's K17 call as (part, fn) steps writing ``out``."""
    import torch

    from sage2_tpu_torch import kernels

    N, L = reads.shape
    T = table.shape[0]
    at = kernels.solid_offset(T)
    solid = directory[at:] if directory.numel() > at else None
    n = widx.shape[0]
    if new:     # room for a tile a read (a variant's tiles may be smaller)
        starts = torch.empty(N + 1, dtype=torch.int64, device=reads.device)
        return [("starts", lambda: call(
            lib, "sage2_fix_starts", ptr(widx), n, N, L, k, ptr(starts),
            stream())),
                ("fix", lambda: call(
                    lib, "sage2_fix_windows", ptr(reads), N, L, k,
                    ptr(table), ptr(counts), T, ptr(directory), ptr(solid),
                    thr, off, ptr(widx), ptr(starts), ptr(out),
                    stream()))]
    return [("clone", lambda: out.copy_(reads)),
            ("fix", lambda: call(
                lib, "sage2_fix_windows", ptr(reads), L, k, ptr(table),
                ptr(counts), T, ptr(directory), thr, off, ptr(widx), n,
                ptr(out), stream()))]


def run_k17(libs, tags, turns, label, reads, lengths, which="last",
            directory_only=False):
    import torch

    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.kernels import plain
    from sage2_tpu_torch.kmer.correct import prune_table_for_correction
    from sage2_tpu_torch.kmer.count import count_kmers

    t = prune_table_for_correction(count_kmers(reads, K, lengths), THRESHOLD)
    full = kernels.table_directory(t.keys, t.count, K, THRESHOLD)
    widx = kernels.weak_windows(reads, lengths, t.keys, t.count, full, K,
                                THRESHOLD)
    directory = (kernels.lookup_directory(t.keys, t.count) if directory_only
                 else full)
    off = K - 1 if which == "last" else 0
    got = {}
    for tag in tags:
        out = torch.empty_like(reads)
        for _, fn in k17_steps(*libs[tag], reads, widx, t.keys, t.count,
                               directory, K, THRESHOLD, off, out):
            fn()
        torch.cuda.synchronize()
        got[tag] = out
    want = plain.fix_windows(reads, widx, t.keys, t.count, None, K,
                             THRESHOLD, which)
    new = got["new"]
    eq_old = "-" if len(tags) == 1 else torch.equal(new, got["old"])
    eq_plain = torch.equal(new, want)
    args = (reads, widx, t.keys, t.count, directory, K, THRESHOLD, which)
    mode = " (K2 directory only)" if directory_only else ""
    print(f"K17 {label} {which}{mode}"
          f": {reads.shape[0]} reads of {reads.shape[1]}, {widx.numel()} "
          f"weak windows, {t.keys.numel()} solid keys, "
          f"{int((new != reads).sum())} edits; new equal to old {eq_old}, "
          f"to plain {eq_plain}; bound {bound_ms('fix_windows', args):.4f} "
          f"ms", flush=True)
    if eq_old is False or not eq_plain:
        raise AssertionError(f"K17 {label} {which}: outputs differ")
    del got, want, new
    out = torch.empty_like(reads)
    for tag in turns:
        parts = split_ms(k17_steps(*libs[tag], reads, widx, t.keys, t.count,
                                   directory, K, THRESHOLD, off, out))
        print(f"K17 {label} {which}{mode} {tag}: " + ", ".join(
            f"{p} {ms:.4f} ms" for p, ms in parts.items()), flush=True)
    del out, widx, directory, full, t
    torch.cuda.empty_cache()


# --- K16 --------------------------------------------------------------------

def k16_steps(lib, reads, lengths, table, counts, directory, k, thr, got):
    """One checkout's K16 call as (part, fn) steps; got[0] gets its
    output."""
    import torch

    from sage2_tpu_torch import kernels

    N, L = reads.shape
    P = L - k + 1
    T = table.shape[0]
    at = kernels.solid_offset(T)
    solid = directory[at:] if directory.numel() > at else None
    mask = torch.empty((N, -(-P // 32)), dtype=torch.int32,
                       device=reads.device)
    tiles = -(-N // kernels.WEAK_TILE_READS)
    scan = torch.empty(2 * tiles + 2, dtype=torch.int64, device=reads.device)

    def write():
        got[0] = torch.empty(int(scan[tiles]), dtype=torch.int64,
                             device=reads.device)
        call(lib, "sage2_weak_write", ptr(mask), N, P, ptr(scan),
             ptr(got[0]), stream())

    return [("mask", lambda: call(
        lib, "sage2_weak_mask", ptr(reads), ptr(lengths), N, L, k,
        ptr(table), ptr(counts), T, ptr(directory), ptr(solid), thr,
        ptr(mask), ptr(scan), stream())), ("read + write", write)]


def run_k16(libs, tags, turns, label, reads, lengths):
    import torch

    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.kernels import plain
    from sage2_tpu_torch.kmer.correct import prune_table_for_correction
    from sage2_tpu_torch.kmer.count import count_kmers

    t = prune_table_for_correction(count_kmers(reads, K, lengths), THRESHOLD)
    directory = kernels.table_directory(t.keys, t.count, K, THRESHOLD)
    got = {}
    for tag in tags:
        out = [None]
        for _, fn in k16_steps(libs[tag][0], reads, lengths, t.keys,
                               t.count, directory, K, THRESHOLD, out):
            fn()
        torch.cuda.synchronize()
        got[tag] = out[0]
    want = plain.weak_windows(reads, lengths, t.keys, t.count, None, K,
                              THRESHOLD)
    new = got["new"]
    eq_old = "-" if len(tags) == 1 else torch.equal(new, got["old"])
    eq_plain = torch.equal(new, want)
    args = (reads, lengths, t.keys, t.count, directory, K, THRESHOLD)
    print(f"K16 {label}: {reads.shape[0]} reads of {reads.shape[1]}, "
          f"{new.numel()} weak windows, {t.keys.numel()} solid keys; new "
          f"equal to old {eq_old}, to plain {eq_plain}; bound "
          f"{bound_ms('weak_windows', args, new.numel()):.4f} ms",
          flush=True)
    if eq_old is False or not eq_plain:
        raise AssertionError(f"K16 {label}: outputs differ")
    del got, want, new
    for tag in turns:
        parts = split_ms(k16_steps(libs[tag][0], reads, lengths, t.keys,
                                   t.count, directory, K, THRESHOLD, [None]))
        print(f"K16 {label} {tag}: " + ", ".join(
            f"{p} {ms:.4f} ms" for p, ms in parts.items()), flush=True)
    del directory, t
    torch.cuda.empty_cache()


# --- K12 --------------------------------------------------------------------

def k12_steps(lib, new, reads, lengths, rc, fwd_w, rc_w, take_rc, outs):
    """One checkout's K12 call as (part, fn) steps; ``outs`` (uniq, mult,
    vertex_of_read, lens_u, n_unique holder) get its outputs."""
    import torch

    from sage2_tpu_torch.kernels import bucket_plan

    N, L = reads.shape
    W = fwd_w.shape[1]
    dev = reads.device
    lb = 0 if lengths is None else L.bit_length()
    uniq, mult, vor, lens_u, n_unique = outs
    st = {}
    steps = []
    if new:
        d = bucket_plan.dedup_bucket_bits(N, lengths is not None)
        scratch = torch.empty(bucket_plan.scratch_words(d, N),
                              dtype=torch.int64, device=dev)
        ctl = torch.empty(2, dtype=torch.int64, device=dev)
        passes = bucket_plan.dedup_passes(L, lb)
        reps = torch.empty((N, passes[-1][2]), dtype=torch.int64, device=dev)
        for i, (s0, ns, NW) in enumerate(passes):
            gid = None if i + 1 == len(passes) else torch.empty(
                N, dtype=torch.int32, device=dev)
            prev = st.get("gid")
            elems = torch.empty((N, NW), dtype=torch.int64, device=dev)
            tmp = torch.empty_like(elems)
            lay = (ptr(fwd_w), ptr(rc_w), ptr(take_rc), ptr(lengths),
                   ptr(prev), N, W, L, lb, s0, ns, NW, ptr(ctl),
                   ptr(scratch), d)
            sfx = "" if len(passes) == 1 else f" {i}"

            def mk(fn, *a):
                return lambda: call(lib, fn, *a, stream())

            steps += [
                ("range" + sfx, mk("sage2_dedup_range", *lay, ptr(tmp))),
                ("hist" + sfx, mk("sage2_dedup_hist", ptr(tmp), N, NW,
                                  ptr(ctl), ptr(scratch), d)),
                ("scan" + sfx, mk("sage2_dedup_scan", ptr(scratch), d)),
                ("scatter" + sfx, mk("sage2_dedup_scatter", ptr(tmp), N, NW,
                                     ptr(ctl), ptr(scratch), d,
                                     ptr(elems))),
                ("split" + sfx, mk("sage2_dedup_split", ptr(ctl),
                                   ptr(scratch), d, NW, ptr(elems),
                                   ptr(tmp))),
                ("big" + sfx, mk("sage2_dedup_big", ptr(elems), ptr(tmp),
                                 ptr(scratch), d, N, NW)),
                ("sort" + sfx, mk("sage2_dedup_sort", ptr(elems), ptr(tmp),
                                  ptr(scratch), d, N, NW, ptr(lengths), N,
                                  ptr(mult), ptr(vor), ptr(lens_u),
                                  ptr(None if gid is not None else reps),
                                  ptr(gid)))]
            st["gid"] = gid
        steps.append(("rows", lambda: call(
            lib, "sage2_dedup_rows", ptr(reps), ptr(scratch), NW, ptr(reads),
            ptr(rc), ptr(lengths), N, L, lb, len(passes) == 1, ptr(uniq),
            ptr(mult), ptr(lens_u), stream())))
        steps.append(("read", lambda: n_unique.__setitem__(
            0, int(scratch[1]))))
        return steps
    n_keys = -(-(2 * L + lb) // 64)
    col = torch.empty(N, dtype=torch.int64, device=dev)
    tiles = max(1, -(-N // 1024))
    scan = torch.empty(tiles + 1, dtype=torch.int64, device=dev)
    s_order = torch.empty(N, dtype=torch.int64, device=dev)
    heads = torch.empty(N, dtype=torch.uint8, device=dev)
    head_pos = torch.empty(N, dtype=torch.int64, device=dev)

    def key(c):
        def fn():
            if c == n_keys - 1:
                st["order"] = st["perm"] = None
            nxt = torch.empty(N, dtype=torch.int64, device=dev)
            call(lib, "sage2_dedup_keys", ptr(fwd_w), ptr(rc_w),
                 ptr(take_rc), ptr(lengths), N, W, L, lb, c,
                 ptr(st["order"]), ptr(st["perm"]), ptr(nxt), ptr(col),
                 stream())
            st["order"] = nxt
        return fn

    def sort():
        st["perm"] = torch.sort(col, stable=True).indices

    for c in reversed(range(n_keys)):
        steps += [(f"key {c}", key(c)), (f"sort {c}", sort)]
    steps += [
        ("heads", lambda: call(
            lib, "sage2_dedup_heads", ptr(st["order"]), ptr(st["perm"]),
            ptr(fwd_w), ptr(rc_w), ptr(take_rc), ptr(lengths), N, W, L,
            ptr(s_order), ptr(heads), ptr(scan), stream())),
        ("scan", lambda: call(lib, "sage2_scan_tiles", ptr(scan), tiles,
                              ptr(scan[tiles:]), stream())),
        ("assign", lambda: call(
            lib, "sage2_dedup_assign", ptr(s_order), ptr(heads), ptr(scan),
            ptr(take_rc), N, ptr(head_pos), ptr(vor), stream())),
        ("rows", lambda: call(
            lib, "sage2_dedup_rows", ptr(s_order), ptr(head_pos),
            ptr(scan[tiles:]), ptr(reads), ptr(rc), ptr(take_rc),
            ptr(lengths), N, L, ptr(uniq), ptr(mult), ptr(lens_u),
            stream())),
        ("read", lambda: n_unique.__setitem__(0, int(scan[tiles]))),
    ]
    return steps


def run_k12(libs, tags, turns, label, reads, lengths):
    import torch

    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.kernels import plain

    k8 = kernels.canonical_reads(reads, lengths)
    lead = torch.where(k8[3][:, None], k8[2][:, :2], k8[1][:, :2])
    run = int(torch.unique(lead, dim=0, return_counts=True)[1].max())

    def outs():
        return (torch.empty_like(reads),
                torch.empty(reads.shape[0], dtype=torch.int32,
                            device=reads.device),
                torch.empty(reads.shape[0], dtype=torch.int32,
                            device=reads.device),
                None if lengths is None else torch.empty_like(lengths), [0])

    got = {}
    for tag in tags:
        o = outs()
        for _, fn in k12_steps(*libs[tag], reads, lengths, *k8, o):
            fn()
        torch.cuda.synchronize()
        got[tag] = (o[0], o[1], o[2], o[4][0]) + (
            () if lengths is None else (o[3],))
    w = plain.dedup_reads(reads, lengths, *k8)
    want = w[:4] + (() if lengths is None else (w[4],))

    def same(a, b):
        return all(torch.equal(x, y) if isinstance(x, torch.Tensor)
                   else x == y for x, y in zip(a, b))

    new = got["new"]
    eq_old = "-" if len(tags) == 1 else same(new, got["old"])
    eq_plain = same(new, want)
    args = (reads, lengths) + tuple(k8)
    print(f"K12 {label}: {reads.shape[0]} reads of {reads.shape[1]}, "
          f"{new[3]} unique, the longest run of equal leading 64-bit words "
          f"{run}; new equal to old {eq_old}, to plain {eq_plain}; bound "
          f"{bound_ms('dedup_reads', args, new[3]):.4f} ms", flush=True)
    if eq_old is False or not eq_plain:
        raise AssertionError(f"K12 {label}: outputs differ")
    del got, want, new, w
    torch.cuda.empty_cache()
    o = outs()
    for tag in turns:
        steps = k12_steps(*libs[tag], reads, lengths, *k8, o)
        parts = split_ms(steps)
        print(f"K12 {label} {tag}: " + ", ".join(
            f"{p} {ms:.4f} ms" for p, ms in parts.items()), flush=True)
        del steps
        torch.cuda.empty_cache()


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="root of another checkout")
    ap.add_argument("--only", choices=("k17", "k12", "k16"))
    ap.add_argument("--variants", default="",
                    help="other sources to time once each, as "
                    "kernel=tag:DIR separated by commas (kernel "
                    "fix_windows or dedup_reads; DIR a checkout's root)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.data import (
        simulate_genome,
        simulate_ragged_reads,
        simulate_reads,
    )
    from sage2_tpu_torch.kmer.correct import correct_reads

    kernels.load_all()
    tmp = tempfile.mkdtemp()
    checkouts = [("new", os.path.dirname(ROOT))] + (
        [("old", args.baseline)] if args.baseline else [])
    tags = [t for t, _ in checkouts]
    turns = tags + tags[::-1] if len(tags) > 1 else tags
    def other(name):
        """The --variants of kernel ``name``, built: {tag: (lib, new)}."""
        out = {}
        for item in filter(None, args.variants.split(",")):
            kernel, spec = item.split("=", 1)
            tag, root = spec.split(":", 1)
            if kernel == name:
                out[tag] = build(root, name, tmp, tag)
        return out

    e = ECOLI
    genome = simulate_genome(e["genome_len"], seed=e["seeds"][0])
    reads, _ = simulate_reads(genome, read_len=e["read_len"],
                              coverage=e["coverage"],
                              error_rate=e["error_rate"], seed=e["seeds"][1])
    reads = torch.from_numpy(reads.astype(np.int32)).cuda()
    rr = ECOLI_RAGGED
    ragged, lengths = simulate_ragged_reads(
        genome, rr["lo"], rr["hi"], rr["coverage"], rr["error_rate"],
        seed=rr["seed"], contained_frac=rr["contained_frac"])
    ragged = torch.from_numpy(ragged.astype(np.int32)).cuda()
    lengths = torch.from_numpy(lengths.astype(np.int32)).cuda()
    if args.only in (None, "k17"):
        libs = {t: build(root, "fix_windows", tmp, t)
                for t, root in checkouts}
        libs.update(other("fix_windows"))
        variants = [t for t in libs if t not in tags]
        run_k17(libs, tags, turns + variants, "phase 4", reads, None, "last")
        run_k17(libs, tags, turns, "phase 4", reads, None, "first")
        run_k17(libs, tags, turns, "phase 4", reads, None, "last",
                directory_only=True)
        run_k17(libs, tags, turns + variants, "8a", ragged, lengths, "last")
    if args.only in (None, "k16"):
        libs = {t: build(root, "weak_windows", tmp, t)
                for t, root in checkouts}
        run_k16(libs, tags, turns, "phase 4", reads, None)
        run_k16(libs, tags, turns, "8a", ragged, lengths)
    if args.only in (None, "k12"):
        libs = {t: build(root, "dedup_reads", tmp, t)
                for t, root in checkouts}
        libs.update(other("dedup_reads"))
        variants = [t for t in libs if t not in tags]
        fixed = correct_reads(reads, K, THRESHOLD, 2)
        run_k12(libs, tags, turns + variants, "phase 4", fixed, None)
        run_k12(libs, tags, turns + variants, "8a", ragged, lengths)
        skew = fixed.clone()
        skew[::10, :32] = 0
        run_k12(libs, tags, turns + variants, "skew", skew, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
