#!/usr/bin/env python3
"""A/B of the PyTorch port's K3 (overlap_join) and K16 (weak_windows) CUDA
kernels against another checkout's, on one GPU, launch by launch.

    python3 scripts/probe_join_weak_ab.py [--baseline DIR] [--scale F]
                                          [--only k3|k16] [--seed S]

DIR is the root of another checkout (e.g. `git archive <commit>
sage2_tpu_torch | tar -x -C .smoke_checkout/parent`); both checkouts'
overlap_join.cu and weak_windows.cu are compiled with the same nvcc flags
(-Xptxas -v printed for each) and called through their own C interface,
which the script tells apart by its symbols:

  K3 old: a count pass (a thread a row, the run head walking its run),
      torch.cumsum of the counts, a host read of the total, the starts
      (offsets - counts), a write pass (a thread a query row looping over
      its run's entries); the fixed-capacity mode the same without the
      host read; new: the runs with their first slots by a look-back, a
      host read (none in the fixed-capacity mode), the slot tiles with
      the payload rows staged (kernels/csrc/overlap_join.cu);
  K16 old: mask (lookups through K2's bucket directory), the one-block
      scan of the tile counts, a host read, write; new: mask (membership
      in the table of the solid keys, the tiles' first slots by a
      look-back), a host read, write; the membership table's build (once
      a round) timed apart. Both take K2's directory from this checkout.

Inputs, made on the card from a seed (--scale shrinks the read counts):

  K3  phase 4's join: 4.6 M reads2 of 100 bp (2.3 M reads from a random
      4.6 Mbp genome with 0.5% substitutions, and their reverse
      complements), s = 32, g = 8, n_pos = 8, min_overlap 40, the rows
      by this checkout's K13; the ragged join (lengths uniform in [60,
      100], containment marks); the same at 8a's shape (4.5 M reads2 of
      150 bp, lengths uniform in [75, 150]); a streamed slab of 4.5 M
      reads2's entry rows with a query chunk of 2 M reads2 (10c's sizes,
      ragged); the
      meshed join, a quarter of the reads2's rows in a shuffled
      received order with the sort's permutation; the bench's shard in
      the fixed-capacity mode (100,000 reads of a 222,222 bp genome,
      capacity 1,114,112); a hot key, the shard with 250 reads2 poly-A
      (2,000 entry and 2,000 query rows of one key: 4 M candidates).
  K16 phase 4's 2.3 M reads (k = 25, threshold 2) and 8a's ragged reads
      (2.25 M reads of 150 bp, lengths uniform in [75, 150]), each
      against the pruned count table of those reads.

Each launch is timed apart (median of 5 CUDA-event timings after a
warm-up), old and new in turns (new, old, old, new), the host reads too,
then the whole call; every output of the two checkouts is compared bit
for bit, and with the plain version. Beside them: the bound
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

from chip_smoke import HBM_BYTES_PER_S, OPS_PER_S, work  # noqa: E402
from probe_route_reduce_ab import split_ms  # noqa: E402
from probe_seed_edges_ab import call, genome_reads, ptr, stream  # noqa

CSRC = os.path.join("sage2_tpu_torch", "kernels", "csrc")
P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
OLD = {
    "sage2_join_count": [P, P, I64, I, I, P, P, P],
    "sage2_join_write": [P, P, I64, I, P, I64, I, I, I, I64, P, P, P, I, I,
                         I, I, I64, P, P, P, P, P, P, P],
    "sage2_join_count_fixed": [P, P, I64, P, I, I, P, P, P],
    "sage2_join_write_fixed": [P, P, I, I64, P, P, P, P, I, I, I, I, I64, P,
                               P, P, P, P],
    "sage2_weak_mask": [P, P, I64, I, I, P, P, I64, P, I, P, P, P],
    "sage2_scan_tiles": [P, I64, P, P],
    "sage2_weak_write": [P, I64, I, P, P, P],
}
NEW = {
    "sage2_join_runs": [P, P, I64, P, I, I, P, P, P, P],
    "sage2_join_slots": [P, P, I64, I, P, I64, I, I, I, P, P, P, P, I, I, I,
                         I, I64, P, P, P, P, P, P],
    "sage2_solid_table": [P, P, I64, I, I, I, P, P, P],
    "sage2_weak_mask": [P, P, I64, I, I, P, P, I64, P, P, I, P, P, P],
    "sage2_weak_write": [P, I64, I, P, P, P],
}
OLD_WEAK_TILE_READS = 32   # the parent's kTileReads


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
    new = hasattr(lib, "sage2_join_runs") or hasattr(lib, "sage2_solid_table")
    for fn, sig in (NEW if new else OLD).items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = sig
            getattr(lib, fn).restype = I
    lib.new = new
    return lib


# --- K3 ---------------------------------------------------------------------

def k3_steps(lib, a: dict):
    """One checkout's K3 on the inputs ``a`` as (part, fn) steps and a
    function giving its outputs (ok, cand_a, cand_b, ovl, total)."""
    import torch

    from sage2_tpu_torch import kernels

    dev = a["s_keys"].device
    n = a["s_keys"].shape[0]
    R, g, trim, mo = a["R"], a["g"], a["trim"], a["min_overlap"]
    W2 = a["payload"].shape[1]
    seg = a["segments"]
    fixed = a.get("capacity") is not None
    st = {}
    steps = []

    def outputs(n_out):
        st["ok"] = torch.empty(n_out, dtype=torch.bool, device=dev)
        st["cand"] = [torch.empty(n_out, dtype=torch.int32, device=dev)
                      for _ in range(3)]

    def outs():
        return (st["ok"], *st["cand"], st["total"])

    if lib.new:
        tiles = max(1, -(-n // kernels.JOIN_COUNT_TILE))
        runs = n // 2
        ctl = torch.empty(3 + 2 * tiles, dtype=torch.int64, device=dev)
        base = torch.empty(runs + 1, dtype=torch.int64, device=dev)
        run = torch.empty((max(runs, 1), 2), dtype=torch.int32, device=dev)
        steps.append(("runs", lambda: call(
            lib, "sage2_join_runs", ptr(a["s_keys"]), ptr(a["s_rows"]), n,
            ptr(a.get("n_live")), R, g, ptr(ctl), ptr(base), ptr(run),
            stream())))
        if fixed:
            outputs(a["capacity"])
            st["total"] = ctl[0]
        else:
            def read():
                st["total"] = int(ctl[0])
                outputs(st["total"])

            steps.append(("host read", read))
        steps.append(("slots", lambda: call(
            lib, "sage2_join_slots", ptr(a["s_rows"]), ptr(seg[0]), seg[1],
            seg[2], ptr(seg[3]), seg[4], seg[5], seg[6], W2,
            ptr(a.get("perm")), ptr(ctl), ptr(base), ptr(run), R, g, trim,
            mo, st["ok"].numel(), ptr(st["ok"]),
            *map(ptr, st["cand"]), ptr(a.get("contained")), stream())))
        return steps, outs
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    ebase = torch.empty(n, dtype=torch.int32, device=dev)
    if fixed:
        steps.append(("count", lambda: call(
            lib, "sage2_join_count_fixed", ptr(a["s_keys"]), ptr(a["s_rows"]),
            n, ptr(a["n_live"]), R, g, ptr(counts), ptr(ebase), stream())))
        outputs(a["capacity"])
    else:
        steps.append(("count", lambda: call(
            lib, "sage2_join_count", ptr(a["s_keys"]), ptr(a["s_rows"]), n,
            R, g, ptr(counts), ptr(ebase), stream())))

    def cumsum():
        st["offsets"] = torch.cumsum(counts, 0, dtype=torch.int64)

    steps.append(("cumsum", cumsum))
    if not fixed:
        def read():
            st["total"] = int(st["offsets"][-1])
            outputs(st["total"])

        steps.append(("host read", read))

    def starts():
        st["starts"] = st["offsets"] - counts
        if fixed:
            st["total"] = st["offsets"][-1]

    steps.append(("starts", starts))
    if fixed:
        steps.append(("write", lambda: call(
            lib, "sage2_join_write_fixed", ptr(a["s_rows"]),
            ptr(a["payload"]), W2, n, ptr(counts), ptr(ebase),
            ptr(st["starts"]), ptr(st["total"]), R, g, trim, mo,
            a["capacity"], ptr(st["ok"]), *map(ptr, st["cand"]), stream())))
    else:
        steps.append(("write", lambda: call(
            lib, "sage2_join_write", ptr(a["s_rows"]), ptr(seg[0]), seg[1],
            seg[2], ptr(seg[3]), seg[4], seg[5], seg[6], W2, n, ptr(counts),
            ptr(ebase), ptr(st["starts"]), R, g, trim, mo, st["ok"].numel(),
            ptr(st["ok"]), *map(ptr, st["cand"]), ptr(a.get("contained")),
            ptr(a.get("perm")), stream())))
    return steps, outs


def k3_plain(a: dict):
    from sage2_tpu_torch.kernels import plain

    seg = a["segments"]
    if a.get("capacity") is not None:
        return plain.overlap_join_stacked(
            a["s_keys"], a["s_rows"], a["payload"], a["n_live"], a["R"],
            a["g"], a["trim"], a["min_overlap"], a["capacity"])
    entry = seg[0] if seg[0] is not seg[3] else None
    return plain.overlap_join(
        a["s_keys"], a["s_rows"], a["payload"], a["R"], a["g"], a["trim"],
        a["min_overlap"], a.get("contained"), None, entry, seg[1], seg[4],
        a.get("perm"))


def k3_work_args(a: dict) -> tuple:
    """The arguments chip_smoke.work reads from a K3 call."""
    seg = a["segments"]
    entry = seg[0] if seg[0] is not seg[3] else None
    if a.get("capacity") is not None:
        return (a["s_keys"], a["s_rows"], a["payload"], a["n_live"], a["R"],
                a["g"], a["trim"], a["min_overlap"], a["capacity"])
    return (a["s_keys"], a["s_rows"], a["payload"], a["R"], a["g"],
            a["trim"], a["min_overlap"], a.get("contained"), None, entry,
            seg[1], seg[4], a.get("perm"))


def run_k3(libs, tags, turns, label, a):
    import torch

    def fresh():
        if a.get("contained") is not None:
            a["contained"].zero_()

    got = {}
    for t in tags:
        fresh()
        steps, outs = k3_steps(libs[t], a)
        for _, fn in steps:
            fn()
        torch.cuda.synchronize()
        marks = None if a.get("contained") is None else a["contained"].clone()
        got[t] = (outs(), marks)
    fresh()
    want = k3_plain(a)
    marks = None if a.get("contained") is None else a["contained"].clone()

    def same(x, y):
        (o1, m1), (o2, m2) = x, y
        return all(torch.equal(p, q) if isinstance(p, torch.Tensor)
                   else p == q for p, q in zip(o1[:4], o2[:4])) and (
            int(o1[4]) == int(o2[4])) and (
            m1 is None or torch.equal(m1, m2))

    new = got["new"]
    eq_old = "-" if len(tags) == 1 else same(new, got["old"])
    eq_plain = same(new, (want, marks))
    total = int(new[0][4])
    key = "overlap_join:stacked" if a.get("capacity") is not None else (
        "overlap_join")
    nbytes, ops = work(key, k3_work_args(a), total)
    bound = max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3
    print(f"K3 {label}: {a['s_keys'].shape[0]} rows, {total} candidates, "
          f"{int(new[0][0].sum())} ok"
          + ("" if marks is None else f", {int(marks.sum())} contained")
          + f"; new equal to old {eq_old}, to plain {eq_plain}; bound "
          f"{bound:.4f} ms", flush=True)
    if eq_old is False or not eq_plain:
        raise AssertionError(f"K3 {label}: outputs differ")
    del got, want, new
    torch.cuda.empty_cache()
    for t in turns:
        steps, _ = k3_steps(libs[t], a)
        parts = split_ms(steps)
        print(f"K3 {label} {t}: " + ", ".join(
            f"{p} {ms:.4f} ms" for p, ms in parts.items()), flush=True)
        del steps
        torch.cuda.empty_cache()


def join_inputs(reads2, lengths, s=32, min_overlap=40, ragged=False):
    """K3's in-core inputs of reads2 (rows by this checkout's K13)."""
    import torch

    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.overlap.detect import join_geometry

    M, L = reads2.shape
    geo = join_geometry(L, min_overlap, s)
    valid = torch.ones(M, dtype=torch.bool, device=reads2.device)
    s_keys, s_rows, payload = kernels.seed_rows(
        reads2, valid, lengths, s, geo.g, geo.n_pos, geo.trim)
    payload = payload.reshape(-1, geo.Wt + 2)
    return {"s_keys": s_keys, "s_rows": s_rows, "payload": payload,
            "R": geo.R, "g": geo.g, "trim": geo.trim,
            "min_overlap": min_overlap,
            "segments": (payload, 0, geo.R, payload, 0, geo.R, 0),
            "contained": (torch.zeros(M, dtype=torch.uint8,
                                      device=reads2.device)
                          if ragged else None)}


# --- K16 --------------------------------------------------------------------

def k16_steps(lib, a: dict):
    """One checkout's K16 call (the membership table built beforehand for
    the new one) as (part, fn) steps and a function giving its output."""
    import torch

    from sage2_tpu_torch import kernels

    reads, lengths, table, counts = (a["reads"], a["lengths"], a["table"],
                                     a["counts"])
    k, threshold = a["k"], a["threshold"]
    N, L = reads.shape
    P_ = L - k + 1
    T = table.shape[0]
    dev = reads.device
    tiles = -(-N // (kernels.WEAK_TILE_READS if lib.new
                     else OLD_WEAK_TILE_READS))
    mask = torch.empty((N, -(-P_ // 32)), dtype=torch.int32, device=dev)
    st = {}
    steps = []
    if lib.new:
        directory = a["directory"]
        off = kernels.solid_offset(T)
        solid = directory[off:] if directory.numel() > off else None
        scan = torch.empty(2 * tiles + 2, dtype=torch.int64, device=dev)
        steps.append(("mask", lambda: call(
            lib, "sage2_weak_mask", ptr(reads), ptr(lengths), N, L, k,
            ptr(table), ptr(counts), T, ptr(directory), ptr(solid),
            threshold, ptr(mask), ptr(scan), stream())))
        offsets, total = scan, scan[tiles:tiles + 1]
    else:
        directory = a["k2_directory"]
        scratch = torch.empty(tiles + 1, dtype=torch.int64, device=dev)
        offsets, total = scratch[:tiles], scratch[tiles:]
        steps.append(("mask", lambda: call(
            lib, "sage2_weak_mask", ptr(reads), ptr(lengths), N, L, k,
            ptr(table), ptr(counts), T, ptr(directory), threshold,
            ptr(mask), ptr(offsets), stream())))
        steps.append(("scan", lambda: call(
            lib, "sage2_scan_tiles", ptr(offsets), tiles, ptr(total),
            stream())))

    def read():
        st["out"] = torch.empty(int(total), dtype=torch.int64, device=dev)

    steps.append(("host read", read))
    steps.append(("write", lambda: call(
        lib, "sage2_weak_write", ptr(mask), N, P_, ptr(offsets),
        ptr(st["out"]), stream())))
    return steps, lambda: st["out"]


def k16_inputs(reads, lengths, k=25, threshold=2):
    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.kmer.correct import prune_table_for_correction
    from sage2_tpu_torch.kmer.count import count_kmers

    t = prune_table_for_correction(count_kmers(reads, k, lengths), threshold)
    return {"reads": reads, "lengths": lengths, "table": t.keys,
            "counts": t.count, "k": k, "threshold": threshold,
            "k2_directory": kernels.lookup_directory(t.keys, t.count)}


def run_k16(libs, tags, turns, label, a):
    import torch

    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.kernels import plain

    import chip_smoke

    T = a["table"].shape[0]
    bits = kernels.solid_bits(T, a["k"])
    a["directory"] = kernels.table_directory(a["table"], a["counts"], a["k"],
                                             a["threshold"])
    build_ms = None if bits is None else chip_smoke.time_ms(
        lambda: kernels.solid_table(a["table"], a["counts"], a["k"],
                                    a["threshold"], a["directory"]))
    got = {}
    for t in tags:
        steps, out = k16_steps(libs[t], a)
        for _, fn in steps:
            fn()
        got[t] = out()
    want = plain.weak_windows(a["reads"], a["lengths"], a["table"],
                              a["counts"], None, a["k"], a["threshold"])
    new = got["new"]
    eq_old = "-" if len(tags) == 1 else torch.equal(new, got["old"])
    eq_plain = torch.equal(new, want)
    nbytes, ops = work("weak_windows", (a["reads"], a["lengths"], a["table"],
                                        a["counts"], None, a["k"],
                                        a["threshold"]), new.numel())
    bound = max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3
    fill = None
    if bits is not None:
        words = a["directory"][kernels.solid_offset(T):]
        buckets = words[kernels.SOLID_HEADER:kernels.SOLID_HEADER
                        + (4 << bits)].view(torch.int32).view(-1, 8)
        used = (buckets != -1).sum(1)
        fill = (f"{1 << bits} buckets of 32 B ({(32 << bits) / 2**20:.1f} "
                f"MiB), {int((used > 0).sum())} occupied, "
                f"{int((buckets[:, 7] < -1).sum())} with an overflow list, "
                f"mean {T / (1 << bits):.2f} keys a bucket")
    print(f"K16 {label}: {a['reads'].shape[0]} reads, {T} solid keys, "
          f"{new.numel()} weak windows; membership table: "
          f"{fill or 'none (K2 directory)'}, its build {build_ms} ms; "
          f"new equal to old {eq_old}, to plain {eq_plain}; bound "
          f"{bound:.4f} ms", flush=True)
    if eq_old is False or not eq_plain:
        raise AssertionError(f"K16 {label}: outputs differ")
    del got, want, new
    torch.cuda.empty_cache()
    for t in turns:
        steps, _ = k16_steps(libs[t], a)
        parts = split_ms(steps)
        print(f"K16 {label} {t}: " + ", ".join(
            f"{p} {ms:.4f} ms" for p, ms in parts.items()), flush=True)
        del steps
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="root of another checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--only", choices=("k3", "k16"))
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
    sc = args.scale
    if args.only in (None, "k3"):
        libs = {t: build(root, "overlap_join", tmp, t)
                for t, root in checkouts}
        reads2 = genome_reads(gen, int(4_600_000 * sc), int(2_300_000 * sc),
                              100, True)
        M = reads2.shape[0]
        a = join_inputs(reads2, None)
        run_k3(libs, tags, turns, "default", a)
        # the meshed join: a quarter of the rows, received in a shuffled
        # order, joined through the sort's permutation
        q = a["s_keys"].shape[0] // 4
        sk, sr = a["s_keys"][:q], a["s_rows"][:q]
        # cut at a run boundary
        while q < a["s_keys"].shape[0] and int(a["s_keys"][q]) == int(sk[-1]):
            q += 1
        sk, sr = a["s_keys"][:q].contiguous(), a["s_rows"][:q].contiguous()
        order = torch.randperm(q, generator=gen, device=dev)
        recv = a["payload"][sr.long()[order]]
        perm = torch.empty_like(order)
        perm[order] = torch.arange(q, device=dev)
        m = dict(a, s_keys=sk, s_rows=sr, payload=recv, perm=perm,
                 segments=(recv, 0, a["R"], recv, 0, a["R"], 0))
        run_k3(libs, tags, turns, "meshed (payload_perm)", m)
        del a, m, sk, sr, recv, perm, order
        torch.cuda.empty_cache()
        lens = torch.randint(60, 101, (M,), generator=gen, dtype=torch.int32,
                             device=dev)
        r2 = torch.where(torch.arange(100, device=dev)[None, :]
                         < lens[:, None], reads2, 0)
        a = join_inputs(r2, lens, ragged=True)
        run_k3(libs, tags, turns, "ragged", a)
        del a
        torch.cuda.empty_cache()
        # the streamed join: an entry slab and one query chunk
        geo_a = join_inputs(r2[:8], lens[:8])
        R, g, trim = geo_a["R"], geo_a["g"], geo_a["trim"]
        n_pos = R - g
        valid = torch.ones(M, dtype=torch.bool, device=dev)
        slab = int(4_500_000 * sc)
        e_keys, e_ids, e_pay = kernels.seed_rows(
            r2[:slab], valid[:slab], lens[:slab], 32, g, n_pos, trim, 0,
            "entries")
        e_pay = e_pay.reshape(-1, e_pay.shape[-1])
        q0, q1 = int(1_000_000 * sc), int(3_000_000 * sc)
        s_keys, s_rows, q_pay = kernels.seed_rows(
            r2[q0:q1], valid[q0:q1], lens[q0:q1], 32, g, n_pos, trim, q0,
            "queries", e_keys, e_ids)
        q_pay = q_pay.reshape(-1, q_pay.shape[-1])
        a = {"s_keys": s_keys, "s_rows": s_rows, "payload": q_pay, "R": R,
             "g": g, "trim": trim, "min_overlap": 40,
             "segments": (e_pay, 0, g, q_pay, q0, n_pos, g),
             "contained": torch.zeros(M, dtype=torch.uint8, device=dev)}
        run_k3(libs, tags, turns, "streamed (slab + query chunk)", a)
        del a, e_keys, e_ids, e_pay, s_keys, s_rows, q_pay, r2, lens, reads2
        torch.cuda.empty_cache()
        # 8a's shape: 150 bp reads2 of lengths uniform in [75, 150]
        n = int(2_250_000 * sc)
        r2 = genome_reads(gen, int(4_600_000 * sc), n, 150, True)
        lens = torch.randint(75, 151, (2 * n,), generator=gen,
                             dtype=torch.int32, device=dev)
        r2 = torch.where(torch.arange(150, device=dev)[None, :]
                         < lens[:, None], r2, 0).contiguous()
        a = join_inputs(r2, lens, ragged=True)
        run_k3(libs, tags, turns, "ragged 150 bp (8a's shape)", a)
        del a, r2, lens
        torch.cuda.empty_cache()
        # the bench's shard: the fixed-capacity mode, then a hot key
        shard = genome_reads(gen, 222_222, 100_000, 100, False)
        sv = torch.ones(100_000, dtype=torch.bool, device=dev)
        keys, rows, pay, n_live = kernels.seed_rows_stacked(
            shard, sv, 32, g, n_pos, trim)
        pay = pay.reshape(-1, pay.shape[-1])
        a = {"s_keys": keys, "s_rows": rows, "payload": pay, "R": R, "g": g,
             "trim": trim, "min_overlap": 40, "n_live": n_live,
             "capacity": 1_114_112,
             "segments": (pay, 0, R, pay, 0, R, 0)}
        run_k3(libs, tags, turns, "stacked shard (fixed capacity)", a)
        hot = shard.clone()
        hot[:250] = 0
        a = join_inputs(hot, None)
        run_k3(libs, tags, turns, "hot key (250 reads poly-A)", a)
        del a, shard, hot, keys, rows, pay
        torch.cuda.empty_cache()
    if args.only in (None, "k16"):
        libs = {t: build(root, "weak_windows", tmp, t)
                for t, root in checkouts}
        reads = genome_reads(gen, int(4_600_000 * sc), int(2_300_000 * sc),
                             100, False)
        run_k16(libs, tags, turns, "default", k16_inputs(reads, None))
        del reads
        torch.cuda.empty_cache()
        n = int(2_250_000 * sc)
        reads = genome_reads(gen, int(4_600_000 * sc), n, 150, False)
        lens = torch.randint(75, 151, (n,), generator=gen, dtype=torch.int32,
                             device=dev)
        reads = torch.where(torch.arange(150, device=dev)[None, :]
                            < lens[:, None], reads, 0).contiguous()
        run_k16(libs, tags, turns, "ragged", k16_inputs(reads, lens))
    return 0


if __name__ == "__main__":
    sys.exit(main())
