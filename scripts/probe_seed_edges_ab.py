#!/usr/bin/env python3
"""A/B of the PyTorch port's K13 (seed_rows) and K14 (longest_edges) CUDA
kernels against another checkout's, on one GPU, launch by launch.

    python3 scripts/probe_seed_edges_ab.py [--baseline DIR] [--scale F]
                                           [--only k13|k14] [--seed S]

DIR is the root of another checkout (e.g. `git archive <commit>
sage2_tpu_torch | tar -x -C .smoke_checkout/parent`); both checkouts'
seed_rows.cu and longest_edges.cu are compiled with the same nvcc flags
(-Xptxas -v printed for each) and called through their own C interface,
which the script tells apart by its symbols:

  K13 old: rows, count, the one-block scan of the tile counts, a host
      read, the compaction in the join's order (or the fixed-capacity
      compaction), a stable torch.sort of the keys, the ids gathered
      through its permutation; new: the rows with the buckets counted,
      the look-back scan, a host read (none in the fixed-capacity mode),
      the two scatter passes (coarse, then fine buckets), the big
      buckets' sort and the bucket sort (kernels/csrc/bucket_sort.cuh);
      an entry slab's rows (rows
      "entries", unsorted): old rows, count, scan, compaction, new rows
      and a look-back compaction;
  K14 old: the keys, torch.sort of them, count, scan, write; new: the
      histogram, scan, two scatter passes, the big buckets' sort and the
      bucket sort (the deferred mode too), over all V ids or a mesh
      shard's range.

Inputs, made on the card from a seed (--scale shrinks the first four):

  K13 4.6 M reads2 of 100 bp (2.3 M reads from a random 4.6 Mbp genome
      with 0.5% substitutions, and their reverse complements), s = 32, g
      = 8, n_pos = 8 (chip_smoke.py phase 4's join); again with ragged
      lengths uniform in [60, 100]; skewed, 6,250 of the reads poly-A
      (100,000 live rows of one key: a bucket past a block's 2,048), and
      a low-complexity read set, 62,500 reads poly-A (10^6 rows of one
      key); the entry slab of the first 1.5 M reads2 (rows t < 8, the
      10c path's size);
  K14 91.4 M candidates over V = 4.6 M vertices, read_len 100, 65% ok,
      3% of the rows a copy of another's pair at an overlap one shorter
      (phase 4's size); skewed, 100,000 and 10^6 candidates of one
      source; a mesh shard's merge (chip_smoke.py's S6: 22.85 M edges,
      all ok, sources in the second of four ranges of V), bucketed over
      the shard's range and over all V;
  the bench's shard (bench.py, chip_smoke.py phase 11): K13's fixed-
      capacity mode on 100,000 reads of a 222,222 bp genome (1.6 M
      rows), K14's deferred mode on its 1,114,112-slot capacity, 61% ok,
      1% duplicate pairs.

Each launch is timed apart (median of 5 CUDA-event timings after a
warm-up), old and new in turns (new, old, old, new), the host reads too,
then the whole call; every output of the two checkouts is compared bit
for bit. Beside them: torch.sort of the same int64 keys (the old call
sorted: K13's live keys, stable; K14's n keys, -1 where not ok), the
yardstick, and the bound (chip_smoke.work: bytes over 3.35 TB/s or
operations over 67 T/s, the larger). The card's name and power limit
come first.
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

from chip_smoke import HBM_BYTES_PER_S, OPS_PER_S, time_ms, work  # noqa
from probe_route_reduce_ab import split_ms  # noqa: E402

CSRC = os.path.join("sage2_tpu_torch", "kernels", "csrc")
P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
OLD = {
    "sage2_seed_rows": [P, P, P, I64, I, I, I, I, I, I, I, P, P, P, P],
    "sage2_seed_count": [P, I64, I, I, I, P, P],
    "sage2_scan_tiles": [P, I64, P, P],
    "sage2_seed_compact": [P, P, I64, I, I, I, I, I64, P, P, P, P],
    "sage2_seed_compact_fixed": [P, P, I64, I, I, P, P, P, P, P],
    "sage2_seed_gather": [P, P, I64, P, P],
    "sage2_edge_keys": [P, P, P, P, I64, I, I, I, P, P],
    "sage2_edge_count": [P, I64, I, P, P],
    "sage2_edge_count_deferred": [P, I64, I, P, P, P],
    "sage2_edge_write": [P, I64, I, I, I, P, P, P, P, P, I64, I, P, P, P,
                         P],
}
NEW = {
    "sage2_seed_rows": [P, P, P, I64, I, I, I, I, I, I, I, P, P, P, P, I64,
                        P, I, P],
    "sage2_seed_scan": [P, I, P],
    "sage2_seed_scatter": [P, P, I64, I, I, I, I, I64, P, P, I64, P, I, P,
                           P],
    "sage2_seed_split": [P, P, P, I, P],
    "sage2_seed_big": [P, P, P, I, I64, P, P, P],
    "sage2_seed_sort": [P, P, I, I64, P, P, P],
    "sage2_seed_compact": [P, P, I64, I, I, I, I, I64, P, P, P, P],
    "sage2_edge_hist": [P, P, I64, I64, I64, P, I, P],
    "sage2_edge_scan": [P, I, P],
    "sage2_edge_scatter": [P, P, P, P, I64, I64, I64, I, I, I, P, I, P, P],
    "sage2_edge_split": [P, P, P, I, I64, I64, I, I, I, P],
    "sage2_edge_big": [P, P, P, I, I64, I, I, I, I, P, P, P, P],
    "sage2_edge_sort": [P, P, P, I, I64, I, I, I, I64, I, P, P, P, P],
}
SCAN_TILE = 1024        # the old kernels' scan.cuh tile


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
    new = hasattr(lib, "sage2_seed_scan") or hasattr(lib, "sage2_edge_hist")
    for fn, sig in (NEW if new else OLD).items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = sig
            getattr(lib, fn).restype = I
    lib.new = new
    return lib


def call(lib, fn, *args):
    rc = getattr(lib, fn)(*args)
    if rc:
        raise RuntimeError(f"{fn}: CUDA error {rc}")


def ptr(t):
    return None if t is None else t.data_ptr()


def stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def k13_steps(lib, reads2, valid2, lengths, s, g, n_pos, trim, mode):
    """One checkout's K13 (mode "all": every row sorted; "stacked": the
    fixed-capacity mode; "entries": an entry slab's rows, compacted in id
    order) as (part, fn) steps and its outputs' dict."""
    import torch

    from sage2_tpu_torch.kernels import bucket_plan

    M, L = reads2.shape
    R = g + n_pos
    t0, Rw = 0, (g if mode == "entries" else R)
    n = M * Rw
    dev = reads2.device
    Wt = -(-(L - g) // 16) - trim
    st = {"keys": torch.empty(n, dtype=torch.int64, device=dev),
          "live": torch.empty(n, dtype=torch.uint8, device=dev),
          "payload": torch.empty((M, Rw, Wt + 2), dtype=torch.int32,
                                 device=dev)}
    geo = (ptr(reads2), ptr(valid2), ptr(lengths), M, L, s, g, n_pos, trim,
           t0, Rw)
    outs = (ptr(st["keys"]), ptr(st["live"]), ptr(st["payload"]))
    stacked = mode == "stacked"
    steps = []
    if mode == "entries":
        st["base"] = torch.empty(n, dtype=torch.int32, device=dev)
        st["ckeys"] = torch.empty(n, dtype=torch.int64, device=dev)
        if lib.new:
            tiles = max(1, -(-n // 2048))
            state = torch.empty(2 + tiles, dtype=torch.int64, device=dev)
            steps.append(("rows", lambda: call(
                lib, "sage2_seed_rows", *geo, *outs, None, 0, None, 0,
                stream())))
            steps.append(("compact", lambda: call(
                lib, "sage2_seed_compact", ptr(st["live"]), ptr(st["keys"]),
                M, g, n_pos, t0, Rw, 0, ptr(state), ptr(st["base"]),
                ptr(st["ckeys"]), stream())))
            total = state[0]
        else:
            tiles = max(1, -(-n // SCAN_TILE))
            scratch = torch.empty(tiles + 1, dtype=torch.int64, device=dev)
            counts, total = scratch[:tiles], scratch[tiles]
            steps.append(("rows", lambda: call(lib, "sage2_seed_rows", *geo,
                                               *outs, stream())))
            steps.append(("count", lambda: call(
                lib, "sage2_seed_count", ptr(st["live"]), M, g, n_pos, Rw,
                ptr(counts), stream())))
            steps.append(("scan", lambda: call(
                lib, "sage2_scan_tiles", ptr(counts), tiles, ptr(total),
                stream())))
            steps.append(("compact", lambda: call(
                lib, "sage2_seed_compact", ptr(st["live"]), ptr(st["keys"]),
                M, g, n_pos, t0, Rw, 0, ptr(counts), ptr(st["base"]),
                ptr(st["ckeys"]), stream())))

        def read():
            st["n"] = int(total)
            st["s_keys"] = st["ckeys"][:st["n"]]
            st["s_rows"] = st["base"][:st["n"]]

        steps.append(("host read", read))
        st["n_live"] = lambda: int(total)
        return steps, st
    if lib.new:
        d = bucket_plan.bucket_bits(n)
        scratch = torch.empty(bucket_plan.scratch_words(d, n),
                              dtype=torch.int64, device=dev)
        steps.append(("rows", lambda: call(
            lib, "sage2_seed_rows", *geo, *outs, None, 0, ptr(scratch), d,
            stream())))
        steps.append(("scan", lambda: call(lib, "sage2_seed_scan",
                                           ptr(scratch), d, stream())))

        def read():
            st["n"] = n if stacked else int(scratch[0])
            st["elems"] = torch.empty((st["n"], 2), dtype=torch.int64,
                                      device=dev)
            st["tmp"] = torch.empty_like(st["elems"])
            st["s_keys"] = torch.empty(st["n"], dtype=torch.int64,
                                       device=dev)
            st["s_rows"] = torch.empty(st["n"], dtype=torch.int32,
                                       device=dev)

        steps.append(("host read", read))
        steps.append(("scatter", lambda: call(
            lib, "sage2_seed_scatter", ptr(st["keys"]), ptr(st["live"]), M,
            g, n_pos, 0, R, 0, None, None, 0, ptr(scratch), d,
            ptr(st["elems"]), stream())))
        steps.append(("split", lambda: call(
            lib, "sage2_seed_split", ptr(st["elems"]), ptr(st["tmp"]),
            ptr(scratch), d, stream())))
        steps.append(("big", lambda: call(
            lib, "sage2_seed_big", ptr(st["elems"]), ptr(st["tmp"]),
            ptr(scratch), d, n, ptr(st["s_keys"]), ptr(st["s_rows"]),
            stream())))
        steps.append(("sort", lambda: call(
            lib, "sage2_seed_sort", ptr(st["tmp"]), ptr(scratch), d,
            n if stacked else 0, ptr(st["s_keys"]), ptr(st["s_rows"]),
            stream())))
        st["n_live"] = lambda: int(scratch[0])
        return steps, st
    tiles = max(1, -(-n // SCAN_TILE))
    scratch = torch.empty(tiles + 1, dtype=torch.int64, device=dev)
    counts, total = scratch[:tiles], scratch[tiles:]
    steps.append(("rows", lambda: call(lib, "sage2_seed_rows", *geo, *outs,
                                       stream())))
    steps.append(("count", lambda: call(lib, "sage2_seed_count",
                                        ptr(st["live"]), M, g, n_pos, R,
                                        ptr(counts), stream())))
    steps.append(("scan", lambda: call(lib, "sage2_scan_tiles", ptr(counts),
                                       tiles, ptr(total), stream())))
    st["base"] = torch.empty(n, dtype=torch.int32, device=dev)
    st["ckeys"] = torch.empty(n, dtype=torch.int64, device=dev)
    if stacked:
        steps.append(("compact", lambda: call(
            lib, "sage2_seed_compact_fixed", ptr(st["live"]),
            ptr(st["keys"]), M, g, n_pos, ptr(counts), ptr(total),
            ptr(st["base"]), ptr(st["ckeys"]), stream())))
        st["n"] = n
    else:
        steps.append(("compact", lambda: call(
            lib, "sage2_seed_compact", ptr(st["live"]), ptr(st["keys"]), M,
            g, n_pos, 0, R, 0, ptr(counts), ptr(st["base"]),
            ptr(st["ckeys"]), stream())))

        def read():
            st["n"] = int(total)

        steps.append(("host read", read))

    def sort():
        st["s_keys"], st["perm"] = torch.sort(st["ckeys"][:st["n"]],
                                              stable=True)
        st["s_rows"] = torch.empty(st["n"], dtype=torch.int32, device=dev)

    steps.append(("torch.sort", sort))
    steps.append(("gather", lambda: call(
        lib, "sage2_seed_gather", ptr(st["base"]), ptr(st["perm"]), st["n"],
        ptr(st["s_rows"]), stream())))
    st["n_live"] = lambda: int(total)
    return steps, st


def k14_steps(lib, ok, a, b, ovl, V, L, capacity, deferred, sources):
    """One checkout's K14 (normal or deferred mode; the new kernels'
    buckets over ``sources``, (lo, hi), or all V ids) as (part, fn) steps
    and its outputs' dict."""
    import torch

    from sage2_tpu_torch.kernels import bucket_plan, plain

    n = ok.shape[0]
    dev = ok.device
    db, ob = plain.edge_key_bits(V, L)
    wide = 2 * db + ob > 63
    st = {x: torch.empty(capacity, dtype=torch.int32, device=dev)
          for x in ("src", "dst", "ovl")}
    out = (ptr(st["src"]), ptr(st["dst"]), ptr(st["ovl"]))
    if lib.new:
        lo, hi = sources or (0, V)
        d = bucket_plan.edge_bucket_bits(n, hi - lo)
        rng = (lo, hi - lo)
        scratch = torch.empty(bucket_plan.scratch_words(d, n),
                              dtype=torch.int64, device=dev)
        st["elems"] = torch.empty((n, 2 if wide else 1), dtype=torch.int64,
                                  device=dev)
        st["tmp"] = torch.empty_like(st["elems"])
        steps = [
            ("histogram", lambda: call(lib, "sage2_edge_hist", ptr(ok),
                                       ptr(a), n, *rng, ptr(scratch), d,
                                       stream())),
            ("scan", lambda: call(lib, "sage2_edge_scan", ptr(scratch), d,
                                  stream())),
            ("scatter", lambda: call(
                lib, "sage2_edge_scatter", ptr(ok), ptr(a), ptr(b), ptr(ovl),
                n, *rng, db, ob, int(wide), ptr(scratch), d,
                ptr(st["elems"]), stream())),
            ("split", lambda: call(
                lib, "sage2_edge_split", ptr(st["elems"]), ptr(st["tmp"]),
                ptr(scratch), d, *rng, db, ob, int(wide), stream())),
            ("big", lambda: call(
                lib, "sage2_edge_big", ptr(st["elems"]), ptr(st["tmp"]),
                ptr(scratch), d, n, db, ob, int(wide), int(deferred), *out,
                stream())),
            ("sort", lambda: call(
                lib, "sage2_edge_sort", ptr(st["elems"]), ptr(st["tmp"]),
                ptr(scratch), d, n, db, ob, int(wide), capacity,
                int(deferred), *out, stream())),
        ]
        st["counts"] = lambda: (int(scratch[1]),
                                int(scratch[0]) if deferred else None)
        return steps, st
    tiles = max(1, -(-n // SCAN_TILE))
    scratch = torch.empty(tiles + 2, dtype=torch.int64, device=dev)
    counts, total, keepers = scratch[:tiles], scratch[tiles], scratch[tiles + 1]
    st["keys"] = torch.empty(n, dtype=torch.int64, device=dev)

    def sort():
        st["sorted"] = torch.sort(st["keys"]).values

    def count():
        if deferred:
            keepers.zero_()
            call(lib, "sage2_edge_count_deferred", ptr(st["sorted"]), n, ob,
                 ptr(counts), ptr(keepers), stream())
        else:
            call(lib, "sage2_edge_count", ptr(st["sorted"]), n, ob,
                 ptr(counts), stream())

    steps = [
        ("keys", lambda: call(lib, "sage2_edge_keys", ptr(ok), ptr(a), ptr(b),
                              ptr(ovl), n, db, ob, 0, ptr(st["keys"]),
                              stream())),
        ("torch.sort", sort),
        ("count", count),
        ("scan", lambda: call(lib, "sage2_scan_tiles", ptr(counts), tiles,
                              ptr(total), stream())),
        ("write", lambda: call(
            lib, "sage2_edge_write", ptr(st["sorted"]), n, db, ob, 0, None,
            None, ptr(ovl), ptr(counts), ptr(total), capacity, int(deferred),
            *out, stream())),
    ]
    st["counts"] = lambda: ((int(keepers), int(total)) if deferred
                            else (int(total), None))
    return steps, st


def genome_reads(gen, genome_len, n_reads, L, revcomp):
    """(n_reads (x2 with their reverse complements), L) int32 codes from a
    random genome, 0.5% substitutions."""
    import torch

    dev = torch.device("cuda")
    genome = torch.randint(0, 4, (genome_len + L,), generator=gen,
                           dtype=torch.int32, device=dev)
    starts = torch.randint(0, genome_len, (n_reads,), generator=gen,
                           device=dev)
    reads = genome[starts[:, None] + torch.arange(L, device=dev)]
    err = torch.rand(reads.shape, generator=gen, device=dev) < 0.005
    shift = torch.randint(1, 4, reads.shape, generator=gen,
                          dtype=torch.int32, device=dev)
    reads = torch.where(err, (reads + shift) % 4, reads)
    if revcomp:
        reads = torch.cat([reads, (3 - reads).flip(1)])
    return reads.contiguous()


def candidates(gen, n, V, L, ok_share, dup_share):
    """(ok, a, b, ovl) of n join candidates over V vertices; dup_share of
    the rows copy another row's pair at an overlap one shorter."""
    import torch

    dev = torch.device("cuda")
    a = torch.randint(0, V, (n,), generator=gen, dtype=torch.int32,
                      device=dev)
    b = torch.randint(0, V, (n,), generator=gen, dtype=torch.int32,
                      device=dev)
    ovl = torch.randint(41, L, (n,), generator=gen, dtype=torch.int32,
                        device=dev)
    ok = torch.rand(n, generator=gen, device=dev) < ok_share
    nd = int(n * dup_share)
    if nd:
        to = torch.randperm(n, generator=gen, device=dev)[:nd]
        fr = torch.randint(0, n, (nd,), generator=gen, device=dev)
        a[to], b[to], ovl[to] = a[fr], b[fr], ovl[fr] - 1
        ok[to] = True
    return ok, a, b, ovl


def run_k13(libs, tags, turns, label, args, mode):
    import torch

    from sage2_tpu_torch.kernels import plain

    outs = {}
    for t in tags:
        steps, st = k13_steps(libs[t], *args, mode)
        for _, fn in steps:
            fn()
        outs[t] = (st["s_keys"], st["s_rows"], st["payload"], st["n_live"]())
    got = outs["new"]
    same = len(tags) == 1 or all(
        torch.equal(x, y) for x, y in zip(got[:3], outs["old"][:3])) and (
        got[3] == outs["old"][3])
    keys_live = got[0][:got[3]]
    sort_ms = time_ms(lambda: torch.sort(keys_live, stable=True))
    nbytes, ops = work("seed_rows", args[:3] + args[3:7], got[3])
    bound = max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3
    print(f"K13 {label}: {args[0].shape[0]} reads2, {got[3]} live rows of "
          f"{args[0].shape[0] * (args[4] + args[5])}; outputs equal {same}; "
          f"torch.sort(live keys, stable) {sort_ms:.4f} ms; bound "
          f"{bound:.4f} ms", flush=True)
    if mode != "stacked":
        kind = "all" if mode == "all" else "entries"
        want = plain.seed_rows(*args, 0, kind)
        print(f"K13 {label}: equal to plain.seed_rows "
              f"{all(torch.equal(x, y) for x, y in zip(got[:3], want))}",
              flush=True)
        del want
    del outs, got, keys_live
    torch.cuda.empty_cache()
    for t in turns:
        steps, st = k13_steps(libs[t], *args, mode)
        parts = split_ms(steps)
        print(f"K13 {label} {t}: " + ", ".join(
            f"{p} {ms:.4f} ms" for p, ms in parts.items()), flush=True)
        del steps, st
        torch.cuda.empty_cache()


def run_k14(libs, tags, turns, label, args, deferred, sources=None,
            also_all=False):
    """K14 on ``args`` in both checkouts (the new one's buckets over
    ``sources``; with ``also_all`` the new one's over all V ids too)."""
    import torch

    from sage2_tpu_torch.kernels import plain

    runs = [(t, sources if t == "new" else None) for t in tags]
    if also_all:
        runs.append(("new", None))
    outs = {}
    for t, srcs in runs:
        steps, st = k14_steps(libs[t], *args, deferred, srcs)
        for _, fn in steps:
            fn()
        outs[t, srcs] = (st["src"], st["dst"], st["ovl"], st["counts"]())
    got = outs["new", sources]
    same = all(all(torch.equal(x, y) for x, y in zip(got[:3], o[:3]))
               and got[3] == o[3] for o in outs.values())
    ok, a, b, ovl, V, L, cap = args
    db, ob = plain.edge_key_bits(V, L)
    keys = torch.where(ok, (a.long() << (db + ob)) | (b.long() << ob)
                       | ovl.long(), torch.full_like(a, -1, dtype=torch.int64))
    sort_ms = time_ms(lambda: torch.sort(keys))
    del keys
    nbytes, ops = work("longest_edges", args, got[3][0])
    bound = max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3
    print(f"K14 {label}: {ok.numel()} candidates, {int(ok.sum())} ok, "
          f"counts (keepers, written where deferred) {got[3]}; outputs "
          f"equal {same}; torch.sort(keys) {sort_ms:.4f} ms; bound "
          f"{bound:.4f} ms", flush=True)
    del outs, got
    torch.cuda.empty_cache()
    for t in turns:
        for srcs in ([sources, None] if also_all and t == "new"
                     else [sources if t == "new" else None]):
            steps, st = k14_steps(libs[t], *args, deferred, srcs)
            parts = split_ms(steps)
            over = "" if t == "old" else (
                " (buckets over all V)" if srcs is None
                else f" (buckets over [{srcs[0]}, {srcs[1]}))")
            print(f"K14 {label} {t}{over}: " + ", ".join(
                f"{p} {ms:.4f} ms" for p, ms in parts.items()), flush=True)
            del steps, st
            torch.cuda.empty_cache()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="root of another checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--only", choices=("k13", "k14"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    tmp = tempfile.mkdtemp()
    checkouts = [("new", os.path.dirname(ROOT))] + (
        [("old", args.baseline)] if args.baseline else [])
    names = {"k13": ("seed_rows",), "k14": ("longest_edges",)}.get(
        args.only, ("seed_rows", "longest_edges"))
    tags = [t for t, _ in checkouts]
    turns = tags + tags[::-1] if len(tags) > 1 else tags
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    dev = torch.device("cuda")
    sc = args.scale
    if "seed_rows" in names:
        libs = {t: build(root, "seed_rows", tmp, t) for t, root in checkouts}
        n_reads = int(2_300_000 * sc)
        reads2 = genome_reads(gen, int(4_600_000 * sc), n_reads, 100, True)
        M = reads2.shape[0]
        valid = torch.ones(M, dtype=torch.bool, device=dev)
        geo = (32, 8, 8, 2)
        run_k13(libs, tags, turns, "default", (reads2, valid, None, *geo),
                "all")
        lens = torch.randint(60, 101, (M,), generator=gen, dtype=torch.int32,
                             device=dev)
        run_k13(libs, tags, turns, "ragged", (reads2, valid, lens, *geo),
                "all")
        slab = int(1_500_000 * sc)
        run_k13(libs, tags, turns, "entry slab",
                (reads2[:slab], valid[:slab], lens[:slab], *geo), "entries")
        del lens
        skew = reads2.clone()
        skew[: int(6250 * sc)] = 0           # 100,000 rows of one key
        run_k13(libs, tags, turns, "skewed", (skew, valid, None, *geo),
                "all")
        skew[: int(62_500 * sc)] = 0         # 10^6 rows of one key
        run_k13(libs, tags, turns, "hot key", (skew, valid, None, *geo),
                "all")
        del skew, reads2, valid
        torch.cuda.empty_cache()
        shard = genome_reads(gen, 222_222, 100_000, 100, False)
        sv = torch.ones(100_000, dtype=torch.bool, device=dev)
        run_k13(libs, tags, turns, "stacked shard", (shard, sv, None, *geo),
                "stacked")
        del shard, sv
        torch.cuda.empty_cache()
    if "longest_edges" in names:
        libs = {t: build(root, "longest_edges", tmp, t)
                for t, root in checkouts}
        n = int(91_400_000 * sc)
        V = int(4_600_000 * sc)
        ok, a, b, ovl = candidates(gen, n, V, 100, 0.65, 0.03)
        run_k14(libs, tags, turns, "default", (ok, a, b, ovl, V, 100,
                                               n + 4_000_000), False)
        a[: int(100_000 * sc)] = 12_345     # one source's 100,000 rows
        ok[: int(100_000 * sc)] = True
        run_k14(libs, tags, turns, "skewed", (ok, a, b, ovl, V, 100,
                                              n + 4_000_000), False)
        a[: int(1_000_000 * sc)] = 12_345   # and 10^6 rows
        ok[: int(1_000_000 * sc)] = True
        run_k14(libs, tags, turns, "hub", (ok, a, b, ovl, V, 100,
                                           n + 4_000_000), False)
        del ok, a, b, ovl
        torch.cuda.empty_cache()
        # a mesh shard's merge: the second of four source ranges
        v_d = -(-V // 4)
        ok, a, b, ovl = candidates(gen, n // 4, V, 100, 1.0, 0.03)
        a = v_d + a % v_d
        run_k14(libs, tags, turns, "shard", (ok, a, b, ovl, V, 100, n // 4),
                False, (v_d, 2 * v_d), also_all=True)
        del ok, a, b, ovl
        torch.cuda.empty_cache()
        C = 1_114_112
        ok, a, b, ovl = candidates(gen, C, 100_000, 100, 0.61, 0.01)
        run_k14(libs, tags, turns, "deferred shard", (ok, a, b, ovl, 100_000,
                                                      100, C), True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
