#!/usr/bin/env python3
"""A/B of the PyTorch port's K8 (canonical_reads) and K18 (chain_links,
chain_cut) CUDA kernels against another checkout's, on one GPU.

    python3 scripts/probe_canon_chain_ab.py [--baseline DIR]
        [--only k8|k18]

DIR is the root of another checkout (e.g. `git archive <commit>
sage2_tpu_torch | tar -x -C .smoke_checkout/parent`); both checkouts'
canonical_reads.cu and chain_links.cu are compiled with the same nvcc
flags (-Xptxas -v printed for each) and called through their own C
interface, which the script tells apart by the source:

  K8 old: one warp a read, each lane packing two words by 16 dependent
      loads, the reverse-complement rows always written; new: a block a
      tile of consecutive reads loaded by 16-byte loads into a 2-bit
      stream in shared memory, the words by funnel shifts, the choice by
      ballots, the rows (where asked for) by 16-byte stores. The old
      interface writes the rows whatever the call; so the first call is
      timed as the main path makes it: the old kernel's full call, the
      new one's words alone (and its full call beside them). The second
      call (the unique reads' reverse complements) is the old kernel's
      rows into a tensor of their own and the old path's torch.cat of the two
      halves, against the new kernel's rows written into reads2's second
      half;
  K18 old: one cooperative launch (degrees zeroed, edges, vertices, two
      grid barriers); new: the counters zeroed by cudaMemsetAsync, the
      in-edges' 64-bit counters and the out-edges' passes over the rows,
      the degree-one bit maps and the links over the vertices; each on
      the reduced graph's padded rows
      (what the traverse stage passed before) and on its real rows alone
      (what it passes now), so that the input cut and the kernel's design
      are told apart; the cut (old: a thread a vertex; new: four) on the
      same K4 results. Then the traverse stage's own work as the pipeline
      makes it, host clock: the upload of the padded or the real host
      rows, contract_unitigs, a synchronise (this checkout's kernels).

Inputs, made on the card from chip_smoke.py's seeds:

  phase 4  the 4.6 Mbp genome's 2.3 M reads of 100 bp: K8's first call on
      the reads after the two-phase corrector's two rounds, its second on
      the unique reads of their dedup (K12); K18 on the reduced graph of
      phase 4's path (corrector, dedup, overlap join, the device
      reduction, which phase 6 holds equal to the native one): 84.5 M
      padded rows, 3.7 M real;
  8a       the same genome's ragged reads (75-150 bp, 10% contained reads
      of 47-72 bp, zero-padded to 150) with their lengths, uncorrected:
      K8's first and second calls;
  10a      phase 4's first 1,000,000 reads: the streamed dedup's words.

Each call is timed as steps (median of 5 CUDA-event timings after a
warm-up; K18's also behind a spin of the card, so that the host's gaps
between its launches are hidden), old and new in turns (new, old, old,
new); every output is
compared bit for bit, old to new and both to the plain version
(kernels/plain.py, run on the card). Beside them the bound
(chip_smoke.work: bytes over 3.35 TB/s or operations over 67 T/s, the
larger). The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ROOT))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    ECOLI, ECOLI_RAGGED, HBM_BYTES_PER_S, OPS_PER_S, work)
from probe_route_reduce_ab import split_ms  # noqa: E402
from probe_seed_edges_ab import call, ptr, stream  # noqa: E402

CSRC = os.path.join("sage2_tpu_torch", "kernels", "csrc")
P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
K8_SIG = {"sage2_canonical_reads": [P, P, I64, I, P, P, P, P, P]}
K18_SIGS = {
    True: {"sage2_chain_links": [P, P, P, I64, I64] + [P] * 9,
           "sage2_chain_cut": [P, P, P, I64, P, P, P, P, P]},
    False: {"sage2_chain_links": [P, P, P, I64, I64] + [P] * 9,
            "sage2_chain_cut": [P, P, P, I64, P, P, P, P, P]},
}
MARKS = {"canonical_reads": "canonical_tile_kernel",
         "chain_links": "chain_edges_kernel"}


def build(root: str, name: str, outdir: str, tag: str):
    """(lib, new): one checkout's kernel library, and whether it is this
    PR's design (K8's tiles, K18's edge and vertex launches)."""
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
        new = MARKS[name] in f.read()
    sigs = K8_SIG if name == "canonical_reads" else K18_SIGS[new]
    for fn, sig in sigs.items():
        getattr(lib, fn).argtypes = sig
        getattr(lib, fn).restype = I
    return lib, new


def bound_ms(key: str, args: tuple, total=0) -> float:
    nbytes, ops = work(key, args, total)
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def split_device_ms(steps, reps: int = 5) -> dict:
    """split_ms's medians with each run enqueued behind a ~2 ms spin of
    the card (torch.cuda._sleep), so that the host's launch gaps between
    the steps are hidden: the device time of each step and of the call."""
    import torch

    for _, fn in steps:
        fn()
    per = {part: [] for part, _ in steps}
    calls = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(steps) + 1)]
        torch.cuda._sleep(4_000_000)
        ev[0].record()
        for i, (_, fn) in enumerate(steps):
            fn()
            ev[i + 1].record()
        ev[-1].synchronize()
        for i, (part, _) in enumerate(steps):
            per[part].append(ev[i].elapsed_time(ev[i + 1]))
        calls.append(ev[0].elapsed_time(ev[-1]))
    out = {part: statistics.median(v) for part, v in per.items()}
    out["call"] = statistics.median(calls)
    return out


def same(a, b) -> bool:
    import torch

    return all((x is None and y is None) or (
        x is not None and y is not None and torch.equal(x, y))
        for x, y in zip(a, b))


# --- K8 ---------------------------------------------------------------------

def k8_launch(lib, reads, lengths, rc, words):
    """One K8 launch: rows into ``rc`` (or none), words into ``words`` =
    (fwd_w, rc_w, take_rc) (or none)."""
    N, L = reads.shape
    fwd_w, rc_w, take_rc = words if words is not None else (None,) * 3
    call(lib, "sage2_canonical_reads", ptr(reads), ptr(lengths), N, L,
         ptr(rc), ptr(fwd_w), ptr(rc_w), ptr(take_rc), stream())


def k8_outputs(reads, rows=True, words=True):
    import torch

    N, L = reads.shape
    W = -(-L // 16)
    dev = reads.device
    rc = torch.empty_like(reads) if rows else None
    w = (torch.empty((N, W), dtype=torch.int64, device=dev),
         torch.empty((N, W), dtype=torch.int64, device=dev),
         torch.empty(N, dtype=torch.bool, device=dev)) if words else None
    return rc, w


def run_k8_first(libs, tags, turns, label, reads, lengths):
    """The dedup's first call: the old full call against the new words
    alone (and the new full call)."""
    from sage2_tpu_torch.kernels import plain

    want = plain.canonical_reads(reads, lengths)
    got = {}
    for tag in tags:
        lib, new = libs[tag]
        rc, w = k8_outputs(reads, rows=not new)
        k8_launch(lib, reads, lengths, rc, w)
        got[tag] = (rc,) + w
    full_rc, full_w = k8_outputs(reads)
    k8_launch(libs["new"][0], reads, lengths, full_rc, full_w)
    ok_new = same(got["new"][1:], want[1:]) and same((full_rc,) + full_w,
                                                     want)
    ok_old = "-" if len(tags) == 1 else same(got["old"], want)
    words_args = (reads, lengths, False, True)
    full_args = (reads, lengths)
    print(f"K8 {label} first call: {reads.shape[0]} reads of "
          f"{reads.shape[1]}{' with lengths' if lengths is not None else ''}"
          f", {int(want[3].sum())} flipped; new (words, and full) equal "
          f"to plain {ok_new}, old (full) {ok_old}; bound words "
          f"{bound_ms('canonical_reads', words_args):.4f} ms, full "
          f"{bound_ms('canonical_reads', full_args):.4f} ms", flush=True)
    if not ok_new or ok_old is False:
        raise AssertionError(f"K8 {label}: outputs differ")
    del got, want
    outs = {tag: k8_outputs(reads, rows=not libs[tag][1]) for tag in tags}
    for tag in turns:
        lib, new = libs[tag]
        rc, w = outs[tag]
        steps = [("words" if new else "full",
                  lambda: k8_launch(lib, reads, lengths, rc, w))]
        if new:
            steps.append(("full", lambda: k8_launch(lib, reads, lengths,
                                                    full_rc, full_w)))
        parts = split_ms(steps)
        print(f"K8 {label} first call {tag}: " + ", ".join(
            f"{p} {ms:.4f} ms" for p, ms in parts.items() if p != "call"),
            flush=True)


def run_k8_rc(libs, tags, turns, label, uniq, lens_u):
    """The dedup's second call: the unique reads' reverse complements;
    old: into a tensor of their own, then torch.cat with the unique rows;
    new: into reads2's second half."""
    import torch

    from sage2_tpu_torch.kernels import plain

    N, L = uniq.shape
    want = plain.canonical_reads(uniq, lens_u, True)[0]
    reads2 = {tag: torch.empty((2 * N, L), dtype=torch.int32,
                               device=uniq.device) for tag in tags}
    rc_old = torch.empty_like(uniq)

    def steps(tag):
        lib, new = libs[tag]
        r2 = reads2[tag]
        if new:
            return [("rows into reads2", lambda: k8_launch(
                lib, uniq, lens_u, r2[N:], None))]

        def cat():
            torch.cat([uniq, rc_old], dim=0, out=r2)

        return [("rows", lambda: k8_launch(lib, uniq, lens_u, rc_old,
                                           None)),
                ("cat", cat)]

    for tag in tags:
        reads2[tag][:N].copy_(uniq)
        for _, fn in steps(tag):
            fn()
    ok_new = torch.equal(reads2["new"][N:], want)
    ok_old = "-" if len(tags) == 1 else torch.equal(reads2["old"],
                                                    reads2["new"])
    args = (uniq, lens_u, True, False, reads2["new"][N:])
    print(f"K8 {label} rc call: {N} unique reads of {L}; new equal to "
          f"plain {ok_new}, reads2 old equal to new {ok_old}; bound "
          f"{bound_ms('canonical_reads', args):.4f} ms (the rows; the cat "
          f"moved {4 * uniq.numel() * 4 / 1e9:.3f} GB more)", flush=True)
    if not ok_new or ok_old is False:
        raise AssertionError(f"K8 {label} rc: outputs differ")
    for tag in turns:
        parts = split_ms(steps(tag))
        print(f"K8 {label} rc call {tag}: " + ", ".join(
            f"{p} {ms:.4f} ms" for p, ms in parts.items()), flush=True)
    del reads2, rc_old


# --- K18 --------------------------------------------------------------------

def k18_links(lib, new, src, dst, ovl, V, out):
    """One checkout's links call into ``out`` (outdeg, indeg, nxt,
    ovl_next, p, and the scratch: two (V,) int64, two (V,) int32)."""
    outdeg, indeg, nxt, ovl_next, p, s64a, s64b, s32a, s32b = out
    if new:     # in_word, succ, the bit maps
        call(lib, "sage2_chain_links", ptr(src), ptr(dst), ptr(ovl),
             src.numel(), V, ptr(outdeg), ptr(indeg), ptr(s64a), ptr(s64b),
             ptr(s32a), ptr(nxt), ptr(ovl_next), ptr(p), stream())
    else:       # succ, succ_ovl, pred
        call(lib, "sage2_chain_links", ptr(src), ptr(dst), ptr(ovl),
             src.numel(), V, ptr(outdeg), ptr(indeg), ptr(s32a), ptr(s32b),
             ptr(s64a), ptr(nxt), ptr(ovl_next), ptr(p), stream())


def k18_out(V, dev):
    import torch

    return ([torch.empty(V, dtype=torch.int32, device=dev) for _ in range(5)]
            + [torch.empty(V, dtype=torch.int64, device=dev)
               for _ in range(2)]
            + [torch.empty(max(V, 64), dtype=torch.int32, device=dev)
               for _ in range(2)])


def k18_cut(lib, p, pf, m, nxt, ovl_next, p_out, d0):
    call(lib, "sage2_chain_cut", ptr(p), ptr(pf), ptr(m), p.numel(),
         ptr(nxt), ptr(ovl_next), ptr(p_out), ptr(d0), stream())


def run_k18(libs, tags, turns, padded, n_real, V):
    import torch

    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.kernels import plain

    src, dst, ovl = padded
    real = tuple(a[:n_real] for a in padded)
    if bool((real[0] == 2**31 - 1).any()) or bool(
            (src[n_real:] != 2**31 - 1).any()):
        raise AssertionError("the reduced graph's real rows do not lead")
    want = plain.chain_links(*real, V)
    oks = []
    for tag in tags:
        lib, new = libs[tag]
        for rows in (padded, real):
            out = k18_out(V, src.device)
            k18_links(lib, new, *rows, V, out)
            oks.append(same(out[:5], want))
    ids = torch.arange(V, dtype=torch.int32, device=src.device)
    steps = max(1, (max(V, 2) - 1).bit_length() + 1)
    p = want[4]
    pf, _ = kernels.pointer_jump(p, None, "none", steps)
    _, m = kernels.pointer_jump(p, ids, "min", steps)
    n_w, o_w = want[2].clone(), want[3].clone()
    cut_want = plain.chain_cut(p, pf, m, n_w, o_w)
    cut_bufs = {}
    for tag in tags:
        n2, o2 = want[2].clone(), want[3].clone()
        p_out, d0 = torch.empty_like(p), torch.empty_like(p)
        k18_cut(libs[tag][0], p, pf, m, n2, o2, p_out, d0)
        oks.append(same((p_out, d0, n2, o2), cut_want + (n_w, o_w)))
        cut_bufs[tag] = (n2, o2, p_out, d0)
    n_breakers = int((cut_want[0] != p).sum())
    print(f"K18 phase 4: {V} vertices, {src.numel()} padded rows, {n_real} "
          f"real; {n_breakers} cycles cut; every output equal to plain "
          f"(old, new; padded, real; cut) {oks}; bound links padded "
          f"{bound_ms('chain_links', (src, dst, ovl, V)):.4f} ms, real "
          f"{bound_ms('chain_links', real + (V,)):.4f} ms, cut "
          f"{bound_ms('chain_links:cut', (p, pf, m)):.4f} ms", flush=True)
    if not all(oks):
        raise AssertionError("K18: outputs differ")
    out = k18_out(V, src.device)
    for tag in turns:
        lib, new = libs[tag]
        n2, o2, p_out, d0 = cut_bufs[tag]
        steps = [
            ("links padded", lambda: k18_links(lib, new, src, dst, ovl, V,
                                               out)),
            ("links real", lambda: k18_links(lib, new, *real, V, out)),
            ("cut", lambda: k18_cut(lib, p, pf, m, n2, o2, p_out, d0))]
        for how, timer in (("as issued", split_ms),
                           ("on the device", split_device_ms)):
            parts = timer(steps)
            print(f"K18 phase 4 {tag} {how}: " + ", ".join(
                f"{p_} {ms:.4f} ms" for p_, ms in parts.items()
                if p_ != "call"), flush=True)


def traverse_stage(padded, n_real, V, reps=5):
    """The traverse stage's work (pipeline.py), this checkout's kernels,
    host clock: the upload of the host rows (padded, or the real rows
    alone), contract_unitigs, a synchronise; median of reps after a
    warm-up."""
    import numpy as np
    import torch

    from sage2_tpu_torch.graph.traverse import contract_unitigs

    host = [a.cpu().numpy() for a in padded]
    for label, rows in (("padded", host),
                        ("real", [a[:n_real] for a in host])):
        times = []
        for i in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels = contract_unitigs(*(torch.from_numpy(
                np.ascontiguousarray(a)).to("cuda") for a in rows), V)
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t0)
            del labels
        print(f"traverse stage, {label} rows uploaded: median "
              f"{statistics.median(times):.4f} s (of {reps}: "
              + ", ".join(f"{t:.4f}" for t in times) + ")", flush=True)


def phase4_graph(reads):
    """(corrected reads, the padded reduced graph (src, dst, ovl) on the
    card, n_edges, V) of phase 4's path."""
    from sage2_tpu_torch.graph.reduce import transitive_reduction_auto
    from sage2_tpu_torch.kmer.correct import correct_reads
    from sage2_tpu_torch.overlap import find_overlaps_auto, prepare_reads

    corrected = correct_reads(reads, 25, 2, 2)
    rs = prepare_reads(corrected)
    res = find_overlaps_auto(rs.reads2, rs.valid2, 40, 32)
    V = rs.reads2.shape[0]
    del rs
    red = transitive_reduction_auto(res.src, res.dst, res.ovl, V,
                                    reads.shape[1], backend="device")
    return corrected, (red.src, red.dst, red.ovl), red.n_edges, V


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="root of another checkout")
    ap.add_argument("--only", choices=("k8", "k18"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(card(), flush=True)
    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.data import (
        simulate_genome,
        simulate_ragged_reads,
        simulate_reads,
    )

    kernels.load_all()
    tmp = tempfile.mkdtemp()
    checkouts = [("new", os.path.dirname(ROOT))] + (
        [("old", args.baseline)] if args.baseline else [])
    tags = [t for t, _ in checkouts]
    turns = tags + tags[::-1] if len(tags) > 1 else tags

    e = ECOLI
    genome = simulate_genome(e["genome_len"], seed=e["seeds"][0])
    reads, _ = simulate_reads(genome, read_len=e["read_len"],
                              coverage=e["coverage"],
                              error_rate=e["error_rate"], seed=e["seeds"][1])
    reads = torch.from_numpy(reads.astype(np.int32)).cuda()
    corrected, padded, n_real, V = phase4_graph(reads)
    if args.only in (None, "k8"):
        libs = {t: build(root, "canonical_reads", tmp, t)
                for t, root in checkouts}
        run_k8_first(libs, tags, turns, "phase 4", corrected, None)
        k8 = kernels.canonical_reads(corrected, None, False, True)
        uniq = kernels.dedup_reads(corrected, None, *k8)[0]
        del k8
        run_k8_rc(libs, tags, turns, "phase 4", uniq, None)
        del uniq
        run_k8_first(libs, tags, turns, "10a", reads[:1_000_000].clone(),
                     None)
        rr = ECOLI_RAGGED
        ragged, lengths = simulate_ragged_reads(
            genome, rr["lo"], rr["hi"], rr["coverage"], rr["error_rate"],
            seed=rr["seed"], contained_frac=rr["contained_frac"])
        ragged = torch.from_numpy(ragged.astype(np.int32)).cuda()
        lengths = torch.from_numpy(lengths.astype(np.int32)).cuda()
        run_k8_first(libs, tags, turns, "8a", ragged, lengths)
        k8 = kernels.canonical_reads(ragged, lengths, False, True)
        dd = kernels.dedup_reads(ragged, lengths, None, *k8[1:])
        del k8
        run_k8_rc(libs, tags, turns, "8a", dd[0], dd[4])
        del dd, ragged, lengths
        torch.cuda.empty_cache()
    if args.only in (None, "k18"):
        del corrected
        libs = {t: build(root, "chain_links", tmp, t)
                for t, root in checkouts}
        run_k18(libs, tags, turns, padded, n_real, V)
        traverse_stage(padded, n_real, V)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
