#!/usr/bin/env python3
"""A/B of the PyTorch port's K15 (prune_table) and K20 heads
(routed_gather.cu's dedup_heads) CUDA kernels against another
checkout's, on one GPU.

    python3 scripts/probe_prune_heads_ab.py [--baseline DIR]
        [--only k15|k20]

DIR is the root of another checkout (e.g. `git archive <commit>
sage2_tpu_torch | tar -x -C .smoke_checkout/parent`); both checkouts'
prune_table.cu and routed_gather.cu are compiled with the same nvcc flags
(-Xptxas -v printed for each) and called through their own C interface,
which the script tells apart by the source:

  K15 old: a count launch (one block a tile of 1,024 entries), the
      one-block scan of the tile counts (scan.cuh's sage2_scan_tiles),
      the host read of the total and the outputs' allocation, a write
      launch that recounts its tile; new: one launch (tiles of 4,096 in
      ticket order, a decoupled look-back for their first slots, the kept
      entries staged in shared memory and stored coalesced) into the
      wrapper's one allocation (kernels.prune_buffers: outputs of the
      table's size, the ticket, the total and the look-back's words),
      then the host read of the total (the outputs are views of the
      buffer; a copy of the kept entries to their own size, which the
      wrapper does not make, is timed beside). Each step is timed as the
      wrapper makes it (its allocations included);
  K20 heads old: a thread a sorted request, a binary search for its
      run's head; new: a block a tile of 1,024 requests, a block max-scan
      of the heads' positions from the entering run's head (a warp finds
      it in the 32 keys before the tile, or by a 32-way search). Both
      take the same torch.sort output, and
      that sort (stable, as the caller runs it) is timed beside them,
      and, for the new kernel, the same launch with the requests' input
      positions in order (its scatter to input order coalesced) and
      torch's scatter_ of one int32 a request by the same positions.

Inputs, made on the card from chip_smoke.py's seeds:

  K15  phase 4's count table (the 4.6 Mbp genome's 2.3 M reads of 100
      bp, k = 25), the ragged reads' table (8a's, 75-150 bp with 10%
      contained reads) and 10d's (the same reads counted in 1 M-read
      chunks, stream.count_kmers_chunked), each at threshold 2;
  K20  phase 4's reduced graph (corrector, dedup, overlap join, the
      device reduction) labeled by sharded_contract_unitigs on a mesh of
      four shards of the one card (phase 12's labeling): shard 0's
      requests of the first chain-mask gather (the vertices without a
      successor ask INT32_MAX) and of the last pointer-doubling step of
      the first loop (the longest runs: most requests ask a chain head).

Each call is timed as steps (median of 5 CUDA-event timings after a
warm-up), as issued and behind a ~2 ms spin of the card (so that the
host's gaps between launches are hidden, except where a step waits on a
host read), old and new in turns (new, old, old, new); every output is
compared bit for bit, old to new and both to the plain version
(kernels/plain.py, run on the card). Beside them the bound
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
    ECOLI, ECOLI_RAGGED, MESH_SHARDS, STREAM_CHUNK)
from probe_canon_chain_ab import (  # noqa: E402
    bound_ms, card, phase4_graph, split_device_ms)
from probe_route_reduce_ab import split_ms  # noqa: E402
from probe_seed_edges_ab import call, ptr, stream  # noqa: E402

CSRC = os.path.join("sage2_tpu_torch", "kernels", "csrc")
P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGS = {
    ("prune_table", True): {
        "sage2_prune_table": [P, P, I64, I, P, P, P, P]},
    ("prune_table", False): {
        "sage2_prune_count": [P, I64, I, P, P],
        "sage2_scan_tiles": [P, I64, P, P],
        "sage2_prune_write": [P, P, I64, I, P, P, P, P]},
    ("routed_gather", True): {"sage2_dedup_heads": [P, P, I64, P, P, P]},
    ("routed_gather", False): {"sage2_dedup_heads": [P, P, I64, P, P, P]},
}
MARKS = {"prune_table": "sage2_prune_table(",
         "routed_gather": "warp_lower_bound"}
OLD_PRUNE_TILE = 1024       # kScanTile of the old scan.cuh


def build(root: str, name: str, outdir: str, tag: str):
    """(lib, new): one checkout's kernel library, and whether its source
    has the one-launch K15 and the tiled K20 heads (the new interface)."""
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
    for fn, sig in SIGS[(name, new)].items():
        getattr(lib, fn).argtypes = sig
        getattr(lib, fn).restype = I
    return lib, new


# --- K15 --------------------------------------------------------------------

def k15_steps(lib, new, keys, counts, threshold, out):
    """One checkout's K15 call as its wrapper makes it, as (part, fn)
    steps; ``out`` gets the (keys, counts) result."""
    import torch

    from sage2_tpu_torch.kernels import prune_buffers

    T = keys.numel()
    dev = keys.device
    st = {}
    if new:
        def launch():
            st["k"], st["c"], st["w"] = prune_buffers(T, dev)
            call(lib, "sage2_prune_table", ptr(keys), ptr(counts), T,
                 threshold, ptr(st["k"]), ptr(st["c"]), ptr(st["w"]),
                 stream())

        def read():
            n = int(st["w"][1])
            out[:] = [st["k"][:n], st["c"][:n]]

        return [("launch", launch), ("read", read)]

    tiles = max(1, -(-T // OLD_PRUNE_TILE))

    def count():
        st["s"] = torch.empty(tiles + 1, dtype=torch.int64, device=dev)
        call(lib, "sage2_prune_count", ptr(counts), T, threshold,
             ptr(st["s"]), stream())

    def scan():
        call(lib, "sage2_scan_tiles", ptr(st["s"]), tiles,
             ptr(st["s"][tiles:]), stream())

    def read():
        n = int(st["s"][tiles])
        st["k"] = torch.empty(n, dtype=torch.int64, device=dev)
        st["c"] = torch.empty(n, dtype=torch.int32, device=dev)

    def write():
        call(lib, "sage2_prune_write", ptr(keys), ptr(counts), T, threshold,
             ptr(st["s"]), ptr(st["k"]), ptr(st["c"]), stream())
        out[:] = [st["k"], st["c"]]

    return [("count", count), ("scan", scan), ("read", read),
            ("write", write)]


def run_k15(libs, tags, turns, label, keys, counts, threshold=2):
    import torch

    from sage2_tpu_torch.kernels import plain

    want = plain.prune_table(keys, counts, threshold)
    oks = []
    for tag in tags:
        lib, new = libs[tag]
        out = []
        for _, fn in k15_steps(lib, new, keys, counts, threshold, out):
            fn()
        torch.cuda.synchronize()
        oks.append(all(torch.equal(a, b) for a, b in zip(out, want)))
    n = want[0].numel()
    print(f"K15 {label}: {keys.numel()} entries, {n} kept; outputs equal "
          f"to plain ({', '.join(tags)}) {oks}; bound "
          f"{bound_ms('prune_table', (keys, counts, threshold), n):.4f} ms",
          flush=True)
    if not all(oks):
        raise AssertionError(f"K15 {label}: outputs differ")
    for tag in turns:
        lib, new = libs[tag]
        out = []
        steps = k15_steps(lib, new, keys, counts, threshold, out)
        for how, timer in (("as issued", split_ms),
                           ("on the device", split_device_ms)):
            parts = timer(steps)
            print(f"K15 {label} {tag} {how}: call {parts['call']:.4f} ms ("
                  + ", ".join(f"{p} {ms:.4f}" for p, ms in parts.items()
                              if p != "call") + ")", flush=True)
    masked = split_ms([("masked_select", lambda: (
        torch.masked_select(keys, counts >= threshold),
        torch.masked_select(counts, counts >= threshold))),
        ("copy", lambda: (want[0].clone(), want[1].clone()))])
    print(f"K15 {label} masked_select of keys and counts: "
          f"{masked['masked_select']:.4f} ms; a copy of the kept entries "
          f"to their own size {masked['copy']:.4f} ms", flush=True)


# --- K20 heads --------------------------------------------------------------

def heads_inputs(padded, V):
    """Shard 0's (s_key, s_ord) of the first chain-mask gather and of the
    last step of the first pointer-doubling loop of phase 12's labeling on
    phase 4's reduced graph."""
    import math

    import numpy as np

    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.parallel import (
        make_mesh,
        partition_edges_by_src,
        sharded_contract_unitigs,
    )

    n = MESH_SHARDS
    host = [a.cpu().numpy() for a in padded]
    s_sh, d_sh, o_sh, _ = partition_edges_by_src(*host, V, n)
    s_sh, d_sh, o_sh = (np.ascontiguousarray(a) for a in (s_sh, d_sh, o_sh))
    mesh = make_mesh(n)
    steps = max(1, math.ceil(math.log2(max(V, 2))) + 1)
    want = {0: "first chain-mask gather",
            2 + steps - 1: "last doubling step of the first loop"}
    rcap = max(4096, 2 * max(s_sh.shape[1], -(-V // n)) // n)
    heads = kernels.dedup_heads
    while True:
        kept, seen = {}, [0]

        def capture(s_key, s_ord):
            gather, shard = divmod(seen[0], n)
            seen[0] += 1
            if shard == 0 and gather in want:
                kept[want[gather]] = (s_key.clone(), s_ord.clone())
            return heads(s_key, s_ord)

        kernels.dedup_heads = capture
        try:
            _, overflow = sharded_contract_unitigs(mesh, s_sh, d_sh, o_sh, V,
                                                   route_cap=rcap)
        finally:
            kernels.dedup_heads = heads
        if not overflow:
            return [(label, *kept[label]) for label in want.values()]
        rcap *= 2


def heads_launch(lib, s_key, s_ord, out):
    call(lib, "sage2_dedup_heads", ptr(s_key), ptr(s_ord), s_key.numel(),
         ptr(out[0]), ptr(out[1]), stream())


def run_k20(libs, tags, turns, label, s_key, s_ord):
    import torch

    from sage2_tpu_torch.kernels import plain

    Q = s_key.numel()
    want = plain.dedup_heads(s_key, s_ord)
    outs = {tag: (torch.empty_like(s_key), torch.empty_like(s_key))
            for tag in tags}
    oks = []
    for tag in tags:
        heads_launch(libs[tag][0], s_key, s_ord, outs[tag])
        torch.cuda.synchronize()
        oks.append(all(torch.equal(a, b) for a, b in zip(outs[tag], want)))
    n_invalid = int((s_key == 2**31 - 1).sum())
    n_heads = int((want[0] != 2**31 - 1).sum())
    longest = int(torch.unique_consecutive(s_key, return_counts=True)[1]
                  .max())
    print(f"K20 heads, {label}: {Q} requests, {n_invalid} INT32_MAX, "
          f"{n_heads} runs (longest {longest}); outputs equal to plain "
          f"({', '.join(tags)}) {oks}; bound "
          f"{bound_ms('routed_gather:heads', (s_key, s_ord)):.4f} ms; with "
          f"a 32-byte sector a scattered store "
          f"{Q * 48 / 3.35e12 * 1e3:.4f} ms", flush=True)
    if not all(oks):
        raise AssertionError(f"K20 heads {label}: outputs differ")
    key_in = torch.empty_like(s_key)
    key_in[s_ord] = s_key
    for tag in turns:
        lib = libs[tag][0]
        steps = [("sort", lambda: torch.sort(key_in, stable=True)),
                 ("heads", lambda: heads_launch(lib, s_key, s_ord,
                                                outs[tag]))]
        for how, timer in (("as issued", split_ms),
                           ("on the device", split_device_ms)):
            parts = timer(steps)
            print(f"K20 heads {label} {tag} {how}: heads "
                  f"{parts['heads']:.4f} ms (torch.sort before it "
                  f"{parts['sort']:.4f} ms)", flush=True)
    in_order = torch.arange(Q, dtype=torch.int64, device=s_key.device)
    pos = torch.empty_like(s_key)
    steps = [("in order", lambda: heads_launch(libs["new"][0], s_key,
                                               in_order, outs["new"])),
             ("scatter_", lambda: pos.scatter_(0, s_ord, s_key))]
    for how, timer in (("as issued", split_ms),
                       ("on the device", split_device_ms)):
        parts = timer(steps)
        print(f"K20 heads {label} {how}: new kernel with the input "
              f"positions in order {parts['in order']:.4f} ms; torch "
              f"scatter_ of an int32 a request by s_ord "
              f"{parts['scatter_']:.4f} ms", flush=True)


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="root of another checkout")
    ap.add_argument("--only", choices=("k15", "k20"))
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
    from sage2_tpu_torch.kmer.count import count_kmers
    from sage2_tpu_torch.stream import count_kmers_chunked

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
    if args.only in (None, "k15"):
        libs = {t: build(root, "prune_table", tmp, t)
                for t, root in checkouts}
        t4 = count_kmers(reads, 25)
        run_k15(libs, tags, turns, "phase 4", t4.keys, t4.count)
        del t4
        rr = ECOLI_RAGGED
        ragged, lengths = simulate_ragged_reads(
            genome, rr["lo"], rr["hi"], rr["coverage"], rr["error_rate"],
            seed=rr["seed"], contained_frac=rr["contained_frac"])
        t8 = count_kmers(torch.from_numpy(ragged.astype(np.int32)).cuda(),
                         25, torch.from_numpy(lengths.astype(np.int32))
                         .cuda())
        run_k15(libs, tags, turns, "8a", t8.keys, t8.count)
        t10 = count_kmers_chunked(ragged.astype(np.int8), 25, STREAM_CHUNK,
                                  "cuda", lengths)
        same = (torch.equal(t10.keys, t8.keys)
                and torch.equal(t10.count, t8.count))
        print(f"10d's table (1 M-read chunks) equal to 8a's: {same}",
              flush=True)
        del t8, ragged, lengths
        run_k15(libs, tags, turns, "10d", t10.keys, t10.count)
        del t10
        torch.cuda.empty_cache()
    if args.only in (None, "k20"):
        libs = {t: build(root, "routed_gather", tmp, t)
                for t, root in checkouts}
        _, padded, _, V = phase4_graph(reads)
        del reads
        inputs = heads_inputs(padded, V)
        del padded
        torch.cuda.empty_cache()
        for label, s_key, s_ord in inputs:
            run_k20(libs, tags, turns, label, s_key, s_ord)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
