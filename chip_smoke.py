#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sage2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (one flushed line each, with its seconds):

  0  the card (nvidia-smi name and power limit) and torch/CUDA versions;
  1  build the eight CUDA kernels (nvcc, sm_90a, one process per source,
     all at once) and the host libraries;
  3  the overlap join at the bench's shard 0 (100,000 reads x 100 bp,
     genome 222,222 bp, seeds 7/8, min_overlap 40, seed 32): asserts the
     reference's 1,044,016 candidates and 680,790 verified overlaps;
  4  reads to contigs at E. coli scale (4.6 Mbp genome, 50x, 100 bp,
     error 0.005, seeds 7/8, default AssemblyConfig: single_window
     corrector, host-native reduction) through
     pipeline.assemble(device="cuda"): per-stage seconds, contig stats,
     genome_fraction >= 0.99 asserted;
  5  the same reads through the voting corrector and the device
     reduction (correction_rule="vote_all_windows",
     reduce_backend="device", no artifacts written): the same report,
     genome_fraction >= 0.99 asserted;
  6  phase 4's edge list reduced by the device backend and by the host
     native backend: equal arrays, n_edges and n_expansions asserted;
  7  the Pallas probe's path (scripts/probe_pallas_gather.py): its
     largest gathers, (65536, 128) and (1 << 20, 128) on axis 0 and
     (2048, 2048) on axis 1, through kernels.gather_along;
  2  each kernel against its plain PyTorch version on the inputs that
     phases 3-7 gave it (captured during those runs, so it comes after
     them; the call with the most input elements, for reduce_marks the
     largest slot range; pointer_jump once for each of its ops
     none/min/add; gather_along once per probe shape): bit equality
     asserted, median times (CUDA events), the bound from bytes and
     operations, and one PyTorch call computing the same function
     where there is one (torch.searchsorted beside K2, index_select
     beside K4 none, torch.gather beside P1).

Each path runs with the launch counts set to 0 just before it and read
just after it: phase 4 for K1-K4, phase 5 for K5-K7, phase 7 for P1.
Every kernel must have launched on its path. pointer_jump's counts are
split by op. The last two lines are the kernel table and
{"ok": true, "device": {...}}. Any failure exits non-zero before them;
without a GPU the script exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# card peaks (H100 SXM data sheet): device memory rate, and the 32-bit
# rate outside the tensor cores, used for the integer kernels' work
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

SHARD0 = dict(n_reads=100_000, read_len=100, coverage=45.0,
              error_rate=0.005, seeds=(7, 8), min_overlap=40)
SHARD0_CANDIDATES = 1_044_016
SHARD0_VERIFIED = 680_790
ECOLI = dict(genome_len=4_600_000, coverage=50.0, read_len=100,
             error_rate=0.005, seeds=(7, 8))
# the reference (sage2_tpu) on the same input, BASELINE.md round 4:
# printed as a guide, not a gate
REFERENCE_ASSEMBLY = {"n_contigs": 5, "n50": 1_435_616,
                      "genome_fraction": 1.0}

# the probe's largest gathers (scripts/probe_pallas_gather.py:95,100,103)
PROBE_SHAPES = ((65536, 128, 0), (1 << 20, 128, 0), (2048, 2048, 1))

_CSRC = "sage2_tpu_torch/kernels/csrc/"
# one row of the kernel table per key (pointer_jump once per op,
# gather_along once per probe shape): source, the TPU kernel it
# replaces, and the phase whose run gives its launch count
KERNEL_INFO = {
    "kmer_keys": (_CSRC + "kmer_keys.cu",
                  "sage2_tpu/ops/bitpack.py:126", "4"),
    "lookup_counts": (_CSRC + "lookup_counts.cu",
                      "sage2_tpu/kmer/count.py:97", "4"),
    "overlap_join": (_CSRC + "overlap_join.cu",
                     "sage2_tpu/overlap/detect.py:863", "4"),
    "pointer_jump:none": (_CSRC + "pointer_jump.cu",
                          "sage2_tpu/graph/traverse.py:81", "4"),
    "pointer_jump:min": (_CSRC + "pointer_jump.cu",
                         "sage2_tpu/graph/traverse.py:88", "4"),
    "pointer_jump:add": (_CSRC + "pointer_jump.cu",
                         "sage2_tpu/graph/traverse.py:114", "4"),
    "vote_windows": (_CSRC + "vote_windows.cu",
                     "sage2_tpu/kmer/correct.py:134", "5"),
    "reduce_counts": (_CSRC + "reduce_counts.cu",
                      "sage2_tpu/graph/reduce.py:133", "5"),
    "reduce_marks": (_CSRC + "reduce_marks.cu",
                     "sage2_tpu/graph/reduce.py:520", "5"),
}
for _n, _w, _a in PROBE_SHAPES:
    KERNEL_INFO[f"gather_along:{_a}:{_n}x{_w}"] = (
        _CSRC + "gather_along.cu", "scripts/probe_pallas_gather.py:73", "7")

T_START = time.perf_counter()


def say(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, t0: float, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    say(f"[phase {name}] {time.perf_counter() - t0:.3f} s "
        f"(at {time.perf_counter() - T_START:.1f} s) {extra}".rstrip())


def time_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() over reps runs, by CUDA events, after
    one warm-up run."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class Capture:
    """Wraps the kernel wrappers of ``sage2_tpu_torch.kernels`` (the
    callers look them up on the module at each call). For each key of
    KERNEL_INFO it keeps a clone of the arguments of the call with the
    most input elements, and it splits the wrapper's own launch counts
    (``kernels.LAUNCHES``) by key."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.originals = {n: getattr(kernels, n) for n in kernels.KERNELS}
        self.args: dict = {}
        self.launches = {key: 0 for key in KERNEL_INFO}
        for name, fn in self.originals.items():
            setattr(kernels, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        import torch

        def call(*args):
            key = name
            size = sum(a.numel() for a in args
                       if isinstance(a, torch.Tensor))
            if name == "pointer_jump":
                key = f"{name}:{args[2] if len(args) > 2 else 'none'}"
            elif name == "gather_along":
                key = f"{name}:{args[2]}:{args[0].shape[0]}x{args[0].shape[1]}"
            elif name == "reduce_marks":
                size += args[-1] - args[-2]      # the slot range
            kept = self.args.get(key)
            if kept is None or size > kept[0]:
                self.args[key] = (size, tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args))
            before = self.kernels.LAUNCHES[name]
            out = fn(*args)
            self.launches[key] += self.kernels.LAUNCHES[name] - before
            return out

        return call

    def reset_launch_counts(self) -> None:
        self.kernels.reset_launch_counts()
        self.launches = dict.fromkeys(self.launches, 0)

    def path_launches(self, path: str) -> dict:
        """Launches by key since the last reset; raises unless every
        kernel of ``path`` launched and the counts add up to the
        wrappers' own."""
        if sum(self.launches.values()) != sum(self.kernels.LAUNCHES.values()):
            raise AssertionError(f"launch counts {self.kernels.LAUNCHES} "
                                 f"do not add up to {self.launches}")
        for key, info in KERNEL_INFO.items():
            if info[2] == path and self.launches[key] == 0:
                raise AssertionError(f"kernel {key} not launched on the "
                                     f"path of phase {path}")
        return dict(self.launches)

    def close(self) -> None:
        for name, fn in self.originals.items():
            setattr(self.kernels, name, fn)


def work(key: str, args: tuple, total: int = 0):
    """(bytes moved, integer operations) of one call: each input read
    once and each output written once; operations counted from this
    call's shapes."""
    if key == "kmer_keys":
        reads, k = args
        N, L = reads.shape
        NP = N * (L - k + 1)
        return reads.numel() * 4 + 3 * NP * 8, NP * k * 6
    if key == "lookup_counts":
        table, counts, queries = args
        T, Q = table.numel(), queries.numel()
        steps = max(1, math.ceil(math.log2(T + 1)))
        return T * 12 + Q * 12, Q * steps * 4
    if key == "overlap_join":
        s_keys, s_rows, payload = args[:3]
        W = payload.shape[1]
        n = s_keys.numel()
        return (n * 12 + payload.numel() * 4 + total * 13,
                n * 8 + total * (6 * (W - 2) + 20))
    if key.startswith("pointer_jump"):
        p, val, op = args
        per = 8 if op == "none" else 16
        return p.numel() * per, p.numel() * 2
    if key == "vote_windows":
        reads, table, _, k, _ = args
        N, L = reads.shape
        NP = N * (L - k + 1)
        steps = max(1, math.ceil(math.log2(table.numel() + 1)))
        # (3k + 1) searches a window, 4 ops a step; key edits and votes
        return (reads.numel() * 8 + table.numel() * 12,
                NP * (3 * k + 1) * (steps * 4 + 8) + NP * k * 6)
    if key == "reduce_counts":
        keys, src, dst, ovl, V, _ = args
        E = keys.numel()
        steps = max(1, math.ceil(math.log2(E + 1)))
        return (E * 8 + E * 12 + (3 * V + 1) * 4 + E * 4,
                (V + 1) * 3 * steps * 4 + E * (steps * 4 + 10))
    if key == "reduce_marks":
        return marks_work(args, total)
    tbl = args[0]                                   # gather_along
    return tbl.numel() * 12, tbl.numel() * 2


def marks_work(args: tuple, n_marked: int):
    """(bytes, operations) that K7's slot range [j0, j1) needs on these
    inputs: the edges whose expansions hold the slots (offsets, src,
    dst, ovl and start of dst: 24 bytes each), the distinct (src, sl)
    rows they expand into (ss_sl, ss_dst: 8 bytes each), the
    (src, dst)-order runs of their sources searched for membership (dst,
    ovl: 8 bytes a row, startd) and one byte per mark set; two binary
    searches a slot."""
    import torch

    (_, offsets, src, dst, _, _, _, start, startd, _, j0, j1) = args
    E = src.numel()
    bounds = torch.searchsorted(
        offsets, torch.tensor([j0, j1 - 1], device=offsets.device),
        right=True)
    e_lo, e_hi = (int(b) for b in bounds)
    e = slice(e_lo, e_hi + 1)
    before = offsets[e_lo - 1] if e_lo else offsets.new_zeros(())
    counts = torch.diff(offsets[e], prepend=before.reshape(1))
    first = start[dst[e].long()].long()
    cover = torch.zeros(E + 1, dtype=torch.int32, device=src.device)
    cover.index_add_(0, first, torch.ones_like(first, dtype=torch.int32))
    cover.index_add_(0, first + counts,
                     -torch.ones_like(first, dtype=torch.int32))
    n_rows = int((torch.cumsum(cover, 0) > 0).sum())
    v_lo, v_hi = int(src[e_lo]), int(src[e_hi])
    run_rows = int(startd[v_hi + 1] - startd[v_lo])
    n_e = e_hi - e_lo + 1
    max_deg = int((startd[1:] - startd[:-1]).max())
    steps = (max(1, math.ceil(math.log2(E + 1)))
             + max(1, math.ceil(math.log2(max_deg + 1))))
    nbytes = (n_e * 24 + n_rows * 8 + run_rows * 8
              + (v_hi - v_lo + 2) * 4 + n_marked)
    return nbytes, (j1 - j0) * (steps * 4 + 20)


def max_abs_err(a, b) -> float:
    """Largest absolute difference between two outputs (a tensor, or a
    tuple of tensors and ints)."""
    import torch

    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    worst = 0.0
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            if x.shape != y.shape:
                return float("inf")
            if x.numel():
                d = (x.to(torch.float64) - y.to(torch.float64)).abs().max()
                worst = max(worst, float(d))
        elif x != y:
            worst = max(worst, abs(float(x) - float(y)))
    return worst


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.config import AssemblyConfig
    from sage2_tpu_torch.data import simulate_genome, simulate_reads
    from sage2_tpu_torch.graph import flow_native, reduce_native
    from sage2_tpu_torch.graph.reduce import transitive_reduction_auto
    from sage2_tpu_torch.kernels import plain
    from sage2_tpu_torch.overlap import find_overlaps_auto
    from sage2_tpu_torch.pipeline import assemble
    from sage2_tpu_torch.utils.metrics import MetricsLog
    from sage2_tpu_torch.utils.stats import genome_fraction

    # --- phase 0: the card ---------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)}")
    phase("0 card", t0)

    dev = torch.device("cuda")

    # --- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    kernels.load_all()
    reduce_native._load()
    if not flow_native.available():
        raise RuntimeError("native flow solver did not build")
    phase("1 build", t0, kernels=len(kernels.KERNELS))

    # --- inputs (set-up, not part of any phase) -------------------------
    t0 = time.perf_counter()
    s = SHARD0
    g_len = int(s["n_reads"] * s["read_len"] / s["coverage"])
    g0 = simulate_genome(g_len, seed=s["seeds"][0])
    shard0, _ = simulate_reads(g0, read_len=s["read_len"],
                               coverage=s["coverage"],
                               error_rate=s["error_rate"], seed=s["seeds"][1])
    shard0 = shard0[: s["n_reads"]]
    e = ECOLI
    genome = simulate_genome(e["genome_len"], seed=e["seeds"][0])
    reads, _ = simulate_reads(genome, read_len=e["read_len"],
                              coverage=e["coverage"],
                              error_rate=e["error_rate"], seed=e["seeds"][1])
    phase("inputs", t0, shard0_genome=g_len, shard0_reads=shard0.shape[0],
          ecoli_reads=reads.shape[0])

    capture = Capture(kernels)

    # --- phase 3: overlap join at the bench's shard 0 -------------------
    t0 = time.perf_counter()
    r0 = torch.from_numpy(shard0.astype(np.int32)).to(dev)
    v0 = torch.ones(r0.shape[0], dtype=torch.bool, device=dev)
    find_overlaps_auto(r0, v0, s["min_overlap"], 32)   # first (cold) run
    torch.cuda.synchronize()
    capture.reset_launch_counts()
    runs = []
    for _ in range(3):
        t1 = time.perf_counter()
        res = find_overlaps_auto(r0, v0, s["min_overlap"], 32)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t1)
        if (res.n_candidates, res.n_verified) != (SHARD0_CANDIDATES,
                                                  SHARD0_VERIFIED):
            raise AssertionError(
                f"shard 0: {res.n_candidates} candidates, "
                f"{res.n_verified} verified; expected "
                f"{SHARD0_CANDIDATES}, {SHARD0_VERIFIED}")
    best = min(runs)
    phase("3 overlap shard0", t0, n_candidates=res.n_candidates,
          n_verified=res.n_verified, n_edges=res.n_edges,
          best_s=f"{best:.4f}", reads_per_s=f"{s['n_reads'] / best:.0f}",
          launches=json.dumps({k: v // 3 for k, v in
                               kernels.LAUNCHES.items()}))
    del r0, v0, res

    # --- phase 4: E. coli scale, reads to contigs -----------------------
    t0 = time.perf_counter()
    log = MetricsLog(None, echo=False)
    with tempfile.TemporaryDirectory() as outdir:
        capture.reset_launch_counts()
        contigs, stats = assemble(reads, AssemblyConfig(), outdir=outdir,
                                  metrics=log, device="cuda")
        launches = dict(kernels.LAUNCHES)
        launches_by_key = {"4": capture.path_launches("4")}
        t_asm = time.perf_counter() - t0
        with open(os.path.join(outdir, "stats.json")) as f:
            json.load(f)
        with np.load(os.path.join(outdir, "edges.npz")) as z:
            edges = (z["src"], z["dst"], z["ovl"])
            n_vertices = z["valid2"].shape[0]
    report_assembly("4 ecoli", t0, t_asm, log, launches, contigs, stats,
                    genome, genome_fraction)

    # --- phase 5: voting corrector + device reduction -------------------
    t0 = time.perf_counter()
    log = MetricsLog(None, echo=False)
    capture.reset_launch_counts()
    contigs, stats = assemble(
        reads, AssemblyConfig(correction_rule="vote_all_windows",
                              reduce_backend="device"),
        outdir=None, metrics=log, device="cuda")
    launches = dict(kernels.LAUNCHES)
    launches_by_key["5"] = capture.path_launches("5")
    report_assembly("5 ecoli vote+device", t0, time.perf_counter() - t0,
                    log, launches, contigs, stats, genome, genome_fraction)
    del contigs, stats

    # --- phase 6: device reduction against the native one ---------------
    t0 = time.perf_counter()
    t1 = time.perf_counter()
    nat = transitive_reduction_auto(*edges, n_vertices, ECOLI["read_len"],
                                    backend="native")
    t_nat = time.perf_counter() - t1
    t1 = time.perf_counter()
    dev_red = transitive_reduction_auto(*edges, n_vertices,
                                        ECOLI["read_len"], backend="device",
                                        device="cuda")
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t1
    for field in ("src", "dst", "ovl"):
        got = getattr(dev_red, field).cpu().numpy()
        if not np.array_equal(got, getattr(nat, field)):
            raise AssertionError(f"device reduction differs from the "
                                 f"native one in {field}")
    if (dev_red.n_edges, dev_red.n_expansions, dev_red.overflow) != (
            nat.n_edges, nat.n_expansions, nat.overflow):
        raise AssertionError(
            f"device reduction n_edges/n_expansions/overflow "
            f"{dev_red[3:]} != native {nat[3:]}")
    phase("6 reduce device vs native", t0, n_edges_in=int(
        np.count_nonzero(edges[0] != 2**31 - 1)), n_edges=nat.n_edges,
        n_expansions=nat.n_expansions, native_s=f"{t_nat:.3f}",
        device_s=f"{t_dev:.3f}", equal=True)
    del nat, dev_red, edges

    # --- phase 7: the Pallas probe's gathers ----------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    capture.reset_launch_counts()
    for n, w, axis in PROBE_SHAPES:
        tbl = torch.arange(n * w, dtype=torch.int32, device=dev).reshape(n, w)
        idx = torch.randint(0, n if axis == 0 else w, (n, w), generator=gen,
                            dtype=torch.int32, device=dev)
        kernels.gather_along(tbl, idx, axis)
    torch.cuda.synchronize()
    launches_by_key["7"] = capture.path_launches("7")
    phase("7 probe gathers", t0, shapes=json.dumps(PROBE_SHAPES))
    capture.close()

    # --- phase 2: each kernel against its plain version -----------------
    t0 = time.perf_counter()
    rows = []
    for key, (source, replaces, path) in KERNEL_INFO.items():
        t1 = time.perf_counter()
        name = key.split(":")[0]
        args = capture.args[key][1]
        wrapper = getattr(kernels, name)
        ref = getattr(plain, name)

        def fresh():
            # reduce_marks updates its first argument in place
            return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                         for a in args)

        got = wrapper(*fresh())
        want = ref(*fresh())
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{key}: kernel differs from its plain "
                                 f"version (max abs err {err})")
        if name == "overlap_join":
            total = got[4]
        elif name == "reduce_marks":            # marks this range sets
            total = int((got != args[0]).sum())
        else:
            total = 0
        heavy = name == "vote_windows"
        ms = time_ms(lambda: wrapper(*args), reps=3 if heavy else 5)
        plain_ms = time_ms(lambda: ref(*args), reps=1 if heavy else 3)
        library_ms, library = library_time(key, args)
        nbytes, ops = work(key, args, total)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / OPS_PER_S * 1e3
        n_launches = launches_by_key[path][key]
        rows.append({
            "name": key, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        })
        shape = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        say(f"  {key}: equal, {ms:.3f} ms (plain {plain_ms:.3f} ms"
            + (f", {library} {library_ms:.3f} ms" if library else "")
            + f"), bound {max(t_bytes, t_ops):.3f} ms, launches "
            f"{n_launches} (phase {path}), inputs {shape}, check "
            f"{time.perf_counter() - t1:.1f} s")
    phase("2 kernels vs plain", t0)

    say(f"total {time.perf_counter() - T_START:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def report_assembly(label, t0, t_asm, log, launches, contigs, stats, genome,
                    genome_fraction) -> None:
    """Print an assemble run's stage seconds, launches and contig stats;
    raise unless genome_fraction >= 0.99."""
    stages: dict = {}
    for r in log.records:
        if "seconds" in r:
            stages[r["stage"]] = round(stages.get(r["stage"], 0.0)
                                       + r["seconds"], 3)
    stages["untimed"] = round(t_asm - sum(stages.values()), 3)
    gf = genome_fraction(contigs, genome)
    phase(label, t0, assemble_s=f"{t_asm:.3f}", stages=json.dumps(stages),
          launches=json.dumps(launches))
    say(f"assembly: n_contigs={stats['n_contigs']} n50={stats['n50']} "
        f"total_bases={stats['total_bases']} genome_fraction={gf:.6f} "
        f"(sage2_tpu reference on this input, default config, for comparison: "
        f"{json.dumps(REFERENCE_ASSEMBLY)})")
    if gf < 0.99:
        raise AssertionError(f"{label}: genome_fraction {gf} < 0.99")


def library_time(key: str, args: tuple):
    """(ms, name) of one PyTorch call computing the kernel's function on
    the same inputs, or (None, None) where there is none."""
    import torch

    if key == "lookup_counts":
        table, _, queries = args
        return time_ms(lambda: torch.searchsorted(table, queries)), \
            "searchsorted"
    if key == "pointer_jump:none":
        p = args[0]
        return time_ms(lambda: torch.index_select(p, 0, p)), "index_select"
    if key.startswith("gather_along"):
        tbl, idx, axis = args
        idx64 = idx.long()
        return time_ms(lambda: torch.gather(tbl, axis, idx64)), "gather"
    return None, None


if __name__ == "__main__":
    sys.exit(main())
