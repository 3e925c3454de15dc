#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sage2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (one flushed line each, with its seconds):

  0  the card (nvidia-smi name and power limit) and torch/CUDA versions;
  1  build the four CUDA kernels (nvcc, sm_90a) and the host libraries;
  3  the overlap join at the bench's shard 0 (100,000 reads x 100 bp,
     genome 222,222 bp, seeds 7/8, min_overlap 40, seed 32): asserts the
     reference's 1,044,016 candidates and 680,790 verified overlaps;
  4  reads to contigs at E. coli scale (4.6 Mbp genome, 50x, 100 bp,
     error 0.005, seeds 7/8, default AssemblyConfig) through
     pipeline.assemble(device="cuda"): per-stage seconds, contig stats,
     genome_fraction >= 0.99 asserted;
  2  each kernel against its plain PyTorch version on the inputs that
     phases 3 and 4 gave it (captured during those runs, so it comes
     after them; pointer_jump once for each of its ops none/min/add):
     bit equality asserted, median times (CUDA events), the bound from
     bytes and operations, and torch.searchsorted beside K2.

Launch counts are reset right before phase 4's run and read right after
it; pointer_jump's are split by op. The last two lines are the kernel
table and
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

# one row of the kernel table per key: pointer_jump once per op
KERNEL_INFO = {
    "kmer_keys": ("sage2_tpu_torch/kernels/csrc/kmer_keys.cu",
                  "sage2_tpu/ops/bitpack.py:126"),
    "lookup_counts": ("sage2_tpu_torch/kernels/csrc/lookup_counts.cu",
                      "sage2_tpu/kmer/count.py:97"),
    "overlap_join": ("sage2_tpu_torch/kernels/csrc/overlap_join.cu",
                     "sage2_tpu/overlap/detect.py:863"),
    "pointer_jump:none": ("sage2_tpu_torch/kernels/csrc/pointer_jump.cu",
                          "sage2_tpu/graph/traverse.py:81"),
    "pointer_jump:min": ("sage2_tpu_torch/kernels/csrc/pointer_jump.cu",
                         "sage2_tpu/graph/traverse.py:88"),
    "pointer_jump:add": ("sage2_tpu_torch/kernels/csrc/pointer_jump.cu",
                         "sage2_tpu/graph/traverse.py:114"),
}

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
            if name == "pointer_jump":
                key = f"{name}:{args[2] if len(args) > 2 else 'none'}"
            size = sum(a.numel() for a in args
                       if isinstance(a, torch.Tensor))
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
    p, val, op = args
    per = 8 if op == "none" else 16
    return p.numel() * per, p.numel() * 2


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
        launches_by_key = dict(capture.launches)
        t_asm = time.perf_counter() - t0
        with open(os.path.join(outdir, "stats.json")) as f:
            json.load(f)
    capture.close()
    stages: dict = {}
    for r in log.records:
        if "seconds" in r:
            stages[r["stage"]] = round(stages.get(r["stage"], 0.0)
                                       + r["seconds"], 3)
    stages["untimed"] = round(t_asm - sum(stages.values()), 3)
    gf = genome_fraction(contigs, genome)
    phase("4 ecoli", t0, assemble_s=f"{t_asm:.3f}",
          stages=json.dumps(stages), launches=json.dumps(launches))
    say(f"assembly: n_contigs={stats['n_contigs']} n50={stats['n50']} "
        f"total_bases={stats['total_bases']} genome_fraction={gf:.6f} "
        f"(sage2_tpu reference on this input, as a guide: "
        f"{json.dumps(REFERENCE_ASSEMBLY)})")
    if gf < 0.99:
        raise AssertionError(f"genome_fraction {gf} < 0.99")
    for key, n in launches_by_key.items():
        if n == 0:
            raise AssertionError(f"kernel {key} not launched on the "
                                 f"main path")
    if sum(launches_by_key.values()) != sum(launches.values()):
        raise AssertionError(f"launch counts {launches} do not add up "
                             f"to {launches_by_key}")

    # --- phase 2: each kernel against its plain version -----------------
    t0 = time.perf_counter()
    rows = []
    for key in KERNEL_INFO:
        t1 = time.perf_counter()
        name = key.split(":")[0]
        args = capture.args[key][1]
        wrapper = getattr(kernels, name)
        ref = getattr(plain, name)
        got = wrapper(*args)
        want = ref(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{key}: kernel differs from its plain "
                                 f"version (max abs err {err})")
        ms = time_ms(lambda: wrapper(*args))
        plain_ms = time_ms(lambda: ref(*args), reps=3)
        library_ms = None
        if name == "lookup_counts":
            table, _, queries = args
            library_ms = time_ms(lambda: torch.searchsorted(table, queries))
        total = got[4] if name == "overlap_join" else 0
        nbytes, ops = work(key, args, total)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / OPS_PER_S * 1e3
        source, replaces = KERNEL_INFO[key]
        rows.append({
            "name": key, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches_by_key[key],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        })
        shape = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        say(f"  {key}: equal, {ms:.3f} ms (plain {plain_ms:.3f} ms"
            + (f", searchsorted {library_ms:.3f} ms" if library_ms else "")
            + f"), bound {max(t_bytes, t_ops):.3f} ms, launches "
            f"{launches_by_key[key]}, inputs {shape}, check "
            f"{time.perf_counter() - t1:.1f} s")
    phase("2 kernels vs plain", t0)

    say(f"total {time.perf_counter() - T_START:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
