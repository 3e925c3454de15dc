#!/usr/bin/env python3
"""A/B of the PyTorch port's K2 (lookup_counts) and P1 (gather_along)
CUDA kernels against another checkout's, on one GPU.

    python3 scripts/probe_torch_kernels_ab.py [--baseline DIR]

DIR is the root of another checkout (e.g. `git archive <commit>`
unpacked under a gitignored directory); its two sources are compiled
with the same nvcc flags and called through their own C interface
(K2: one launch; P1: the wrapper's aminmax and host round trip before
the launch, as that checkout's wrapper makes them). Without DIR only
this checkout's kernels and the library calls are timed.

Inputs, made on the card from a seed:
  K2: a table of ~5,126,426 distinct keys below 2^50, each the smaller
      of two uniform draws (as a canonical 25-mer's key is the smaller
      of its two strands'), with random counts; 174,800,000 queries
      (phase 4's 2.3 M reads x 76 windows), 88% of them table keys and
      the rest random 50-bit keys (windows with an error). Again over
      54-bit keys, whose buckets are too far apart for packed entries
      (K2's int64 branch);
  P1: the Pallas probe's largest gathers, (65536, 128) and (1 << 20,
      128) on axis 0 and (2048, 2048) on axis 1, random indices.

Prints nvcc -Xptxas -v for this checkout's two sources, then one line a
measurement: median of 7 CUDA-event timings after a warm-up (a "device
time" line enqueues each run behind a spin of the card, which hides
the host's launch cost), the
version (new = this checkout, old = DIR), and whether its output equals
the library call's (torch.searchsorted + gather for K2, torch.gather for
P1). The card's name and power limit come first.
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

from chip_smoke import device_ms, time_ms  # noqa: E402

CSRC = os.path.join("sage2_tpu_torch", "kernels", "csrc")
SHAPES = ((65536, 128, 0), (1 << 20, 128, 0), (2048, 2048, 1))


def build(root: str, name: str, outdir: str, verbose: bool = False):
    from sage2_tpu_torch.kernels import nvcc_command

    src = os.path.join(root, CSRC, name + ".cu")
    so = os.path.join(outdir, f"{name}-{abs(hash(root))}.so")
    cmd = nvcc_command() + (["-Xptxas", "-v"] if verbose else []) + [
        "-o", so, src]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"nvcc {src}: {res.stderr}")
    if verbose:
        for line in res.stderr.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return ctypes.CDLL(so)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="root of another checkout")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from sage2_tpu_torch import kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernels.load_all()
    tmp = tempfile.mkdtemp()
    for name in ("lookup_counts", "gather_along"):
        build(ROOT, name, tmp, verbose=True)
    old = {}
    if args.baseline:
        P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        old["lookup_counts"] = build(args.baseline, "lookup_counts", tmp)
        old["lookup_counts"].sage2_lookup_counts.argtypes = [P, P, I64, P,
                                                             I64, P, P]
        old["gather_along"] = build(args.baseline, "gather_along", tmp)
        old["gather_along"].sage2_gather_along.argtypes = [P, P, I64, I64, I,
                                                           P, P]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    stream = torch.cuda.current_stream().cuda_stream

    def report(what, ms, equal):
        print(f"{what}: {ms:.4f} ms, equal to the library's: {equal}",
              flush=True)

    # --- K2 -------------------------------------------------------------
    def k2_inputs(bits):
        """(table, counts, queries) over ``bits``-bit keys."""
        draw = torch.randint(0, 1 << bits, (2, 5_126_426), generator=g,
                             device=dev)
        table = torch.unique(draw.min(dim=0).values)
        T = table.numel()
        counts = torch.randint(2, 1000, (T,), generator=g, device=dev,
                               dtype=torch.int32)
        Q = 174_800_000
        present = table[torch.randint(0, T, (Q,), generator=g, device=dev)]
        absent = torch.randint(0, 1 << bits, (Q,), generator=g, device=dev)
        queries = torch.where(
            torch.rand(Q, generator=g, device=dev) < 0.88, present, absent)
        return table, counts, queries

    def library(table, counts, queries):
        at = torch.searchsorted(table, queries).clamp_(max=table.numel() - 1)
        return torch.where(table[at] == queries, counts[at], 0)

    # 50-bit keys: buckets 2^29 apart, packed entries; 54-bit keys: 2^33
    # apart, the int64 branch
    for bits in (50, 54):
        table, counts, queries = k2_inputs(bits)
        T, Q = table.numel(), queries.numel()
        want = library(table, counts, queries)
        packed = int(kernels.lookup_directory(table, counts)[3])
        print(f"K2 {bits}-bit keys: table {T} keys, {Q} queries, "
              f"{float((want > 0).float().mean()):.3f} found, packed "
              f"{packed}", flush=True)
        got = kernels.lookup_counts(table, counts, queries)
        report(f"K2 {bits}-bit new (index + lookup)", time_ms(
            lambda: kernels.lookup_counts(table, counts, queries)),
            bool(torch.equal(got, want)))
        report(f"K2 {bits}-bit new index launch", time_ms(
            lambda: kernels.lookup_directory(table, counts)), True)
        if old:
            out = torch.empty_like(got)

            def old_k2():
                old["lookup_counts"].sage2_lookup_counts(
                    table.data_ptr(), counts.data_ptr(), T,
                    queries.data_ptr(), Q, out.data_ptr(), stream)

            ms = time_ms(old_k2)
            report(f"K2 {bits}-bit old", ms, bool(torch.equal(out, want)))
        report(f"K2 {bits}-bit torch.searchsorted", time_ms(
            lambda: torch.searchsorted(table, queries)), True)
        del queries, want, got, table, counts
        torch.cuda.empty_cache()

    # --- P1 -------------------------------------------------------------
    for n, w, axis in SHAPES:
        tbl = torch.arange(n * w, dtype=torch.int32, device=dev).reshape(n, w)
        idx = torch.randint(0, n if axis == 0 else w, (n, w), generator=g,
                            dtype=torch.int32, device=dev)
        want = torch.gather(tbl, axis, idx.long())
        tag = f"P1 axis {axis} ({n}, {w})"
        got = kernels.gather_along(tbl, idx, axis)
        report(f"{tag} new wrapper", time_ms(
            lambda: kernels.gather_along(tbl, idx, axis)),
            bool(torch.equal(got, want)))
        out = torch.empty_like(tbl)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        report(f"{tag} new bare launch", time_ms(
            lambda: kernels.gather_along_launch(tbl, idx, axis, out, flag)),
            bool(torch.equal(out, want)))
        report(f"{tag} new bare launch, device time", device_ms(
            lambda: kernels.gather_along_launch(tbl, idx, axis, out, flag)),
            True)
        if old:
            def old_bare():
                old["gather_along"].sage2_gather_along(
                    tbl.data_ptr(), idx.data_ptr(), n, w, axis,
                    out.data_ptr(), stream)

            def old_wrapper():
                lo, hi = (int(v) for v in torch.aminmax(idx))
                assert 0 <= lo and hi < tbl.shape[axis]
                old_bare()

            out.zero_()
            report(f"{tag} old wrapper", time_ms(old_wrapper),
                   bool(torch.equal(out, want)))
            report(f"{tag} old bare launch", time_ms(old_bare), True)
            report(f"{tag} old bare launch, device time", device_ms(old_bare),
                   True)
        idx64 = idx.long()
        report(f"{tag} torch.gather", time_ms(
            lambda: torch.gather(tbl, axis, idx64)), True)
        report(f"{tag} torch.gather, device time", device_ms(
            lambda: torch.gather(tbl, axis, idx64)), True)
        del tbl, idx, want, got, out, idx64
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
