"""End-to-end assembly wall-clock benchmark of the PyTorch/CUDA port
(sage2_tpu_torch) on one GPU; the port's twin of bench_e2e.py.

    python3 bench_e2e_gpu.py

Assembles a synthetic E. coli-scale input (default 4.6 Mbp x 50x,
100 bp reads, 0.5% error) through sage2_tpu_torch.pipeline.assemble on
the card and prints ONE JSON line:
  {"metric": "e2e_assembly_wall_clock_s", "value": S, "unit": "s", ...}
with bench_e2e.py's detail names (stage seconds, N50, contigs, genome
fraction); the stage breakdown, the device split of the dedup and
overlap stages (the ``dedup_split`` and ``overlap_split`` records, CUDA
event milliseconds), the card's name and power limit and the peak host
RSS go to stderr. The kernels are built before the clock starts
(kernels.load_all, the counterpart of bench_e2e.py's compile warm-up).

Env knobs (bench_e2e.py's): SAGE2_E2E_GENOME (4600000),
SAGE2_E2E_COVERAGE (50), SAGE2_E2E_READLEN (100), SAGE2_E2E_ERR (0.005),
SAGE2_E2E_MAX_DEVICE_READS (0 = in-core), SAGE2_E2E_OUTDIR (stage
artifacts there, for resumable reruns), SAGE2_E2E_RESUME (the stage to
resume from; the wall-clock then covers only the remaining stages),
SAGE2_E2E_SPILL_DIR; and SAGE2_BENCH_DEVICE ("cuda"; "cpu" runs the
plain PyTorch versions).
"""

from __future__ import annotations

import json
import os
import resource
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    genome_len = int(os.environ.get("SAGE2_E2E_GENOME", 4_600_000))
    coverage = float(os.environ.get("SAGE2_E2E_COVERAGE", 50))
    read_len = int(os.environ.get("SAGE2_E2E_READLEN", 100))
    err = float(os.environ.get("SAGE2_E2E_ERR", 0.005))
    max_dev = int(os.environ.get("SAGE2_E2E_MAX_DEVICE_READS", 0))
    outdir = os.environ.get("SAGE2_E2E_OUTDIR") or None
    resume = os.environ.get("SAGE2_E2E_RESUME") or None
    device = os.environ.get("SAGE2_BENCH_DEVICE", "cuda")

    from bench_gpu import card
    from sage2_tpu_torch import kernels
    from sage2_tpu_torch.config import AssemblyConfig
    from sage2_tpu_torch.data import simulate_genome, simulate_reads
    from sage2_tpu_torch.pipeline import assemble
    from sage2_tpu_torch.utils.device import resolve_device
    from sage2_tpu_torch.utils.metrics import MetricsLog
    from sage2_tpu_torch.utils.stats import genome_fraction

    dev = resolve_device(device)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        kernels.load_all()
        log(f"kernels built/loaded: {time.perf_counter() - t0:.1f}s")
        name, power_w = card()
        log(f"device: {name} ({power_w} W power limit)")
    else:
        log("device: cpu")

    t0 = time.perf_counter()
    genome = simulate_genome(genome_len, seed=7)
    reads, _ = simulate_reads(
        genome, read_len=read_len, coverage=coverage, error_rate=err, seed=8
    )
    n_reads = reads.shape[0]
    log(f"input: {n_reads} reads x {read_len} bp "
        f"({genome_len} bp genome, {coverage}x, err {err}) "
        f"[simulated in {time.perf_counter()-t0:.1f}s]")

    cfg = AssemblyConfig(
        k=25, min_overlap=40,
        max_device_reads=max_dev or None,
        spill_dir=os.environ.get("SAGE2_E2E_SPILL_DIR") or None,
    )
    stage_secs = {}

    class _Spy(MetricsLog):
        def log(self, event, **fields):
            if "seconds" in fields:
                stage_secs[event] = stage_secs.get(event, 0.0) + (
                    fields["seconds"]
                )
            super().log(event, **fields)

    metrics = _Spy(None, echo=False)
    t0 = time.perf_counter()
    contigs, stats = assemble(
        reads, cfg, metrics=metrics, outdir=outdir, resume_from=resume,
        device=dev,
    )
    wall = time.perf_counter() - t0

    gf = genome_fraction(contigs, genome)
    peak_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    log(f"stages (s): " + ", ".join(
        f"{k}={v:.3f}" for k, v in stage_secs.items()))
    for r in metrics.records:
        if r["stage"] in ("dedup_split", "overlap_split"):
            log(f"{r['stage']} (ms): " + json.dumps(
                {k: round(v, 3) for k, v in r.items() if k.endswith("_ms")}))
    log(f"stats: {stats}; genome_fraction={gf:.4f}; "
        f"peak_host_rss={peak_rss:.2f} GB")
    print(json.dumps({
        "metric": "e2e_assembly_wall_clock_s",
        "value": round(wall, 2),
        "unit": "s",
        "vs_baseline": None,
        "detail": {
            "n_reads": n_reads, "genome_len": genome_len,
            "stages_s": {k: round(v, 2) for k, v in stage_secs.items()},
            "n50": stats.get("n50"), "n_contigs": stats.get("n_contigs"),
            "genome_fraction": round(gf, 4),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
