"""Pipeline orchestration, reads to contigs (port of the in-core,
single-device, unpaired branch of sage2_tpu/pipeline.py).

Stages: count + correct, dedup + overlap, transitive reduction (host
native), unitig labeling, and the host finish (unitig graph, tips,
bubbles, min-cost flow). The device stages run on ``device`` ("cuda" by
default, through the CUDA kernels; "cpu" runs their plain versions).

Stage artifacts are the reference's: corrected.npz, edges.npz,
reduced.npz, labels.npz, contigs.fasta, stats.json and manifest.json
under ``outdir``. ``resume_from`` re-enters at a stage from those files,
which may also come from a sage2_tpu run (load_reference_artifacts).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sage2_tpu_torch.config import AssemblyConfig
from sage2_tpu_torch.graph.finish import (
    annotate_copy_counts,
    build_unitig_graph,
    emit_contigs,
    estimate_single_copy_coverage,
    join_paths,
    mincost_paths,
    pop_bubbles,
    prune_weak_branches,
    prune_zero_copy_branches,
    remove_tips,
)
from sage2_tpu_torch.graph.reduce import transitive_reduction_auto
from sage2_tpu_torch.graph.traverse import contract_unitigs
from sage2_tpu_torch.io.writer import write_fasta
from sage2_tpu_torch.kmer import correct_reads_twophase, count_kmers
from sage2_tpu_torch.overlap import find_overlaps_auto, prepare_reads
from sage2_tpu_torch.utils.device import resolve_device
from sage2_tpu_torch.utils.metrics import MetricsLog
from sage2_tpu_torch.utils.stats import assembly_stats

STAGES = ["correct", "overlap", "reduce", "traverse", "finish"]

ARTIFACTS = ("corrected", "edges", "reduced", "labels")


def _save(outdir: Optional[str], log: MetricsLog, name: str,
          **arrays) -> None:
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with log.timed("save", artifact=name):
            np.savez_compressed(os.path.join(outdir, name + ".npz"),
                                **arrays)


def _manifest(outdir: Optional[str], config: AssemblyConfig,
              stage: str) -> None:
    if not outdir:
        return
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "manifest.json")
    m = {"config": config.to_dict(), "config_digest": config.digest(),
         "stages": []}
    if os.path.exists(path):
        with open(path) as f:
            m = json.load(f)
    if m.get("config_digest") != config.digest():
        m = {"config": config.to_dict(), "config_digest": config.digest(),
             "stages": []}
    if stage not in m["stages"]:
        m["stages"].append(stage)
    with open(path, "w") as f:
        json.dump(m, f, indent=1)


def load_reference_artifacts(outdir: str) -> Dict[str, object]:
    """Read the stage artifacts of a run (of this package or of
    sage2_tpu) with numpy only: ``manifest`` (dict) and, where present,
    ``corrected``, ``edges``, ``reduced`` and ``labels`` (dicts of
    arrays). Raises ValueError for a run whose arrays went to a spill
    store, which the port cannot read."""
    with open(os.path.join(outdir, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("spilled"):
        raise ValueError(
            f"{outdir} was produced by a run that spilled its stage "
            f"arrays to a spill store; the port has no spill store yet "
            f"(ROADMAP Queue 1 item 11)")
    out: Dict[str, object] = {"manifest": manifest}
    for name in ARTIFACTS:
        path = os.path.join(outdir, name + ".npz")
        if os.path.exists(path):
            with np.load(path) as z:
                out[name] = {k: z[k] for k in z.files}
    return out


def _unsupported(config: AssemblyConfig, n_reads: int, mate_of,
                 lengths) -> Optional[str]:
    """The ROADMAP item a request needs, or None on the ported path."""
    if config.mesh_shape is not None:
        return "a device mesh (ROADMAP Queue 1 item 12)"
    if config.max_device_reads is not None and n_reads > config.max_device_reads:
        return "streaming beyond device memory (ROADMAP Queue 1 item 11)"
    if config.spill_dir:
        return "the spill store (ROADMAP Queue 1 item 11)"
    if lengths is not None:
        return "ragged reads (ROADMAP Queue 1 item 10)"
    if config.correction_rule != "single_window":
        return "the vote_all_windows corrector (ROADMAP Queue 1 item 3)"
    if config.reduce_backend == "device":
        return "the device reduction (ROADMAP Queue 1 item 9)"
    if mate_of is not None:
        return "paired reads and scaffolding (ROADMAP Queue 1 item 14)"
    return None


def assemble(
    reads: np.ndarray,
    config: AssemblyConfig = AssemblyConfig(),
    outdir: Optional[str] = None,
    metrics: Optional[MetricsLog] = None,
    resume_from: Optional[str] = None,
    device="cuda",
    mate_of: Optional[np.ndarray] = None,
    lengths: Optional[np.ndarray] = None,
) -> Tuple[List[np.ndarray], Dict[str, float]]:
    """Assemble reads (N, L) int codes -> (contigs, stats).

    ``device``: "cuda" (default; raises when no GPU is available) or
    "cpu". ``mate_of`` and ``lengths`` exist for the reference's
    signature; paired and ragged inputs raise NotImplementedError, as
    does any configuration off the ported path.
    """
    dev = resolve_device(device)
    missing = _unsupported(config, reads.shape[0], mate_of, lengths)
    if missing:
        raise NotImplementedError(f"not ported yet: {missing}")
    if resume_from is not None and resume_from not in STAGES:
        raise ValueError(f"unknown stage {resume_from!r}")
    log = metrics or MetricsLog(
        os.path.join(outdir, "metrics.jsonl") if outdir else None
    )
    return _assemble_inner(reads, config, outdir, log, resume_from, dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _assemble_inner(reads, config, outdir, log, resume_from, dev):
    N, L = reads.shape
    start = STAGES.index(resume_from) if resume_from else 0
    prior = load_reference_artifacts(outdir) if start else {}

    def stage_input(name):
        if name not in prior:
            raise ValueError(f"resume from {resume_from!r} needs "
                             f"{name}.npz in {outdir}")
        return prior[name]

    # --- stage 1+2: count + correct ------------------------------------
    if start <= STAGES.index("correct"):
        r = torch.from_numpy(reads.astype(np.int32)).to(dev)
        with log.timed("count", n_reads=N, read_len=L, k=config.k):
            table = count_kmers(r, config.k)
            _sync(dev)
        log.log("count_result", n_unique=int(table.n_unique))
        with log.timed("correct", rounds=config.correction_rounds):
            corrected = correct_reads_twophase(
                r, config.k, config.solid_threshold,
                config.correction_rounds, table=table,
            )
            _sync(dev)
        del r, table
        corrected_np = corrected.to(torch.int8).cpu().numpy()
        del corrected
        _save(outdir, log, "corrected", reads=corrected_np)
        _manifest(outdir, config, "correct")
    else:
        corrected_np = stage_input("corrected")["reads"]

    # --- stage 3: dedup + overlaps -------------------------------------
    if start <= STAGES.index("overlap"):
        with log.timed("dedup"):
            rs = prepare_reads(
                torch.from_numpy(corrected_np.astype(np.int32)).to(dev))
            _sync(dev)
        with log.timed("overlap"):
            res = find_overlaps_auto(
                rs.reads2, rs.valid2, config.min_overlap,
                config.effective_seed_len,
            )
            _sync(dev)
        edges = (res.src.cpu().numpy(), res.dst.cpu().numpy(),
                 res.ovl.cpu().numpy())
        log.log("overlap_result", n_edges=res.n_edges,
                n_candidates=res.n_candidates,
                n_unique_reads=int(rs.n_unique))
        n_edges = res.n_edges
        reads2_np = rs.reads2.to(torch.int8).cpu().numpy()
        valid2_np = rs.valid2.cpu().numpy()
        mult_np = rs.multiplicity.cpu().numpy()
        del rs, res
        _save(outdir, log, "edges", src=edges[0], dst=edges[1],
              ovl=edges[2], n_edges=n_edges, reads2=reads2_np,
              valid2=valid2_np, multiplicity=mult_np)
        _manifest(outdir, config, "overlap")
    else:
        z = stage_input("edges")
        if "lengths2" in z or "mate_pairs" in z:
            raise NotImplementedError(
                "not ported yet: resuming a ragged or paired run "
                "(ROADMAP Queue 1 items 10, 14)")
        edges = (z["src"], z["dst"], z["ovl"])
        reads2_np, valid2_np, mult_np = (z["reads2"], z["valid2"],
                                         z["multiplicity"])

    V = reads2_np.shape[0]

    # --- stage 4: transitive reduction (host native) -------------------
    if start <= STAGES.index("reduce"):
        with log.timed("reduce", backend=config.reduce_backend):
            red = transitive_reduction_auto(
                edges[0], edges[1], edges[2], V, L,
                backend=config.reduce_backend,
            )
        log.log("reduce_result", n_edges=red.n_edges,
                n_expansions=red.n_expansions)
        redges = (red.src, red.dst, red.ovl)
        _save(outdir, log, "reduced", src=redges[0], dst=redges[1],
              ovl=redges[2])
        _manifest(outdir, config, "reduce")
    else:
        z = stage_input("reduced")
        redges = (z["src"], z["dst"], z["ovl"])

    # --- stage 5: unitig labeling --------------------------------------
    if start <= STAGES.index("traverse"):
        with log.timed("traverse"):
            labels = contract_unitigs(
                *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in redges), V,
            )
            _sync(dev)
        lab = {k: v.cpu().numpy() for k, v in labels._asdict().items()}
        _save(outdir, log, "labels", **lab)
        _manifest(outdir, config, "traverse")
    else:
        lab = stage_input("labels")

    # --- stage 6: host finishing + emission ----------------------------
    with log.timed("finish"):
        g = build_unitig_graph(
            lab["head"], lab["dist"], lab["ovl_next"], redges,
            valid2_np, mult_np, L,
        )
        n_unitigs_raw = len(g.unitigs)
        capn = V // 2
        n_tips = remove_tips(g, capn, config.tip_max_reads)
        n_pruned = 0
        c1 = estimate_single_copy_coverage(g, L)
        annotate_copy_counts(g, c1)
        if config.traversal == "mincost":
            n_pruned = prune_weak_branches(g, config.branch_dominance)
            n_pruned += prune_zero_copy_branches(g, c1)
        n_bub = pop_bubbles(g, capn, config.bubble_max_reads,
                            config.bubble_ratio)
        n_tips += remove_tips(g, capn, config.tip_max_reads)
        if config.traversal == "mincost":
            annotate_copy_counts(g, c1)  # re-annotate post-cleaning
            flow_stats: dict = {}
            paths = mincost_paths(
                g, capn,
                path_penalty=config.path_penalty,
                flow_max_extra=config.flow_max_extra,
                flow_max_component=config.flow_max_component,
                stats_out=flow_stats,
            )
            log.log("flow_traversal", **flow_stats)
        else:
            paths = join_paths(g)
        contigs = emit_contigs(g, paths, reads2_np, config)
    stats = assembly_stats(contigs)
    log.log("finish_result", n_unitigs=n_unitigs_raw, tips_removed=n_tips,
            single_copy_coverage=round(c1, 2),
            branches_pruned=n_pruned, bubbles_popped=n_bub, **stats)
    if outdir:
        write_fasta(os.path.join(outdir, "contigs.fasta"), contigs)
        with open(os.path.join(outdir, "stats.json"), "w") as f:
            json.dump(stats, f, indent=1)
        _manifest(outdir, config, "finish")
    return contigs, stats
