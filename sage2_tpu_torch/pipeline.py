"""Pipeline orchestration, reads to contigs (port of the single-device,
unpaired branches of sage2_tpu/pipeline.py: in core for fixed-length and
ragged reads, streamed beyond device memory for fixed-length reads).

Stages: count + correct (either rule), dedup + overlap, transitive
reduction (host native, or on the device with ``reduce_backend=
"device"``), unitig labeling, and the host finish (unitig graph, tips,
bubbles, min-cost flow). The device stages run on ``device`` ("cuda" by
default, through the CUDA kernels; "cpu" runs their plain versions).
Ragged reads (``lengths``) also go through SAGE's containment removal
after the overlap stage: a read that lies whole inside a longer one
leaves the graph with its edges.

Streaming (``config.max_device_reads`` below the read count): count,
correct, dedup and overlap go to the device in chunks of that many reads
(``sage2_tpu_torch.stream``; the overlap join through kernels K9 and
K10, for ragged reads through K13 and K3 over an entry slab), with the
in-core result bit for bit. With ``config.spill_dir``
the big host arrays (corrected reads, the read store, the edge lists)
become memmaps of a spill store there (``utils.spill``), and the native
reduction marks and compacts through it.

A device mesh (``config.mesh_shape``; fixed-length or ragged reads,
either correction rule): count, correct, overlap, reduction and unitig
labeling run sharded over ``n`` shard slots (``parallel``; shard d on
device d % the device count, so four shards may share one card), the
dedup, the containment removal of ragged reads and the host finish as on
one device; the result equals the single-device run's. With streaming
too, count, correct and overlap stream their chunks through the mesh
(``parallel.sharded_stream``) and the overlap's edge slices chain into
the sharded reduction, as in core.

Stage artifacts are the reference's: corrected.npz, edges.npz,
reduced.npz, labels.npz, contigs.fasta, stats.json and manifest.json
under ``outdir`` (a spilled run keeps its big arrays in the spill store
and only the small ones in the npz files). ``resume_from`` re-enters at
a stage from those files, which may also come from a sage2_tpu run
(load_reference_artifacts).
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
from sage2_tpu_torch.graph.reduce import (
    transitive_reduction_auto,
    transitive_reduction_spill,
)
from sage2_tpu_torch.graph.traverse import contract_unitigs
from sage2_tpu_torch.io.writer import write_fasta
from sage2_tpu_torch.kmer import correct_reads, count_kmers
from sage2_tpu_torch.ops.sort import I32_MAX
from sage2_tpu_torch.overlap import find_overlaps_auto, prepare_reads
from sage2_tpu_torch.stream import (
    compact_pad_edges_spill,
    correct_reads_chunked,
    find_overlaps_chunked,
    find_overlaps_chunked_ragged,
    prepare_reads_chunked,
)
from sage2_tpu_torch.utils.device import resolve_device
from sage2_tpu_torch.utils.metrics import DeviceSplit, MetricsLog
from sage2_tpu_torch.utils.spill import SpillStore
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
              stage: str, spilled: bool = False) -> None:
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
    # the big arrays live in the spill store, not in the npz artifacts:
    # a resume of this outdir needs the same spill dir
    if spilled:
        m["spilled"] = True
    with open(path, "w") as f:
        json.dump(m, f, indent=1)


def load_reference_artifacts(outdir: str,
                             spill_dir: Optional[str] = None
                             ) -> Dict[str, object]:
    """Read the stage artifacts of a run (of this package or of
    sage2_tpu) with numpy only: ``manifest`` (dict) and, where present,
    ``corrected``, ``edges``, ``reduced`` and ``labels`` (dicts of
    arrays). ``spill_dir``: the spill store of a run that spilled its
    big arrays; its ``corrected``, ``edges_*``/``reads2`` and
    ``reduced_*`` arrays (memmaps) take the place of the npz ones.
    Raises ValueError for a spilled run without its spill dir."""
    with open(os.path.join(outdir, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("spilled") and spill_dir is None:
        raise ValueError(
            f"{outdir} was produced by a run that spilled its stage "
            f"arrays to a spill store; resume with the same --spill-dir")
    out: Dict[str, object] = {"manifest": manifest}
    for name in ARTIFACTS:
        path = os.path.join(outdir, name + ".npz")
        if os.path.exists(path):
            with np.load(path) as z:
                out[name] = {k: z[k] for k in z.files}
    if spill_dir is not None:
        store = SpillStore(spill_dir)
        if store.exists("corrected"):
            out["corrected"] = {"reads": store.load("corrected")}
        if "edges" in out and store.exists("edges_src"):
            out["edges"].update(
                {k: store.load(f"edges_{k}") for k in ("src", "dst", "ovl")},
                reads2=store.load("reads2"))
        if store.exists("reduced_src"):
            out["reduced"] = {k: store.load(f"reduced_{k}")
                              for k in ("src", "dst", "ovl")}
    return out


def _unsupported(config: AssemblyConfig, n_reads: int, mate_of,
                 lengths) -> Optional[str]:
    """The ROADMAP item a request needs, or None on the ported path."""
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
    "cpu". ``lengths``: (N,) per-read lengths of ragged reads, padded
    with zeros to the array width (``--length-policy pad``).
    ``config.max_device_reads`` below the read count streams the device
    stages (fixed-length and ragged reads), ``config.entry_block_reads``
    and ``config.spill_dir`` with them; a spilled run resumes only with
    its spill dir. ``config.mesh_shape`` shards the stages (either rule,
    fixed-length or ragged reads, in core or streamed; a streamed mesh
    ignores ``entry_block_reads``, as the reference does) over a mesh of
    prod(mesh_shape) shards on ``device`` ("cuda": the visible cards,
    shard d on card d % their count, at most 8 shards; "cpu": all on the
    CPU). ``mate_of`` exists for the reference's signature; paired
    inputs raise NotImplementedError.
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
    return _assemble_inner(reads, config, outdir, log, resume_from, dev,
                           lengths)


def _stream_chunk(config: AssemblyConfig, n_reads: int) -> Optional[int]:
    """Reads per chunk of the streamed stages: max_device_reads when the
    input exceeds it, else None (in core)."""
    if (config.max_device_reads is not None
            and n_reads > config.max_device_reads):
        return config.max_device_reads
    return None


def _spill_store(config: AssemblyConfig, stream_chunk, resume_from, log):
    """The run's spill store, or None: a store needs a streamed run. On a
    fresh run the store records the config digest; a resume checks it
    (spill_dir is outside the digest, so an equal digest means the same
    pipeline)."""
    if not config.spill_dir:
        return None
    if stream_chunk is None:
        log.log("spill_skipped", reason="spill requires a streamed path "
                "(set max_device_reads below the input size)")
        return None
    store = SpillStore(config.spill_dir)
    if resume_from:
        d = store.get_meta("config_digest")
        if d is not None and d != config.digest():
            raise ValueError(
                f"spill dir {config.spill_dir} was written by a run with a "
                f"different config (digest {d} != {config.digest()}); its "
                f"arrays do not match this resume; point --spill-dir at "
                f"the original run's spill directory")
    else:
        store.set_meta("config_digest", config.digest())
    log.log("spill", dir=config.spill_dir)
    return store


def _writable(a: np.ndarray) -> np.ndarray:
    """``a``, or a copy of it when it is read-only (a spill memmap read
    back), for torch.from_numpy."""
    return a if a.flags.writeable else np.array(a)


def _real_rows(edges: Tuple, n_edges: Optional[int]) -> Tuple:
    """The real rows of padded (src, dst, ovl) host arrays: the first
    ``n_edges`` where that count is known (a ReducedGraph's real rows
    lead it), else the rows with src != INT32_MAX."""
    if n_edges is not None:
        return tuple(a[:n_edges] for a in edges)
    real = np.asarray(edges[0]) != I32_MAX
    return tuple(np.asarray(a)[real] for a in edges)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sync_mesh(mesh) -> None:
    for dev in set(mesh.devices):
        _sync(dev)


def _drop_vertices(edges, gone: np.ndarray):
    """The edges touching no vertex of the mask ``gone``, re-padded to
    the input length with (INT32_MAX, INT32_MAX, 0); and their count."""
    e_src, e_dst, e_ovl = edges
    real = e_src != I32_MAX
    keep = real.copy()
    keep[real] = ~(gone[e_src[real]] | gone[e_dst[real]])
    n_keep = int(keep.sum())
    out = []
    for a, fill in ((e_src, I32_MAX), (e_dst, I32_MAX), (e_ovl, 0)):
        b = np.full(a.shape[0], fill, np.int32)
        b[:n_keep] = a[keep]
        out.append(b)
    return tuple(out), n_keep


def _mesh_of(config: AssemblyConfig, dev: torch.device, log):
    """The run's mesh, or None: prod(mesh_shape) shards on ``dev`` (for
    "cuda" without an index, on every visible card); its collective
    ledger starts empty."""
    if config.mesh_shape is None:
        return None
    from sage2_tpu_torch.parallel import comm, make_mesh

    devices = None if dev.type == "cuda" and dev.index is None else dev
    mesh = make_mesh(int(np.prod(config.mesh_shape)), devices=devices)
    comm.reset()
    log.log("mesh", n_devices=mesh.size)
    return mesh


def _pad_rows(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Rows padded to a multiple of the mesh size with copies of the last
    (sage2_tpu/pipeline.py:123; the copies are masked as invalid)."""
    pad = (-arr.shape[0]) % multiple
    if not pad:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)


def _mesh_correct(mesh, reads, config, log, dev, lengths):
    """The meshed count + correct stage (sage2_tpu/pipeline.py:251-277):
    (N, L) int8 corrected reads on ``dev``; ``lengths`` padded as the
    reads are."""
    from sage2_tpu_torch.parallel import sharded_correct_reads

    N, L = reads.shape
    nd = mesh.size
    padded = _pad_rows(reads.astype(np.int32), nd)
    pvalid = np.arange(padded.shape[0]) < N
    lens_pad = None if lengths is None else _pad_rows(
        np.asarray(lengths, np.int32).reshape(-1, 1), nd).reshape(-1)
    cap = max(4096, 4 * padded.shape[0] * (L - config.k + 1) // nd)
    with log.timed("correct", rounds=config.correction_rounds,
                   sharded=True):
        corrected, ovf = sharded_correct_reads(
            mesh, padded, config.k, config.solid_threshold,
            config.correction_rounds, route_cap=cap, query_cap=cap,
            valid=pvalid, lengths=lens_pad, rule=config.correction_rule)
        _sync_mesh(mesh)
    if ovf:
        raise RuntimeError("sharded correction routing overflow")
    return corrected[:N].to(dev, torch.int8)


def _stream_overlap(reads2, valid2, lengths2, n_uniq, config, log,
                    stream_chunk, store, dev):
    """The streamed overlap stage on one device (sage2_tpu/pipeline.py:
    446-560): the streamed join (K9/K10, or for ragged reads K13 and K3),
    its capacity doubled until no chunk overflows; the containment
    removal of ragged reads; the edge list padded to the 2^14 grain (the
    store's ``edges_*`` memmaps with a spill store). Returns (n_edges,
    the edge list, valid2)."""
    # ~19 edges a vertex at 50x coverage: up to ~32 candidates a read of
    # a chunk; starting at 64x avoids doubling retries (each a full
    # streamed pass) on dense graphs
    cap_chunk = max(1 << 16, 64 * stream_chunk)
    while True:
        with log.timed("overlap", streamed=True, chunk_reads=stream_chunk):
            common = dict(chunk_reads=2 * stream_chunk,
                          seed_len=config.effective_seed_len,
                          capacity_per_chunk=cap_chunk, store=store,
                          entry_block_reads=config.entry_block_reads,
                          device=dev)
            if lengths2 is not None:
                e_src, e_dst, e_ovl, n_edges, cont, overflow = (
                    find_overlaps_chunked_ragged(
                        reads2, valid2, lengths2, config.min_overlap,
                        **common))
            else:
                e_src, e_dst, e_ovl, n_edges, overflow = (
                    find_overlaps_chunked(reads2, valid2, config.min_overlap,
                                          **common))
        if not overflow:
            break
        cap_chunk *= 2
        log.log("overlap_retry", capacity_per_chunk=cap_chunk)
    cont_mask = None
    if lengths2 is not None:
        # SAGE containment removal (sage2_tpu/pipeline.py:474-483): a read
        # contained in either orientation leaves the graph with its edges
        cont = cont | np.roll(cont, cont.shape[0] // 2)
        n_cont = int(cont.sum())
        log.log("containment", n_contained=n_cont)
        if n_cont:
            cont_mask = cont
            valid2 = valid2 & ~cont
    if store is not None and lengths2 is None:
        # find_overlaps_chunked wrote the padded edges_* memmaps
        edges = (e_src, e_dst, e_ovl)
    elif store is not None:
        *edges, n_edges = compact_pad_edges_spill(
            store, e_src, e_dst, e_ovl, n_edges, cont=cont_mask)
        edges = tuple(edges)
    else:
        if cont_mask is not None:
            keep = ~(cont_mask[e_src[:n_edges]] | cont_mask[e_dst[:n_edges]])
            e_src, e_dst, e_ovl = (a[:n_edges][keep]
                                   for a in (e_src, e_dst, e_ovl))
            n_edges = int(keep.sum())
        # pad to the reference's grain of the sorted edge list
        pad_to = max(1, -(-n_edges // (1 << 14)) * (1 << 14))
        edges = tuple(
            np.concatenate([a[:n_edges], np.full(
                pad_to - n_edges, I32_MAX if j < 2 else 0, np.int32)])
            for j, a in enumerate((e_src, e_dst, e_ovl)))
    log.log("overlap_result", n_edges=n_edges, n_candidates=n_edges,
            n_unique_reads=n_uniq)
    return n_edges, edges, valid2


def _mesh_correct_streamed(mesh, reads, config, log, stream_chunk, store,
                           lengths):
    """The streamed meshed count + correct stage (sage2_tpu/pipeline.py:
    219-250): (N, L) int8 corrected reads on the host (the store's
    ``corrected`` memmap with a spill store); the route and table
    capacities doubled until nothing overflows."""
    from sage2_tpu_torch.parallel import sharded_correct_reads_chunked

    N, L = reads.shape
    nd = mesh.size
    rows = min(stream_chunk, N)
    rows += (-rows) % nd
    cap = max(4096, 4 * rows * (L - config.k + 1) // nd)
    # unique k-mers an owner: a quarter of all windows to start with
    tcap = max(1 << 15, N * (L - config.k + 1) // (4 * nd))
    while True:
        with log.timed("correct", rounds=config.correction_rounds,
                       sharded=True, streamed=True, chunk_reads=stream_chunk):
            corrected, ovf = sharded_correct_reads_chunked(
                mesh, reads, config.k, config.solid_threshold,
                config.correction_rounds, stream_chunk, cap, cap, tcap,
                lengths=lengths, rule=config.correction_rule,
                out=(store.empty("corrected", np.int8, reads.shape)
                     if store is not None else None))
            _sync_mesh(mesh)
        if not ovf:
            return corrected
        cap *= 2
        tcap *= 2
        log.log("correct_retry", route_cap=cap, table_cap=tcap)


def _mesh_overlap_streamed(mesh, reads2, valid2, lengths2, n_uniq, config,
                           log, stream_chunk, store, outdir):
    """The streamed meshed overlap stage (sage2_tpu/pipeline.py:325-426)
    on the streamed dedup's host arrays: the reference's capacities, all
    doubled until nothing overflows; the edge slices gathered to the host
    (into the spill store's ``edges_*`` memmaps for fixed-length reads
    with a store and an outdir) when there is an outdir or lengths; the
    containment removal of ragged reads. Returns (the edge slices, or
    None once containment changed the edges; n_edges; the host edge list
    or None; valid2)."""
    from sage2_tpu_torch.overlap.detect import join_geometry
    from sage2_tpu_torch.parallel import (
        gather_edge_shards,
        gather_edge_shards_spill,
        sharded_find_overlaps_chunked,
    )

    nd = mesh.size
    M2, L = reads2.shape
    geo = join_geometry(L, config.min_overlap, config.effective_seed_len)
    rows = min(2 * stream_chunk, M2)
    rows += (-rows) % nd
    row_cap = max(4096, 2 * (rows // nd) * geo.g // nd)
    q_cap = max(4096, 2 * (rows // nd) * geo.n_pos // nd)
    join_cap = max(1 << 16, 32 * rows // nd)
    # a chunk's edges land on the one or two owners of its source range
    edge_chunk_cap = max(4096, 32 * rows // nd)
    edge_cap = max(1 << 16, 32 * (M2 + (-M2) % nd) // nd)
    while True:
        with log.timed("overlap", sharded=True, streamed=True,
                       chunk_reads=stream_chunk):
            out = sharded_find_overlaps_chunked(
                mesh, reads2, valid2, config.min_overlap,
                config.effective_seed_len, 2 * stream_chunk, row_cap, q_cap,
                join_cap, edge_chunk_cap, edge_cap, lengths=lengths2)
            src_sh, dst_sh, ovl_sh, n_edges, ovf = out[:5]
            _sync_mesh(mesh)
        if not ovf:
            break
        row_cap *= 2
        q_cap *= 2
        join_cap *= 2
        edge_chunk_cap *= 2
        edge_cap *= 2
        log.log("overlap_retry", row_cap=row_cap, q_cap=q_cap,
                join_cap=join_cap, edge_chunk_cap=edge_chunk_cap,
                edge_cap=edge_cap)
    log.log("overlap_result", n_edges=n_edges, n_candidates=n_edges,
            n_unique_reads=n_uniq)
    log.log("overlap_device_memory", chunk_rows_per_device=rows // nd,
            entry_rows_per_device="accumulated/ndev", row_cap=row_cap,
            q_cap=q_cap, join_cap=join_cap, edge_chunk_cap=edge_chunk_cap,
            edge_cap=edge_cap, global_reads=M2)
    edges_dev = (src_sh, dst_sh, ovl_sh)
    if store is not None and lengths2 is None and outdir:
        edges = gather_edge_shards_spill(store, src_sh, dst_sh, ovl_sh,
                                         n_edges)
    elif outdir or lengths2 is not None:
        edges = gather_edge_shards(src_sh, dst_sh, ovl_sh, n_edges)
    else:
        edges = None
    if lengths2 is not None:
        # SAGE containment removal (sage2_tpu/pipeline.py:401-426); the
        # edge set changes on the host, so the reduction partitions it anew
        cont = out[5]
        cont = cont | np.roll(cont, M2 // 2)
        log.log("containment", n_contained=int(cont.sum()))
        if cont.any():
            edges, n_edges = _drop_vertices(edges, cont)
            edges_dev = None
            valid2 = valid2 & ~cont
    return edges_dev, n_edges, edges, valid2


def _mesh_overlap(mesh, rs, config, log, outdir):
    """The meshed overlap stage (sage2_tpu/pipeline.py:561-620): the
    deduplicated reads padded to the mesh (ragged ones with length 0),
    routed join, capacities doubled until nothing overflows. Returns
    (per-shard edge slices, n_edges, the host edge list or None without
    ``outdir`` or lengths, the (M2,) containment marks of ragged reads or
    None)."""
    from sage2_tpu_torch.overlap.detect import join_geometry
    from sage2_tpu_torch.parallel import (
        gather_edge_shards,
        sharded_find_overlaps,
    )

    nd = mesh.size
    M2, L = rs.reads2.shape
    padm = (-M2) % nd
    dev = rs.reads2.device
    reads2 = torch.cat([rs.reads2, torch.zeros((padm, L), dtype=torch.int32,
                                               device=dev)])
    valid2 = torch.cat([rs.valid2, torch.zeros(padm, dtype=torch.bool,
                                               device=dev)])
    lengths2 = None if rs.lengths2 is None else torch.cat(
        [rs.lengths2.to(torch.int32),
         torch.zeros(padm, dtype=torch.int32, device=dev)])
    Mp = M2 + padm
    geo = join_geometry(L, config.min_overlap, config.effective_seed_len)
    row_cap = max(4096, 2 * (Mp // nd) * geo.R // nd)
    join_cap = max(1 << 16, 32 * Mp // nd)
    edge_cap = join_cap
    while True:
        with log.timed("overlap", sharded=True):
            out = sharded_find_overlaps(
                mesh, reads2, valid2, config.min_overlap,
                config.effective_seed_len, row_cap=row_cap,
                join_cap=join_cap, edge_cap=edge_cap, lengths=lengths2)
            src_sh, dst_sh, ovl_sh, n_edges, ovf = out[:5]
            _sync_mesh(mesh)
        if not ovf:
            break
        row_cap *= 2
        join_cap *= 2
        edge_cap *= 2
        log.log("overlap_retry", row_cap=row_cap, join_cap=join_cap,
                edge_cap=edge_cap)
    log.log("overlap_device_memory", reads_per_device=Mp // nd,
            seed_rows_per_device=(Mp // nd) * geo.R, row_cap=row_cap,
            join_cap=join_cap, edge_cap=edge_cap, global_reads=Mp)
    edges = (gather_edge_shards(src_sh, dst_sh, ovl_sh, n_edges)
             if outdir or lengths2 is not None else None)
    cont = None if lengths2 is None else out[5][:M2]
    return (src_sh, dst_sh, ovl_sh), n_edges, edges, cont


def _mesh_reduce(mesh, edges_dev, edges, n_edges, V, L, config, log,
                 lengths2):
    """The meshed transitive reduction (sage2_tpu/pipeline.py:755-830):
    the overlap stage's slices, or the host edges partitioned by src
    range; ragged reads' ``lengths2`` partitioned by vertex range
    (:776-784); the reference's capacity retries. Returns (reduced
    slices, host reduced edges, n_edges, n_expansions)."""
    from sage2_tpu_torch.parallel import (
        gather_edge_shards,
        partition_edges_by_src,
        partition_vertex_range,
        sharded_transitive_reduction,
    )

    nd = mesh.size
    if edges_dev is not None:
        s_sh, d_sh, o_sh = edges_dev
        n_edges_glob = n_edges
    else:
        s_sh, d_sh, o_sh, _ = partition_edges_by_src(
            edges[0], edges[1], edges[2], V, nd)
        n_edges_glob = int(np.sum(s_sh != I32_MAX))
    lens_sh = None if lengths2 is None else partition_vertex_range(
        np.asarray(lengths2, np.int32), V, nd)
    e_d = int(s_sh[0].shape[0])
    cap = config.reduce_capacity
    reqc = max(4096, 2 * e_d // nd)
    while True:
        cap_dev = -(-cap // nd)
        with log.timed("reduce", capacity=cap, sharded=True):
            r_src, r_dst, r_ovl, r_n, r_exp, r_ovf = (
                sharded_transitive_reduction(
                    mesh, s_sh, d_sh, o_sh, V, L, req_cap=reqc,
                    cand_cap=cap_dev, lengths_sh=lens_sh))
        if not r_ovf:
            break
        grain = 1 << 16
        cap = max(cap + grain, 2 * cap,
                  -(-int(r_exp * 1.05) // grain) * grain)
        reqc *= 2
        log.log("reduce_retry", new_capacity=cap)
    log.log("reduce_device_memory", edges_per_device=e_d, req_cap=reqc,
            cand_cap=cap_dev, global_edges=n_edges_glob)
    red = gather_edge_shards(r_src, r_dst, r_ovl, r_n)
    return (r_src, r_dst, r_ovl), red, r_n, r_exp


def _mesh_traverse(mesh, reduced_dev, redges, V, log, dev):
    """The meshed unitig labeling (sage2_tpu/pipeline.py:877-915):
    labels gathered to host arrays."""
    from sage2_tpu_torch.parallel import (
        gather_cyclic_shards,
        partition_edges_by_src,
        sharded_contract_unitigs,
    )

    nd = mesh.size
    if reduced_dev is not None:
        s_sh, d_sh, o_sh = reduced_dev
    else:
        s_sh, d_sh, o_sh, _ = partition_edges_by_src(
            redges[0], redges[1], redges[2], V, nd)
    e_d = int(s_sh[0].shape[0])
    rcap = max(4096, 2 * max(e_d, -(-V // nd)) // nd)
    while True:
        with log.timed("traverse", sharded=True):
            shards, t_ovf = sharded_contract_unitigs(mesh, s_sh, d_sh, o_sh,
                                                     V, route_cap=rcap)
            _sync_mesh(mesh)
        if not t_ovf:
            break
        rcap *= 2
        log.log("traverse_retry", route_cap=rcap)
    names = ["head", "dist", "nxt", "ovl_next", "outdeg", "indeg"]
    log.log("traverse_device_memory", vertices_per_device=-(-V // nd),
            edges_per_device=e_d, route_cap=rcap, global_vertices=V)
    return {k: gather_cyclic_shards(sh, V) for k, sh in zip(names, shards)}


def _assemble_inner(reads, config, outdir, log, resume_from, dev, lengths):
    N, L = reads.shape
    start = STAGES.index(resume_from) if resume_from else 0
    mesh = _mesh_of(config, dev, log)
    edges_dev = reduced_dev = None      # meshed: per-shard edge slices
    stream_chunk = _stream_chunk(config, N)
    if stream_chunk is not None:
        log.log("streaming", chunk_reads=stream_chunk, n_reads=N)
    store = _spill_store(config, stream_chunk, resume_from, log)
    spilled = store is not None
    prior = (load_reference_artifacts(outdir, config.spill_dir if spilled
                                      else None) if start else {})

    def stage_input(name):
        if name not in prior:
            raise ValueError(f"resume from {resume_from!r} needs "
                             f"{name}.npz in {outdir}")
        return prior[name]

    lens = None if lengths is None else torch.from_numpy(
        np.asarray(lengths, np.int32)).to(dev)

    # --- stage 1+2: count + correct ------------------------------------
    if start <= STAGES.index("correct"):
        if stream_chunk is not None and mesh is not None:
            corrected_np = _mesh_correct_streamed(
                mesh, reads, config, log, stream_chunk, store, lengths)
        elif stream_chunk is not None:
            with log.timed("correct", rounds=config.correction_rounds,
                           streamed=True, chunk_reads=stream_chunk):
                corrected_np = correct_reads_chunked(
                    reads, config.k, config.solid_threshold,
                    config.correction_rounds, stream_chunk,
                    rule=config.correction_rule,
                    out=(store.empty("corrected", np.int8, reads.shape)
                         if spilled else None),
                    device=dev, lengths=lengths,
                )
        elif mesh is not None:
            # kept on the card for the in-core dedup
            corrected8 = _mesh_correct(mesh, reads, config, log, dev,
                                       lengths)
            corrected_np = corrected8.cpu().numpy()
        else:
            r = torch.from_numpy(reads.astype(np.int32)).to(dev)
            with log.timed("count", n_reads=N, read_len=L, k=config.k):
                table = count_kmers(r, config.k, lens)
                _sync(dev)
            log.log("count_result", n_unique=int(table.n_unique))
            with log.timed("correct", rounds=config.correction_rounds):
                corrected = correct_reads(
                    r, config.k, config.solid_threshold,
                    config.correction_rounds, table=table, lengths=lens,
                    rule=config.correction_rule,
                )
                _sync(dev)
            del r, table
            # kept on the card for the in-core dedup
            corrected8 = corrected.to(torch.int8)
            del corrected
            corrected_np = corrected8.cpu().numpy()
        if not spilled:
            _save(outdir, log, "corrected", reads=corrected_np)
        _manifest(outdir, config, "correct", spilled=spilled)
    else:
        corrected_np = stage_input("corrected")["reads"]

    # --- stage 3: dedup + overlaps -------------------------------------
    if start <= STAGES.index("overlap") and stream_chunk is not None:
        with log.timed("dedup", streamed=True):
            # on the host clock: each part ends in a read to the host
            split = DeviceSplit("cpu")
            reads2_np, valid2_np, mult_np, n_uniq, _, lengths2_np = (
                prepare_reads_chunked(corrected_np, stream_chunk,
                                      store=store, device=dev,
                                      lengths=lengths, split=split))
        log.log("dedup_split", **split.ms())
        if mesh is not None:
            edges_dev, n_edges, edges, valid2_np = _mesh_overlap_streamed(
                mesh, reads2_np, valid2_np, lengths2_np, n_uniq, config, log,
                stream_chunk, store, outdir)
        else:
            n_edges, edges, valid2_np = _stream_overlap(
                reads2_np, valid2_np, lengths2_np, n_uniq, config, log,
                stream_chunk, store, dev)
        extra = {} if lengths2_np is None else {"lengths2": lengths2_np}
        if spilled and store.exists("edges_src"):
            # the big arrays live in the spill store; the npz carries
            # only the small per-vertex ones
            _save(outdir, log, "edges", n_edges=n_edges, valid2=valid2_np,
                  multiplicity=mult_np, **extra)
        elif edges is not None:     # a meshed run gathers them for outdir
            _save(outdir, log, "edges", src=edges[0], dst=edges[1],
                  ovl=edges[2], n_edges=n_edges, reads2=reads2_np,
                  valid2=valid2_np, multiplicity=mult_np, **extra)
        _manifest(outdir, config, "overlap", spilled=spilled)
    elif start <= STAGES.index("overlap"):
        if start > STAGES.index("correct"):
            corrected8 = torch.from_numpy(
                _writable(np.asarray(corrected_np, np.int8))).to(dev)
        with log.timed("dedup"):
            split = DeviceSplit(dev)
            corrected = corrected8.to(torch.int32)
            split.mark("widen")
            del corrected8
            rs = prepare_reads(corrected, lens, split)
            del corrected
            _sync(dev)
        log.log("dedup_split", **split.ms())
        if mesh is not None:
            edges_dev, n_edges, edges, contained = _mesh_overlap(
                mesh, rs, config, log, outdir)
            n_candidates = n_edges
        else:
            with log.timed("overlap"):
                split = DeviceSplit(dev)
                res = find_overlaps_auto(
                    rs.reads2, rs.valid2, config.min_overlap,
                    config.effective_seed_len, lengths=rs.lengths2,
                    split=split,
                )
                _sync(dev)
            log.log("overlap_split", **split.ms())
            if res.overflow:
                raise RuntimeError("find_overlaps_auto returned an "
                                   "overflowed candidate capacity")
            edges = (res.src.cpu().numpy(), res.dst.cpu().numpy(),
                     res.ovl.cpu().numpy())
            n_edges, n_candidates = res.n_edges, res.n_candidates
            contained = res.contained
            del res
        valid2_np = rs.valid2.cpu().numpy()
        if lengths is not None:
            # SAGE containment removal (sage2_tpu/pipeline.py:670-696): a
            # read contained in either orientation leaves the graph with
            # its edges
            cont = contained.cpu().numpy()
            cont = cont | np.roll(cont, cont.shape[0] // 2)
            log.log("containment", n_contained=int(cont.sum()))
            if cont.any():
                edges, n_edges = _drop_vertices(edges, cont)
                valid2_np = valid2_np & ~cont
                # the edge set changed on the host: the meshed reduction
                # partitions it anew (sage2_tpu/pipeline.py:654)
                edges_dev = None
        log.log("overlap_result", n_edges=n_edges,
                n_candidates=n_candidates,
                n_unique_reads=int(rs.n_unique))
        reads2_np = rs.reads2.to(torch.int8).cpu().numpy()
        mult_np = rs.multiplicity.cpu().numpy()
        extra = {}
        lengths2_np = None
        if rs.lengths2 is not None:
            lengths2_np = rs.lengths2.cpu().numpy()
            extra["lengths2"] = lengths2_np
        del rs
        if edges is not None:       # a meshed run gathers them for outdir
            _save(outdir, log, "edges", src=edges[0], dst=edges[1],
                  ovl=edges[2], n_edges=n_edges, reads2=reads2_np,
                  valid2=valid2_np, multiplicity=mult_np, **extra)
            _manifest(outdir, config, "overlap")
    else:
        z = stage_input("edges")
        if "mate_pairs" in z:
            raise NotImplementedError(
                "not ported yet: resuming a paired run "
                "(ROADMAP Queue 1 item 14)")
        if "src" not in z:
            # the original run wrote its edges to a spill store
            raise ValueError(
                f"edges.npz in {outdir} has no edge arrays: the original "
                f"run wrote them to a spill store; resume with the same "
                f"--spill-dir")
        edges = (z["src"], z["dst"], z["ovl"])
        reads2_np, valid2_np, mult_np = (z["reads2"], z["valid2"],
                                         z["multiplicity"])
        lengths2_np = z.get("lengths2")

    V = reads2_np.shape[0]
    vlen_arg = L if lengths2_np is None else lengths2_np

    # --- stage 4: transitive reduction --------------------------------
    # the reduced graph's real rows lead its arrays (ReducedGraph); None
    # where the count is not known (a resumed run), and the traverse
    # stage finds them by their src
    n_reduced = None
    # host arrays: "auto" and "native" reduce them on the host (through
    # the spill store when there is one), "device" uploads them once and
    # reduces on ``dev``
    if start <= STAGES.index("reduce") and mesh is not None:
        reduced_dev, redges, red_n, red_exp = _mesh_reduce(
            mesh, edges_dev, edges, n_edges if edges_dev else None, V, L,
            config, log, lengths2_np)
        edges_dev = None
        log.log("reduce_result", n_edges=red_n, n_expansions=red_exp)
        _save(outdir, log, "reduced", src=redges[0], dst=redges[1],
              ovl=redges[2])
        _manifest(outdir, config, "reduce")
    elif start <= STAGES.index("reduce"):
        with log.timed("reduce", backend=config.reduce_backend):
            if spilled and config.reduce_backend in ("auto", "native"):
                red = transitive_reduction_spill(
                    store, edges[0], edges[1], edges[2], V, vlen_arg)
            else:
                red = transitive_reduction_auto(
                    edges[0], edges[1], edges[2], V, vlen_arg,
                    backend=config.reduce_backend, device=dev,
                )
            redges = tuple(a.cpu().numpy() if isinstance(a, torch.Tensor)
                           else a for a in (red.src, red.dst, red.ovl))
        log.log("reduce_result", n_edges=red.n_edges,
                n_expansions=red.n_expansions)
        n_reduced = red.n_edges
        del red
        # the reduced_* spill files come from transitive_reduction_spill
        # alone; any other reduction persists its result here
        if not (spilled and store.exists("reduced_src")):
            _save(outdir, log, "reduced", src=redges[0], dst=redges[1],
                  ovl=redges[2])
        _manifest(outdir, config, "reduce", spilled=spilled)
    else:
        z = stage_input("reduced")
        redges = (z["src"], z["dst"], z["ovl"])

    # --- stage 5: unitig labeling --------------------------------------
    if start <= STAGES.index("traverse") and mesh is not None:
        lab = _mesh_traverse(mesh, reduced_dev, redges, V, log, dev)
        reduced_dev = None
        _save(outdir, log, "labels", **lab)
        _manifest(outdir, config, "traverse")
    elif start <= STAGES.index("traverse"):
        with log.timed("traverse"):
            # the real rows alone go to the device: padding changes no
            # label (sage2_tpu/graph/traverse.py:46-51)
            labels = contract_unitigs(
                *(torch.from_numpy(_writable(np.ascontiguousarray(a)))
                  .to(dev) for a in _real_rows(redges, n_reduced)), V,
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
            valid2_np, mult_np, vlen_arg,
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
        contigs = emit_contigs(g, paths, reads2_np, config,
                               lengths=lengths2_np)
    stats = assembly_stats(contigs)
    log.log("finish_result", n_unitigs=n_unitigs_raw, tips_removed=n_tips,
            single_copy_coverage=round(c1, 2),
            branches_pruned=n_pruned, bubbles_popped=n_bub, **stats)
    if outdir:
        write_fasta(os.path.join(outdir, "contigs.fasta"), contigs)
        with open(os.path.join(outdir, "stats.json"), "w") as f:
            json.dump(stats, f, indent=1)
        _manifest(outdir, config, "finish")
    if mesh is not None:
        # the collective ledger: per sharded stage, its dispatches and the
        # bytes its exchanges moved
        from sage2_tpu_torch.parallel import comm

        log.log("comm", programs=comm.summary())
    return contigs, stats
