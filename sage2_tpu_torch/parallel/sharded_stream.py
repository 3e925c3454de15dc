"""Streaming on the device mesh (port of sage2_tpu/parallel/sharded_stream.py):
the sharded stages over host-resident reads, one chunk at a time.

Reads stay on the host (numpy arrays or spill memmaps); each chunk of
``rows`` reads (a multiple of the mesh size, the last one padded with
copies of its last read, marked invalid) is split over the shards, shard
d taking rows [d rows_local, (d + 1) rows_local), and routed as the
in-core stages route (``parallel.sharded``, whose owner steps these
reuse):

  sharded_count_kmers_chunked    K1 keys of each shard's slice, K19 to
                                 the hash owners, each owner's count
                                 (torch.sort + K11) merged into its
                                 running table (torch.sort + K11
                                 weighted), cut to ``table_cap``
  sharded_correct_reads_chunked  a chunked recount a round, then each
                                 chunk through the rule's routed lookups
                                 (K22, K19, K2, K20; K5's routed mode)
  sharded_find_overlaps_chunked  (A) K13's entry rows of each chunk with
                                 global ids to the seed owners (K19),
                                 who keep them; (B) each chunk's query
                                 rows to the same owners, each joining
                                 all its entries with them (K3 under the
                                 sort's permutation, K14) and routing
                                 the edges to their source's owner (K19);
                                 (C) each source owner's merge (K14)

Every capacity is the reference's, per (source, destination) and per
owner, and every flag fires where the reference's fires, so the
pipeline's retries are the reference's; the results are the in-core
stages' bit for bit. Device memory holds one chunk's rows and buffers,
the owners' running tables or accumulated entry rows, and the gathered
edges.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from sage2_tpu_torch.kmer.count import KmerTable
from sage2_tpu_torch.ops import bitpack
from sage2_tpu_torch.overlap.detect import join_geometry
from sage2_tpu_torch.parallel import comm
from sage2_tpu_torch.parallel.mesh import Mesh
from sage2_tpu_torch.parallel.sharded import (
    _correct_round,
    _count_owned,
    _exchange,
    _kmer_valid,
    _merge_edges,
    _owner_join,
    _routed_seed_rows,
    _split_rows,
)
from sage2_tpu_torch.stream import _merge_tables
from sage2_tpu_torch.utils import watchdog


def _pad_chunk(arr: np.ndarray, rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """A host chunk padded to exactly ``rows`` rows with copies of its
    last row; returns (padded, valid), the copies invalid (:66)."""
    n = arr.shape[0]
    valid = np.zeros(rows, bool)
    valid[:n] = True
    if n == rows:
        return arr, valid
    pad = np.repeat(arr[-1:], rows - n, axis=0)
    return np.concatenate([arr, pad], axis=0), valid


def _chunk_lens(lengths, i: int, rows: int) -> np.ndarray:
    """The int32 lengths of reads [i, i + rows), 0 past the last read
    (:164)."""
    lc = np.zeros(rows, np.int32)
    seg = np.asarray(lengths[i : i + rows], np.int32)
    lc[: seg.shape[0]] = seg
    return lc


def _chunk_rows(mesh: Mesh, chunk_reads: int, n_reads: int) -> int:
    """Reads a chunk: ``chunk_reads`` (at most all of them), rounded up
    to a multiple of the mesh size."""
    rows = min(chunk_reads, n_reads)
    return rows + (-rows) % mesh.size


def _shard_reads(mesh: Mesh, chunk: np.ndarray) -> List[torch.Tensor]:
    """Each shard's rows of a host chunk of read codes: sent as int8,
    widened to int32 on its device."""
    return [x.to(torch.int32) for x in
            _split_rows(mesh, np.asarray(chunk, np.int8), torch.int8)]


# --------------------------------------------------------------------------
# chunked sharded k-mer counting
# --------------------------------------------------------------------------


def _merge_owned(running: Optional[List[KmerTable]], parts: List[KmerTable],
                 k: int, table_cap: int) -> Tuple[List[KmerTable], bool]:
    """Each owner's counted chunk folded into its running table (the
    counterpart of _merge_sorted_local, :82): torch.sort and K11's
    weighted runs (stream._merge_tables), the result cut to ``table_cap``
    keys. Returns (tables, overflow: some owner held more unique keys
    than ``table_cap``)."""
    out, overflow = [], False
    for d, part in enumerate(parts):
        t = part if running is None else _merge_tables([running[d], part], k)
        if t.n_unique > table_cap:
            overflow = True
            t = KmerTable(t.keys[:table_cap], t.count[:table_cap], table_cap,
                          k)
        out.append(t)
    return out, overflow


def sharded_count_kmers_chunked(
    mesh: Mesh,
    reads: np.ndarray,
    k: int,
    chunk_reads: int,
    route_cap: int,
    table_cap: int,
    lengths: Optional[np.ndarray] = None,
) -> Tuple[List[KmerTable], bool]:
    """Exact canonical counting of host-resident (N, L) reads, streamed
    in chunks over the mesh (:171). Returns (tables, overflow): the
    hash-partitioned tables of sharded_count_kmers (``tables[d]`` the
    keys shard d owns, sorted, with their counts). ``lengths``: ragged
    (0-padded) reads, windows past a read's end masked out. A route past
    ``route_cap`` or an owner past ``table_cap`` unique keys stops the
    pass at that chunk (overflow True), as the reference's does."""
    if not 1 < k <= 31:
        raise ValueError(f"k must be in (1, 31], got {k}")
    N, L = reads.shape
    rows = _chunk_rows(mesh, chunk_reads, N)
    tables = None
    for i in range(0, N, rows):
        watchdog.touch(f"sharded chunk {i}")
        chunk, valid = _pad_chunk(np.asarray(reads[i : i + rows]), rows)
        with comm.label("sharded_count_chunked"):
            r = _shard_reads(mesh, chunk)
            lens = None if lengths is None else _split_rows(
                mesh, _chunk_lens(lengths, i, rows), torch.int32)
            kvalid = _kmer_valid(_split_rows(mesh, valid, torch.bool), lens,
                                 L, k)
            keys = [bitpack.kmer_keys(x, k)[2].reshape(-1) for x in r]
            del r
            parts, ovf = _count_owned(mesh, keys, kvalid, k, route_cap)
            del keys, kvalid
            tables, ovf_t = _merge_owned(tables, parts, k, table_cap)
            del parts
        if ovf or ovf_t:
            # the caller's retry restarts the pass: the rest would be lost
            return tables, True
    return tables, False


# --------------------------------------------------------------------------
# chunked sharded spectrum correction
# --------------------------------------------------------------------------


def sharded_correct_reads_chunked(
    mesh: Mesh,
    reads: np.ndarray,
    k: int,
    threshold: int,
    rounds: int,
    chunk_reads: int,
    route_cap: int,
    query_cap: int,
    table_cap: int,
    lengths: Optional[np.ndarray] = None,
    rule: str = "single_window",
    out: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, bool]:
    """Streamed sharded correction (:285): each round rebuilds the
    sharded table by chunked routed counting, then every chunk runs the
    rule (single_window's two sub-passes, or the covering-window vote)
    with routed lookups against it; a chunk's padding rows are dropped.
    kmer.correct_reads' result with the same rule and ``lengths``.
    ``out``: an optional (N, L) int8 destination (a spill memmap) written
    chunk by chunk, so host memory stays O(chunk). Returns (out,
    overflow); an overflow stops the pass at once."""
    if rule not in ("single_window", "vote_all_windows"):
        raise ValueError(f"unknown correction rule {rule!r}")
    N = reads.shape[0]
    if out is None:
        out = np.array(reads, dtype=np.int8, copy=True)
    else:
        if out.shape != reads.shape or out.dtype != np.int8:
            raise ValueError(f"out must be {reads.shape} int8, got "
                             f"{out.shape} {out.dtype}")
        for i in range(0, N, chunk_reads):
            watchdog.touch(f"sharded chunk {i}")
            out[i : i + chunk_reads] = reads[i : i + chunk_reads]
    rows = _chunk_rows(mesh, chunk_reads, N)
    for _ in range(rounds):
        tables, ovf = sharded_count_kmers_chunked(
            mesh, out, k, chunk_reads, route_cap, table_cap, lengths)
        if ovf:
            return out, True
        for i in range(0, N, rows):
            watchdog.touch(f"sharded chunk {i}")
            chunk, _ = _pad_chunk(np.asarray(out[i : i + rows]), rows)
            with comm.label("sharded_correct_chunked"):
                lens = ([None] * mesh.size if lengths is None else
                        _split_rows(mesh, _chunk_lens(lengths, i, rows),
                                    torch.int32))
                r, ovf = _correct_round(mesh, _shard_reads(mesh, chunk),
                                        tables, k, threshold, query_cap,
                                        lens, rule)
            if ovf:
                return out, True
            n_real = min(i + rows, N) - i
            out[i : i + n_real] = torch.cat(
                [x.to(torch.int8).cpu() for x in r]).numpy()[:n_real]
            del r
        del tables
    return out, False


# --------------------------------------------------------------------------
# chunked sharded overlap detection
# --------------------------------------------------------------------------


def sharded_find_overlaps_chunked(
    mesh: Mesh,
    reads2: np.ndarray,
    valid2: np.ndarray,
    min_overlap: int,
    seed_len: int,
    chunk_reads: int,
    row_cap: int,
    q_cap: int,
    join_cap: int,
    edge_chunk_cap: int,
    edge_cap: int,
    lengths: Optional[np.ndarray] = None,
) -> Tuple:
    """Streamed sharded overlap detection over host-resident reads2
    (:538). Returns (src, dst, ovl, n_edges, overflow): per-shard edge
    slices by source range (v_d = ceil(M / n) reads a shard), sorted
    with INT32_MAX padding, as sharded_find_overlaps returns them (they
    chain into the sharded reduction), and host n_edges and overflow.
    Each slice has the reference's length: ``edge_cap``, or the rows the
    reference gathers when fewer (chunks x n x ``edge_chunk_cap``). With
    ``lengths`` ((M,) per-row, ragged) a sixth output: the host (M,) bool
    containment marks, OR-ed over chunks and owners.

    Each owner joins its entries, in the order they came (chunk by chunk,
    source by source: id order), with a chunk's queries (source by
    source, each source's in K13's key order, so id order within a key):
    the reference's (key, tag | id) order within each key. Capacities:
    ``row_cap`` and ``q_cap`` per (source, owner) and chunk, ``join_cap``
    an owner's candidates a chunk, ``edge_chunk_cap`` per (owner, source
    owner) and chunk, ``edge_cap`` a source owner's edges."""
    n = mesh.size
    M, L = reads2.shape
    s = min(seed_len, min_overlap, 32)
    geo = join_geometry(L, min_overlap, s)
    if M * geo.R >= (1 << 31) - 1:
        raise ValueError(f"global seed rows {M * geo.R} overflow 31-bit ids")
    v_d = -(-M // n)
    rows = _chunk_rows(mesh, chunk_reads, M)
    rows_local = rows // n
    starts = range(0, M, rows)

    def chunk(i):
        reads, cvalid = _pad_chunk(np.asarray(reads2[i : i + rows]), rows)
        cvalid[: min(rows, M - i)] &= np.asarray(valid2[i : i + rows], bool)
        lens = ([None] * n if lengths is None else
                _split_rows(mesh, _chunk_lens(lengths, i, rows), torch.int32))
        return (_shard_reads(mesh, reads), _split_rows(mesh, cvalid,
                                                       torch.bool), lens)

    overflow = False
    # --- (A) each chunk's entry rows, kept by their seed owners
    entries: List[List[torch.Tensor]] = [[] for _ in range(n)]
    for i in starts:
        watchdog.touch(f"sharded chunk {i}")
        with comm.label("sharded_overlap_entry_chunked"):
            recv, ovf = _routed_seed_rows(mesh, *chunk(i), i, rows_local,
                                          "entries", s, geo, row_cap)
        overflow |= ovf
        for d in range(n):
            entries[d].append(recv[d])
        del recv
    entries = [torch.cat(p) if len(p) > 1 else p[0] for p in entries]
    # --- (B) each chunk's queries joined at the owners, edges routed on
    marks = [None if lengths is None else torch.zeros(
        M, dtype=torch.uint8, device=mesh.device_of(d)) for d in range(n)]
    edges: List[List[torch.Tensor]] = [[] for _ in range(n)]
    for i in starts:
        watchdog.touch(f"sharded chunk {i}")
        with comm.label("sharded_overlap_query_chunked"):
            recv, ovf = _routed_seed_rows(mesh, *chunk(i), i, rows_local,
                                          "queries", s, geo, q_cap)
            overflow |= ovf
            routes = []
            for d in range(n):
                parts = [entries[d], recv[d]]
                recv[d] = None
                route, total = _owner_join(parts, geo, M, L, min_overlap,
                                           join_cap, marks[d], n, v_d,
                                           edge_chunk_cap)
                overflow |= total > join_cap
                routes.append(route)
            recv = _exchange(mesh, routes)
            overflow |= any(rt.overflow for rt in routes)
            del routes
        for d in range(n):
            edges[d].append(recv[d])
        del recv
    del entries
    # --- (C) each source owner's merge of the edges it gathered
    with comm.label("sharded_overlap_merge"):
        gathered = [torch.cat(p) for p in edges]
        del edges
        src, dst, ovl, n_local, ovf = _merge_edges(
            gathered, M, L, v_d, edge_cap,
            min(edge_cap, len(starts) * n * edge_chunk_cap))
        overflow |= ovf
        n_edges = comm.psum(n_local)
        if lengths is None:
            return src, dst, ovl, n_edges, overflow
        contained = comm.psum([c.to(torch.int32) for c in marks]) > 0
    return src, dst, ovl, n_edges, overflow, contained.cpu().numpy()
