"""Streamed stages for inputs beyond device memory (port of
sage2_tpu/stream.py: the single-device path for fixed-length reads).

Reads stay on the host (numpy arrays, or spill memmaps) and go to the
device one chunk at a time; per-chunk partial results merge through the
same sort and run accounting as the in-core stages, so every result is
bit-identical to the in-core one (the reference proves it,
tests/test_stream.py; the port's tests hold both to sage2_tpu).

  count_kmers_chunked    K1 keys, sort, K11 runs per chunk; K11 merges
  correct_reads_chunked  a chunked recount per round, then each chunk
                         corrected against the global table (K1 + K2, or
                         K5 for the voting rule)
  prepare_reads_chunked  K8 canonical words per chunk; the dedup sort and
                         the representative rows on the host
  find_overlaps_chunked  the streamed join: K9 builds the entry side
                         (bucket table + slab) once, or once per entry
                         block; K10 probes, expands and verifies each
                         query chunk; the longest overlap per pair is
                         kept per chunk

Ragged reads (``lengths``) are not streamed yet (ROADMAP Queue 1 item
17).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from sage2_tpu_torch import kernels
from sage2_tpu_torch.kmer.correct import (
    correct_reads,
    prune_table_for_correction,
    twophase_round,
)
from sage2_tpu_torch.kmer.count import KmerTable, count_from_keys
from sage2_tpu_torch.ops import bitpack
from sage2_tpu_torch.ops.sort import I32_MAX
from sage2_tpu_torch.overlap import detect
from sage2_tpu_torch.utils import watchdog
from sage2_tpu_torch.utils.device import resolve_device

# Block-nested entry chunking: when the global seed slab and its
# M * g-row sort would not fit the device, the entry side streams too.
# It engages above _BLOCK_ENGAGE_ROWS seed rows; each block holds about
# _BLOCK_TARGET_ROWS rows (the reference's constants, :113-114).
_BLOCK_ENGAGE_ROWS = 48 * 1024 * 1024
_BLOCK_TARGET_ROWS = 24 * 1024 * 1024

# edge lists written to a spill store are padded to a multiple of this
# with (INT32_MAX, INT32_MAX, 0) rows, as the in-RAM pipeline pads them
_EDGE_GRAIN = 1 << 14


def _rows(rows: np.ndarray, dev: torch.device) -> torch.Tensor:
    """(n, L) int32 codes on ``dev`` of host rows (any integer type, a
    memmap window included); they travel as int8."""
    return torch.from_numpy(np.array(rows, dtype=np.int8)).to(dev).to(
        torch.int32)


def _merge_tables(tables: List[KmerTable], k: int) -> KmerTable:
    """Merge sorted count tables: concatenate, sort the keys carrying
    their counts, add the counts of equal keys (kernel K11)."""
    keys = torch.cat([t.keys for t in tables])
    counts = torch.cat([t.count for t in tables])
    s_keys, order = torch.sort(keys)
    uniq, sums = kernels.merge_runs(s_keys, counts[order])
    return KmerTable(uniq, sums, uniq.shape[0], k)


def _compact(table: KmerTable) -> KmerTable:
    """The reference trims a table's padding to the next power of two
    above n_unique (:96); the port's KmerTable holds its n_unique rows
    and no padding, so there is nothing to trim."""
    return table


def count_kmers_chunked(reads: np.ndarray, k: int, chunk_reads: int,
                        device="cuda") -> KmerTable:
    """Exact canonical k-mer counting over host-resident (N, L) reads,
    sent to ``device`` in chunks of ``chunk_reads``: device memory holds
    one chunk's keys plus the merged table of unique keys. The table is
    count_kmers' on all reads at once."""
    if not 1 < k <= 31:
        raise ValueError(f"k must be in (1, 31], got {k}")
    dev = resolve_device(device)
    N = reads.shape[0]
    table: Optional[KmerTable] = None
    for i in range(0, N, chunk_reads):
        watchdog.touch(f"count chunk {i}/{N}")
        _, _, canon = bitpack.kmer_keys(_rows(reads[i : i + chunk_reads],
                                              dev), k)
        part = _compact(count_from_keys(canon.reshape(-1), k))
        table = part if table is None else _compact(
            _merge_tables([table, part], k))
    assert table is not None, "no reads"
    return table


def correct_reads_chunked(
    reads: np.ndarray,
    k: int,
    threshold: int,
    rounds: int,
    chunk_reads: int,
    rule: str = "single_window",
    out: Optional[np.ndarray] = None,
    device="cuda",
) -> np.ndarray:
    """Spectrum correction streamed in chunks; kmer.correct_reads'
    result exactly. Each round recounts over all reads (chunked), then
    corrects each chunk against that round's global table: a read's
    verdicts depend only on the table and the read itself.

    ``rule="single_window"`` runs the two-phase round (K1 + K2) against
    the table pruned once per round; ``"vote_all_windows"`` one voting
    round a chunk (K5). ``out``: an optional (N, L) int8 destination
    (a spill memmap) written chunk by chunk, so host RAM stays
    O(chunk); returned in place of a new array.
    """
    if rule not in ("single_window", "vote_all_windows"):
        raise ValueError(f"unknown correction rule {rule!r}")
    dev = resolve_device(device)
    N = reads.shape[0]
    if out is None:
        out = np.array(reads, dtype=np.int8, copy=True)
    else:
        if out.shape != reads.shape or out.dtype != np.int8:
            raise ValueError(f"out must be {reads.shape} int8, got "
                             f"{out.shape} {out.dtype}")
        for i in range(0, N, chunk_reads):
            out[i : i + chunk_reads] = reads[i : i + chunk_reads]
    for _ in range(rounds):
        table = count_kmers_chunked(out, k, chunk_reads, dev)
        pruned = (prune_table_for_correction(table, threshold)
                  if rule == "single_window" else None)
        for i in range(0, N, chunk_reads):
            watchdog.touch(f"correct chunk {i}/{N}")
            chunk = _rows(out[i : i + chunk_reads], dev)
            if pruned is not None:
                corrected = twophase_round(chunk, pruned, k, threshold)
            else:
                corrected = correct_reads(chunk, k, threshold, rounds=1,
                                          table=table, rule=rule)
            out[i : i + chunk_reads] = corrected.to(torch.int8).cpu().numpy()
    return out


def prepare_reads_chunked(reads: np.ndarray, chunk_reads: int, store=None,
                          device="cuda") -> Tuple:
    """Read dedup and RC augmentation for read sets beyond device
    memory: prepare_reads' layout exactly (the same stable sort of the
    canonical words, head-of-group representative, vertex numbering).
    Only the canonical words are computed on the device, per chunk (K8);
    the dedup sort runs on the host. ``store`` (utils.spill.SpillStore):
    reads2 becomes its ``reads2`` memmap.

    Returns host arrays (reads2 int8 (2N, L), valid2, multiplicity,
    n_unique, vertex_of_read, lengths2); lengths2 is None, as for every
    fixed-length input.
    """
    dev = resolve_device(device)
    N, L = reads.shape
    canon_w_parts, take_rc_parts = [], []
    for i in range(0, N, chunk_reads):
        watchdog.touch(f"dedup chunk {i}/{N}")
        _, fwd_w, rc_w, take_rc = kernels.canonical_reads(
            _rows(reads[i : i + chunk_reads], dev))
        canon_w_parts.append(
            torch.where(take_rc[:, None], rc_w, fwd_w).cpu().numpy())
        take_rc_parts.append(take_rc.cpu().numpy())
    canon_w = np.concatenate(canon_w_parts)
    take_rc = np.concatenate(take_rc_parts)
    W = canon_w.shape[1]

    # stable host sort on the canonical words, major word first
    order = np.lexsort(tuple(canon_w[:, j] for j in range(W - 1, -1, -1)))
    s_keys = canon_w[order]
    neq = np.ones(N, bool)
    neq[1:] = (s_keys[1:] != s_keys[:-1]).any(axis=1)
    group_id = np.cumsum(neq) - 1
    n_unique = int(group_id[-1] + 1)

    rep = np.zeros(n_unique, np.int64)
    rep[group_id[neq]] = order[neq]
    mult = np.bincount(group_id, minlength=n_unique).astype(np.int32)
    gid_in = np.empty(N, np.int32)
    gid_in[order] = group_id.astype(np.int32)
    vertex_of_read = gid_in + np.where(take_rc, N, 0).astype(np.int32)

    reads2 = (store.empty("reads2", np.int8, (2 * N, L)) if store is not None
              else np.zeros((2 * N, L), np.int8))
    # the representative rows, gathered and oriented in windows so host
    # RAM stays O(chunk) when reads and reads2 are memmaps
    for w0 in range(0, n_unique, chunk_reads):
        rw = rep[w0 : w0 + chunk_reads]
        u = np.asarray(reads[rw], np.int8)
        f = take_rc[rw]
        u[f] = (3 - u[f])[:, ::-1]
        reads2[w0 : w0 + rw.shape[0]] = u
        reads2[N + w0 : N + w0 + rw.shape[0]] = (3 - u)[:, ::-1]
    valid2 = np.zeros(2 * N, bool)
    valid2[:n_unique] = True
    valid2[N : N + n_unique] = True
    mult2 = np.zeros(2 * N, np.int32)
    mult2[:n_unique] = mult
    mult2[N : N + n_unique] = mult
    return reads2, valid2, mult2, n_unique, vertex_of_read, None


def _words(rows: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Unshifted packed words (n, ceil(L / 16)) int64 of host rows."""
    return bitpack.pack_read_words(_rows(rows, dev))


def _chunk_edges(ok, cand_a, cand_b, cand_ovl, L: int, M: int):
    """The longest overlap per (src, dst) of one chunk's candidates (of
    M vertices), as host arrays in (src, dst) order."""
    src, dst, ovl, n_keep = detect.reduce_edge_candidates(
        ok, cand_a, cand_b, cand_ovl, L, M)
    return tuple(a[:n_keep].cpu().numpy() for a in (src, dst, ovl))


def _edge_writers(store, names):
    return [store.writer(n, np.int32) for n in names]


def _close_padded(writers, n_edges: int):
    """Close the three edge writers, padded to the edge grain with the
    sentinel rows."""
    pad_to = max(1, -(-n_edges // _EDGE_GRAIN) * _EDGE_GRAIN)
    return (writers[0].close(pad_to=pad_to, fill=I32_MAX),
            writers[1].close(pad_to=pad_to, fill=I32_MAX),
            writers[2].close(pad_to=pad_to, fill=0))


def _overflow(writers):
    """The result of a pass stopped by a chunk over its capacity (fail
    fast: the pass is doomed, and a retry starts over); its spill
    writers are aborted, so no spill file is left."""
    for w in writers:
        w.abort()
    empty = np.zeros(0, np.int32)
    return empty, empty, empty, 0, True


def _concat(parts):
    if not parts:
        empty = np.zeros(0, np.int32)
        return empty, empty, empty
    return tuple(np.concatenate([p[j] for p in parts]) for j in range(3))


def find_overlaps_chunked(
    reads2: np.ndarray,
    valid2: np.ndarray,
    min_overlap: int,
    chunk_reads: int,
    seed_len: int = 32,
    capacity_per_chunk: int = 1 << 20,
    stride: Optional[int] = None,
    store=None,
    entry_block_reads: Optional[int] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, bool]:
    """Streamed strided overlap detection for read sets beyond device
    memory; overlap.find_overlaps' edges and order exactly.

    Device residency: the seed table's slab (g entry rows a read, W + 1
    int32 words each), the 2^B-bucket table, every read's unshifted
    words, and one query chunk's candidates. Every candidate (a, b)
    comes from a's probes, which all lie in a's chunk, so the
    longest-per-pair reduction is complete per chunk and the chunks'
    sorted edge lists concatenate into the global sorted list.

    Returns (src, dst, ovl, n_edges, overflow) as host arrays.
    ``capacity_per_chunk``: a chunk with more candidates stops the pass
    at once (overflow True, empty arrays, no spill files left).
    ``store`` (utils.spill.SpillStore): the edges go to its
    ``edges_src``/``edges_dst``/``edges_ovl`` memmaps, padded to a 2^14
    grain with (INT32_MAX, INT32_MAX, 0), instead of RAM.
    ``entry_block_reads``: stream the entry side too, in blocks of this
    many reads (block-nested join); None engages it above
    _BLOCK_ENGAGE_ROWS seed rows; a value >= the read count forces the
    single table.
    """
    dev = resolve_device(device)
    M, L = reads2.shape
    s = min(seed_len, min_overlap, 32)
    pa = L - min_overlap
    g = detect.auto_stride(min_overlap, s, pa) if stride is None else stride
    n_pos = -(-pa // g)

    if entry_block_reads is None and M * g > _BLOCK_ENGAGE_ROWS:
        entry_block_reads = max(chunk_reads, _BLOCK_TARGET_ROWS // g)
    if entry_block_reads is not None and entry_block_reads < M:
        return _find_overlaps_chunked_blocked(
            reads2, valid2, chunk_reads, s, g, n_pos, pa,
            capacity_per_chunk, store, entry_block_reads, dev,
        )
    if M * g >= 1 << 31:
        # entry ids pack as (invalid-bit | id) in one 32-bit word
        raise ValueError(f"seed table too large: {M * g} entries >= 2^31")
    assert M, "no reads"

    # --- entry side: every read's words, one table (K9) ----------------
    parts = []
    for i in range(0, M, chunk_reads):
        watchdog.touch(f"overlap seed chunk {i}/{M}")
        parts.append(_words(reads2[i : i + chunk_reads], dev))
    words0 = torch.cat(parts)
    del parts
    valid = torch.from_numpy(np.asarray(valid2, bool)).to(dev)
    B = detect._pick_bucket_bits(M * g, M * n_pos, 2 * s, None)
    table, slab = kernels.seed_table(words0, valid, L, s, g, B, 0)

    # --- query side: per chunk probe + expand + verify (K10), reduce ---
    writers = (_edge_writers(store, ("edges_src", "edges_dst", "edges_ovl"))
               if store is not None else None)
    chunks_out = []
    n_edges = 0
    for i in range(0, M, chunk_reads):
        watchdog.touch(f"overlap probe chunk {i}/{M}")
        ok, ca, cb, ovl, n_cand = kernels.probe_join(
            words0[i : i + chunk_reads], valid[i : i + chunk_reads], table,
            slab, L, s, g, pa, i, capacity_per_chunk)
        if n_cand > capacity_per_chunk:
            return _overflow(writers or [])
        part = _chunk_edges(ok, ca, cb, ovl, L, M)
        del ok, ca, cb, ovl
        n_edges += part[0].shape[0]
        if writers is not None:
            for w, a in zip(writers, part):
                w.append(a)
        else:
            chunks_out.append(part)
    if writers is not None:
        return (*_close_padded(writers, n_edges), n_edges, False)
    return (*_concat(chunks_out), n_edges, False)


def _find_overlaps_chunked_blocked(
    reads2: np.ndarray,
    valid2: np.ndarray,
    chunk_reads: int,
    s: int,
    g: int,
    n_pos: int,
    pa: int,
    capacity_per_chunk: int,
    store,
    entry_block_reads: int,
    dev: torch.device,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, bool]:
    """Block-nested streamed join: the entry side is built for blocks of
    ``entry_block_reads`` reads (K9), and every query chunk probes every
    block (K10), so device residency is O(block + chunk).

    All of read b's entry seeds lie in b's block, so the longest-per-pair
    reduction is complete per (chunk, block) and pairs are disjoint
    across blocks. Each chunk's per-block fragments (each (src, dst)
    sorted) merge with one lexsort; chunks concatenate in ascending read
    order into the single-table path's list. With a store the fragments
    go to transient ``efrag<chunk>_*`` spill files.
    """
    M, L = reads2.shape
    EB = entry_block_reads
    if M * g >= 1 << 31:
        raise ValueError(f"seed table too large: {M * g} entries >= 2^31")
    n_chunks = -(-M // chunk_reads)
    # one bucket count for every block (the reference's constant geometry)
    B = detect._pick_bucket_bits(EB * g, min(M, chunk_reads) * n_pos, 2 * s,
                                 None)
    if store is not None:
        frag_writers = [_edge_writers(store, [f"efrag{c}_{n}" for n in
                                              ("src", "dst", "ovl")])
                        for c in range(n_chunks)]
        frags = None
    else:
        frags = [[] for _ in range(n_chunks)]
        frag_writers = None

    valid = torch.from_numpy(np.asarray(valid2, bool)).to(dev)
    for b0 in range(0, M, EB):
        watchdog.touch(f"overlap entry block {b0}/{M}")
        table, slab = kernels.seed_table(
            _words(reads2[b0 : b0 + EB], dev), valid[b0 : b0 + EB], L, s, g,
            B, b0)
        for ci, i in enumerate(range(0, M, chunk_reads)):
            watchdog.touch(f"overlap block {b0} probe chunk {i}/{M}")
            ok, ca, cb, ovl, n_cand = kernels.probe_join(
                _words(reads2[i : i + chunk_reads], dev),
                valid[i : i + chunk_reads], table, slab, L, s, g, pa, i,
                capacity_per_chunk)
            if n_cand > capacity_per_chunk:
                return _overflow([w for ws in frag_writers or [] for w in ws])
            part = _chunk_edges(ok, ca, cb, ovl, L, M)
            del ok, ca, cb, ovl
            if frag_writers is not None:
                for w, a in zip(frag_writers[ci], part):
                    w.append(a)
            else:
                frags[ci].append(part)
        del table, slab

    # per chunk, the fragments sort by (src, dst) (pairs are unique
    # across blocks, so the order is total); chunks concatenate. One
    # stable argsort of the int64 key src << 32 | dst gives
    # lexsort((dst, src))'s order at a fraction of its time.
    writers = (_edge_writers(store, ("edges_src", "edges_dst", "edges_ovl"))
               if store is not None else None)
    chunks_out = []
    n_edges = 0
    for ci in range(n_chunks):
        if frag_writers is not None:
            src_c, dst_c, ovl_c = (np.asarray(w.close())
                                   for w in frag_writers[ci])
        else:
            src_c, dst_c, ovl_c = _concat(frags[ci])
        order = np.argsort((src_c.astype(np.int64) << 32) | dst_c,
                           kind="stable")
        part = (src_c[order], dst_c[order], ovl_c[order])
        n_edges += part[0].shape[0]
        if writers is not None:
            for w, a in zip(writers, part):
                w.append(a)
            for n in ("src", "dst", "ovl"):
                store.remove(f"efrag{ci}_{n}")
        else:
            chunks_out.append(part)
    if writers is not None:
        return (*_close_padded(writers, n_edges), n_edges, False)
    return (*_concat(chunks_out), n_edges, False)
