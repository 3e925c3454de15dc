"""Streamed stages for inputs beyond device memory (port of
sage2_tpu/stream.py: the single-device path, fixed-length and ragged
reads).

Reads stay on the host (numpy arrays, or spill memmaps) and go to the
device one chunk at a time; per-chunk partial results merge through the
same sort and run accounting as the in-core stages, so every result is
bit-identical to the in-core one (the reference proves it,
tests/test_stream.py; the port's tests hold both to sage2_tpu).

  count_kmers_chunked    K1 keys, sort, K11 runs per chunk; K11 merges
  correct_reads_chunked  a chunked recount per round, then each chunk
                         corrected against the global table (K15 prunes
                         it, K16 + K17 correct; or K5 for the voting rule)
  prepare_reads_chunked  K8 canonical words per chunk; the dedup sort and
                         the representative rows on the host
  find_overlaps_chunked  the streamed join: K9 builds the entry side
                         (bucket table + slab) once, or once per entry
                         block; K10 probes, expands and verifies each
                         query chunk; the longest overlap per pair is
                         kept per chunk
  find_overlaps_chunked_ragged
                         the streamed join of ragged reads: K13 builds
                         each chunk's entry rows into a slab (once, or
                         per entry block) and each query chunk's query
                         rows, K3 joins [slab + chunk] with lengths and
                         containment marks, K14 keeps the longest
                         overlap per pair
  compact_pad_edges_spill
                         the containment filter and padding of a spilled
                         raw edge list, on the host in windows

Ragged reads (``lengths``): the counts mask the windows past a read's
end, the correctors take the lengths, the dedup keys on the length
first, and the ragged join replaces K9/K10.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sage2_tpu_torch import kernels
from sage2_tpu_torch.kmer.correct import (
    prune_table_for_correction,
    twophase_round,
    voting_round_pruned,
)
from sage2_tpu_torch.kmer.count import (
    KmerTable,
    count_from_keys,
    window_mask,
)
from sage2_tpu_torch.ops import bitpack
from sage2_tpu_torch.ops.sort import I32_MAX
from sage2_tpu_torch.overlap import detect
from sage2_tpu_torch.utils import watchdog
from sage2_tpu_torch.utils.device import resolve_device
from sage2_tpu_torch.utils.metrics import DeviceSplit, mark_part

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


def _lengths(lengths: Optional[np.ndarray], i: int, j: int,
             dev: torch.device) -> Optional[torch.Tensor]:
    """The int32 lengths of reads [i, j) on ``dev``, or None."""
    if lengths is None:
        return None
    return torch.from_numpy(np.asarray(lengths[i:j], np.int32)).to(dev)


def count_kmers_chunked(reads: np.ndarray, k: int, chunk_reads: int,
                        device="cuda",
                        lengths: Optional[np.ndarray] = None) -> KmerTable:
    """Exact canonical k-mer counting over host-resident (N, L) reads,
    sent to ``device`` in chunks of ``chunk_reads``: device memory holds
    one chunk's keys plus the merged table of unique keys. The table is
    count_kmers' on all reads at once. ``lengths``: (N,) per-read lengths
    of ragged reads; windows past a read's end are not counted."""
    if not 1 < k <= 31:
        raise ValueError(f"k must be in (1, 31], got {k}")
    dev = resolve_device(device)
    N, L = reads.shape
    table: Optional[KmerTable] = None
    for i in range(0, N, chunk_reads):
        watchdog.touch(f"count chunk {i}/{N}")
        _, _, canon = bitpack.kmer_keys(_rows(reads[i : i + chunk_reads],
                                              dev), k)
        lens = _lengths(lengths, i, i + chunk_reads, dev)
        valid = (None if lens is None else
                 window_mask(lens, L, k).reshape(-1))
        part = _compact(count_from_keys(canon.reshape(-1), k, valid))
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
    lengths: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Spectrum correction streamed in chunks; kmer.correct_reads'
    result exactly. Each round recounts over all reads (chunked), then
    corrects each chunk against that round's global table: a read's
    verdicts depend only on the table and the read itself.

    ``rule="single_window"`` runs the two-phase round (K16 + K17) a
    chunk, ``"vote_all_windows"`` one voting round a chunk (K5), both
    against the table pruned once per round (K15). ``out``: an optional
    (N, L) int8 destination (a spill memmap) written chunk by chunk, so
    host RAM stays O(chunk); returned in place of a new array.
    ``lengths``: (N,) per-read lengths of ragged reads.
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
    round_fn = (twophase_round if rule == "single_window"
                else voting_round_pruned)
    for _ in range(rounds):
        # one pruned table a round, in the count table's place
        pruned = prune_table_for_correction(
            count_kmers_chunked(out, k, chunk_reads, dev, lengths), threshold)
        for i in range(0, N, chunk_reads):
            watchdog.touch(f"correct chunk {i}/{N}")
            chunk = _rows(out[i : i + chunk_reads], dev)
            lens = _lengths(lengths, i, i + chunk_reads, dev)
            corrected = round_fn(chunk, pruned, k, threshold, lens)
            out[i : i + chunk_reads] = corrected.to(torch.int8).cpu().numpy()
        del pruned          # before the next round's count
    return out


def _revcomp_ragged_np(rows: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Reverse complement of each row's first ``lens`` bases, zero past
    them (sage2_tpu/stream.py:507). The rows of one length l take the
    last l columns of the reversed complement, one slice a length."""
    L = rows.shape[1]
    rev = (3 - rows[:, ::-1]).astype(rows.dtype)
    out = np.zeros_like(rows)
    for n in np.unique(lens):
        sel = np.flatnonzero(lens == n)
        out[sel, :n] = rev[sel, L - n:]
    return out


def prepare_reads_chunked(reads: np.ndarray, chunk_reads: int, store=None,
                          device="cuda",
                          lengths: Optional[np.ndarray] = None,
                          split: Optional[DeviceSplit] = None) -> Tuple:
    """Read dedup and RC augmentation for read sets beyond device
    memory: prepare_reads' layout exactly (the same stable sort of the
    canonical words, head-of-group representative, vertex numbering).
    Only the canonical words are computed on the device, per chunk (K8);
    the dedup sort runs on the host. ``store`` (utils.spill.SpillStore):
    reads2 becomes its ``reads2`` memmap. ``lengths``: (N,) per-read
    lengths of ragged reads: the words take the codes past a read's end
    as 0, the length is the sort's most major key (a read collapses only
    with an equal read of its length), and the representatives are
    zeroed past their length.

    Returns host arrays (reads2 int8 (2N, L), valid2, multiplicity,
    n_unique, vertex_of_read, lengths2); lengths2 (2N,) int32 is None
    for fixed-length reads. ``split``: marks the end of the canonical
    words ("words"), the host sort and grouping ("sort") and the
    representative rows ("rows").
    """
    dev = resolve_device(device)
    N, L = reads.shape
    canon_w_parts, take_rc_parts = [], []
    for i in range(0, N, chunk_reads):
        watchdog.touch(f"dedup chunk {i}/{N}")
        # K8's words alone (words_only): no reverse-complement rows
        _, fwd_w, rc_w, take_rc = kernels.canonical_reads(
            _rows(reads[i : i + chunk_reads], dev),
            _lengths(lengths, i, i + chunk_reads, dev), False, True)
        canon_w_parts.append(
            torch.where(take_rc[:, None], rc_w, fwd_w).cpu().numpy())
        take_rc_parts.append(take_rc.cpu().numpy())
    canon_w = np.concatenate(canon_w_parts)
    take_rc = np.concatenate(take_rc_parts)
    W = canon_w.shape[1]
    mark_part(split, "words")

    # stable host sort on the canonical words, major word first (the
    # length the most major key of ragged reads)
    keys = tuple(canon_w[:, j] for j in range(W - 1, -1, -1))
    if lengths is not None:
        lengths = np.asarray(lengths, np.int32)
        keys += (lengths,)
    order = np.lexsort(keys)
    s_keys = canon_w[order]
    neq = np.ones(N, bool)
    neq[1:] = (s_keys[1:] != s_keys[:-1]).any(axis=1)
    if lengths is not None:
        s_lens = lengths[order]
        neq[1:] |= s_lens[1:] != s_lens[:-1]
    group_id = np.cumsum(neq) - 1
    n_unique = int(group_id[-1] + 1)

    rep = np.zeros(n_unique, np.int64)
    rep[group_id[neq]] = order[neq]
    mult = np.bincount(group_id, minlength=n_unique).astype(np.int32)
    gid_in = np.empty(N, np.int32)
    gid_in[order] = group_id.astype(np.int32)
    vertex_of_read = gid_in + np.where(take_rc, N, 0).astype(np.int32)
    mark_part(split, "sort")

    reads2 = (store.empty("reads2", np.int8, (2 * N, L)) if store is not None
              else np.zeros((2 * N, L), np.int8))
    lens_u = None if lengths is None else lengths[rep]
    # the representative rows, gathered and oriented in windows so host
    # RAM stays O(chunk) when reads and reads2 are memmaps
    for w0 in range(0, n_unique, chunk_reads):
        rw = rep[w0 : w0 + chunk_reads]
        u = np.asarray(reads[rw], np.int8)
        f = take_rc[rw]
        if lens_u is not None:
            # one reverse complement a window: that of the RC of a row
            # zeroed past its length is the row itself
            lu = lens_u[w0 : w0 + chunk_reads]
            fwd = np.where(np.arange(L, dtype=np.int32)[None, :]
                           < lu[:, None], u, 0).astype(np.int8)
            rc = _revcomp_ragged_np(fwd, lu)
            u = np.where(f[:, None], rc, fwd)
            ru = np.where(f[:, None], fwd, rc)
        else:
            u[f] = (3 - u[f])[:, ::-1]
            ru = (3 - u)[:, ::-1]
        reads2[w0 : w0 + rw.shape[0]] = u
        reads2[N + w0 : N + w0 + rw.shape[0]] = ru
    mark_part(split, "rows")
    valid2 = np.zeros(2 * N, bool)
    valid2[:n_unique] = True
    valid2[N : N + n_unique] = True
    mult2 = np.zeros(2 * N, np.int32)
    mult2[:n_unique] = mult
    mult2[N : N + n_unique] = mult
    lengths2 = None
    if lens_u is not None:
        lengths2 = np.zeros(2 * N, np.int32)
        lengths2[:n_unique] = lens_u
        lengths2[N : N + n_unique] = lens_u
    return reads2, valid2, mult2, n_unique, vertex_of_read, lengths2


def _words(rows: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Unshifted packed words (n, ceil(L / 16)) int64 of host rows."""
    return bitpack.pack_read_words(_rows(rows, dev))


def _chunk_edges(ok, cand_a, cand_b, cand_ovl, L: int, M: int, i: int,
                 j: int):
    """The longest overlap per (src, dst) of the candidates of the query
    chunk of reads [i, j) (of M vertices; a candidate's source is its
    query read), as host arrays in (src, dst) order."""
    src, dst, ovl, n_keep = detect.reduce_edge_candidates(
        ok, cand_a, cand_b, cand_ovl, L, M, (i, j))
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
        part = _chunk_edges(ok, ca, cb, ovl, L, M, i,
                            min(i + chunk_reads, M))
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
    frags = _Fragments(n_chunks, store)

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
                return _overflow(frags.spill_writers())
            frags.append(ci, _chunk_edges(ok, ca, cb, ovl, L, M, i,
                                          min(i + chunk_reads, M)))
            del ok, ca, cb, ovl
        del table, slab
    return (*frags.merge(("edges_src", "edges_dst", "edges_ovl"), True),
            False)


class _Fragments:
    """The edge fragments of a block-nested join, by query chunk: one
    (src, dst)-sorted list a (chunk, block), in RAM, or with a store in
    transient ``efrag<chunk>_*`` spill files."""

    def __init__(self, n_chunks: int, store):
        self.n_chunks, self.store = n_chunks, store
        if store is not None:
            self.writers = [_edge_writers(store, [f"efrag{c}_{n}" for n in
                                                  ("src", "dst", "ovl")])
                            for c in range(n_chunks)]
        else:
            self.parts = [[] for _ in range(n_chunks)]

    def append(self, ci: int, part) -> None:
        if self.store is not None:
            for w, a in zip(self.writers[ci], part):
                w.append(a)
        else:
            self.parts[ci].append(part)

    def spill_writers(self) -> list:
        """Every fragment writer, for ``_overflow`` to abort."""
        return ([w for ws in self.writers for w in ws]
                if self.store is not None else [])

    def merge(self, names, padded: bool):
        """(src, dst, ovl, n_edges) of all fragments: per chunk they sort
        by (src, dst) (pairs are unique across blocks, so the order is
        total), and chunks concatenate. One stable argsort of the int64
        key src << 32 | dst gives lexsort((dst, src))'s order at a
        fraction of its time. With a store the result goes to the
        writers ``names``, closed padded to the edge grain or not, and
        the fragment files are removed."""
        store = self.store
        writers = _edge_writers(store, names) if store is not None else None
        chunks_out = []
        n_edges = 0
        for ci in range(self.n_chunks):
            if writers is not None:
                src_c, dst_c, ovl_c = (np.asarray(w.close())
                                       for w in self.writers[ci])
            else:
                src_c, dst_c, ovl_c = _concat(self.parts[ci])
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
        if writers is None:
            return (*_concat(chunks_out), n_edges)
        if padded:
            return (*_close_padded(writers, n_edges), n_edges)
        return (*(w.close() for w in writers), n_edges)


class _Slab(NamedTuple):
    """The live entry seed rows of the reads [base, base + n) of a
    streamed ragged join: their exact seed keys and global row ids, in
    id order (unsorted), and every entry row's payload, (n * g, Wt + 2)
    int32, the row t of read b at (b - base) * g + t."""

    keys: torch.Tensor
    ids: torch.Tensor
    payload: torch.Tensor
    base: int


def _ragged_slab(reads2, valid, lens, b0: int, b1: int, chunk_reads: int,
                 s: int, geo, dev) -> _Slab:
    """Phase A of the streamed ragged join: the entry rows (K13, rows
    "entries", global ids) of reads [b0, b1), streamed in chunks."""
    keys, ids, pays = [], [], []
    for i in range(b0, b1, chunk_reads):
        j = min(i + chunk_reads, b1)
        watchdog.touch(f"ragged entry chunk {i}/{b1}")
        k, r, p = kernels.seed_rows(
            _rows(reads2[i:j], dev), valid[i:j], lens[i:j], s, geo.g,
            geo.n_pos, geo.trim, i, "entries")
        keys.append(k)
        ids.append(r)
        pays.append(p.reshape(-1, geo.Wt + 2))
    return _Slab(torch.cat(keys), torch.cat(ids), torch.cat(pays), b0)


def _ragged_chunk(slab: _Slab, reads2, valid, lens, i: int, chunk_reads: int,
                  s: int, geo, min_overlap: int, capacity: int,
                  contained: torch.Tensor, dev):
    """Phase B for the query chunk of reads [i, i + chunk_reads): K13's
    query rows sorted with the slab's entries, K3 with lengths (marking
    ``contained``, (M,) uint8, in place) and K14. The chunk's edges as
    host arrays in (src, dst) order, or None when its candidates exceed
    ``capacity`` (nothing is written then)."""
    M, L = reads2.shape
    j = min(i + chunk_reads, M)
    s_keys, s_rows, payload = kernels.seed_rows(
        _rows(reads2[i:j], dev), valid[i:j], lens[i:j], s, geo.g, geo.n_pos,
        geo.trim, i, "queries", slab.keys, slab.ids)
    ok, ca, cb, ovl, total = kernels.overlap_join(
        s_keys, s_rows, payload.reshape(-1, geo.Wt + 2), geo.R, geo.g,
        geo.trim, min_overlap, contained,
        lambda n: 0 if n > capacity else n, slab.payload, slab.base, i)
    del s_keys, s_rows, payload
    if total > capacity:
        return None
    return _chunk_edges(ok, ca, cb, ovl, L, M, i, j)


def find_overlaps_chunked_ragged(
    reads2: np.ndarray,
    valid2: np.ndarray,
    lengths2: np.ndarray,
    min_overlap: int,
    chunk_reads: int,
    seed_len: int = 32,
    capacity_per_chunk: int = 1 << 20,
    store=None,
    entry_block_reads: Optional[int] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, np.ndarray, bool]:
    """Streamed overlap detection of ragged reads (the fused-join form,
    sage2_tpu/stream.py:517); overlap.find_overlaps' edges with lengths
    exactly, and its containment marks.

    Phase A streams the reads in chunks and keeps their live ENTRY seed
    rows with global ids, and their payload, in a slab on the device;
    phase B streams them again and joins [slab + the chunk's query rows]
    (K13, K3 with the lengths and containment marks, K14 per chunk). All
    of a read's query rows lie in its own chunk, so each chunk's pairs
    are complete, and its (src, dst)-sorted list is a run of the global
    one.

    Returns (src, dst, ovl, n_edges, contained, overflow): host arrays,
    contained (M,) bool. ``capacity_per_chunk``: a chunk with more
    candidates stops the pass at once (overflow True, empty arrays, the
    marks so far, no spill files left). ``store``: the edges go to its
    ``edges_raw_src``/``_dst``/``_ovl`` memmaps, unpadded (see
    compact_pad_edges_spill). ``entry_block_reads``: stream the entry
    side too, in blocks of this many reads; None engages it above
    _BLOCK_ENGAGE_ROWS entry rows.
    """
    dev = resolve_device(device)
    M, L = reads2.shape
    s = min(seed_len, min_overlap, 32)
    geo = detect.join_geometry(L, min_overlap, s)
    if M * geo.R >= (1 << 31) - 1:
        raise ValueError(f"seed rows {M * geo.R} overflow 31-bit row ids")
    valid = torch.from_numpy(np.asarray(valid2, bool)).to(dev)
    lens = torch.from_numpy(np.asarray(lengths2, np.int32)).to(dev)
    contained = torch.zeros(M, dtype=torch.uint8, device=dev)
    if entry_block_reads is None and M * geo.g > _BLOCK_ENGAGE_ROWS:
        entry_block_reads = max(chunk_reads, _BLOCK_TARGET_ROWS // geo.g)
    if entry_block_reads is not None and entry_block_reads < M:
        return _find_overlaps_chunked_ragged_blocked(
            reads2, s, geo, valid, lens, contained, min_overlap, chunk_reads,
            capacity_per_chunk, store, entry_block_reads, dev)

    slab = _ragged_slab(reads2, valid, lens, 0, M, chunk_reads, s, geo, dev)
    writers = (_edge_writers(store, ("edges_raw_src", "edges_raw_dst",
                                     "edges_raw_ovl"))
               if store is not None else None)
    chunks_out = []
    n_edges = 0
    for i in range(0, M, chunk_reads):
        watchdog.touch(f"ragged query chunk {i}/{M}")
        part = _ragged_chunk(slab, reads2, valid, lens, i, chunk_reads, s,
                             geo, min_overlap, capacity_per_chunk, contained,
                             dev)
        if part is None:
            return _ragged_overflow(writers or [], contained)
        n_edges += part[0].shape[0]
        if writers is not None:
            for w, a in zip(writers, part):
                w.append(a)
        else:
            chunks_out.append(part)
    cont = contained.bool().cpu().numpy()
    if writers is not None:
        return (*(w.close() for w in writers), n_edges, cont, False)
    return (*_concat(chunks_out), n_edges, cont, False)


def _ragged_overflow(writers, contained: torch.Tensor):
    """The result of a ragged pass stopped by a chunk over its capacity:
    empty edges, the marks so far, the writers aborted."""
    out = _overflow(writers)
    return (*out[:4], contained.bool().cpu().numpy(), True)


def _find_overlaps_chunked_ragged_blocked(
    reads2: np.ndarray, s: int, geo, valid: torch.Tensor,
    lens: torch.Tensor, contained: torch.Tensor, min_overlap: int,
    chunk_reads: int, capacity_per_chunk: int, store, entry_block_reads: int,
    dev: torch.device,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, np.ndarray, bool]:
    """Block-nested streamed ragged join (sage2_tpu/stream.py:638): the
    entry slab is built for blocks of ``entry_block_reads`` reads, and
    every query chunk joins every block, so device residency is O(block
    + chunk). All of read b's entry rows lie in b's block, so the
    longest-per-pair reduction is complete per (chunk, block) and pairs
    are disjoint across blocks; containment marks accumulate across
    blocks. Each chunk's per-block fragments (each (src, dst) sorted)
    merge with one stable sort; chunks concatenate in read order into
    the single-slab path's list. With a store the fragments go to
    transient ``efrag<chunk>_*`` spill files and the result to
    ``edges_raw_*``."""
    M = reads2.shape[0]
    EB = entry_block_reads
    frags = _Fragments(-(-M // chunk_reads), store)

    for b0 in range(0, M, EB):
        watchdog.touch(f"ragged entry block {b0}/{M}")
        slab = _ragged_slab(reads2, valid, lens, b0, min(b0 + EB, M),
                            chunk_reads, s, geo, dev)
        for ci, i in enumerate(range(0, M, chunk_reads)):
            watchdog.touch(f"ragged block {b0} query chunk {i}/{M}")
            part = _ragged_chunk(slab, reads2, valid, lens, i, chunk_reads,
                                 s, geo, min_overlap, capacity_per_chunk,
                                 contained, dev)
            if part is None:
                return _ragged_overflow(frags.spill_writers(), contained)
            frags.append(ci, part)
        del slab
    return (*frags.merge(("edges_raw_src", "edges_raw_dst",
                          "edges_raw_ovl"), False),
            contained.bool().cpu().numpy(), False)


def compact_pad_edges_spill(
    store, e_src, e_dst, e_ovl, n_raw: int,
    cont: Optional[np.ndarray] = None, window: int = 1 << 22,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The raw spilled edge list without the edges that touch a vertex of
    the mask ``cont`` (None keeps all), in order, into the store's
    ``edges_src``/``_dst``/``_ovl`` memmaps padded to the 2^14 grain with
    (INT32_MAX, INT32_MAX, 0) (sage2_tpu/stream.py:800); ``window``
    edges at a time, so host RAM stays O(window). Returns (src, dst,
    ovl, n_edges)."""
    writers = _edge_writers(store, ("edges_src", "edges_dst", "edges_ovl"))
    n_out = 0
    for w0 in range(0, n_raw, window):
        s = np.asarray(e_src[w0 : w0 + window])
        d = np.asarray(e_dst[w0 : w0 + window])
        o = np.asarray(e_ovl[w0 : w0 + window])
        if cont is not None:
            keep = ~(cont[s] | cont[d])
            s, d, o = s[keep], d[keep], o[keep]
        n_out += s.shape[0]
        for w, a in zip(writers, (s, d, o)):
            w.append(a)
    return (*_close_padded(writers, n_out), n_out)
