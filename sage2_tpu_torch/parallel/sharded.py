"""Sharded pipeline stages over a device mesh (port of the in-core part
of sage2_tpu/parallel/sharded.py).

Reads are sharded over the mesh (shard d holds rows [d m, (d + 1) m));
the k-mer space is hash-partitioned, so each shard owns a slice of the
global count table; edges live with the owner of their source's range;
and vertex state of the unitig labeling lives cyclically (vertex v on
shard v % n, slot v // n). Every cross-shard movement is a routed
exchange: kernel K19 (``route_rows``) ranks each row within its owner
and writes the accepted rows destination-major, ``comm.all_to_all_rows``
moves them, and answers come back along the same counts, placed at the
asker's inputs by kernel K20 (``route_back``). Capacities are per
(source, destination), as in the reference: rows of rank >= cap are
dropped and flagged, and the caller retries larger. Only the accepted
rows move, not the reference's padded (n, cap) buffers.

Each stage runs its per-shard steps one shard after another (on
``mesh.device_of(d)``), cut at each exchange, so a stage's result is
the reference's shard_map result bit for bit: the owners' results depend
only on the rows they received and their order. The K-mer owners run
the port's count (torch.sort + K11) and lookup (K2); the overlap owners
K3 on their rows sorted by (key, entries first); the reduction K21 and
the labeling K20's deduplicated gathers. The correction takes either
rule (the voting rule's counts come back from the owners to K5's routed
mode) and ragged reads (``lengths``) everywhere: their windows masked in
the count and the verdicts, their overlap join's containment marks OR-ed
over the owners, their reduction's offsets from each shard's own vertex
lengths.

The streamed stages (``sharded_stream``) run the same owners' steps a
chunk at a time: ``_count_owned``, ``_correct_round``, ``_owner_join``
and ``_merge_edges`` serve both.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sage2_tpu_torch import kernels
from sage2_tpu_torch.kmer.count import KmerTable, count_from_keys, window_mask
from sage2_tpu_torch.ops import bitpack
from sage2_tpu_torch.ops.sort import I32_MAX
from sage2_tpu_torch.overlap.detect import join_geometry
from sage2_tpu_torch.parallel import comm
from sage2_tpu_torch.parallel.mesh import Mesh
from sage2_tpu_torch.stream import _close_padded, _edge_writers

def _devices(mesh: Mesh) -> List[torch.device]:
    return [mesh.device_of(d) for d in range(mesh.size)]


def _split_rows(mesh: Mesh, x, dtype: torch.dtype) -> List[torch.Tensor]:
    """Shard d's rows [d m, (d + 1) m) of a global array, on its device."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.from_numpy(a if a.flags.writeable else a.copy())
    n = mesh.size
    if x.shape[0] % n:
        raise ValueError(f"rows ({x.shape[0]}) must divide the mesh size "
                         f"({n})")
    m = x.shape[0] // n
    return [x[d * m:(d + 1) * m].to(mesh.device_of(d), dtype)
            for d in range(n)]


def _shard_list(mesh: Mesh, x, dtype=torch.int32) -> List[torch.Tensor]:
    """Per-shard tensors from a list of them or an (n, ...) array."""
    if isinstance(x, (list, tuple)):
        items = list(x)
    else:
        items = [x[d] for d in range(mesh.size)]
    if len(items) != mesh.size:
        raise ValueError(f"{len(items)} shards for a mesh of {mesh.size}")
    out = []
    for d, t in enumerate(items):
        t = t if isinstance(t, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(t))
        out.append(t.to(mesh.device_of(d), dtype).contiguous())
    return out


def _key_rows(keys: torch.Tensor) -> torch.Tensor:
    """(Q,) int64 keys as (Q, 2) int32 rows, for routing."""
    return keys.contiguous().view(torch.int32).reshape(-1, 2)


def _row_keys(rows: torch.Tensor) -> torch.Tensor:
    """(Q, 2) int32 rows back to (Q,) int64 keys."""
    return rows.contiguous().view(torch.int64).reshape(-1)


def _back(back: torch.Tensor, route: kernels.Route, pos=None, valid=None
          ) -> torch.Tensor:
    """K20's way back of the answers ``back`` to the asker's inputs."""
    return kernels.route_back(back, route.dest, route.rank, route.sent_ok,
                              route.offsets, pos, valid)


def _exchange(mesh: Mesh, routes: Sequence[kernels.Route]
              ) -> List[torch.Tensor]:
    """Each shard's received rows, by source then rank."""
    return comm.all_to_all_rows([r.send for r in routes],
                                [r.counts for r in routes], _devices(mesh))


def _answer(mesh: Mesh, routes: Sequence[kernels.Route],
            answers: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The owners' answer rows (one a received row, in received order)
    back to the askers, where they lie as each asker's send buffer."""
    n = mesh.size
    counts = [[routes[s].counts[d] for s in range(n)] for d in range(n)]
    return comm.all_to_all_rows(answers, counts, _devices(mesh))


# --------------------------------------------------------------------------
# sharded k-mer counting and lookups
# --------------------------------------------------------------------------


def _count_owned(mesh: Mesh, keys: List[torch.Tensor],
                 valid: Optional[List[torch.Tensor]], k: int, cap: int):
    """Route canonical keys to their owners; each owner counts what it
    received (sharded.py:181). Returns (tables, overflow)."""
    n = mesh.size
    routes = [kernels.route_rows(
        _key_rows(keys[d]), n, cap, None, keys[d], False,
        None if valid is None else valid[d], False) for d in range(n)]
    recv = _exchange(mesh, routes)
    overflow = any(r.overflow for r in routes)
    del routes
    tables = []
    for d in range(n):
        tables.append(count_from_keys(_row_keys(recv[d]), k))
        recv[d] = None
    return tables, overflow


def _sharded_lookup(mesh: Mesh, tables: List[KmerTable],
                    queries: Callable[[int], torch.Tensor], cap: int):
    """Counts of each shard's int64 queries (any shape) from the owners'
    tables (sharded.py:193); ``queries(d)`` makes shard d's queries, one
    shard after another, each freed once routed (its send buffer holds
    them), and the send buffers go once exchanged. Returns (counts int32
    per shard, overflow)."""
    n = mesh.size
    shapes, routes = [], []
    for d in range(n):
        q = queries(d)
        shapes.append(q.shape)
        q = q.reshape(-1)
        routes.append(kernels.route_rows(_key_rows(q), n, cap, None, q))
        del q
    recv = _exchange(mesh, routes)
    routes = [rt._replace(send=None) for rt in routes]
    answers = []
    for d in range(n):
        q = _row_keys(recv[d])
        recv[d] = None
        t = tables[d]
        if t.n_unique and q.numel():
            a = kernels.lookup_counts(t.keys, t.count, q)
        else:
            a = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
        answers.append(a.reshape(-1, 1))
    back = _answer(mesh, routes, answers)
    del answers
    overflow = any(rt.overflow for rt in routes)
    counts = []
    for d in range(n):
        counts.append(_back(back[d], routes[d])[:, 0].reshape(shapes[d]))
        back[d] = routes[d] = None
    return counts, overflow


def sharded_count_kmers(mesh: Mesh, reads, k: int, route_cap: int
                        ) -> Tuple[List[KmerTable], bool]:
    """Count canonical k-mers of the (N, L) reads sharded over the mesh
    (N a multiple of its size). Returns (tables, overflow): ``tables[d]``
    holds the keys shard d owns, sorted, with their counts; the tables
    partition the global table."""
    if not 1 < k <= 31:
        raise ValueError(f"k must be in (1, 31], got {k}")
    r = _split_rows(mesh, reads, torch.int32)
    with comm.label("sharded_count_kmers"):
        keys = [bitpack.kmer_keys(x, k)[2].reshape(-1) for x in r]
        return _count_owned(mesh, keys, None, k, route_cap)


def _kmer_valid(v: List[torch.Tensor], lens: Optional[List[torch.Tensor]],
                L: int, k: int) -> List[torch.Tensor]:
    """Each shard's flat (rows * P,) flags of the windows to count: its
    read is valid and, for ragged reads, the window lies inside it."""
    P = L - k + 1
    out = []
    for d, x in enumerate(v):
        kv = x[:, None].expand(-1, P)
        if lens is not None:
            kv = kv & window_mask(lens[d], L, k)
        out.append(kv.reshape(-1))
    return out


def _correct_round(mesh: Mesh, r: List[torch.Tensor],
                   tables: List[KmerTable], k: int, threshold: int,
                   query_cap: int, lens: Sequence[Optional[torch.Tensor]],
                   rule: str) -> Tuple[List[torch.Tensor], bool]:
    """One round of the rule on each shard's reads ``r`` against the
    owners' count tables (sharded.py:252-283, sharded_stream.py:249-278).
    Returns (the corrected reads per shard, overflow)."""
    n = mesh.size
    overflow = False
    if rule == "vote_all_windows":
        votes = [torch.zeros(x.shape + (4,), dtype=torch.uint8,
                             device=x.device) for x in r]
        for j in range(k):
            counts, ovf = _sharded_lookup(
                mesh, tables, lambda d: kernels.window_variants(r[d], k, j),
                query_cap)
            overflow |= ovf
            for d in range(n):
                kernels.vote_add(votes[d], counts[d], j, k, threshold,
                                 lens[d])
                counts[d] = None
        return [kernels.vote_apply(r[d], votes[d]) for d in range(n)], overflow
    for which in kernels.plain.WHICH:
        counts, ovf = _sharded_lookup(
            mesh, tables, lambda d: kernels.window_variants(r[d], k, which),
            query_cap)
        overflow |= ovf
        r = [kernels.apply_verdicts(r[d], counts[d], k, which, threshold,
                                    lens[d]) for d in range(n)]
        del counts
    return r, overflow


def sharded_correct_reads(
    mesh: Mesh,
    reads,
    k: int,
    threshold: int,
    rounds: int,
    route_cap: int,
    query_cap: int,
    valid=None,
    lengths=None,
    rule: str = "single_window",
) -> Tuple[torch.Tensor, bool]:
    """Spectrum correction of the (N, L) reads sharded over the mesh: every
    count comes from the hash-partitioned table through routed lookups
    (sharded.py:245). Each round counts the canonical k-mers of the valid
    reads (K1, routed by K19, counted by each owner), then runs its rule:

    * ``single_window``: two sub-passes, the 4 variants of each window's
      last, then first base (K22), their counts looked up at the owners
      (K19, K2, K20), and the verdicts (K22);
    * ``vote_all_windows``: for each window position j the 4 variants of
      base j of every window (K22), their routed counts, and their solid
      verdicts added to the shard's votes (K5's ``vote_add``); after the
      k positions the rule (K5's ``vote_apply``).

    ``lengths`` (N,) for ragged (0-padded) reads: windows past a read's
    end are not counted, do not vote and edit nothing, and bases past it
    stay; every window's variants are still routed, as the reference's
    are, so the overflow flags are the reference's. Returns (reads int32
    on the first shard's device, overflow). The result equals
    kmer.correct_reads with the same rule and lengths."""
    if rule not in ("single_window", "vote_all_windows"):
        raise ValueError(f"unknown correction rule {rule!r}")
    n = mesh.size
    r = _split_rows(mesh, reads, torch.int32)
    if valid is None:
        valid = torch.ones(sum(x.shape[0] for x in r), dtype=torch.bool)
    v = _split_rows(mesh, valid, torch.bool)
    lens = (None if lengths is None
            else _split_rows(mesh, lengths, torch.int32))
    kvalid = _kmer_valid(v, lens, r[0].shape[1], k)
    lens = lens or [None] * n
    overflow = False
    with comm.label("sharded_correct_reads"):
        for _ in range(rounds):
            keys = [bitpack.kmer_keys(x, k)[2].reshape(-1) for x in r]
            tables, ovf = _count_owned(mesh, keys, kvalid, k, route_cap)
            del keys
            overflow |= ovf
            r, ovf = _correct_round(mesh, r, tables, k, threshold,
                                    query_cap, lens, rule)
            overflow |= ovf
            del tables
    dev0 = mesh.device_of(0)
    return torch.cat([x.to(dev0) for x in r]), overflow


# --------------------------------------------------------------------------
# host-side partitions and gathers (numpy)
# --------------------------------------------------------------------------


def partition_edges_by_src(src, dst, ovl, n_vertices: int, ndev: int,
                           pad_multiple: int = 1024):
    """Host partition of a (src, dst)-sorted padded edge list into
    per-shard slices by src range (shard d owns src in [d v_d, (d + 1)
    v_d), v_d = ceil(V / ndev)) (sharded.py:347). Returns int32 (ndev,
    E_d) arrays padded with INT32_MAX / 0, each slice still sorted, and
    v_d."""
    src, dst, ovl = (np.asarray(a) for a in (src, dst, ovl))
    v_d = -(-n_vertices // ndev)
    bounds = np.searchsorted(
        src, np.arange(ndev + 1, dtype=np.int64) * v_d, side="left")
    counts = np.diff(bounds)
    e_d = -(-max(int(counts.max()), 1) // pad_multiple) * pad_multiple
    o_src = np.full((ndev, e_d), I32_MAX, np.int32)
    o_dst = np.full((ndev, e_d), I32_MAX, np.int32)
    o_ovl = np.zeros((ndev, e_d), np.int32)
    for d in range(ndev):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        o_src[d, :hi - lo] = src[lo:hi]
        o_dst[d, :hi - lo] = dst[lo:hi]
        o_ovl[d, :hi - lo] = ovl[lo:hi]
    return o_src, o_dst, o_ovl, v_d


def partition_vertex_range(values, n_vertices: int, ndev: int):
    """Host partition of a (V,) per-vertex array into (ndev, v_d) range
    slices (sharded.py:381)."""
    values = np.asarray(values)
    v_d = -(-n_vertices // ndev)
    return np.pad(
        values[:ndev * v_d],
        (0, ndev * v_d - min(values.shape[0], ndev * v_d)),
    ).reshape(ndev, v_d)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def gather_edge_shards(src_sh, dst_sh, ovl_sh, n_edges):
    """Host concatenation of per-shard edge slices (lists of tensors, or
    (ndev, E_d) arrays) into the globally sorted padded edge list
    (sharded.py:974): shard order is src-range order."""
    src, dst, ovl = (np.concatenate([_host(x).reshape(-1) for x in sh])
                     for sh in (src_sh, dst_sh, ovl_sh))
    keep = src != I32_MAX
    n = int(n_edges)
    out_src = np.full(src.shape[0], I32_MAX, np.int32)
    out_dst = np.full(src.shape[0], I32_MAX, np.int32)
    out_ovl = np.zeros(src.shape[0], np.int32)
    out_src[:n] = src[keep]
    out_dst[:n] = dst[keep]
    out_ovl[:n] = ovl[keep]
    return out_src, out_dst, out_ovl


def gather_edge_shards_spill(store, src_sh, dst_sh, ovl_sh, n_edges):
    """gather_edge_shards into the spill store's ``edges_src``/``_dst``/
    ``_ovl`` memmaps, one shard at a time, so host memory stays
    O(shard) (sharded.py:996): each shard's live edges appended in shard
    order (src-range order), their total asserted equal to ``n_edges``,
    padded to the streamed edge lists' 2^14 grain with (INT32_MAX,
    INT32_MAX, 0). Returns the three memmaps."""
    writers = _edge_writers(store, ("edges_src", "edges_dst", "edges_ovl"))
    total = 0
    for d in range(len(src_sh)):
        src = _host(src_sh[d]).reshape(-1)
        keep = src != I32_MAX
        writers[0].append(src[keep])
        writers[1].append(_host(dst_sh[d]).reshape(-1)[keep])
        writers[2].append(_host(ovl_sh[d]).reshape(-1)[keep])
        total += int(keep.sum())
    assert total == int(n_edges), (total, int(n_edges))
    return _close_padded(writers, total)


def gather_cyclic_shards(shards, n_vertices: int) -> np.ndarray:
    """Host reassembly of cyclic vertex slices (a list of (v_d,) tensors,
    or an (ndev, v_d) array) into the global (V,) array: global[v] =
    shard[v % ndev][v // ndev] (sharded.py:806)."""
    arr = np.stack([_host(x) for x in shards])
    return np.ascontiguousarray(arr.T).reshape(-1)[:n_vertices]


# --------------------------------------------------------------------------
# sharded overlap detection
# --------------------------------------------------------------------------


def sharded_find_overlaps(
    mesh: Mesh,
    reads2,
    valid2,
    min_overlap: int,
    seed_len: int,
    row_cap: int,
    join_cap: int,
    edge_cap: Optional[int] = None,
    lengths=None,
):
    """Overlap detection with the reads sharded over the mesh
    (sharded.py:821): each shard builds the seed rows of its reads with
    global ids (K13), one routed exchange (K19) sends each live row, its
    id and payload to the owner of its seed hash, and each owner joins
    the rows it received (sorted by key, entries before queries: K3 with
    the sort's payload permutation), keeps the longest overlap per pair
    (K14), and routes each edge to the owner of its source's read range
    (K19), which merges and deduplicates them (K14).

    Returns (src, dst, ovl, n_edges, overflow): per-shard (edge_cap,)
    int32 edge slices, shard d's holding the edges whose src lies in its
    read range, sorted with INT32_MAX padding (gather_edge_shards
    concatenates them into find_overlaps' edge list), and host
    n_edges and overflow. With ``lengths`` ((M,) per-read lengths of
    ragged reads: K13's rows live only inside their read, K3 verifies
    against each row's own length) a sixth output: the (M,) bool
    containment marks on the first shard's device, read b marked where
    some owner verified a pair that holds it whole (each owner's K3
    marks its (M,) array; their int32 sum over the shards, > 0, is the
    reference's psum, sharded.py:957-966)."""
    n = mesh.size
    r2 = _split_rows(mesh, reads2, torch.int32)
    v2 = _split_rows(mesh, valid2, torch.bool)
    lens2 = (None if lengths is None
             else _split_rows(mesh, lengths, torch.int32))
    M, L = sum(x.shape[0] for x in r2), r2[0].shape[1]
    m_local = M // n
    s = min(seed_len, min_overlap, 32)
    if edge_cap is None:
        edge_cap = join_cap
    geo = join_geometry(L, min_overlap, s)
    if M * geo.R >= (1 << 31) - 1:
        raise ValueError(f"global seed rows {M * geo.R} overflow 31-bit ids")
    with comm.label("sharded_find_overlaps"):
        # --- each shard's live seed rows, global ids, to the seed owners
        recv, overflow = _routed_seed_rows(
            mesh, r2, v2, lens2 or [None] * n, 0, m_local, "all", s, geo,
            row_cap)
        # --- each owner's join, and its edges to their source's owner
        routes, marks = [], []
        for d in range(n):
            cont = None if lens2 is None else torch.zeros(
                M, dtype=torch.uint8, device=mesh.device_of(d))
            parts = [recv[d]]
            recv[d] = None
            route, total = _owner_join(parts, geo, M, L, min_overlap,
                                       join_cap, cont, n, m_local, edge_cap)
            marks.append(cont)
            overflow |= total > join_cap
            routes.append(route)
        recv = _exchange(mesh, routes)
        overflow |= any(rt.overflow for rt in routes)
        del routes
        # --- each source owner's merge and dedup
        out_src, out_dst, out_ovl, n_edges, ovf = _merge_edges(
            recv, M, L, m_local, edge_cap, edge_cap)
        overflow |= ovf
        n_edges = comm.psum(n_edges)
        if lens2 is None:
            return out_src, out_dst, out_ovl, n_edges, overflow
        contained = comm.psum([c.to(torch.int32) for c in marks]) > 0
    return out_src, out_dst, out_ovl, n_edges, overflow, contained


def _routed_seed_rows(mesh: Mesh, r, v, lens, base: int, rows_local: int,
                      kind: str, s: int, geo, cap: int):
    """Each shard's live seed rows of one ``kind`` (K13's "all",
    "entries" or "queries", with global ids from ``base + d rows_local``;
    sharded.py:899-916, sharded_stream.py:380-397, :444-461) as [key (2
    words), id, payload] rows, routed to the owners of their seed hashes
    (K19, ``cap`` per destination). Returns (the rows each owner
    received, by source and rank; overflow)."""
    n = mesh.size
    R, g, W2 = geo.R, geo.g, geo.Wt + 2
    # a read's rows of this kind, and the first one's offset t
    per, t0 = {"all": (R, 0), "entries": (g, 0),
               "queries": (geo.n_pos, g)}[kind]
    routes = []
    for d in range(n):
        id_base = base + d * rows_local
        s_keys, s_rows, payload = kernels.seed_rows(
            r[d], v[d], lens[d], s, g, geo.n_pos, geo.trim, id_base, kind)
        ids = s_rows.to(torch.int64)
        local = (torch.div(ids, R, rounding_mode="floor") - id_base) * per \
            + torch.remainder(ids, R) - t0
        rows = torch.cat([_key_rows(s_keys), s_rows[:, None],
                          payload.reshape(-1, W2)[local]], dim=1)
        del payload, local, ids
        routes.append(kernels.route_rows(rows, n, cap, None, s_keys, True,
                                         None, False))
        del rows, s_keys, s_rows
    recv = _exchange(mesh, routes)
    return recv, any(rt.overflow for rt in routes)


def _owner_join(parts: List[torch.Tensor], geo, M: int, L: int,
                min_overlap: int, join_cap: int,
                cont: Optional[torch.Tensor], n: int, v_d: int,
                edge_cap: int) -> Tuple[kernels.Route, int]:
    """One seed owner's join over the rows it holds (sharded.py:925-956,
    sharded_stream.py:462-491): ``parts``, int32 rows [key (2 words),
    global row id, payload], concatenated in the order given; the list is
    emptied, so that the rows are freed once split. The rows go in the
    reference's (key, tag | id) order: entries before queries (stably),
    then a stable key sort, which is that order while each class arrives
    in id order. K3 joins them through the sort's payload permutation
    (``cont``: (M,) uint8 containment marks of ragged reads, set in
    place), K14 keeps the longest overlap per pair, and K19 routes each
    edge to the owner of its source's range of ``v_d`` reads. Returns
    (the edges' one-way route, the join's candidate total)."""
    R, g = geo.R, geo.g
    rows = torch.cat(parts) if len(parts) > 1 else parts[0]
    parts.clear()
    keys = _row_keys(rows[:, :2])
    ids = rows[:, 2].contiguous()
    payload = rows[:, 3:].contiguous()
    del rows
    first = torch.sort(((ids % R) >= g).to(torch.uint8), stable=True).indices
    s_keys, order = torch.sort(keys[first], stable=True)
    perm = first[order]
    del keys, first, order
    ok, a, b, ovl, total = kernels.overlap_join(
        s_keys, ids[perm], payload, R, g, geo.trim, min_overlap, cont,
        join_cap, None, 0, 0, perm)
    del s_keys, perm, payload, ids
    e_src, e_dst, e_ovl, n_e = kernels.longest_edges(ok, a, b, ovl, M, L,
                                                     ok.shape[0])
    del ok, a, b, ovl
    erows = torch.stack([e_src[:n_e], e_dst[:n_e], e_ovl[:n_e]], 1)
    owner = torch.div(erows[:, 0], v_d, rounding_mode="floor").clamp(0, n - 1)
    return kernels.route_rows(erows, n, edge_cap, owner.to(torch.int32),
                              None, False, None, False), total


def _merge_edges(recv: List[torch.Tensor], M: int, L: int, v_d: int,
                 edge_cap: int, out_len: int):
    """Each source owner's merge of the (rows, 3) edges it received (shard
    d: sources in [d v_d, (d + 1) v_d), the last shard's up to M): the
    longest overlap per pair (K14, its buckets over the shard's sources),
    sorted, cut to ``out_len`` rows with INT32_MAX padding
    (sharded.py:972-979, sharded_stream.py:521-533). Returns (src, dst,
    ovl per shard, n_edges per shard, overflow: some shard kept more than
    ``edge_cap``)."""
    out = ([], [], [])
    n_edges, overflow = [], False
    n = len(recv)
    for d in range(n):
        er, recv[d] = recv[d], None
        ones = torch.ones(er.shape[0], dtype=torch.bool, device=er.device)
        lo = max(0, min(d * v_d, M - 1))
        hi = M if d == n - 1 else max(lo + 1, min(M, (d + 1) * v_d))
        *edges, n_local = kernels.longest_edges(
            ones, er[:, 0].contiguous(), er[:, 1].contiguous(),
            er[:, 2].contiguous(), M, L, max(out_len, er.shape[0]),
            (lo, hi))
        del er, ones
        overflow |= n_local > edge_cap
        n_edges.append(n_local)
        for o, x in zip(out, edges):
            o.append(x[:out_len])
    return (*out, n_edges, overflow)


# --------------------------------------------------------------------------
# sharded transitive reduction
# --------------------------------------------------------------------------


def sharded_transitive_reduction(
    mesh: Mesh,
    src_sh,
    dst_sh,
    ovl_sh,
    n_vertices: int,
    read_len: int,
    req_cap: int,
    cand_cap: int,
    lengths_sh=None,
):
    """Myers transitive reduction with the edges sharded by src range
    (sharded.py:394; ``partition_edges_by_src``'s layout, or the overlap
    stage's output), no edge list replicated:

      1. each edge (v, w, sl_vw) with maxsl(v) - sl_vw >= 0 sends the
         request [v, w, sl_vw, maxsl(v) - sl_vw] to owner(w) (K19);
      2. owner(w) finds each request's range of w's local adjacency,
         sorted by (src, sl), with sl_wx <= the bound and expands the
         candidates [v, x, sl_vw + sl_wx] (K21), routed to owner(v)
         (K19);
      3. owner(v) probes each candidate among its (src, dst)-sorted
         edges and marks the edges it removes (K21).

    Each shard builds its vertex row table once (K21's ``reduce_rows``:
    the first row of each of its v_d vertices in the (src, sl) order,
    which the (src, dst) order shares), so that steps 2 and 3 search a
    vertex's run and not the whole shard.

    ``lengths_sh``: ragged reads, (ndev, v_d) per-vertex lengths
    range-partitioned as the edges are (``partition_vertex_range``), or a
    list of (v_d,) tensors: an edge's offset is sl = len(src) - ovl, and
    the probe takes len(v) (:460-466, :524-527); both lengths live with
    the vertex's owner.

    Returns (src, dst, ovl) per-shard slices of the input's lengths,
    sorted with padding at the end, and host (n_edges, n_expansions,
    overflow)."""
    n = mesh.size
    src, dst, ovl = (_shard_list(mesh, x) for x in (src_sh, dst_sh, ovl_sh))
    lens = (None if lengths_sh is None
            else _shard_list(mesh, lengths_sh))
    V = n_vertices
    v_d = -(-V // n)
    overflow = False
    n_expansions = []
    with comm.label("sharded_transitive_reduction"):
        # --- local adjacency, maxsl, and the requests to owner(w) -------
        adj, tables, routes, is_edge = [], [], [], []
        for d in range(n):
            e = src[d] != I32_MAX
            local = (src[d].to(torch.int64) - d * v_d)
            if lens is None:
                src_len = read_len
            else:
                src_len = lens[d][local.clamp(0, v_d - 1)]
            sl = torch.where(e, src_len - ovl[d], I32_MAX)
            ss_key, order = torch.sort(
                (src[d].to(torch.int64) << 32) | sl.to(torch.int64),
                stable=True)
            adj.append((ss_key, dst[d][order].contiguous()))
            tables.append(kernels.reduce_rows(ss_key, d * v_d, v_d))
            seg = torch.where(e, local, v_d)
            maxsl = torch.full((v_d + 1,), -1, dtype=torch.int32,
                               device=src[d].device).scatter_reduce_(
                0, seg, torch.where(e, sl, -1), "amax")[:v_d]
            bound = torch.where(
                e, maxsl[local.clamp(0, max(v_d - 1, 0))] - sl, -1)
            req = torch.stack([src[d], dst[d], sl, bound], 1).to(torch.int32)
            owner = torch.div(dst[d], v_d, rounding_mode="floor").clamp(
                0, n - 1).to(torch.int32)
            routes.append(kernels.route_rows(
                req, n, req_cap, owner, None, False, e & (bound >= 0),
                False))
            is_edge.append(e)
            del sl, order, seg, maxsl, bound, req, owner, local, src_len
        recv = _exchange(mesh, routes)
        overflow |= any(rt.overflow for rt in routes)
        del routes
        # --- owner(w): ranges and candidates, to owner(v) ---------------
        routes = []
        for d in range(n):
            cand, ok, total = kernels.reduce_requests(
                adj[d][0], adj[d][1], recv[d], cand_cap, tables[d], d * v_d)
            recv[d] = adj[d] = None
            overflow |= total > cand_cap
            n_expansions.append(total)
            owner = torch.div(cand[:, 0], v_d, rounding_mode="floor").clamp(
                0, n - 1).to(torch.int32)
            routes.append(kernels.route_rows(
                cand, n, cand_cap, owner, None, False, ok, False))
            del cand, ok, owner
        recv = _exchange(mesh, routes)
        overflow |= any(rt.overflow for rt in routes)
        del routes
        # --- owner(v): probe and removal, the kept edges compacted ------
        out = ([], [], [])
        n_edges = []
        for d in range(n):
            removed = kernels.reduce_probe(
                src[d], dst[d], ovl[d], recv[d],
                read_len if lens is None else lens[d], d * v_d, tables[d])
            recv[d] = tables[d] = None
            keep = is_edge[d] & ~removed
            kept = int(keep.sum())
            n_edges.append(kept)
            E = src[d].shape[0]
            for o, x, fill in zip(out, (src[d], dst[d], ovl[d]),
                                  (I32_MAX, I32_MAX, 0)):
                y = torch.full((E,), fill, dtype=torch.int32,
                               device=x.device)
                y[:kept] = x[keep]
                o.append(y)
        n_edges = comm.psum(n_edges)
        n_expansions = comm.psum(n_expansions)
    return (*out, n_edges, n_expansions, overflow)


# --------------------------------------------------------------------------
# sharded unitig labeling (pointer doubling with routed gathers)
# --------------------------------------------------------------------------


def _dedup_routed_gather(mesh: Mesh, tables: Sequence[Tuple[torch.Tensor,
                                                              ...]],
                         idx: Sequence[torch.Tensor],
                         valid: Optional[Sequence[torch.Tensor]], cap: int):
    """Rows [t[idx] for t in tables] of cyclically partitioned int32
    tables (vertex v on shard v % n, slot v // n) with the requests
    deduplicated on each shard first (sharded.py:575): a torch.sort of
    the requests and K20's heads, the distinct ones routed to their
    owners (K19), the owners' rows (K20 gather), and each request's
    answer from its run head (K20 back). Returns ((Q, K) int32 per
    shard, overflow)."""
    n = mesh.size
    routes, pos = [], []
    for d in range(n):
        key = idx[d] if valid is None else torch.where(valid[d], idx[d],
                                                       I32_MAX)
        s_key, s_ord = torch.sort(key.to(torch.int32), stable=True)
        uniq, pos_of_orig = kernels.dedup_heads(s_key, s_ord)
        del s_key, s_ord, key
        owner = torch.remainder(uniq, n).to(torch.int32)
        routes.append(kernels.route_rows(uniq[:, None], n, cap, owner, None,
                                         False, uniq != I32_MAX))
        pos.append(pos_of_orig)
    recv = _exchange(mesh, routes)
    answers = [kernels.gather_rows(recv[d][:, 0].contiguous(), n,
                                   *tables[d]) for d in range(n)]
    del recv
    back = _answer(mesh, routes, answers)
    del answers
    out = [_back(back[d], routes[d], pos[d],
                 None if valid is None else valid[d]) for d in range(n)]
    return out, any(r.overflow for r in routes)


def sharded_contract_unitigs(mesh: Mesh, src_sh, dst_sh, ovl_sh,
                             n_vertices: int, route_cap: int):
    """Unambiguous-chain labeling (graph.traverse semantics, bit for bit)
    with the vertex state cyclically partitioned (sharded.py:619): the
    edges (sharded by src range) are routed to the owners of src and of
    dst (K19), which count degrees and keep single neighbours; then every
    pointer-doubling step is one deduplicated routed gather (K19, K20),
    as are the chain masks; the chain edges into cycle breakers are
    dissolved at their predecessors' owners (K19).

    Returns ((head, dist, nxt, ovl_next, outdeg, indeg), each a list of
    (v_d,) int32 cyclic slices (gather_cyclic_shards reassembles them),
    overflow)."""
    n = mesh.size
    src, dst, ovl = (_shard_list(mesh, x) for x in (src_sh, dst_sh, ovl_sh))
    V = n_vertices
    v_d = -(-V // n)
    steps = max(1, math.ceil(math.log2(max(V, 2))) + 1)
    overflow = False

    def myslot(v):
        return torch.div(v, n, rounding_mode="floor").clamp(
            0, max(v_d - 1, 0)).to(torch.int64)

    with comm.label("sharded_contract_unitigs"):
        # --- edges to the cyclic owners of src and of dst ---------------
        by_src, by_dst = [], []
        for d in range(n):
            e = src[d] != I32_MAX
            rows = torch.stack([src[d], dst[d], ovl[d]], 1)
            by_src.append(kernels.route_rows(
                rows, n, route_cap, torch.remainder(src[d], n).to(
                    torch.int32), None, False, e, False))
            by_dst.append(kernels.route_rows(
                rows, n, route_cap, torch.remainder(dst[d], n).to(
                    torch.int32), None, False, e, False))
        r_s = _exchange(mesh, by_src)
        r_d = _exchange(mesh, by_dst)
        overflow |= any(r.overflow for r in by_src + by_dst)
        del by_src, by_dst
        outdeg, indeg, succ, succ_ovl, pred, ids = [], [], [], [], [], []
        for d in range(n):
            dev = mesh.device_of(d)
            seg = myslot(r_s[d][:, 0])
            outdeg.append(torch.bincount(seg, minlength=v_d)[:v_d].to(
                torch.int32))
            sc = torch.full((v_d,), -1, dtype=torch.int32, device=dev)
            sc[seg] = r_s[d][:, 1]
            so = torch.zeros((v_d,), dtype=torch.int32, device=dev)
            so[seg] = r_s[d][:, 2]
            succ.append(sc)
            succ_ovl.append(so)
            seg = myslot(r_d[d][:, 1])
            indeg.append(torch.bincount(seg, minlength=v_d)[:v_d].to(
                torch.int32))
            pr = torch.full((v_d,), -1, dtype=torch.int32, device=dev)
            pr[seg] = r_d[d][:, 0]
            pred.append(pr)
            ids.append(d + torch.arange(v_d, dtype=torch.int32,
                                        device=dev) * n)
        del r_s, r_d

        # --- chain masks (two routed gathers) ---------------------------
        at_succ, ovf = _dedup_routed_gather(
            mesh, [(t,) for t in indeg], succ, [x >= 0 for x in succ],
            route_cap)
        overflow |= ovf
        at_pred, ovf = _dedup_routed_gather(
            mesh, [(t,) for t in outdeg], pred, [x >= 0 for x in pred],
            route_cap)
        overflow |= ovf
        nxt, ovl_next, p, pred_c, own = [], [], [], [], []
        for d in range(n):
            chain_out = (outdeg[d] == 1) & (succ[d] >= 0) & (
                at_succ[d][:, 0] == 1)
            nxt.append(torch.where(chain_out, succ[d], -1).to(torch.int32))
            ovl_next.append(torch.where(chain_out, succ_ovl[d], 0).to(
                torch.int32))
            chain_in = (indeg[d] == 1) & (pred[d] >= 0) & (
                at_pred[d][:, 0] == 1)
            own.append(torch.clamp(ids[d], max=V - 1))
            pred_c.append(pred[d].clamp(min=0))
            p.append(torch.where(chain_in & (ids[d] < V), pred_c[d],
                                 own[d]).to(torch.int32))
        del succ, succ_ovl, at_succ, at_pred

        def g1(tbl, index):
            out, o = _dedup_routed_gather(mesh, [(t,) for t in tbl], index,
                                          None, route_cap)
            return [x[:, 0] for x in out], o

        def g2(t1, t2, index):
            out, o = _dedup_routed_gather(
                mesh, [(a, b) for a, b in zip(t1, t2)], index, None,
                route_cap)
            return ([x[:, 0].contiguous() for x in out],
                    [x[:, 1].contiguous() for x in out], o)

        def double(p0):
            ov = False
            for _ in range(steps):
                p0, o = g1(p0, p0)
                ov |= o
            return p0, ov

        def min_prop(p0):
            m, pp, ov = own, p0, False
            for _ in range(steps):
                m_at, pp, o = g2(m, pp, pp)
                m = [torch.minimum(a, b) for a, b in zip(m, m_at)]
                ov |= o
            return m, ov

        pf, ovf = double(p)
        overflow |= ovf
        p_at_pf, ovf = g1(p, pf)
        overflow |= ovf
        m, ovf = min_prop(p)
        overflow |= ovf
        routes = []
        for d in range(n):
            breaker = (p_at_pf[d] != pf[d]) & (m[d] == own[d]) & (
                ids[d] < V)
            p[d] = torch.where(breaker, own[d], p[d])
            # dissolve the chain edge INTO each breaker at its
            # predecessor's owner
            routes.append(kernels.route_rows(
                pred_c[d][:, None].contiguous(), n, route_cap,
                torch.remainder(pred_c[d], n).to(torch.int32), None, False,
                breaker & (pred[d] >= 0), False))
        del pf, p_at_pf, m
        recv = _exchange(mesh, routes)
        overflow |= any(r.overflow for r in routes)
        del routes
        for d in range(n):
            bslot = myslot(recv[d][:, 0])
            nxt[d][bslot] = -1
            ovl_next[d][bslot] = 0
        del recv

        head, ovf = double(p)
        overflow |= ovf
        dist = [(p[d] != own[d]).to(torch.int32) for d in range(n)]
        pp = p
        for _ in range(steps):
            d_at, pp, o = g2(dist, pp, pp)
            dist = [a + b for a, b in zip(dist, d_at)]
            overflow |= o
    return (head, dist, nxt, ovl_next, outdeg, indeg), overflow

