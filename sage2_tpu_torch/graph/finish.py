"""Host-side finishing: unitig-graph cleaning and contig emission.

After device-side reduction and unitig labeling, the condensed unitig
graph is orders of magnitude smaller than the read graph (~#junctions),
so tip removal, bubble popping, and final path joining run on host
(SURVEY.md §3.5: "finalizing ambiguous joins on host"; §2 "Graph
cleaner"). All rules are RC-symmetric, so the double-stranded graph stays
consistent and each contig is emitted once in canonical orientation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from sage2_tpu_torch.config import AssemblyConfig


@dataclasses.dataclass
class Unitig:
    uid: int
    vertices: List[int]          # ordered chain of read-vertices
    ovls: List[int]              # overlap v[i] -> v[i+1], len = len(vertices)-1
    length: int                  # bases
    n_reads: int
    coverage: float              # read-multiplicity bases / length
    copy_count: int = 1          # expected genome multiplicity (cost model)


@dataclasses.dataclass
class UnitigGraph:
    unitigs: Dict[int, Unitig]
    out_edges: Dict[int, List[Tuple[int, int]]]   # uid -> [(uid2, ovl)]
    in_edges: Dict[int, List[Tuple[int, int]]]
    uid_of_head: Dict[int, int]
    uid_of_tail: Dict[int, int]


def build_unitig_graph(
    head: np.ndarray,
    dist: np.ndarray,
    ovl_next: np.ndarray,
    edges: Tuple[np.ndarray, np.ndarray, np.ndarray],
    valid2: np.ndarray,
    multiplicity: np.ndarray,
    read_len,
) -> UnitigGraph:
    """Condense chain labels + reduced edges into the unitig graph.

    ``read_len``: scalar, or a (V,) per-vertex length array for ragged
    reads (unitig length / coverage then use each member's own length).
    """
    V = head.shape[0]
    if isinstance(read_len, int):
        rlen = np.full(V, read_len, np.int64)
    else:
        rlen = np.asarray(read_len, np.int64)
    head = np.asarray(head)
    dist = np.asarray(dist)
    ovl_next = np.asarray(ovl_next, np.int64)
    valid2 = np.asarray(valid2)
    multiplicity = np.asarray(multiplicity, np.int64)
    vids = np.nonzero(valid2)[0]
    order = np.lexsort((dist[vids], head[vids]))
    sv = vids[order]
    n = len(sv)
    unitigs: Dict[int, Unitig] = {}
    uid_of_head: Dict[int, int] = {}
    uid_of_tail: Dict[int, int] = {}
    vert_uid = np.full(V, -1, np.int64)
    if n:
        # group-by head over the (head, dist)-sorted vertex array: each
        # run of equal heads is one unitig chain (vectorized — the
        # per-vertex Python loop dominated finish wall-clock at scale)
        sh = head[sv]
        is_start = np.empty(n, bool)
        is_start[0] = True
        is_start[1:] = sh[1:] != sh[:-1]
        starts = np.flatnonzero(is_start)
        counts = np.diff(np.append(starts, n))
        n_uni = len(starts)
        vert_uid[sv] = np.cumsum(is_start) - 1
        is_last = np.empty(n, bool)
        is_last[:-1] = is_start[1:]
        is_last[-1] = True
        rl = rlen[sv]
        ovl_m = np.where(is_last, 0, ovl_next[sv])
        lengths = np.add.reduceat(rl, starts) - np.add.reduceat(ovl_m, starts)
        mult_sv = multiplicity[sv]
        bases = np.add.reduceat(mult_sv * rl, starts)
        heads_v = sv[starts]
        tails_v = sv[starts + counts - 1]
        sv_l = sv.tolist()
        ovn_l = ovl_next[sv].tolist()
        for uid in range(n_uni):
            s = int(starts[uid])
            e = s + int(counts[uid])
            length = int(lengths[uid])
            unitigs[uid] = Unitig(
                uid, sv_l[s:e], ovn_l[s : e - 1], length, e - s,
                coverage=int(bases[uid]) / max(length, 1),
            )
        uid_of_head = {int(v): u for u, v in enumerate(heads_v)}
        uid_of_tail = {int(v): u for u, v in enumerate(tails_v)}

    out_edges: Dict[int, List[Tuple[int, int]]] = {u: [] for u in unitigs}
    in_edges: Dict[int, List[Tuple[int, int]]] = {u: [] for u in unitigs}
    src, dst, ovl = edges
    src = np.asarray(src)
    dst = np.asarray(dst)
    ovl = np.asarray(ovl)
    # a kept edge joins tail(a) -> head(b) of two chains; chain-interior
    # edges (a not its unitig's tail / b not a head) drop out. Same rule
    # as the original per-edge loop: a edge survives iff a is the tail of
    # its unitig AND b is the head of its unitig (a tail->head self-edge
    # is a cycle edge and survives too).
    if n:
        is_tail_of = np.zeros(V, bool)
        is_tail_of[tails_v] = True
        is_head_of = np.zeros(V, bool)
        is_head_of[heads_v] = True
        m = (src >= 0) & (src < V) & (dst >= 0) & (dst < V)
        m[m] = valid2[src[m]]
        a_k = src[m]
        b_k = dst[m]
        o_k = ovl[m]
        keep = is_tail_of[a_k] & is_head_of[b_k]
        for a, b, o in zip(a_k[keep].tolist(), b_k[keep].tolist(),
                           o_k[keep].tolist()):
            ua, ub = int(vert_uid[a]), int(vert_uid[b])
            out_edges[ua].append((ub, int(o)))
            in_edges[ub].append((ua, int(o)))
    return UnitigGraph(unitigs, out_edges, in_edges, uid_of_head, uid_of_tail)


def rc_vertex(v: int, cap: int) -> int:
    return (v + cap) % (2 * cap)


def twin_uid(g: UnitigGraph, uid: int, cap: int) -> Optional[int]:
    """The unitig representing the reverse complement of ``uid``."""
    tail = g.unitigs[uid].vertices[-1]
    return g.uid_of_head.get(rc_vertex(tail, cap))


def _remove_unitig(g: UnitigGraph, uid: int) -> None:
    for (nb, o) in g.out_edges.pop(uid, []):
        g.in_edges[nb] = [(u, oo) for (u, oo) in g.in_edges[nb] if u != uid]
    for (nb, o) in g.in_edges.pop(uid, []):
        g.out_edges[nb] = [(u, oo) for (u, oo) in g.out_edges[nb] if u != uid]
    u = g.unitigs.pop(uid)
    g.uid_of_head.pop(u.vertices[0], None)
    g.uid_of_tail.pop(u.vertices[-1], None)


def remove_tips(g: UnitigGraph, cap: int, max_reads: int, rounds: int = 4) -> int:
    """Drop short dead-end/dead-start unitigs hanging off the graph.

    RC-symmetric: a dead-end tip's twin is a dead-start tip; both match.
    Isolated unitigs (no edges at all) are never tips.
    """
    removed = 0
    for _ in range(rounds):
        tips = []
        for uid, u in g.unitigs.items():
            if u.n_reads > max_reads:
                continue
            has_out = bool(g.out_edges.get(uid))
            has_in = bool(g.in_edges.get(uid))
            if has_out != has_in:  # dead end xor dead start, attached
                tips.append(uid)
        if not tips:
            break
        for uid in tips:
            if uid in g.unitigs:
                _remove_unitig(g, uid)
                removed += 1
    return removed


def pop_bubbles(
    g: UnitigGraph, cap: int, max_reads: int, ratio: float
) -> int:
    """Pop simple bubbles: parallel single-in/single-out short unitigs
    between the same junction pair; keep the best-supported branch.

    Deterministic and RC-symmetric: the winner is (coverage, then length,
    then canonical-orientation tie-break on the unitig's base sequence
    position — here the minimum vertex id of the pair {min(v0), min(rc
    tie)} which twins share).
    """
    groups: Dict[Tuple[int, int], List[int]] = {}
    for uid, u in g.unitigs.items():
        if u.n_reads > max_reads:
            continue
        if len(g.in_edges.get(uid, [])) == 1 and len(g.out_edges.get(uid, [])) == 1:
            a = g.in_edges[uid][0][0]
            b = g.out_edges[uid][0][0]
            groups.setdefault((a, b), []).append(uid)
    removed = 0
    for (a, b), uids in groups.items():
        # a branch popped with its twin in an earlier group is gone (the
        # reference looks it up here and raises KeyError: ROADMAP
        # Queue 3, "Fixed")
        uids = [uid for uid in uids if uid in g.unitigs]
        if len(uids) < 2:
            continue
        # twin-consistent tie-break key: min over the unitig and its twin
        # of the minimum vertex id (shared by RC pairs)
        def key(uid):
            u = g.unitigs[uid]
            t = twin_uid(g, uid, cap)
            mv = min(u.vertices)
            if t is not None and t in g.unitigs:
                mv = min(mv, min(g.unitigs[t].vertices))
            return (-u.coverage, -u.length, mv)

        uids_sorted = sorted(uids, key=key)
        best = g.unitigs[uids_sorted[0]]
        for uid in uids_sorted[1:]:
            u = g.unitigs.get(uid)
            if u is None:
                continue
            # an error bubble is length-similar AND coverage-weaker than
            # the winner; a genuine near-identical repeat variant carries
            # comparable coverage and must survive, so the length clause
            # is gated on a coverage deficit (never pop equal-coverage
            # parallel branches on length-similarity alone)
            length_similar = abs(u.length - best.length) <= 0.1 * best.length
            cov_weak = u.coverage <= ratio * best.coverage
            cov_below = u.coverage <= 0.75 * best.coverage
            if cov_weak or (length_similar and cov_below):
                t = twin_uid(g, uid, cap)
                _remove_unitig(g, uid)
                removed += 1
                if t is not None and t != uid and t in g.unitigs:
                    _remove_unitig(g, t)
                    removed += 1
    return removed


def estimate_single_copy_coverage(g: UnitigGraph, read_len: int) -> float:
    """Single-copy coverage c1: length-weighted median coverage of long
    unitigs (>= 2 read lengths); falls back to all unitigs.

    This is the anchor of the SAGE cost model (SURVEY.md §2 "Copy-count /
    cost model": expected read multiplicity from coverage) — a unitig's
    expected genome copy number is coverage / c1.
    """
    pool = [u for u in g.unitigs.values() if u.length >= 2 * read_len]
    if not pool:
        pool = list(g.unitigs.values())
    if not pool:
        return 1.0
    pool.sort(key=lambda u: u.coverage)
    total = sum(u.length for u in pool)
    acc = 0
    for u in pool:
        acc += u.length
        if acc * 2 >= total:
            return max(u.coverage, 1e-9)
    return max(pool[-1].coverage, 1e-9)


def annotate_copy_counts(g: UnitigGraph, c1: float) -> None:
    """copy_count(U) = round(coverage / c1); 0 flags likely artifacts."""
    for u in g.unitigs.values():
        u.copy_count = int(round(u.coverage / c1))


def prune_zero_copy_branches(g: UnitigGraph, c1: float,
                             low_frac: float = 0.35,
                             high_frac: float = 0.8) -> int:
    """Cost-model pruning: at a junction, drop a branch edge whose target
    (resp. source) unitig has coverage < low_frac * c1 while a sibling
    branch has >= high_frac * c1 — an expected-copy-count-zero branch
    competing with a real one. Complements sibling-relative dominance
    pruning when all branches are weak-ish or coverage is noisy.
    RC-symmetric (applied to out- and in-junctions alike)."""
    removed = 0
    to_drop = []
    for uid in g.unitigs:
        for edges, forward in ((g.out_edges.get(uid, []), True),
                               (g.in_edges.get(uid, []), False)):
            if len(edges) < 2:
                continue
            covs = [g.unitigs[v].coverage for (v, _o) in edges]
            if max(covs) < high_frac * c1:
                continue
            for (v, _o), c in zip(list(edges), covs):
                if c < low_frac * c1:
                    to_drop.append((uid, v) if forward else (v, uid))
    for a, b in to_drop:
        if any(v == b for (v, _o) in g.out_edges.get(a, [])):
            _remove_edge(g, a, b)
            removed += 1
    return removed


def _remove_edge(g: UnitigGraph, a: int, b: int) -> None:
    g.out_edges[a] = [(v, o) for (v, o) in g.out_edges.get(a, []) if v != b]
    g.in_edges[b] = [(u, o) for (u, o) in g.in_edges.get(b, []) if u != a]


def prune_weak_branches(
    g: UnitigGraph, dominance: float, max_rounds: int = 8
) -> int:
    """Coverage-cost branch resolution (the "mincost" traversal mode).

    The SAGE cost model prefers continuations whose coverage supports
    them (SURVEY.md §2 "Copy-count / cost model"): at a junction, a
    branch whose target coverage is ``dominance`` times weaker than the
    best sibling is an error/chimera artifact — its edge is dropped,
    which re-linearizes junctions the tip pass missed. Applied to both
    out- and in-junctions, so the rule is RC-symmetric (the twin of an
    out-junction is an in-junction with identical coverages).
    """
    removed = 0
    for _ in range(max_rounds):
        to_drop = []
        for uid in g.unitigs:
            for edges, forward in ((g.out_edges.get(uid, []), True),
                                   (g.in_edges.get(uid, []), False)):
                if len(edges) < 2:
                    continue
                covs = [g.unitigs[v].coverage for (v, _o) in edges]
                best = max(covs)
                for (v, _o), c in zip(list(edges), covs):
                    if c * dominance <= best:
                        to_drop.append((uid, v) if forward else (v, uid))
        if not to_drop:
            break
        for a, b in to_drop:
            if any(v == b for (v, _o) in g.out_edges.get(a, [])):
                _remove_edge(g, a, b)
                removed += 1
    return removed


def _pair_key(g: UnitigGraph, uid: int, cap: int) -> int:
    """RC-invariant identity of {uid, twin(uid)}: the minimum vertex id
    across the pair (shared by both orientations of a unitig)."""
    mv = min(g.unitigs[uid].vertices)
    t = twin_uid(g, uid, cap)
    if t is not None and t in g.unitigs:
        mv = min(mv, min(g.unitigs[t].vertices))
    return mv


def greedy_budget_paths(
    g: UnitigGraph, cap: int, only: Optional[Set[int]] = None
) -> List[List[int]]:
    """Round-1 greedy residual-budget walk (fallback traversal).

    Each unitig carries an expected genome multiplicity (copy_count from
    the coverage cost model); a residual copy budget — shared between a
    unitig and its reverse-complement twin so traversal is strand-
    symmetric — limits how often it may be used. Paths start at sources
    (no in-edges), then any unitig with residual budget, and extend
    greedily along the locally-cheapest continuation: the out-neighbor
    with the largest residual budget, ties broken by length then
    RC-invariant id. Superseded as the default by the true min-cost flow
    traversal (graph.flowpaths.mincost_flow_paths) — greedy takes each
    junction locally and misroutes multi-junction repeats — but retained
    for components beyond the flow solver's size bound.

    ``only``: restrict the walk to a subset of unitigs (used for the
    per-component fallback). Deterministic; terminates because every
    step consumes budget.
    """
    member = (lambda u: u in only) if only is not None else (lambda u: True)
    # pair budget = max over both twins' copy_count, so the shared budget
    # is strand-symmetric even if coverage rounding ever disagrees between
    # a unitig and its RC twin (not insertion-order dependent)
    resid: Dict[int, int] = {}
    for uid in g.unitigs:
        if not member(uid):
            continue
        pk = _pair_key(g, uid, cap)
        c = max(1, g.unitigs[uid].copy_count)
        resid[pk] = max(resid.get(pk, 0), c)

    def take(uid: int) -> None:
        resid[_pair_key(g, uid, cap)] -= 1

    def budget(uid: int) -> int:
        return resid.get(_pair_key(g, uid, cap), 0)

    def cost_key(uid: int):
        u = g.unitigs[uid]
        return (-budget(uid), -u.length, _pair_key(g, uid, cap), uid)

    paths: List[List[int]] = []
    used: Set[int] = set()
    src_set = {u for u in g.unitigs
               if member(u) and not g.in_edges.get(u) and g.out_edges.get(u)}
    sources = sorted(src_set)
    everything = sources + [
        u for u in sorted(g.unitigs) if member(u) and u not in src_set
    ]
    for start in everything:
        # non-source starts (cycles, leftover repeat budget) only open a
        # path if never placed — unplaced repeat copies would otherwise
        # emit fragments duplicating already-emitted sequence
        while budget(start) > 0 and (start in src_set or start not in used):
            path = [start]
            take(start)
            used.add(start)
            cur = start
            while True:
                outs = [v for (v, _o) in g.out_edges.get(cur, [])
                        if member(v) and budget(v) > 0]
                if not outs:
                    break
                nxt = min(outs, key=cost_key)
                take(nxt)
                used.add(nxt)
                path.append(nxt)
                cur = nxt
            paths.append(path)
    return paths


def mincost_paths(
    g: UnitigGraph,
    cap: int,
    path_penalty: int = 150,
    flow_max_extra: int = 2,
    flow_max_component: int = 2000,
    stats_out: Dict[str, int] | None = None,
) -> List[List[int]]:
    """True minimum-cost contig traversal (SAGE's namesake step): solves
    a min-cost circulation under the copy-count model and decomposes the
    flow into Euler trails — see graph.flowpaths for the objective and
    the algorithm. Components beyond ``flow_max_component`` condensed
    nodes use greedy_budget_paths (``stats_out`` counts them)."""
    from sage2_tpu_torch.graph.flowpaths import mincost_flow_paths

    return mincost_flow_paths(
        g, cap, path_penalty=path_penalty, max_extra=flow_max_extra,
        max_component=flow_max_component, stats_out=stats_out,
    )


def join_paths(g: UnitigGraph) -> List[List[int]]:
    """Merge unambiguous unitig chains after cleaning; returns paths of
    uids (cycles broken at the minimum uid)."""
    nxt: Dict[int, int] = {}
    for uid in g.unitigs:
        outs = g.out_edges.get(uid, [])
        if len(outs) == 1:
            nb = outs[0][0]
            if len(g.in_edges.get(nb, [])) == 1 and nb != uid:
                nxt[uid] = nb
    prv = {v: u for u, v in nxt.items()}
    paths = []
    seen: Set[int] = set()
    for uid in sorted(g.unitigs):
        if uid in seen or uid in prv:
            continue
        path = [uid]
        seen.add(uid)
        while path[-1] in nxt and nxt[path[-1]] not in seen:
            path.append(nxt[path[-1]])
            seen.add(path[-1])
        paths.append(path)
    for uid in sorted(g.unitigs):  # cycles
        if uid in seen:
            continue
        cyc = [uid]
        seen.add(uid)
        w = nxt.get(uid)
        while w is not None and w not in seen:
            cyc.append(w)
            seen.add(w)
            w = nxt.get(w)
        start = cyc.index(min(cyc))
        paths.append(cyc[start:] + cyc[:start])
    return paths


def path_ovl(g: UnitigGraph, a: int, b: int) -> int:
    for (nb, o) in g.out_edges.get(a, []):
        if nb == b:
            return o
    raise KeyError((a, b))


def emit_contigs(
    g: UnitigGraph,
    paths: List[List[int]],
    reads2: np.ndarray,
    config: AssemblyConfig,
    lengths: Optional[np.ndarray] = None,
) -> List[np.ndarray]:
    """Stitch paths into base sequences; canonical-orientation dedup.

    Each contig appears twice in the double-stranded graph (as its own
    reverse complement); only the lexicographically smaller orientation is
    emitted (SURVEY.md §7: deterministic, reshard-invariant output).
    ``lengths``: per-vertex read lengths for ragged inputs (slices stop
    at each read's own end instead of the padded row width).
    """
    return emit_contigs_with_placements(g, paths, reads2, config, lengths)[0]


def emit_contigs_with_placements(
    g: UnitigGraph,
    paths: List[List[int]],
    reads2: np.ndarray,
    config: AssemblyConfig,
    lengths: Optional[np.ndarray] = None,
) -> Tuple[List[np.ndarray], Dict[int, Tuple[int, int, int]]]:
    """emit_contigs plus per-vertex placements for mate-pair scaffolding.

    Returns (contigs, placements): placements maps a read-vertex to
    (contig_id, start, dir) — contig[start : start + rlen[v]] equals
    reads2[v] when dir=+1 and its reverse complement when dir=-1. Only
    UNIQUELY placed vertices appear (a vertex emitted at two positions —
    a repeat unitig traversed twice by the min-cost flow — is an
    unreliable anchor and is dropped; graph.scaffold consumes this map).
    """
    L = reads2.shape[1]
    if lengths is None:
        rlen = np.full(reads2.shape[0], L, np.int64)
    else:
        rlen = np.asarray(lengths, np.int64)
    reads2_flat = np.ascontiguousarray(reads2).reshape(-1)
    emitted = []  # (canonical seq, [(vertex, start, dir)])
    for path in paths:
        # vectorized stitch: per piece, vertex v contributes
        # reads2[v][o : rlen[v]] at running position (one flat gather for
        # the whole contig — the per-vertex append loop dominated finish
        # wall-clock at scale)
        vs_parts: List[np.ndarray] = []
        os_parts: List[np.ndarray] = []
        prev_tail = None
        for uid in path:
            u = g.unitigs[uid]
            vs_parts.append(np.asarray(u.vertices, np.int64))
            first = (
                0 if prev_tail is None else path_ovl(g, prev_tail, uid)
            )
            os_parts.append(np.concatenate([
                np.asarray([first], np.int64),
                np.asarray(u.ovls, np.int64),
            ]))
            prev_tail = uid
        v = np.concatenate(vs_parts)
        o = np.concatenate(os_parts)
        plen = rlen[v] - o
        T = int(plen.sum())
        if T < config.min_contig_len:
            continue
        starts_piece = np.concatenate([[0], np.cumsum(plen)[:-1]])
        gidx = np.arange(T, dtype=np.int64) - np.repeat(starts_piece, plen)
        src = np.repeat(v * L + o, plen) + gidx
        seq = reads2_flat[src]
        placed = list(zip(v.tolist(), (starts_piece - o).tolist()))
        rc = (3 - seq)[::-1]
        # bytewise comparison == elementwise code comparison (codes 0-3)
        if seq.tobytes() <= rc.tobytes():
            emitted.append((seq, [(v_, s, 1) for v_, s in placed]))
        else:
            n = len(seq)
            emitted.append((
                rc,
                [(v_, n - s - int(rlen[v_]), -1) for v_, s in placed],
            ))
    # dedup identical canonical contigs (each double-stranded path pair)
    uniq: Dict[bytes, Tuple[np.ndarray, list]] = {}
    for c, pl in emitted:
        uniq.setdefault(c.tobytes(), (c, pl))
    ordered = sorted(
        uniq.values(), key=lambda cp: (-len(cp[0]), cp[0].tobytes())
    )
    placements: Dict[int, Tuple[int, int, int]] = {}
    multi: Set[int] = set()
    for cid, (_c, pl) in enumerate(ordered):
        for v, s, d in pl:
            if v in placements or v in multi:
                placements.pop(v, None)
                multi.add(v)
            else:
                placements[v] = (cid, int(s), d)
    return [c for c, _pl in ordered], placements
