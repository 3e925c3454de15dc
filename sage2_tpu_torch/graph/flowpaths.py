"""Minimum-cost-path contig traversal via min-cost circulation.

This is the method's namesake step (SURVEY.md §2 "Copy-count / cost
model" / "Contig traversal", §3.5; SAGE, Ilie et al. 2014 — reference
mount empty, no file:line citation possible, SURVEY.md §0): every unitig
carries an expected genome multiplicity c_u = round(coverage / c1), and
contigs should be the paths of a flow that matches those expectations at
minimum cost, rather than the locally-greedy continuations of round 1.

Formulation (pinned semantics; the brute-force oracle in
``sage2_tpu.refmodel.flow`` (in the reference package) enumerates the same objective):

  minimize   sum_u len_u * |f_u - c_u|  +  path_penalty * (#paths)
  subject to flow conservation at every unitig (in + opened =
             out + terminated), integer flows f_u >= 0 capped at
             c_u + flow_max_extra.

As a circulation network: each unitig (or contracted chain) becomes
unit arcs u_in->u_out with convex marginal costs (-w for the first c_u
units — covering an expected copy removes w of deficit — then +w),
junction edges are free arcs, and a virtual S/T pair with a T->S return
arc closes the circulation; S->u_in arcs charge ``path_penalty`` per
path opened. The optimum is reached by deterministic negative-cycle
canceling (Klein): a feasible circulation is optimal iff its residual
graph has no negative cycle.

Contigs are then the Euler-trail decomposition of the flow multigraph:
each S->T trail is one contig, with Hierholzer cycle-splicing so a
repeat traversed twice (f_u = 2) is walked through BOTH its contexts
(X R Y R Z comes out as one path); leftover balanced cycles (circular
genomes / plasmids) are emitted as cyclic contigs broken at their
minimum unitig id.

Scale: the solver runs on the CONDENSED junction graph (unambiguous
chains contracted to single super-nodes with summed convex costs), per
weakly-connected component. Components beyond
``config.flow_max_component`` condensed nodes fall back to the round-1
greedy residual-budget walk for that component (documented bound; the
condensed graph of a cleaned bacterial assembly is orders of magnitude
smaller than the unitig graph).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from sage2_tpu_torch.graph.finish import UnitigGraph, greedy_budget_paths


# --------------------------------------------------------------------------
# generic min-cost circulation by deterministic negative-cycle canceling
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Arc:
    to: int
    cap: int
    cost: int
    flow: int = 0


class Circulation:
    """Residual-graph circulation solver (small graphs, host side).

    Deterministic: arcs are relaxed in insertion order; Bellman-Ford
    negative-cycle detection walks parent pointers, so identical inputs
    yield identical flows.
    """

    def __init__(self, n: int):
        self.n = n
        self.arcs: List[_Arc] = []          # even index i, reverse at i^1

    def add_arc(self, u: int, v: int, cap: int, cost: int) -> int:
        i = len(self.arcs)
        self.arcs.append(_Arc(v, cap, cost))
        self.arcs.append(_Arc(u, 0, -cost))
        return i

    def _residual(self, i: int) -> int:
        return self.arcs[i].cap - self.arcs[i].flow

    def _find_negative_cycle(self) -> Optional[List[int]]:
        """Bellman-Ford over the residual graph; returns arc indices of a
        negative cycle or None."""
        n = self.n
        dist = [0] * n                       # virtual source to all nodes
        par_arc = [-1] * n
        x = -1
        for it in range(n):
            x = -1
            for i, arc in enumerate(self.arcs):
                if arc.cap - arc.flow <= 0:
                    continue
                u = self.arcs[i ^ 1].to
                if dist[u] + arc.cost < dist[arc.to]:
                    dist[arc.to] = dist[u] + arc.cost
                    par_arc[arc.to] = i
                    x = arc.to
            if x == -1:
                return None
        # x was relaxed in round n => lies on / reaches a negative cycle
        for _ in range(n):
            x = self.arcs[par_arc[x] ^ 1].to
        cycle = []
        v = x
        while True:
            i = par_arc[v]
            cycle.append(i)
            v = self.arcs[i ^ 1].to
            if v == x:
                break
        cycle.reverse()
        return cycle

    def solve(self, max_iters: int = 1_000_000) -> int:
        """Cancel negative cycles to optimality; returns total cost.

        Routes through the native C++ solver (graph.flow_native) when
        available — an exact port (same arc order, comparisons, cycle
        walks), so flows are bit-identical to the Python loops below
        (tested); the Python path is the no-toolchain fallback. The
        flow stage measured as the DOMINANT cost of the 10 Mbp
        repeat-rich rehearsal before this (round-5, BASELINE.md)."""
        if self.arcs:
            from sage2_tpu_torch.graph import flow_native

            import numpy as np

            to = np.fromiter((a.to for a in self.arcs), np.int32,
                             len(self.arcs))
            cap = np.fromiter((a.cap for a in self.arcs), np.int64,
                              len(self.arcs))
            cost = np.fromiter((a.cost for a in self.arcs), np.int64,
                               len(self.arcs))
            flow = flow_native.solve_circulation(
                self.n, to, cap, cost, max_iters
            )
            if flow is not None:
                for a, f in zip(self.arcs, flow.tolist()):
                    a.flow = f
                return sum(a.flow * a.cost for a in self.arcs[::2])

        iters = 0
        while iters < max_iters:
            cycle = self._find_negative_cycle()
            if cycle is None:
                break
            push = min(self._residual(i) for i in cycle)
            for i in cycle:
                self.arcs[i].flow += push
                self.arcs[i ^ 1].flow -= push
            iters += 1
        return sum(a.flow * a.cost for a in self.arcs[::2])


# --------------------------------------------------------------------------
# condensed junction graph
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Chain:
    cid: int
    uids: List[int]                  # unambiguous unitig chain, in order
    copies: List[int]                # clamped expected copy count per unitig
    lengths: List[int]


def _condense_chains(g: UnitigGraph) -> Tuple[List[_Chain], Dict[int, int]]:
    """Contract maximal unambiguous chains (out-deg 1 -> in-deg 1 links)
    into single nodes; same rule as finish.join_paths."""
    nxt: Dict[int, int] = {}
    for uid in g.unitigs:
        outs = g.out_edges.get(uid, [])
        if len(outs) == 1:
            nb = outs[0][0]
            if len(g.in_edges.get(nb, [])) == 1 and nb != uid:
                nxt[uid] = nb
    prv = {v: u for u, v in nxt.items()}
    chains: List[_Chain] = []
    chain_of: Dict[int, int] = {}
    seen: Set[int] = set()
    for uid in sorted(g.unitigs):
        if uid in seen or uid in prv:
            continue
        path = [uid]
        seen.add(uid)
        while path[-1] in nxt and nxt[path[-1]] not in seen:
            path.append(nxt[path[-1]])
            seen.add(path[-1])
        cid = len(chains)
        chains.append(_Chain(
            cid, path,
            [min(64, max(0, g.unitigs[u].copy_count)) for u in path],
            [g.unitigs[u].length for u in path],
        ))
        for u in path:
            chain_of[u] = cid
    for uid in sorted(g.unitigs):        # cycles of chain links
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
        path = cyc[start:] + cyc[:start]
        cid = len(chains)
        chains.append(_Chain(
            cid, path,
            [min(64, max(0, g.unitigs[u].copy_count)) for u in path],
            [g.unitigs[u].length for u in path],
        ))
        for u in path:
            chain_of[u] = cid
    return chains, chain_of


def _chain_unit_costs(ch: _Chain, max_extra: int) -> List[int]:
    """Marginal cost of the i-th flow unit through the chain (convex,
    nondecreasing): unit i covers every member unitig once, gaining
    -len_u while i <= c_u and paying +len_u beyond."""
    max_units = max(ch.copies, default=0) + max_extra
    out = []
    for i in range(1, max_units + 1):
        out.append(sum(
            -ln if i <= c else ln for c, ln in zip(ch.copies, ch.lengths)
        ))
    return out


# --------------------------------------------------------------------------
# flow -> Euler trails -> unitig paths
# --------------------------------------------------------------------------


def _connect_floating_cycles(
    arc_flows: Dict[Tuple[int, int], int],
    junctions: Set[Tuple[int, int]],
    s: int,
    t: int,
) -> None:
    """Zero-cost tie-break between equal-cost optima: merge floating
    cycles into trails.

    A min-cost circulation can tie between a linear decomposition
    (…->X->R->Y->…) and the degenerate one where X ends at T and {R, Y}
    circulate in a free cycle — both cost the same number of path
    openings. Whenever a trail ENDS at x (flow on x->T), an unused
    junction x->c leads into an s-unreachable cycle node c, and a cycle
    arc w->c carries flow, the reroute {x->T -1, x->c +1, w->c -1,
    w->T +1} is cost-neutral, conserves flow, and connects the cycle to
    the trail. Applied to fixpoint, deterministically (in-place).
    """
    while True:
        # forward closure from s over flow-carrying arcs
        reach = {s}
        frontier = [s]
        out_adj: Dict[int, List[int]] = {}
        for (u, v), f in arc_flows.items():
            if f > 0:
                out_adj.setdefault(u, []).append(v)
        while frontier:
            u = frontier.pop()
            for v in out_adj.get(u, ()):
                if v not in reach:
                    reach.add(v)
                    frontier.append(v)
        applied = False
        for (x, c) in sorted(junctions):
            if x not in reach or c in reach or x in (s, t):
                continue
            if arc_flows.get((x, t), 0) <= 0:
                continue
            w = None
            for (u, v), f in sorted(arc_flows.items()):
                if v == c and f > 0 and u not in (s, t):
                    w = u
                    break
            if w is None:
                continue
            arc_flows[(x, t)] -= 1
            arc_flows[(x, c)] = arc_flows.get((x, c), 0) + 1
            arc_flows[(w, c)] -= 1
            arc_flows[(w, t)] = arc_flows.get((w, t), 0) + 1
            applied = True
            break
        if not applied:
            return


def _euler_paths(
    n_nodes: int,
    s: int,
    t: int,
    arc_flows: Dict[Tuple[int, int], int],
) -> Tuple[List[List[int]], List[List[int]]]:
    """Decompose a conserved flow multigraph into S->T trails plus
    leftover cycles.

    Order matters for correctness: ALL maximal S->T walks are extracted
    first (a maximal walk from S in a conserved flow can only get stuck
    at T); only then is the remainder balanced at every node, so cycle
    walks are guaranteed to close. Cycles are then spliced into the
    trails (or each other) wherever they share a node — this is what
    routes a copy-2 repeat through BOTH of its contexts — and cycles
    touching nothing are returned as standalone circular contigs.
    Deterministic: smallest-successor arc choice, sorted iteration.
    """
    adj: Dict[int, List[List[int]]] = {}
    for (u, v), f in sorted(arc_flows.items()):
        if f > 0:
            adj.setdefault(u, []).append([v, f])

    def take_from(u: int) -> Optional[int]:
        for slot in adj.get(u, []):
            if slot[1] > 0:
                slot[1] -= 1
                return slot[0]
        return None

    def walk(start: int, stop_at: int) -> List[int]:
        trail = [start]
        cur = start
        while True:
            if cur == stop_at and len(trail) > 1:
                break
            nxt = take_from(cur)
            if nxt is None:
                break
            trail.append(nxt)
            cur = nxt
        return trail

    # 1. all S->T trails (plain maximal walks)
    trails: List[List[int]] = []
    while any(slot[1] > 0 for slot in adj.get(s, [])):
        trails.append(walk(s, t))

    # 2. remaining arcs form balanced cycles — peel them
    cycles: List[List[int]] = []     # closed: first == last
    for start in sorted(adj):
        while any(slot[1] > 0 for slot in adj.get(start, [])):
            cyc = walk(start, start)
            assert len(cyc) > 1 and cyc[-1] == start, "unbalanced remainder"
            cycles.append(cyc)

    # 3. splice cycles into trails / other cycles at shared nodes
    def try_splice(host: List[int], cyc: List[int]) -> Optional[List[int]]:
        body = cyc[:-1]
        for idx, u in enumerate(host):
            if u in (s, t):
                continue
            if u in body:
                k = body.index(u)
                rot = body[k:] + body[:k]
                return host[:idx] + rot + host[idx:]
        return None

    pending = cycles
    hosts = trails
    changed = True
    while changed and pending:
        changed = False
        still = []
        for cyc in pending:
            done = False
            for hi in range(len(hosts)):
                merged = try_splice(hosts[hi], cyc)
                if merged is not None:
                    hosts[hi] = merged
                    done = True
                    changed = True
                    break
            if not done:
                for cj in range(len(still)):
                    merged = try_splice(still[cj], cyc)
                    if merged is not None:
                        still[cj] = merged
                        done = True
                        changed = True
                        break
            if not done:
                still.append(cyc)
        pending = still
    return hosts, [c[:-1] for c in pending]


# --------------------------------------------------------------------------
# public entry
# --------------------------------------------------------------------------


def _components(chains: List[_Chain], edges: Set[Tuple[int, int]]):
    """Weakly-connected components over chain ids (sorted, deterministic)."""
    parent = list(range(len(chains)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    comps: Dict[int, List[int]] = {}
    for c in range(len(chains)):
        comps.setdefault(find(c), []).append(c)
    return [comps[r] for r in sorted(comps)]


def mincost_flow_paths(
    g: UnitigGraph,
    cap: int,
    path_penalty: int = 150,
    max_extra: int = 2,
    max_component: int = 2000,
    stats_out: Dict[str, int] | None = None,
) -> List[List[int]]:
    """Minimum-cost contig paths over the unitig graph (module docstring
    has the objective). Returns uid paths; every unitig not covered by
    any path is appended as a singleton so no sequence is lost.
    ``stats_out``: optional dict that receives component/fallback
    counters (config #5 watches the greedy-fallback rate)."""
    if not g.unitigs:
        if stats_out is not None:
            stats_out.update(flow_components=0, flow_fallbacks=0,
                             flow_largest_component=0)
        return []
    chains, chain_of = _condense_chains(g)
    cedges: Dict[Tuple[int, int], int] = {}
    for uid in g.unitigs:
        ca = chain_of[uid]
        for (v, _o) in g.out_edges.get(uid, []):
            cb = chain_of[v]
            if ca == cb:
                continue
            # only tail(chain a) -> head(chain b) edges survive condensation
            if chains[ca].uids[-1] == uid and chains[cb].uids[0] == v:
                cedges[(ca, cb)] = cedges.get((ca, cb), 0) + 1
    comp_list = _components(chains, set(cedges))
    if stats_out is not None:
        stats_out["flow_components"] = len(comp_list)
        stats_out["flow_largest_component"] = max(
            (len(c) for c in comp_list), default=0
        )
        stats_out["flow_fallbacks"] = sum(
            1 for c in comp_list if len(c) > max_component
        )

    # group the (globally sorted) condensed edges by component ONCE:
    # both endpoints of an edge share a component, so scanning + sorting
    # the global edge dict inside every component's loop was
    # O(components * E log E) — measured as a dominant term of the
    # 10 Mbp rehearsal's flow stage (round 5)
    comp_of_chain: Dict[int, int] = {}
    for k_, comp in enumerate(comp_list):
        for c in comp:
            comp_of_chain[c] = k_
    comp_edges: List[List[Tuple[Tuple[int, int], int]]] = [
        [] for _ in comp_list
    ]
    for (ca, cb), mult_ in sorted(cedges.items()):
        comp_edges[comp_of_chain[ca]].append(((ca, cb), mult_))
    # per-component junction sets for _connect_floating_cycles: a
    # foreign junction (x, c) can never fire there (x is unreachable
    # from this component's source), so the filter is exact — and the
    # global set was scanned per fixpoint round per component
    comp_juncs: List[Set[Tuple[int, int]]] = [
        {k for k, _ in es} for es in comp_edges
    ]

    # RC-component canonicalization (round 5): components pair under
    # reverse complement in the double-stranded graph (verified exact on
    # the 10 Mbp artifact: every component maps to one equal-size twin).
    # Emitting BOTH sides and relying on exact-byte dedup in
    # emit_contigs fails when the Euler tie-breaks decompose the two
    # strands differently (measured: ~2x the genome emitted). Each pair
    # is solved on BOTH strands and ONE side is emitted — the one whose
    # decomposition keeps more bases above ``min_emit`` (the two
    # decompositions are equal-cost optima but can fragment differently;
    # picking the better-merged side recovered gf 0.75 -> ~0.9 on the
    # rehearsal) — with the smaller minimum vertex id as the
    # deterministic tie-break. Single-stranded graphs and self-symmetric
    # components keep the old behavior.
    from sage2_tpu_torch.graph.finish import twin_uid

    comp_min_v = [
        min(min(g.unitigs[u].vertices)
            for c in comp for u in chains[c].uids)
        for comp in comp_list
    ]
    twin_of: List[Optional[int]] = [None] * len(comp_list)
    for k_, comp in enumerate(comp_list):
        t = twin_uid(g, chains[comp[0]].uids[0], cap)
        if t is None or t not in chain_of:
            continue
        tk = comp_of_chain.get(chain_of[t])
        if tk is not None and tk != k_:
            twin_of[k_] = tk

    def solve_component(ci_: int, comp: List[int]) -> List[List[int]]:
        """Flow (or greedy fallback) paths of one component, as uid
        paths; pure — no global state mutated."""
        out_paths: List[List[int]] = []
        if len(comp) > max_component:
            sub = set()
            for c in comp:
                sub.update(chains[c].uids)
            return list(greedy_budget_paths(g, cap, only=sub))
        local = {c: i for i, c in enumerate(comp)}
        n = len(comp)
        S, T = 2 * n, 2 * n + 1              # nodes: c_in=2i, c_out=2i+1
        net = Circulation(2 * n + 2)
        for c in comp:
            i = local[c]
            for ucost in _chain_unit_costs(chains[c], max_extra):
                net.add_arc(2 * i, 2 * i + 1, 1, ucost)
        big = sum(
            max(ch.copies, default=0) + max_extra
            for ch in (chains[c] for c in comp)
        ) + 1
        # comp_edges[ci_] holds this component's edges in the same
        # global-sorted order the per-component scan produced
        for (ca, cb), _mult in comp_edges[ci_]:
            net.add_arc(2 * local[ca] + 1, 2 * local[cb], big, 0)
        for c in comp:
            i = local[c]
            net.add_arc(S, 2 * i, big, path_penalty)
            net.add_arc(2 * i + 1, T, big, 0)
        net.add_arc(T, S, big, 0)
        net.solve()

        # arc flows in chain-id space
        arc_flows: Dict[Tuple[int, int], int] = {}
        for i0 in range(0, len(net.arcs), 2):
            arc = net.arcs[i0]
            if arc.flow <= 0:
                continue
            u = net.arcs[i0 ^ 1].to
            v = arc.to
            # skip the chain-internal unit arcs and the T->S return arc
            if u % 2 == 0 and v == u + 1 and v < 2 * n:
                continue
            if u == T and v == S:
                continue
            # map to chain-id multigraph nodes: S/T stay; c_out->c_in
            def name(x):
                if x == S:
                    return -1
                if x == T:
                    return -2
                return comp[x // 2]
            nu, nv = name(u), name(v)
            if nu == nv:
                continue
            key = (nu, nv)
            arc_flows[key] = arc_flows.get(key, 0) + arc.flow

        # relabel S=-1 -> s_node, T=-2 -> t_node for the decomposer
        relabel = {-1: len(chains), -2: len(chains) + 1}
        flows2 = {
            (relabel.get(u, u), relabel.get(v, v)): f
            for (u, v), f in arc_flows.items()
        }
        _connect_floating_cycles(
            flows2, comp_juncs[ci_], relabel[-1], relabel[-2]
        )
        trails, cycles = _euler_paths(
            len(chains) + 2, relabel[-1], relabel[-2], flows2
        )
        for tr in trails:
            inner = [c for c in tr if c < len(chains)]
            if not inner:
                continue
            uid_path: List[int] = []
            for c in inner:
                uid_path.extend(chains[c].uids)
            out_paths.append(uid_path)
        for cyc in cycles:
            inner = [c for c in cyc if c < len(chains)]
            if not inner:
                continue
            # break the chain-cycle at its minimum uid chain (deterministic)
            k = min(range(len(inner)), key=lambda j: chains[inner[j]].uids[0])
            inner = inner[k:] + inner[:k]
            uid_path = []
            for c in inner:
                uid_path.extend(chains[c].uids)
            out_paths.append(uid_path)
        return out_paths

    paths: List[List[int]] = []
    covered: Set[int] = set()
    n_suppressed = 0
    done: Set[int] = set()
    for ci_, comp in enumerate(comp_list):
        if ci_ in done:
            continue
        done.add(ci_)
        tk = twin_of[ci_]
        if tk is not None and tk not in done:
            # canonical member of the pair = the one holding the
            # smaller minimum vertex id (deterministic). Selecting by
            # per-side emitted-content metrics was tried and measured
            # WORSE on the 10 Mbp rehearsal (gf 0.75 -> 0.65): the
            # strands' equal-cost decompositions fragment differently
            # and neither path-bases nor distinct-unitig-bases predicts
            # genome coverage — RC-symmetric Euler tie-breaks are the
            # real fix (future work, BASELINE.md round-5).
            done.add(tk)
            n_suppressed += 1
            if comp_min_v[ci_] > comp_min_v[tk]:
                # twin is canonical: solve/emit it, suppress this one
                for c in comp:
                    covered.update(chains[c].uids)
                for p in solve_component(tk, comp_list[tk]):
                    paths.append(p)
                    covered.update(p)
                continue
            for c in comp_list[tk]:
                covered.update(chains[c].uids)
        for p in solve_component(ci_, comp):
            paths.append(p)
            covered.update(p)
    if stats_out is not None:
        stats_out["flow_twin_components_suppressed"] = n_suppressed

    # no sequence loss: emit uncovered unitigs as singletons
    for uid in sorted(g.unitigs):
        if uid not in covered:
            paths.append([uid])
            covered.add(uid)
    return paths
