"""sage2_tpu_torch unitig labeling, its doubling loops (kernel K4's CPU
path), its links and cycle cut (kernel K18's CPU path) and the
host-native reduction against sage2_tpu (CPU; exact equality), on graphs
with cycles, vertices of degree > 1 on both sides, no vertex and only
padding rows (tests/torch_kernel_cases.py chain_case)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.graph.reduce import transitive_reduction_native as jreduce
from sage2_tpu.graph.traverse import contract_unitigs as jcontract
from sage2_tpu.refmodel.oracle import oracle_unitigs
from sage2_tpu_torch import kernels
from sage2_tpu_torch.graph.reduce import transitive_reduction_auto as treduce
from sage2_tpu_torch.graph.traverse import contract_unitigs as tcontract
from sage2_tpu_torch.kernels import plain
from torch_kernel_cases import CHAIN_CASES, chain_case
from torch_one_thread import one_thread  # noqa: F401

I32_MAX = 2**31 - 1


def _graph(edges, V, pad=5):
    e = sorted(edges)
    src = np.array([a for a, _, _ in e] + [I32_MAX] * pad, np.int32)
    dst = np.array([b for _, b, _ in e] + [I32_MAX] * pad, np.int32)
    ovl = np.array([o for _, _, o in e] + [0] * pad, np.int32)
    return src, dst, ovl


def _random_graph(seed, V=400):
    """Chains, branches and two pure cycles (one a self-contained ring)."""
    rng = np.random.default_rng(seed)
    edges = {}
    order = rng.permutation(V)
    for i in range(0, 300, 1):           # a long chain with some gaps
        if rng.random() < 0.9:
            edges[(int(order[i]), int(order[i + 1]))] = int(rng.integers(20, 60))
    ring = [int(v) for v in order[310:330]]
    for a, b in zip(ring, ring[1:] + ring[:1]):
        edges[(a, b)] = 33
    for _ in range(40):                  # branching noise
        a, b = (int(x) for x in rng.integers(0, V, 2))
        if a != b:
            edges[(a, b)] = int(rng.integers(20, 60))
    return [(a, b, o) for (a, b), o in edges.items()]


@pytest.mark.parametrize("seed", [1, 2, 3, *CHAIN_CASES])
def test_contract_unitigs_matches_reference(seed):
    """Random graphs (seeds), and K18's cases (names): rings broken at
    their least vertex, branches of out- and in-degree 2-3 and a
    self-loop, an empty graph, a graph of padding rows alone."""
    if isinstance(seed, str):
        src, dst, ovl, V = chain_case(seed)
    else:
        V = 400
        src, dst, ovl = _graph(_random_graph(seed, V), V)
    j = jcontract(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ovl), V)
    t = tcontract(torch.from_numpy(src), torch.from_numpy(dst),
                  torch.from_numpy(ovl), V)
    for f in j._fields:
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=f)


def _chains(labels, V):
    head, dist = labels.head.numpy(), labels.dist.numpy()
    by_head = {}
    for v in range(V):
        by_head.setdefault(int(head[v]), []).append((int(dist[v]), v))
    return sorted([v for _, v in sorted(c)] for c in by_head.values())


@pytest.mark.parametrize("seed", [None, 4])
def test_contract_unitigs_chains_match_oracle(seed):
    """A pure ring (broken at its minimum id) or a random graph with a
    ring: the chains equal oracle_unitigs'."""
    if seed is None:
        V, ring = 6, [3, 5, 1, 4]
        edges = [(a, b, 30) for a, b in zip(ring, ring[1:] + ring[:1])]
    else:
        V = 400
        edges = _random_graph(seed, V)
    src, dst, ovl = _graph(edges, V)
    t = tcontract(torch.from_numpy(src), torch.from_numpy(dst),
                  torch.from_numpy(ovl), V)
    want = oracle_unitigs({(a, b): o for a, b, o in edges}, V)
    assert _chains(t, V) == sorted(want)
    if seed is None:
        assert _chains(t, V)[1] == [1, 4, 3, 5]


def test_native_reduction_matches_reference():
    V = 400
    src, dst, ovl = _graph(_random_graph(7, V), V)
    j = jreduce(src, dst, ovl, V, 100)
    t = treduce(src, dst, ovl, V, 100)
    for f in ("src", "dst", "ovl"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f))
    assert (t.n_edges, t.n_expansions) == (int(j.n_edges),
                                           int(j.n_expansions))
    # the device backend (ported since) gives the same graph
    d = treduce(src, dst, ovl, V, 100, backend="device", device="cpu")
    for f in ("src", "dst", "ovl"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(d, f).numpy())
    assert (d.n_edges, d.n_expansions) == (t.n_edges, t.n_expansions)


def _reference_loop(p, val, op, steps):
    """The reference's doubling loops on numpy inputs: the bodies of
    ``double``, ``min_prop`` and ``dist_body``
    (sage2_tpu/graph/traverse.py:81-118), run through lax.fori_loop."""
    pj = jnp.asarray(p)
    if op == "none":
        def body(_, p):
            return p[p]

        return np.asarray(jax.lax.fori_loop(0, steps, body, pj)), None
    if op == "min":
        def body(_, carry):
            m, pp = carry
            return jnp.minimum(m, m[pp]), pp[pp]
    else:
        def body(_, carry):
            d, pp = carry
            return d + d[pp], pp[pp]
    v, pp = jax.lax.fori_loop(0, steps, body, (jnp.asarray(val), pj))
    return np.asarray(pp), np.asarray(v)


def _pointers(graph, V, rng):
    """Parent pointers: a random functional graph (trees hanging off
    cycles), one chain of length V (every step moves it), or disjoint
    rings of a random permutation."""
    if graph == "random":
        return rng.integers(0, V, V).astype(np.int32)
    if graph == "chain":
        return np.maximum(np.arange(V) - 1, 0).astype(np.int32)
    perm = rng.permutation(V)
    p = np.empty(V, np.int32)
    for ring in np.array_split(perm, 7):
        p[ring] = np.roll(ring, 1)
    return p


@pytest.mark.parametrize("steps", [1, 2, "reference"])
@pytest.mark.parametrize("graph", ["random", "chain", "rings"])
@pytest.mark.parametrize("op", ["none", "min", "add"])
def test_pointer_jump_loop_matches_reference(op, graph, steps):
    """kernels.pointer_jump(p, val, op, steps=n) on the CPU equals n
    single plain steps and the reference's loop bodies; add values span
    the int32 range, so the sums wrap."""
    V = 157
    if steps == "reference":
        steps = max(1, math.ceil(math.log2(max(V, 2))) + 1)
    rng = np.random.default_rng(11)
    p = _pointers(graph, V, rng)
    val = None
    if op == "min":
        val = rng.integers(-1000, 1000, V).astype(np.int32)
    elif op == "add":
        val = rng.integers(-2**31, 2**31, V, dtype=np.int64).astype(np.int32)
    want_p, want_v = _reference_loop(p, val, op, steps)
    tv = None if val is None else torch.from_numpy(val)
    got_p, got_v = kernels.pointer_jump(torch.from_numpy(p), tv, op, steps)
    one_p, one_v = torch.from_numpy(p), tv
    for _ in range(steps):
        one_p, one_v = plain.pointer_jump(one_p, one_v, op)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(one_p.numpy(), want_p)
    if op == "none":
        assert got_v is None and one_v is None
    else:
        np.testing.assert_array_equal(got_v.numpy(), want_v)
        np.testing.assert_array_equal(one_v.numpy(), want_v)
    if graph == "chain" and steps > 2:      # every vertex reached the root
        assert not want_p.any()


@pytest.mark.parametrize("case", CHAIN_CASES)
def test_chain_links_and_cut_match_reference_steps(case):
    """K18's two launches (plain versions) against the reference's own
    steps: the degrees, the chain links and the initial parents of
    contract_unitigs (:40-77), and its cycle cut (:96-107) after the
    `none` and `min` loops."""
    src, dst, ovl, V = chain_case(case)
    outdeg, indeg, nxt, ovl_next, p = kernels.chain_links(
        *(torch.from_numpy(a) for a in (src, dst, ovl)), V)
    is_edge = src != I32_MAX
    np.testing.assert_array_equal(
        outdeg.numpy(), np.bincount(src[is_edge], minlength=V))
    np.testing.assert_array_equal(
        indeg.numpy(), np.bincount(dst[is_edge], minlength=V))
    od, idg = outdeg.numpy(), indeg.numpy()
    for v in range(V):
        outs = [(b, o) for a, b, o in zip(src, dst, ovl) if a == v]
        ins = [a for a, b in zip(src, dst) if b == v and a != I32_MAX]
        chain_out = len(outs) == 1 and idg[outs[0][0]] == 1
        assert nxt[v] == (outs[0][0] if chain_out else -1)
        assert ovl_next[v] == (outs[0][1] if chain_out else 0)
        chain_in = len(ins) == 1 and od[ins[0]] == 1
        assert p[v] == (ins[0] if chain_in else v)
    steps = max(1, math.ceil(math.log2(max(V, 2))) + 1)
    ids = np.arange(V, dtype=np.int32)
    pf, _ = _reference_loop(p.numpy(), None, "none", steps)
    _, m = _reference_loop(p.numpy(), ids, "min", steps)
    want_nxt, want_ovl = nxt.numpy().copy(), ovl_next.numpy().copy()
    breaker = (p.numpy()[pf] != pf) & (m == ids)
    want_nxt[p.numpy()[breaker]] = -1
    want_ovl[p.numpy()[breaker]] = 0
    want_p = np.where(breaker, ids, p.numpy())
    got_p, d0 = kernels.chain_cut(p, torch.from_numpy(pf.copy()),
                                  torch.from_numpy(m.copy()), nxt, ovl_next)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(d0.numpy(), want_p != ids)
    np.testing.assert_array_equal(nxt.numpy(), want_nxt)
    np.testing.assert_array_equal(ovl_next.numpy(), want_ovl)
    if case == "rings":   # two rings are cut; the chain into the third
        assert int(breaker.sum()) == 2      # gives it no chain cycle
