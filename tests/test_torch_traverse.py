"""sage2_tpu_torch unitig labeling and host-native reduction against
sage2_tpu (CPU; exact equality), on graphs with cycles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.graph.reduce import transitive_reduction_native as jreduce
from sage2_tpu.graph.traverse import contract_unitigs as jcontract
from sage2_tpu.refmodel.oracle import oracle_unitigs
from sage2_tpu_torch.graph.reduce import transitive_reduction_auto as treduce
from sage2_tpu_torch.graph.traverse import contract_unitigs as tcontract

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


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_contract_unitigs_matches_reference(seed):
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        treduce(src, dst, ovl, V, 100, backend="device")
