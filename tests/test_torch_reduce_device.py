"""The port's device transitive reduction (kernels K6 and K7 through
their plain versions on the CPU) against sage2_tpu's in-core and chunked
reductions, the oracle and the native backend; exact equality,
including the truncated in-core result when the expansion overflows its
capacity."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.data import simulate_genome, simulate_reads
from sage2_tpu.graph.reduce import ReducedGraph as JReducedGraph
from sage2_tpu.graph.reduce import transitive_reduction as jreduce
from sage2_tpu.graph.reduce import transitive_reduction_chunked as jchunked
from sage2_tpu.overlap import find_overlaps, prepare_reads
from sage2_tpu.refmodel.oracle import oracle_transitive_reduction
from sage2_tpu_torch import kernels
from sage2_tpu_torch.graph import reduce as treduce
from sage2_tpu_torch.ops.sort import sort_by_pair
from torch_one_thread import one_thread  # noqa: F401

_I32_MAX = 2**31 - 1


def _graph(seed, glen=2000, L=60, cov=15, min_ovl=30, err=0.0):
    genome = simulate_genome(glen, seed=seed)
    reads, _ = simulate_reads(genome, read_len=L, coverage=cov,
                              error_rate=err, seed=seed + 1)
    rs = prepare_reads(jnp.asarray(reads.astype(np.int32)))
    res = find_overlaps(rs.reads2, rs.valid2, min_ovl, capacity=1 << 16)
    assert not bool(res.overflow)
    edges = tuple(np.asarray(a) for a in (res.src, res.dst, res.ovl))
    return edges, rs.reads2.shape[0], L


@pytest.fixture(scope="module")
def graph():
    return _graph(9)


def _t(edges):
    return tuple(torch.from_numpy(a.copy()) for a in edges)


def _assert_same(ref, port):
    for f in ("src", "dst", "ovl"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      np.asarray(getattr(port, f)),
                                      err_msg=f)
    assert int(ref.n_edges) == port.n_edges
    assert int(ref.n_expansions) == port.n_expansions
    assert bool(ref.overflow) == port.overflow


def _edges_dict(src, dst, ovl):
    return {(int(a), int(b)): int(o) for a, b, o in zip(src, dst, ovl)
            if int(a) != _I32_MAX}


def test_reduced_graph_has_the_reference_fields():
    assert treduce.ReducedGraph._fields == JReducedGraph._fields
    (src, dst, ovl), V, L = _graph(5, glen=600, L=40, min_ovl=20)
    red = treduce.transitive_reduction_native(src, dst, ovl, V, L)
    assert red.overflow is False


def test_sort_by_pair_is_stable():
    major = torch.tensor([3, 1, 3, 1, _I32_MAX, 1], dtype=torch.int32)
    minor = torch.tensor([5, 2, 5, 2, _I32_MAX, 0], dtype=torch.int32)
    keys, order = sort_by_pair(major, minor)
    assert order.tolist() == [5, 1, 3, 0, 2, 4]
    assert keys.tolist() == sorted((int(a) << 32) | int(b)
                                   for a, b in zip(major, minor))


@pytest.mark.parametrize("capacity", [1 << 18, 1000, 1])
def test_in_core_matches_reference(graph, capacity):
    (src, dst, ovl), V, L = graph
    ref = jreduce(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ovl), V, L,
                  capacity=capacity)
    port = treduce.transitive_reduction(*_t((src, dst, ovl)), V, L,
                                        capacity=capacity)
    assert port.overflow == (capacity < port.n_expansions)
    _assert_same(ref, port)


def test_in_core_overflow_keeps_the_first_slots():
    """Capacities that cut a run of equal (src, sl) keys: which
    expansions of the cut edge survive depends on the stable tie order
    (with the ties reversed, each of these capacities gives another
    edge list). Ties need two out-edges of equal overlap, so the reads
    carry errors."""
    (src, dst, ovl), V, L = _graph(13, glen=1500, L=50, cov=25, min_ovl=25,
                                   err=0.02)
    full = treduce.transitive_reduction(*_t((src, dst, ovl)), V, L,
                                        capacity=1 << 20)
    assert not full.overflow
    n_edges = []
    for capacity in (589, 3100, 3999, 4402):
        ref = jreduce(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ovl),
                      V, L, capacity=capacity)
        port = treduce.transitive_reduction(*_t((src, dst, ovl)), V, L,
                                            capacity=capacity)
        assert port.overflow and port.n_expansions == full.n_expansions
        _assert_same(ref, port)
        n_edges.append(port.n_edges)
    # fewer probed slots remove no more edges
    assert n_edges == sorted(n_edges, reverse=True)
    assert n_edges[-1] >= full.n_edges


@pytest.mark.parametrize("host_prep", [False, True])
@pytest.mark.parametrize("chunk_cap", [1 << 12, 1 << 24])
def test_chunked_matches_reference(graph, host_prep, chunk_cap):
    (src, dst, ovl), V, L = graph
    ref = jchunked(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ovl), V,
                   L, chunk_cap=1 << 12, host_prep=host_prep)
    kernels.reset_launch_counts()
    port = treduce.transitive_reduction_chunked(*_t((src, dst, ovl)), V, L,
                                                chunk_cap=chunk_cap)
    assert kernels.LAUNCHES["reduce_marks"] == 0    # plain versions on CPU
    _assert_same(ref, port)


@pytest.mark.parametrize("seed,err", [(21, 0.0), (23, 0.01)])
def test_device_matches_oracle_and_native(seed, err):
    (src, dst, ovl), V, L = _graph(seed, glen=800, L=40, cov=12, min_ovl=20,
                                   err=err)
    dev = treduce.transitive_reduction_chunked(*_t((src, dst, ovl)), V, L)
    nat = treduce.transitive_reduction_native(src, dst, ovl, V, L)
    for f in ("src", "dst", "ovl"):
        np.testing.assert_array_equal(getattr(dev, f).numpy(),
                                      getattr(nat, f), err_msg=f)
    assert (dev.n_edges, dev.n_expansions) == (nat.n_edges,
                                               nat.n_expansions)
    got = _edges_dict(dev.src, dev.dst, dev.ovl)
    full = _edges_dict(src, dst, ovl)
    assert got == oracle_transitive_reduction(full, L)
    assert len(got) < len(full)


def test_auto_dispatch(graph, monkeypatch):
    (src, dst, ovl), V, L = graph
    calls = []
    native = treduce.transitive_reduction_native
    monkeypatch.setattr(treduce, "transitive_reduction_native",
                        lambda *a, **kw: calls.append("native")
                        or native(*a, **kw))
    red = treduce.transitive_reduction_auto(src, dst, ovl, V, L)
    assert calls == ["native"] and isinstance(red.src, np.ndarray)
    for backend in ("auto", "device"):
        red = treduce.transitive_reduction_auto(*_t((src, dst, ovl)), V, L,
                                                backend=backend)
        assert calls == ["native"] and isinstance(red.src, torch.Tensor)
    red = treduce.transitive_reduction_auto(src, dst, ovl, V, L,
                                            backend="device", device="cpu")
    assert calls == ["native"] and red.src.device.type == "cpu"
    red = treduce.transitive_reduction_auto(*_t((src, dst, ovl)), V, L,
                                            backend="native")
    assert calls == ["native", "native"]
    with pytest.raises(ValueError, match="unknown reduce backend"):
        treduce.transitive_reduction_auto(src, dst, ovl, V, L,
                                          backend="gpu")
    # per-vertex lengths (ragged reads, refused before they were ported)
    # all equal to L reduce as the scalar L, on either backend
    lens = np.full(V, L, np.int32)
    for backend in ("native", "device"):
        _assert_same(treduce.transitive_reduction_auto(
            src, dst, ovl, V, L, backend="native"),
            treduce.transitive_reduction_auto(src, dst, ovl, V, lens,
                                              backend=backend,
                                              device="cpu"))


def test_device_backend_on_host_arrays_needs_a_gpu(graph, monkeypatch):
    (src, dst, ovl), V, L = graph
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        treduce.transitive_reduction_auto(src, dst, ovl, V, L,
                                          backend="device")
