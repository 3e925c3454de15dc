"""Ragged reads (per-read lengths, zero padding) through each stage of
sage2_tpu_torch against sage2_tpu and the oracles, on the CPU (the
kernels' plain versions); exact equality.

Inputs: mixed-length reads (50-80 bp plus shorter contained ones, the
recipe of tests/test_ragged.py) with substitution errors on real bases,
made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.graph import reduce as jreduce
from sage2_tpu.kmer import correct_reads as jcorrect
from sage2_tpu.kmer.count import count_kmers as jcount
from sage2_tpu.overlap import find_overlaps as jfind
from sage2_tpu.overlap import find_overlaps_auto as jfind_auto
from sage2_tpu.overlap import prepare_reads as jprepare
from sage2_tpu.refmodel.oracle import (
    oracle_overlaps_ragged,
    oracle_transitive_reduction,
)
from sage2_tpu_torch.data import simulate_genome, simulate_ragged_reads
from sage2_tpu_torch.graph import reduce as treduce
from sage2_tpu_torch.kmer import correct_reads as tcorrect
from sage2_tpu_torch.kmer import count_kmers as tcount
from sage2_tpu_torch.overlap import find_overlaps as tfind
from sage2_tpu_torch.overlap import find_overlaps_auto as tfind_auto
from sage2_tpu_torch.overlap import prepare_reads as tprepare
from torch_one_thread import one_thread  # noqa: F401

K, MIN_OVERLAP = 15, 35
I32_MAX = 2**31 - 1


@pytest.fixture(scope="module")
def ragged():
    """~610 reads of a 3,000 bp genome, plus duplicates that only the
    length key of dedup tells apart."""
    genome = simulate_genome(3000, seed=31)
    reads, lens = simulate_ragged_reads(genome, 50, 80, 12.0, 0.01,
                                        seed=32)
    reads = reads.astype(np.int32)
    # exact copies; reverse complements of the real bases; and reads
    # ending in A cut by one base, whose packed words equal the uncut
    # read's (the length alone keeps them apart)
    ends_a = np.nonzero(reads[np.arange(len(lens)), lens - 1] == 0)[0][:6]
    rc = np.zeros_like(reads[4:9])
    for i, (row, n) in enumerate(zip(reads[4:9], lens[4:9])):
        rc[i, :n] = (3 - row[:n])[::-1]
    cut = reads[ends_a].copy()
    cut[np.arange(len(ends_a)), lens[ends_a] - 1] = 0
    reads = np.concatenate([reads, reads[:5], rc, cut])
    lens = np.concatenate([lens, lens[:5], lens[4:9], lens[ends_a] - 1])
    return reads, lens.astype(np.int32)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_count_kmers_masks_windows_past_the_end(ragged):
    reads, lens = ragged
    jt = jcount(_j(reads), K, lengths=_j(lens))
    tt = tcount(_t(reads), K, _t(lens))
    n = int(jt.n_unique)
    assert tt.n_unique == n < tcount(_t(reads), K).n_unique
    keys = (np.asarray(jt.hi)[:n].astype(np.int64) << 32) | np.asarray(
        jt.lo)[:n].astype(np.int64)
    np.testing.assert_array_equal(keys, tt.keys.numpy())
    np.testing.assert_array_equal(np.asarray(jt.count)[:n], tt.count.numpy())


@pytest.mark.parametrize("rule", ["single_window", "vote_all_windows"])
def test_correct_reads_ragged_matches_reference(ragged, rule):
    """One round against the reference's dense correctors (the
    pipeline's two rounds from the count stage's table are held to its
    two-phase corrector in tests/test_torch_pipeline_ragged.py)."""
    reads, lens = ragged
    want = np.asarray(jcorrect(_j(reads), K, 2, 1, lengths=_j(lens),
                               rule=rule))
    got = tcorrect(_t(reads), K, 2, 1, lengths=_t(lens), rule=rule).numpy()
    assert (want != reads).sum() > 0
    np.testing.assert_array_equal(want, got)
    pad = np.arange(reads.shape[1])[None, :] >= lens[:, None]
    assert (got[pad] == 0).all()


def test_prepare_reads_ragged_all_fields(ragged):
    reads, lens = ragged
    noisy = reads.copy()
    noisy[np.arange(reads.shape[1])[None, :] >= lens[:, None]] = 2
    j = jprepare(_j(noisy), lengths=_j(lens))
    t = tprepare(_t(noisy), _t(lens))
    assert t.n_unique == int(j.n_unique) < reads.shape[0]
    for f in ("reads2", "valid2", "multiplicity", "vertex_of_read",
              "lengths2"):
        want, got = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        np.testing.assert_array_equal(want, got, err_msg=f)
        assert want.dtype == got.dtype, f


@pytest.fixture(scope="module")
def prepared(ragged):
    reads, lens = ragged
    return (jprepare(_j(reads), lengths=_j(lens)),
            tprepare(_t(reads), _t(lens)))


def _same_result(jr, tr):
    for f in ("src", "dst", "ovl", "contained"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                      getattr(tr, f).numpy(), err_msg=f)
    for f in ("n_edges", "n_candidates", "n_verified", "overflow",
              "n_contained"):
        assert int(getattr(jr, f)) == int(getattr(tr, f)), f


@pytest.fixture(scope="module")
def overlaps(prepared):
    """find_overlaps_auto of both packages on the prepared reads."""
    j, t = prepared
    return (jfind_auto(j.reads2, j.valid2, MIN_OVERLAP, lengths=j.lengths2),
            tfind_auto(t.reads2, t.valid2, MIN_OVERLAP, lengths=t.lengths2))


def test_find_overlaps_auto_ragged_with_containments(overlaps):
    """Edges, counts and containment marks."""
    jr, tr = overlaps
    _same_result(jr, tr)
    assert tr.n_contained > 0 and not tr.overflow


def test_find_overlaps_ragged_overflow_marks_kept_slots(prepared):
    """A capacity below the candidate count keeps, and marks
    containments from, the first slots only."""
    j, t = prepared
    jr = jfind(j.reads2, j.valid2, MIN_OVERLAP, capacity=2000,
               lengths=j.lengths2)
    tr = tfind(t.reads2, t.valid2, MIN_OVERLAP, capacity=2000,
               lengths=t.lengths2)
    _same_result(jr, tr)
    assert tr.overflow and tr.n_candidates > 2000


@pytest.fixture(scope="module")
def oracle_graph():
    """50 error-free reads of 40-69 bp and their reverse complements
    (tests/test_ragged.py's oracle case) with the oracle's edges and
    containments."""
    rng = np.random.default_rng(7)
    genome = simulate_genome(500, seed=51)
    raw = []
    for _ in range(50):
        ln = int(rng.integers(40, 70))
        start = int(rng.integers(0, len(genome) - ln))
        raw.append(np.array(genome[start : start + ln], np.int32))
    both = raw + [(3 - r)[::-1] for r in raw]
    reads = np.zeros((len(both), max(len(r) for r in both)), np.int32)
    lens = np.array([len(r) for r in both], np.int32)
    for i, r in enumerate(both):
        reads[i, : len(r)] = r
    edges, contained = oracle_overlaps_ragged(both, 30)
    return reads, lens, edges, contained


def test_find_overlaps_ragged_matches_oracle(oracle_graph):
    reads, lens, want, contained = oracle_graph
    res = tfind(_t(reads), torch.ones(len(lens), dtype=torch.bool), 30,
                capacity=1 << 15, lengths=_t(lens))
    got = {(int(a), int(b)): int(v)
           for a, b, v in zip(res.src.numpy(), res.dst.numpy(),
                              res.ovl.numpy()) if a != I32_MAX}
    assert got == want
    # the join never sees an overlap start of 0, so a read that is a
    # prefix of a longer one is marked through its reverse complement
    # (a suffix there); the pipeline removes a read contained in either
    # orientation, and in that sense the marks are the oracle's
    n = len(lens) // 2
    marks = res.contained.numpy()
    either = {v % n for v in np.nonzero(marks)[0]}
    assert either == {v % n for v in contained}
    assert set(np.nonzero(marks)[0]) <= contained


@pytest.fixture(scope="module")
def ragged_edges(prepared, overlaps):
    """The reference's ragged edge list and per-vertex lengths."""
    j, _ = prepared
    res = overlaps[0]
    edges = tuple(np.array(a) for a in (res.src, res.dst, res.ovl))
    return edges, np.array(j.lengths2), j.reads2.shape[0]


def _same_reduction(ref, port):
    for f in ("src", "dst", "ovl"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      np.asarray(getattr(port, f)),
                                      err_msg=f)
    assert (int(ref.n_edges), int(ref.n_expansions), bool(ref.overflow)) == (
        port.n_edges, port.n_expansions, port.overflow)


@pytest.mark.parametrize("form", ["in_core", "in_core_overflow", "chunked",
                                  "native"])
def test_reductions_with_per_vertex_lengths(ragged_edges, form):
    edges, lens, V = ragged_edges
    te = tuple(_t(a.copy()) for a in edges)
    if form == "native":
        ref = jreduce.transitive_reduction_native(*edges, V, lens)
        port = treduce.transitive_reduction_auto(*edges, V, lens,
                                                 backend="native")
    elif form == "chunked":
        ref = jreduce.transitive_reduction_chunked(
            *(_j(a) for a in edges), V, _j(lens), chunk_cap=1 << 12)
        port = treduce.transitive_reduction_chunked(*te, V, _t(lens),
                                                    chunk_cap=1 << 12)
    else:
        cap = 1 << 15 if form == "in_core" else 700
        ref = jreduce.transitive_reduction(*(_j(a) for a in edges), V,
                                           _j(lens), capacity=cap)
        port = treduce.transitive_reduction(*te, V, _t(lens), capacity=cap)
        assert port.overflow == (form == "in_core_overflow")
    _same_reduction(ref, port)
    if form == "chunked":
        # the device backend through the dispatcher, numpy lengths
        _same_reduction(ref, treduce.transitive_reduction_auto(
            *edges, V, lens, backend="device", device="cpu"))


def test_reduction_ragged_matches_oracle(oracle_graph):
    reads, lens, edges, _ = oracle_graph
    res = tfind(_t(reads), torch.ones(len(lens), dtype=torch.bool), 30,
                capacity=1 << 15, lengths=_t(lens))
    red = treduce.transitive_reduction(res.src, res.dst, res.ovl,
                                       len(lens), _t(lens),
                                       capacity=1 << 15)
    want = oracle_transitive_reduction(
        edges, 0, lengths={v: int(n) for v, n in enumerate(lens)})
    got = {(int(a), int(b)): int(o)
           for a, b, o in zip(red.src.numpy(), red.dst.numpy(),
                              red.ovl.numpy()) if a != I32_MAX}
    assert got == want != edges
