"""Kernels K5 (``kernels.vote_windows``) and K7 (``kernels.reduce_marks``)
on the cases their CUDA designs must get right (tests/torch_kernel_cases.py,
made with numpy from a seed), through their plain versions on the CPU:
against sage2_tpu's ``voting_round`` and ``transitive_reduction_chunked``,
exact equality. ``tests/test_torch_kernels_cuda.py`` holds the kernels
against the plain versions on the same cases on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.graph.reduce import transitive_reduction_chunked as jchunked
from sage2_tpu.kmer.correct import voting_round as jvoting_round
from sage2_tpu.kmer.count import KmerTable
from sage2_tpu.kmer.count import lookup_counts as jlookup
from sage2_tpu_torch import kernels
from sage2_tpu_torch.graph import reduce as treduce
from sage2_tpu_torch.kernels import plain
from sage2_tpu_torch.ops.sort import sort_by_pair
from torch_kernel_cases import (
    MARKS_READ_LEN,
    VOTE_CASES,
    marks_graph,
    slot_splits,
    vote_case,
    weak_covered,
)
from torch_one_thread import one_thread  # noqa: F401


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("case", VOTE_CASES)
def test_vote_windows_case_matches_reference(case):
    """One voting round of the port (K5's plain version) equals the
    reference's voting_round with its sort-join lookup; the reads come
    out as the case says (errors fixed, a tie or an empty table leaves
    them as they were)."""
    reads, lengths, keys, counts, k, threshold, truth = vote_case(case)
    jt = KmerTable(jnp.asarray((keys >> 32).astype(np.uint32)),
                   jnp.asarray((keys & 0xFFFFFFFF).astype(np.uint32)),
                   jnp.asarray(counts), jnp.int32(len(keys)), k)
    want = np.asarray(jvoting_round(
        jnp.asarray(reads), lambda ch, cl: jlookup(jt, ch, cl), k, threshold,
        None if lengths is None else jnp.asarray(lengths)))
    got = kernels.vote_windows(_t(reads), _t(keys), _t(counts), k, threshold,
                               _t(lengths)).numpy()
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(got, reads if case == "empty" else truth)
    assert (got != reads).any() == (case not in ("clean", "tie", "empty"))


@pytest.mark.parametrize("case", VOTE_CASES)
def test_vote_windows_skip_premise(case):
    """K5 looks up variants only at bases with a weak valid covering
    window: every base the round changes has one, and a read without one
    is left as it was."""
    reads, lengths, keys, counts, k, threshold, _ = vote_case(case)
    got = kernels.vote_windows(_t(reads), _t(keys), _t(counts), k, threshold,
                               _t(lengths)).numpy()
    weak = weak_covered(reads, keys, counts, k, threshold, lengths)
    changed = got != reads
    assert not (changed & ~weak).any()
    assert weak.any() == (case != "clean")
    if lengths is not None:           # past a read's end: never weak
        assert not weak[np.arange(reads.shape[1])[None, :]
                        >= lengths[:, None]].any()


@pytest.fixture(scope="module")
def marks():
    """K7's inputs over marks_graph: the sort, K6's prep (plain), the
    prefix sum of the expansion counts."""
    src, dst, ovl, V = marks_graph()
    src, dst, ovl = (torch.from_numpy(a) for a in (src, dst, ovl))
    L = MARKS_READ_LEN
    keys, order = sort_by_pair(src, L - ovl)
    start, _, startd, counts = plain.reduce_counts(keys, src, dst, ovl, V, L)
    offsets = torch.cumsum(counts, 0, dtype=torch.int64)
    rest = (offsets, src, dst, ovl, (keys & 0xFFFFFFFF).to(torch.int32),
            dst[order], start, startd, L)
    return (src, dst, ovl, V), rest


@pytest.mark.parametrize("split", ["one", "mid-hub", "edge-first",
                                   "zero-run", "every-1000"])
def test_reduce_marks_split_union(marks, split):
    """The marks of consecutive slot ranges, cut mid-way through the
    hub's expansion, at an edge's first slot, around a run of zero-count
    edges or every 1,000 slots, add up to the marks of one range."""
    (src, _, _, _), rest = marks
    offsets = rest[0]
    total = int(offsets[-1])
    counts = torch.diff(offsets, prepend=offsets.new_zeros(1))
    assert int(counts.max()) == 5000 and (counts == 0).sum() > 600
    one = kernels.reduce_marks(torch.zeros_like(src, dtype=torch.uint8),
                               *rest, 0, total)
    assert one.any()
    removed = torch.zeros_like(src, dtype=torch.uint8)
    j0 = 0
    for j1 in slot_splits(offsets.numpy(), src.numpy())[split]:
        kernels.reduce_marks(removed, *rest, j0, j1)
        j0 = j1
    assert j0 == total
    assert torch.equal(removed, one)


def test_reduce_marks_graph_matches_reference(marks):
    """The chunked reduction of marks_graph (its hub and its zero-count
    run) equals the reference's; the hub's implied edges are removed."""
    (src, dst, ovl, V), _ = marks
    want = jchunked(jnp.asarray(src.numpy()), jnp.asarray(dst.numpy()),
                    jnp.asarray(ovl.numpy()), V, MARKS_READ_LEN)
    got = treduce.transitive_reduction_chunked(src, dst, ovl, V,
                                               MARKS_READ_LEN)
    for f in ("src", "dst", "ovl"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    assert int(want.n_edges) == got.n_edges < src.shape[0]
    assert int(want.n_expansions) == got.n_expansions
    kept = set(zip(got.src[: got.n_edges].tolist(),
                   got.dst[: got.n_edges].tolist()))
    h1 = int(src[-1])                 # the hub; h0 -> h1 -> each leaf
    assert sum(a == h1 for a, _ in kept) == 5000
    assert [b for a, b in kept if a == h1 - 1] == [h1]


def test_reduce_marks_range_follows_offsets(marks):
    """The slot range is checked against offsets[-1], which the wrapper
    reads once for a tensor: a change in place is seen, and a range past
    the total raises."""
    (src, _, _, _), rest = marks
    offsets = rest[0].clone()
    total = int(offsets[-1])
    removed = torch.zeros_like(src, dtype=torch.uint8)
    kernels.reduce_marks(removed, offsets, *rest[1:], 0, total)
    with pytest.raises(ValueError, match="outside"):
        kernels.reduce_marks(removed, offsets, *rest[1:], 0, total + 1)
    offsets[-1] -= 1                  # the last edge loses its last slot
    with pytest.raises(ValueError, match="outside"):
        kernels.reduce_marks(removed, offsets, *rest[1:], 0, total)
    kernels.reduce_marks(removed, offsets, *rest[1:], 0, total - 1)
