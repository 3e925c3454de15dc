"""The two-phase corrector's kernels K15 (``prune_table``), K16
(``weak_windows``) and K17 (``fix_windows``) through their plain versions
on the CPU, against sage2_tpu's ``_prune_impl``, ``_phase1_kernel`` and
``_phase2_kernel`` on CPU JAX, and ``twophase_round`` against the
reference's: exact equality. The cases (tests/torch_kernel_cases.py,
made with numpy from a seed) hold a table where no window is weak
("clean"), one where a weak window's variants tie at the maximum
("tie"), ragged reads ("short", "sim_ragged"), an unpruned table and an
empty one, at k = 15 and 25 (and 31)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.kmer import correct as jcorrect
from sage2_tpu.kmer.count import KmerTable as JTable
from sage2_tpu_torch import kernels
from sage2_tpu_torch.data import simulate_genome, simulate_ragged_reads
from sage2_tpu_torch.kmer import correct as tcorrect
from sage2_tpu_torch.kmer.count import KmerTable
from torch_kernel_cases import VOTE_CASES, count_table, vote_case
from torch_one_thread import one_thread  # noqa: F401

CASES = VOTE_CASES + ("sim_ragged",)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _jtable(keys, counts, k):
    return JTable(jnp.asarray((keys >> 32).astype(np.uint32)),
                  jnp.asarray((keys & 0xFFFFFFFF).astype(np.uint32)),
                  jnp.asarray(counts), jnp.int32(len(keys)), k)


def _case(case, k):
    """(reads, lengths, keys, counts, k, threshold) of a case."""
    if case == "sim_ragged":
        g = simulate_genome(2500, seed=17)
        reads, lengths = simulate_ragged_reads(g, 40, 70, 14, 0.01, seed=18)
        reads = reads.astype(np.int32)
        keys, counts = count_table(reads, k, lengths, 2)
        return reads, lengths, keys, counts, k, 2
    reads, lengths, keys, counts, k, threshold, _ = vote_case(case, k=k)
    return reads, lengths, keys, counts, k, threshold


@pytest.mark.parametrize("threshold", [1, 2, 3])
def test_prune_table_matches_reference(threshold):
    """K15 keeps the entries with count >= threshold in table order: the
    reference's masked sort gives the same first n_keep rows."""
    reads, lengths, keys, counts, k, _ = _case("sim_ragged", 25)
    keys, counts = count_table(reads, k, lengths)        # unpruned
    jt = _jtable(keys, counts, k)
    s_hi, s_lo, s_cnt, n = jcorrect._prune_impl(jt.hi, jt.lo, jt.count,
                                                threshold)
    n = int(n)
    want = ((np.asarray(s_hi)[:n].astype(np.int64) << 32)
            | np.asarray(s_lo)[:n].astype(np.int64))
    got_keys, got_counts = kernels.prune_table(_t(keys), _t(counts),
                                               threshold)
    np.testing.assert_array_equal(got_keys.numpy(), want)
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(s_cnt)[:n])
    assert (n < len(keys)) == (threshold > 1)
    pruned = tcorrect.prune_table_for_correction(
        KmerTable(_t(keys), _t(counts), len(keys), k), threshold)
    assert pruned.n_unique == n and torch.equal(pruned.keys, got_keys)


@pytest.mark.parametrize("edge", ["keep_all", "keep_none", "one_entry"])
def test_prune_table_edges_match_reference(edge):
    """K15 at the edges of its compaction: a threshold that keeps every
    entry, one that keeps none, and a table of one entry (kept and not)."""
    rng = np.random.default_rng(23)
    keys = np.unique(rng.integers(0, 1 << 50, size=300)).astype(np.int64)
    counts = rng.integers(1, 9, size=keys.size).astype(np.int32)
    if edge == "one_entry":
        keys, counts = keys[:1], np.array([4], np.int32)
    thresholds = {"keep_all": [int(counts.min()), 0],
                  "keep_none": [int(counts.max()) + 1, 1 << 30],
                  "one_entry": [4, 5]}[edge]
    jt = _jtable(keys, counts, 25)
    for threshold in thresholds:
        s_hi, s_lo, s_cnt, n = jcorrect._prune_impl(jt.hi, jt.lo, jt.count,
                                                    threshold)
        n = int(n)
        want = ((np.asarray(s_hi)[:n].astype(np.int64) << 32)
                | np.asarray(s_lo)[:n].astype(np.int64))
        got_keys, got_counts = kernels.prune_table(_t(keys), _t(counts),
                                                   threshold)
        np.testing.assert_array_equal(got_keys.numpy(), want)
        np.testing.assert_array_equal(got_counts.numpy(),
                                      np.asarray(s_cnt)[:n])
        kept = {"keep_all": keys.size, "keep_none": 0,
                "one_entry": int(threshold <= 4)}[edge]
        assert n == kept


@pytest.mark.parametrize("k", [15, 25])
@pytest.mark.parametrize("case", CASES)
def test_phases_match_reference(case, k):
    """K16's weak windows equal the reference's phase 1 (its sorted flat
    indices up to n_weak), and K17's edits at them its phase 2, for the
    forward (last base) and the backward (first base) sub-pass."""
    reads, lengths, keys, counts, k, threshold = _case(case, k)
    jt = _jtable(keys, counts, k)
    N, L = reads.shape
    P = L - k + 1
    lens = (jnp.asarray(lengths) if lengths is not None
            else jnp.zeros((N,), jnp.int32))
    s_idx, n_weak = jcorrect._phase1_kernel(k, threshold,
                                            lengths is not None)(
        jnp.asarray(reads), jt.hi, jt.lo, jt.count, jt.n_unique, lens)
    n_weak = int(n_weak)
    want = np.asarray(s_idx)[:n_weak]
    got = kernels.weak_windows(_t(reads), _t(lengths), _t(keys), _t(counts),
                               None, k, threshold)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (n_weak == 0) == (case == "clean")
    # the reference pads the weak list past n_weak with N * P (no edit)
    padded = np.concatenate([want, np.full(3, N * P, want.dtype)])
    for which in ("last", "first"):
        ref = np.asarray(jcorrect._phase2_kernel(k, threshold, which)(
            jnp.asarray(reads), jt.hi, jt.lo, jt.count, jt.n_unique,
            jnp.asarray(padded)))
        out = kernels.fix_windows(_t(reads), got, _t(keys), _t(counts), None,
                                  k, threshold, which).numpy()
        np.testing.assert_array_equal(out, ref)
        if case in ("clean", "tie", "empty"):
            np.testing.assert_array_equal(out, reads)


@pytest.mark.parametrize("case,k", [(c, 25 if i % 2 else 15)
                                    for i, c in enumerate(CASES)])
def test_twophase_round_matches_reference(case, k):
    """One forward + backward round (K16, K17, K16, K17 around one bucket
    directory) equals the reference's twophase_round."""
    reads, lengths, keys, counts, k, threshold = _case(case, k)
    jt = _jtable(keys, counts, k)
    want = np.asarray(jcorrect.twophase_round(
        jnp.asarray(reads), jt, k, threshold,
        None if lengths is None else jnp.asarray(lengths)))
    got = tcorrect.twophase_round(
        _t(reads), KmerTable(_t(keys), _t(counts), len(keys), k), k,
        threshold, _t(lengths)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != reads).any() == (case not in ("clean", "tie", "empty"))
