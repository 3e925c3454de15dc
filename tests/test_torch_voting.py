"""sage2_tpu_torch.kmer.correct_reads under both rules against the
reference's dense correct_reads and the oracles (CPU; byte-equal reads).

The port's single_window rule runs the two-phase path and its
vote_all_windows rule kernel K5's plain version; the reference runs its
dense jitted correctors (_correct_impl, _correct_voting_impl).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.data import simulate_genome, simulate_reads
from sage2_tpu.kmer import correct_reads as jcorrect
from sage2_tpu.kmer.count import count_kmers as jcount
from sage2_tpu.refmodel.oracle import oracle_correct, oracle_correct_voting
from sage2_tpu_torch.kmer import correct_reads as tcorrect
from sage2_tpu_torch.kmer import count_kmers as tcount
from torch_one_thread import one_thread  # noqa: F401


def _reads(seed, n_genome=4000, L=80, cov=20, err=0.015):
    g = simulate_genome(n_genome, seed=seed)
    r, _ = simulate_reads(g, read_len=L, coverage=cov, error_rate=err,
                          seed=seed + 1)
    return r.astype(np.int32)


@pytest.mark.parametrize("rule", ["single_window", "vote_all_windows"])
@pytest.mark.parametrize("k,rounds,threshold,with_table", [
    (25, 2, 2, True), (21, 1, 3, False),
])
def test_correct_reads_matches_dense_reference(rule, k, rounds, threshold,
                                               with_table):
    r = _reads(40 + k)
    jt = jcount(jnp.asarray(r), k) if with_table else None
    tt = tcount(torch.from_numpy(r), k) if with_table else None
    want = np.asarray(jcorrect(jnp.asarray(r), k, threshold, rounds,
                               table=jt, rule=rule))
    got = tcorrect(torch.from_numpy(r), k, threshold, rounds, table=tt,
                   rule=rule).numpy()
    assert (want != r).sum() > 0          # the input had errors to fix
    np.testing.assert_array_equal(want, got)


def test_voting_round_zero_uses_the_given_table():
    """Round 0 votes against the table it is given, later rounds
    recount: a table from other reads changes the first round only."""
    r = _reads(71)
    other = _reads(72)
    want = np.asarray(jcorrect(jnp.asarray(r), 25, 2, 2,
                               table=jcount(jnp.asarray(other), 25),
                               rule="vote_all_windows"))
    got = tcorrect(torch.from_numpy(r), 25, 2, 2,
                   table=tcount(torch.from_numpy(other), 25),
                   rule="vote_all_windows").numpy()
    np.testing.assert_array_equal(want, got)
    plain = tcorrect(torch.from_numpy(r), 25, 2, 2,
                     rule="vote_all_windows").numpy()
    assert (plain != got).any()


@pytest.mark.parametrize("rule,oracle", [
    ("single_window", oracle_correct),
    ("vote_all_windows", oracle_correct_voting),
])
def test_correct_reads_matches_oracle(rule, oracle):
    r = _reads(81, n_genome=600, L=40, cov=8, err=0.02)
    want = oracle(r, 13, 2, 2)
    got = tcorrect(torch.from_numpy(r), 13, 2, 2, rule=rule).numpy()
    assert (want != r).sum() > 0
    np.testing.assert_array_equal(want, got)


def test_unknown_rule_and_ragged_raise():
    """An unknown rule raises. Ragged reads, refused before they were
    ported, now vote as in the reference: full lengths give the fixed
    result."""
    r = torch.from_numpy(_reads(91, n_genome=500, L=40, cov=4))
    with pytest.raises(ValueError, match="unknown correction rule"):
        tcorrect(r, 15, 2, 1, rule="majority")
    got = tcorrect(r, 15, 2, 1, lengths=torch.full((r.shape[0],), 40),
                   rule="vote_all_windows")
    np.testing.assert_array_equal(
        got.numpy(), tcorrect(r, 15, 2, 1, rule="vote_all_windows").numpy())
