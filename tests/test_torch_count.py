"""sage2_tpu_torch k-mer counting and lookups against sage2_tpu (CPU;
exact equality)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.data import simulate_genome, simulate_reads
from sage2_tpu.kmer import count as jcount
from sage2_tpu.kmer.correct import prune_table_for_correction as jprune
from sage2_tpu_torch.kmer import count as tcount
from sage2_tpu_torch.kmer.correct import prune_table_for_correction as tprune


def _reads(seed, err=0.01):
    g = simulate_genome(4000, seed=seed)
    r, _ = simulate_reads(g, read_len=80, coverage=20, error_rate=err,
                          seed=seed + 1)
    return r.astype(np.int32)


def _ref_keys(t, n):
    return (np.asarray(t.hi)[:n].astype(np.int64) << 32) | np.asarray(
        t.lo)[:n].astype(np.int64)


@pytest.mark.parametrize("k", [21, 25, 31])
def test_count_kmers_matches_reference(k):
    reads = _reads(3)
    jt = jcount.count_kmers(jnp.asarray(reads), k)
    tt = tcount.count_kmers(torch.from_numpy(reads), k)
    n = int(jt.n_unique)
    assert tt.n_unique == n
    np.testing.assert_array_equal(_ref_keys(jt, n), tt.keys.numpy())
    np.testing.assert_array_equal(np.asarray(jt.count)[:n], tt.count.numpy())


@pytest.mark.parametrize("pruned", [False, True])
def test_lookup_counts_matches_reference(pruned):
    reads = _reads(5)
    jt = jcount.count_kmers(jnp.asarray(reads), 25)
    tt = tcount.count_kmers(torch.from_numpy(reads), 25)
    if pruned:
        jt, tt = jprune(jt, 2), tprune(tt, 2)
    rng = np.random.default_rng(9)
    present = _ref_keys(jt, int(jt.n_unique))
    q = np.concatenate([present[rng.integers(0, len(present), 500)],
                        rng.integers(0, 1 << 50, 496),
                        np.zeros(4, np.int64)]).reshape(-1, 8)
    want = jcount.lookup_counts(
        jt, jnp.asarray((q >> 32).astype(np.uint32)),
        jnp.asarray((q & 0xFFFFFFFF).astype(np.uint32)))
    got = tcount.lookup_counts(tt, torch.from_numpy(q))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.shape == q.shape


def test_count_rejects_ragged():
    """Ragged reads were refused before they were ported; now windows
    past a read's end are left out of the count, as in the reference."""
    reads = _reads(7)[:50, :40].copy()
    lens = np.array([40, 30] * 25, np.int32)
    reads[np.arange(40)[None, :] >= lens[:, None]] = 0
    jt = jcount.count_kmers(jnp.asarray(reads), 25, lengths=jnp.asarray(lens))
    tt = tcount.count_kmers(torch.from_numpy(reads), 25,
                            lengths=torch.from_numpy(lens))
    n = int(jt.n_unique)
    assert tt.n_unique == n < tcount.count_kmers(torch.from_numpy(reads),
                                                 25).n_unique
    np.testing.assert_array_equal(_ref_keys(jt, n), tt.keys.numpy())
    np.testing.assert_array_equal(np.asarray(jt.count)[:n], tt.count.numpy())
