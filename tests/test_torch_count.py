"""sage2_tpu_torch k-mer counting and lookups against sage2_tpu (CPU;
exact equality)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.data import simulate_genome, simulate_reads
from sage2_tpu.kmer import count as jcount
from sage2_tpu.kmer.correct import prune_table_for_correction as jprune
from sage2_tpu_torch import kernels
from sage2_tpu_torch.kmer import count as tcount
from sage2_tpu_torch.kmer.correct import prune_table_for_correction as tprune
from torch_kernel_cases import (
    SIGNED_CASES,
    UNSIGNED_CASES,
    lookup_case,
    oracle_lookup,
)
from torch_one_thread import one_thread  # noqa: F401


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


def _split(keys):
    """The reference's (hi, lo) uint32 halves of int64 keys >= 0."""
    return (jnp.asarray((keys >> 32).astype(np.uint32)),
            jnp.asarray((keys & 0xFFFFFFFF).astype(np.uint32)))


def _tables(case):
    """(reference table, port table, queries): the count tables of
    simulated reads (whole, or pruned at 2), or a synthetic table of
    kernel K2's edge cases (tests/torch_kernel_cases.py) - every key but
    one in the first bucket, one key, queries just outside the keys'
    span, keys over all 50 bits."""
    if case in ("full", "pruned"):
        reads = _reads(5)
        jt = jcount.count_kmers(jnp.asarray(reads), 25)
        tt = tcount.count_kmers(torch.from_numpy(reads), 25)
        if case == "pruned":
            jt, tt = jprune(jt, 2), tprune(tt, 2)
        rng = np.random.default_rng(9)
        present = _ref_keys(jt, int(jt.n_unique))
        q = np.concatenate([present[rng.integers(0, len(present), 500)],
                            rng.integers(0, 1 << 50, 496),
                            np.zeros(4, np.int64)]).reshape(-1, 8)
        return jt, tt, q
    keys, counts, q = lookup_case(case)
    jt = jcount.KmerTable(*_split(keys), jnp.asarray(counts),
                          jnp.int32(len(keys)), 25)
    tt = tcount.KmerTable(torch.from_numpy(keys), torch.from_numpy(counts),
                          len(keys), 25)
    return jt, tt, q


@pytest.mark.parametrize("case", [pytest.param("full", id="False"),
                                  pytest.param("pruned", id="True"),
                                  *UNSIGNED_CASES])
def test_lookup_counts_matches_reference(case):
    jt, tt, q = _tables(case)
    want = jcount.lookup_counts(jt, *_split(q))
    got = tcount.lookup_counts(tt, torch.from_numpy(q))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.shape == q.shape


@pytest.mark.parametrize("case", UNSIGNED_CASES + SIGNED_CASES)
def test_lookup_counts_plain_edges(case):
    """The plain version (what a CPU tensor takes) on kernel K2's edge
    cases against a dictionary: negative keys and the int64 extremes too,
    which the reference's uint32 halves cannot carry."""
    keys, counts, q = lookup_case(case)
    got = kernels.lookup_counts(torch.from_numpy(keys),
                                torch.from_numpy(counts), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), oracle_lookup(keys, counts, q))


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
