"""sage2_tpu_torch dedup and overlap detection against sage2_tpu and the
brute-force oracle (CPU; exact equality)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.data import simulate_genome, simulate_reads
from sage2_tpu.overlap import find_overlaps as jfind
from sage2_tpu.overlap import find_overlaps_auto as jfind_auto
from sage2_tpu.overlap import prepare_reads as jprepare
from sage2_tpu.refmodel.oracle import oracle_overlaps
from sage2_tpu_torch.overlap import find_overlaps as tfind
from sage2_tpu_torch.overlap import find_overlaps_auto as tfind_auto
from sage2_tpu_torch.overlap import prepare_reads as tprepare


def _reads(seed, n_genome=3000, L=60, cov=15, err=0.0):
    g = simulate_genome(n_genome, seed=seed)
    r, _ = simulate_reads(g, read_len=L, coverage=cov, error_rate=err,
                          seed=seed + 1)
    return r.astype(np.int32)


def test_prepare_reads_all_fields_match_reference():
    reads = _reads(21, err=0.01)
    # exact and reverse-complement duplicates
    reads = np.concatenate([reads, reads[:7], (3 - reads[3:9])[:, ::-1]])
    j = jprepare(jnp.asarray(reads))
    t = tprepare(torch.from_numpy(reads))
    assert t.n_unique == int(j.n_unique)
    for f in ("reads2", "valid2", "multiplicity", "vertex_of_read"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=f)


def _edges(res, n):
    return {(int(a), int(b)): int(v) for a, b, v in zip(
        np.asarray(res.src)[:n], np.asarray(res.dst)[:n],
        np.asarray(res.ovl)[:n])}


@pytest.mark.parametrize("min_overlap,err,L", [(40, 0.0, 60), (30, 0.01, 60),
                                               (40, 0.005, 100)])
def test_find_overlaps_auto_matches_reference(min_overlap, err, L):
    reads = _reads(31, L=L, err=err)
    j = jprepare(jnp.asarray(reads))
    t = tprepare(torch.from_numpy(reads))
    jr = jfind_auto(j.reads2, j.valid2, min_overlap, 32)
    tr = tfind_auto(t.reads2, t.valid2, min_overlap, 32)
    assert (tr.n_edges, tr.n_candidates, tr.n_verified) == (
        int(jr.n_edges), int(jr.n_candidates), int(jr.n_verified))
    for f in ("src", "dst", "ovl"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                      getattr(tr, f).numpy(), err_msg=f)


@pytest.mark.parametrize("min_overlap,err", [(20, 0.0), (25, 0.01)])
def test_find_overlaps_auto_matches_oracle(min_overlap, err):
    reads = _reads(41, n_genome=500, L=40, cov=12, err=err)
    t = tprepare(torch.from_numpy(reads))
    tr = tfind_auto(t.reads2, t.valid2, min_overlap, 32)
    n_u, cap = t.n_unique, t.capacity
    r2 = t.reads2.numpy()
    expect = oracle_overlaps(
        np.concatenate([r2[:n_u], r2[cap: cap + n_u]]), min_overlap)
    remap = lambda i: i if i < n_u else cap + (i - n_u)  # noqa: E731
    assert _edges(tr, tr.n_edges) == {(remap(a), remap(b)): v
                                      for (a, b), v in expect.items()}


def test_polyT_seeds_and_capacity_overflow_match_reference():
    rng = np.random.default_rng(51)
    genome = np.asarray(rng.integers(0, 4, size=400), np.int8)
    genome[100:180] = 3                  # all-T seeds: the all-ones key
    reads = np.stack([genome[s: s + 60] for s in range(0, 340, 7)]
                     ).astype(np.int32)
    valid = np.ones(reads.shape[0], bool)
    for cap in (1 << 14, 64):            # the second one overflows
        jr = jfind(jnp.asarray(reads), jnp.asarray(valid), 30, 32,
                   capacity=cap)
        tr = tfind(torch.from_numpy(reads), torch.from_numpy(valid), 30, 32,
                   capacity=cap)
        assert tr.overflow == bool(jr.overflow) == (cap == 64)
        assert (tr.n_edges, tr.n_candidates, tr.n_verified) == (
            int(jr.n_edges), int(jr.n_candidates), int(jr.n_verified))
        for f in ("src", "dst", "ovl"):
            np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                          getattr(tr, f).numpy())
    full = tfind(torch.from_numpy(reads), torch.from_numpy(valid), 30, 32,
                 capacity=1 << 14)
    assert _edges(full, full.n_edges) == oracle_overlaps(reads, 30)
