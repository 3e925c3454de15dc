"""The benches' stacked overlap path of sage2_tpu_torch against sage2_tpu,
on the CPU: find_overlaps_stacked (kernels K13 and K3 in their
fixed-capacity modes, K14 in its deferred mode), the deferred reduction
and the host compaction.

Inputs are made with numpy from a seed (the reference's own stacked
tests' recipes, tests/test_overlap.py:249-343) and handed to both
packages. Tolerance: exact equality (integer programs), dtypes included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.data import simulate_genome, simulate_reads
from sage2_tpu.overlap import detect as jdetect
from sage2_tpu.overlap import prepare_reads as jprepare
from sage2_tpu_torch import kernels
from sage2_tpu_torch.kernels import plain
from sage2_tpu_torch.overlap import compact_stacked_result
from sage2_tpu_torch.overlap import detect as tdetect
from sage2_tpu_torch.overlap import find_overlaps, find_overlaps_stacked
from torch_kernel_cases import REDUCE_CASES, reduce_case
from torch_one_thread import one_thread  # noqa: F401

I32_MAX = 2**31 - 1
FIELDS = ("src", "dst", "ovl", "n_edges", "n_candidates", "n_verified",
          "overflow", "n_dups")


def _shards(K=3):
    """K prepared shards of the reference's stacked test, padded to one M
    with invalid rows."""
    shards = []
    for k in range(K):
        genome = simulate_genome(400, seed=31 + k)
        reads, _ = simulate_reads(genome, read_len=40, coverage=10,
                                  error_rate=0.005, seed=41 + k)
        rs = jprepare(jnp.asarray(reads.astype(np.int32)))
        shards.append((np.asarray(rs.reads2), np.asarray(rs.valid2)))
    M = max(r.shape[0] for r, _ in shards)
    reads3 = np.zeros((K, M, shards[0][0].shape[1]), np.int32)
    valid3 = np.zeros((K, M), bool)
    for k, (r, v) in enumerate(shards):
        reads3[k, : r.shape[0]] = r
        valid3[k, : v.shape[0]] = v
    return reads3, valid3


def _poly_t_reads():
    """The reference's poly-T seed reads (tests/test_overlap.py:294-313):
    their all-T 32-base seeds carry the all-ones key."""
    rng = np.random.default_rng(51)
    genome = np.asarray(rng.integers(0, 4, size=400), np.int8)
    genome[100:180] = 3
    starts = np.arange(0, 400 - 60, 7)
    return np.stack([genome[s : s + 60] for s in starts]).astype(np.int32)


def _periodic_reads():
    """Two reads of period 3 (tests/test_overlap.py:316-343): one pair
    verifies at two overlap lengths."""
    rng = np.random.default_rng(61)
    unit = np.array([0, 1, 2], np.int32)
    A = np.concatenate([rng.integers(0, 4, 15), np.tile(unit, 3)])
    B = np.tile(unit, 8)
    return np.stack([A, B]).astype(np.int32)


def _both(reads3, valid3, min_overlap, capacity):
    j = jdetect.find_overlaps_stacked(jnp.asarray(reads3),
                                      jnp.asarray(valid3), min_overlap,
                                      capacity=capacity)
    t = find_overlaps_stacked(torch.from_numpy(reads3),
                              torch.from_numpy(valid3), min_overlap,
                              capacity=capacity, device="cpu")
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _assert_fields_equal(j, t):
    assert len(j) == len(t) == 8
    for name, x, y in zip(FIELDS, j, t):
        assert x.dtype == y.dtype, (name, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=name)


def _assert_row_is_find_overlaps(t, k, res):
    for i, name in enumerate(FIELDS):
        want = getattr(res, name)
        got = t[i][k]
        if isinstance(want, torch.Tensor):
            np.testing.assert_array_equal(got, want.numpy(), err_msg=name)
        else:
            assert got == want, (name, got, want)


def test_stacked_matches_reference_and_find_overlaps():
    """All 8 fields of three shards bit-equal to the reference's, and
    each shard's row equal to the port's find_overlaps at that
    capacity, deferred and (no duplicates here) compacted alike."""
    reads3, valid3 = _shards()
    cap = 1 << 14
    j, t = _both(reads3, valid3, 20, cap)
    _assert_fields_equal(j, t)
    assert not t[6].any() and t[5].min() > 0 and not t[7].any()
    for k in range(reads3.shape[0]):
        args = (torch.from_numpy(reads3[k]), torch.from_numpy(valid3[k]), 20)
        _assert_row_is_find_overlaps(
            t, k, find_overlaps(*args, capacity=cap, defer_dup_compact=True))
        _assert_row_is_find_overlaps(t, k, find_overlaps(*args,
                                                         capacity=cap))


def test_stacked_overflow_matches_reference():
    """A capacity below the candidates: the first C slots reduced, the
    overflow flag and the full candidate count, as the reference's."""
    reads3, valid3 = _shards(2)
    j, t = _both(reads3, valid3, 20, 200)
    _assert_fields_equal(j, t)
    assert t[6].all() and (t[4] > 200).all()


def test_stacked_periodic_duplicates_and_compaction():
    """Periodic reads verify one pair at two lengths: n_dups > 0 in both
    packages, the same deferred arrays, and the same arrays after
    compact_stacked_result, which are find_overlaps' compacted ones."""
    reads = _periodic_reads()
    reads3, valid3 = reads[None], np.ones((1, 2), bool)
    j, t = _both(reads3, valid3, 6, 256)
    _assert_fields_equal(j, t)
    assert t[7][0] > 0
    want = jdetect.compact_stacked_result(
        tuple(jnp.asarray(x) for x in j), reads.shape[1])
    got = compact_stacked_result(
        tuple(torch.from_numpy(x) for x in t), reads.shape[1])
    for x, y in zip(want, got):
        np.testing.assert_array_equal(x, y)
        assert y.dtype == np.int32
    res = find_overlaps(torch.from_numpy(reads), torch.ones(2, dtype=bool), 6,
                        capacity=256)
    assert res.n_dups == 0 and t[3][0] == res.n_edges
    for y, name in zip(got, ("src", "dst", "ovl")):
        np.testing.assert_array_equal(y[0], getattr(res, name).numpy())
    deferred = find_overlaps(torch.from_numpy(reads),
                             torch.ones(2, dtype=bool), 6, capacity=256,
                             defer_dup_compact=True)
    _assert_row_is_find_overlaps(t, 0, deferred)


@pytest.mark.parametrize("min_overlap", [30, 40])
def test_stacked_poly_t_seeds_with_dead_rows(min_overlap):
    """All-T 32-base seeds (min_overlap 40) share the key INT64_MAX with
    the fixed buffer's dead rows: with every third read invalid in the
    second shard (dead rows behind live all-T rows) both shards still
    match the reference, and find_overlaps; their periodic reads leave
    duplicate rows, compacted as find_overlaps compacts them. At 30 the
    seed is 30 bases (the reference's own test)."""
    reads = _poly_t_reads()
    M = reads.shape[0]
    reads3 = np.stack([reads, reads])
    valid3 = np.ones((2, M), bool)
    valid3[1, ::3] = False
    if min_overlap == 40:
        geo = tdetect.join_geometry(60, 40, 32)
        keys, _, _, n_live = kernels.seed_rows_stacked(
            torch.from_numpy(reads3[1]), torch.from_numpy(valid3[1]), 32,
            geo.g, geo.n_pos, geo.trim)
        n = int(n_live)
        assert n < keys.shape[0] and bool(
            (keys[:n] == plain.I64_MAX).any())
    j, t = _both(reads3, valid3, min_overlap, 1 << 14)
    _assert_fields_equal(j, t)
    assert t[5][0] > t[5][1] > 0 and t[7].all()
    compacted = compact_stacked_result(
        tuple(torch.from_numpy(x) for x in t), reads.shape[1])
    for k in range(2):
        args = (torch.from_numpy(reads3[k]), torch.from_numpy(valid3[k]),
                min_overlap)
        _assert_row_is_find_overlaps(
            t, k, find_overlaps(*args, capacity=1 << 14,
                                defer_dup_compact=True))
        res = find_overlaps(*args, capacity=1 << 14)
        for y, name in zip(compacted, ("src", "dst", "ovl")):
            np.testing.assert_array_equal(y[k], getattr(res, name).numpy())


@pytest.mark.parametrize("case", REDUCE_CASES + ("fallback",))
def test_reduce_fused_deferred_matches_reference(case):
    """_reduce_fused(defer_dup_compact=True) against the reference's:
    every ok row kept in (src, dst, ovl) order, the keepers and the
    duplicate rows counted; at read_len 2^26 with 64 vertices (and at
    ids near 2^30) the reference's fallback, the compacted list with
    n_dups 0."""
    if case == "fallback":
        ok, a, b, ovl, _, V, cap = reduce_case("periodic")
        L = 1 << 26
    else:
        ok, a, b, ovl, L, V, cap = reduce_case(case)
    j = jdetect._reduce_fused(*(jnp.asarray(x) for x in (ok, a, b, ovl)), L,
                              V, defer_dup_compact=True)
    t = tdetect._reduce_fused(*(torch.from_numpy(x) for x in (ok, a, b, ovl)),
                              L, cap, V, defer_dup_compact=True)
    fallback = V >= 1 << (31 - L.bit_length())
    assert fallback == (case in ("fallback", "wide"))
    n = ok.shape[0]
    for x, y, fill in zip(j[:3], t[:3], (I32_MAX, I32_MAX, 0)):
        assert y.dtype == torch.int32 and y.shape == (cap,)
        np.testing.assert_array_equal(np.asarray(x), y[:n].numpy())
        assert bool((y[n:] == fill).all())
    for x, y in zip(j[3:], t[3:]):
        assert y.dtype == torch.int32 and y.shape == ()
        assert int(x) == int(y)
    if case in ("periodic", "fallback"):
        assert int(t[4]) == (0 if fallback else int(ok.sum()) - int(t[3]))
        assert int(t[3]) > 0 and (fallback or int(t[4]) > 0)
    # written into the stacked path's preallocated rows, fallback or not
    out = tuple(torch.empty(cap, dtype=torch.int32) for _ in range(3))
    again = tdetect._reduce_fused(
        *(torch.from_numpy(x) for x in (ok, a, b, ovl)), L, cap, V,
        defer_dup_compact=True, out=out)
    assert all(x is y for x, y in zip(again[:3], out))
    assert all(torch.equal(x, y) for x, y in zip(again, t))


def _rows_case(invalid_every=0, poly_t=False):
    if poly_t:
        reads = _poly_t_reads()
        min_overlap = 40
    else:
        genome = simulate_genome(3000, seed=9)
        reads, _ = simulate_reads(genome, read_len=60, coverage=8,
                                  error_rate=0.01, seed=10)
        reads = reads.astype(np.int32)
        min_overlap = 25
    valid = np.ones(reads.shape[0], bool)
    if invalid_every:
        valid[::invalid_every] = False
    L = reads.shape[1]
    s = min(32, min_overlap)
    geo = tdetect.join_geometry(L, min_overlap, s)
    return torch.from_numpy(reads), torch.from_numpy(valid), s, geo, \
        min_overlap


@pytest.mark.parametrize("invalid_every,poly_t", [(0, False), (4, False),
                                                  (3, True)])
def test_seed_rows_stacked_plain_is_seed_rows(invalid_every, poly_t):
    """K13's fixed-capacity mode: the first n_live rows are seed_rows'
    sorted live rows, the rest dead (key INT64_MAX, id -1)."""
    r, v, s, geo, _ = _rows_case(invalid_every, poly_t)
    keys, rows, payload, n_live = kernels.seed_rows_stacked(
        r, v, s, geo.g, geo.n_pos, geo.trim)
    want = kernels.seed_rows(r, v, None, s, geo.g, geo.n_pos, geo.trim)
    n = want[0].shape[0]
    assert n_live.dtype == torch.int64 and n_live.shape == () and \
        int(n_live) == n
    assert keys.shape == rows.shape == (r.shape[0] * geo.R,)
    assert torch.equal(keys[:n], want[0]) and torch.equal(rows[:n], want[1])
    assert torch.equal(payload, want[2])
    assert bool((keys[n:] == plain.I64_MAX).all())
    assert bool((rows[n:] == -1).all())
    if poly_t:      # live all-T rows sit before the dead ones
        assert int((keys[:n] == plain.I64_MAX).sum()) > 0
    if invalid_every:
        assert n < keys.shape[0]


@pytest.mark.parametrize("capacity", ["below", "equal", "above"])
@pytest.mark.parametrize("invalid_every,poly_t", [(0, False), (4, False),
                                                  (3, True)])
def test_overlap_join_stacked_plain_is_overlap_join(invalid_every, poly_t,
                                                    capacity):
    """K3's fixed-capacity mode over K13's fixed buffer: the first
    min(total, C) slots are overlap_join's with that slot limit, the
    rest not ok with a, b and ovl 0; total a 0-d int64 tensor."""
    r, v, s, geo, min_overlap = _rows_case(invalid_every, poly_t)
    keys, rows, payload, n_live = kernels.seed_rows_stacked(
        r, v, s, geo.g, geo.n_pos, geo.trim)
    flat = payload.reshape(-1, geo.Wt + 2)
    n = int(n_live)
    total = kernels.overlap_join(keys[:n], rows[:n], flat, geo.R, geo.g,
                                 geo.trim, min_overlap)[4]
    C = {"below": total // 2, "equal": total, "above": total + 999}[capacity]
    got = kernels.overlap_join_stacked(keys, rows, flat, n_live, geo.R,
                                       geo.g, geo.trim, min_overlap, C)
    want = kernels.overlap_join(keys[:n], rows[:n], flat, geo.R, geo.g,
                                geo.trim, min_overlap, None, C)
    assert got[4].dtype == torch.int64 and int(got[4]) == want[4] == total
    m = min(total, C)
    for x, y in zip(got[:4], want[:4]):
        assert x.shape == (C,) and x.dtype == y.dtype
        assert torch.equal(x[:m], y)
        assert not bool(x[m:].any())
    assert bool(got[0].any())
