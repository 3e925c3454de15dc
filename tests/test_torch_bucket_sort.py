"""The bucketed sort K12, K13 and K14 share (kernels/csrc/bucket_sort.cuh),
on the CPU: its host-side plan (kernels/bucket_plan.py, K12's passes and
bucket bits among it; K17's tile size beside it), and a plain mirror of
the order it gives, held to the plain versions' stable sorts and to the
reference's (K12's order: tests/test_torch_dedup_seed_rows.py).

The mirror takes the rows in an arbitrary order (the scatters' shared-
memory atomics fix none), puts each in its bucket by the kernels' bucket
function, and sorts each bucket by its whole unique key; for K14 it
places the keepers, the duplicates' padding and the fill as the kernel
does. How a bucket is sorted on the card (in a block, or by the whole
grid past a block) is held to the plain versions by the card tests.
Inputs are made with numpy from a seed. Tolerance: exact equality
(integer programs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.overlap import detect as jdetect
from sage2_tpu_torch import kernels
from sage2_tpu_torch.kernels import bucket_plan, plain
from sage2_tpu_torch.overlap import detect as tdetect
from torch_kernel_cases import REDUCE_CASES, reduce_case, seed_case
from torch_one_thread import one_thread  # noqa: F401

U64 = (1 << 64) - 1
SIGN = 1 << 63
I32_MAX = 2**31 - 1
QUERY_TAG = 1 << 31


# --- the kernels' bucket functions, and the mirror ---------------------------

def _u(key: int) -> int:
    return (key & U64) ^ SIGN


def _signed(u: int) -> int:
    k = u ^ SIGN
    return k - (1 << 64) if k >= SIGN else k


def seed_bucket(key: int, d: int) -> int:
    """K13's bucket of a stored seed key (top bit flipped): the top d bits
    of the unflipped key (seed_rows.cu SeedSource::fine_of)."""
    return _u(key) >> (64 - d) if d else 0


def edge_bucket(src: int, lo: int, span: int, d: int) -> int:
    """K14's bucket of a source over the range [lo, lo + span)
    (longest_edges.cu SrcRange): (src - lo) * m >> 32, m = 2^(32 + d) //
    span, sources below lo in bucket 0, past the range in the last."""
    m = (1 << (32 + d)) // span
    x = src - lo
    return 0 if x <= 0 else min((x * m) >> 32, (1 << d) - 1)


def _bucketed(elems, buckets, d):
    """(each bucket's first slot, each bucket's rows sorted, the rows
    bucket by bucket): the order of the scan, the scatters and the
    sort."""
    members = [[] for _ in range(1 << d)]
    for e, b in zip(elems, buckets):
        members[b].append(e)
    members = [sorted(m) for m in members]
    offsets = np.cumsum([0] + [len(m) for m in members])[:-1].tolist()
    return offsets, members, [e for m in members for e in m]


def _seed_mirror(keys, tags, ids, d):
    """K13's sorted (keys, ids) from live rows in any order."""
    elems = [(_u(k), (t << 32) | i) for k, t, i in zip(keys, tags, ids)]
    _, _, out = _bucketed(elems, [seed_bucket(k, d) for k in keys], d)
    return ([_signed(hi) for hi, _ in out],
            [lo & 0xFFFFFFFF for _, lo in out])


def _tag(i: int, R: int, g: int) -> int:
    return (QUERY_TAG if i % R >= g else 0) | i


# --- the plan ----------------------------------------------------------------

def test_bucket_bits():
    """The fewest bits that bring the average bucket to FILL of a block,
    capped; monotone in n."""
    per = int(bucket_plan.BLOCK * bucket_plan.FILL)
    assert bucket_plan.BLOCK == bucket_plan.SORT_THREADS * bucket_plan.ITEMS
    assert bucket_plan.bucket_bits(0) == 0
    assert bucket_plan.bucket_bits(per) == 0
    assert bucket_plan.bucket_bits(per + 1) == 1
    assert bucket_plan.bucket_bits(per << 5) == 5
    assert bucket_plan.bucket_bits((per << 5) + 1) == 6
    assert bucket_plan.bucket_bits(1 << 40) == bucket_plan.MAX_BUCKET_BITS
    prev = 0
    for n in np.unique(np.geomspace(1, 1 << 34, 300).astype(np.int64)):
        d = bucket_plan.bucket_bits(int(n))
        assert d >= prev
        prev = d
        if d < bucket_plan.MAX_BUCKET_BITS:
            assert n <= per << d


@pytest.mark.parametrize("L,lb", [(1, 0), (16, 0), (40, 6), (100, 0),
                                  (150, 8), (159, 8), (236, 8), (237, 8),
                                  (300, 9), (1000, 10)])
def test_dedup_passes(L, lb):
    """K12's passes cover the key string's 32-bit words once, its last
    segment first; a pass's element holds its words, the previous pass's
    group id (after the first) and the read's index; one pass takes the
    narrowest width that holds the string and the index, and strings past
    the widest element go in DEDUP_SEGMENT-word passes."""
    S = bucket_plan.dedup_string_words(L, lb)
    assert S == -(-(2 * L + lb) // 32)
    passes = bucket_plan.dedup_passes(L, lb)
    starts = [s0 for s0, _, _ in passes]
    assert starts == sorted(starts, reverse=True) and starts[-1] == 0
    covered = [w for s0, ns, _ in passes for w in range(s0, s0 + ns)]
    assert sorted(covered) == list(range(S))
    widest = bucket_plan.DEDUP_WIDTHS[-1]
    for i, (s0, ns, NW) in enumerate(passes):
        assert NW in bucket_plan.DEDUP_WIDTHS and NW % 2 == 0
        assert ns + (i > 0) + 1 <= 2 * NW
    if len(passes) == 1:
        assert S + 1 <= 2 * widest
        assert passes[0][2] == min(w for w in bucket_plan.DEDUP_WIDTHS
                                   if 2 * w >= S + 1)
    else:
        assert S + 1 > 2 * widest
        assert all(ns == bucket_plan.DEDUP_SEGMENT
                   for s0, ns, _ in passes[1:])
    assert (len(passes) > 1) == (L > 236)


def test_dedup_bucket_bits():
    """K12's buckets are ``bucket_bits`` of twice the reads (four times
    for ragged reads, whose lengths lead the words), so that the crowded
    end of the canonical words (twice the mean) still fits a block."""
    for n in (0, 1, 1000, 2_248_889, 2_300_000, 1 << 40):
        assert bucket_plan.dedup_bucket_bits(n, False) == \
            bucket_plan.bucket_bits(bucket_plan.DEDUP_SKEW * n)
        assert bucket_plan.dedup_bucket_bits(n, True) == \
            bucket_plan.bucket_bits(bucket_plan.DEDUP_SKEW_RAGGED * n)
    d = bucket_plan.dedup_bucket_bits(2_300_000, False)
    assert 2 * 2_300_000 / (1 << d) <= bucket_plan.BLOCK * bucket_plan.FILL
    assert d == 12 and bucket_plan.dedup_bucket_bits(2_248_889, True) == 13


@pytest.mark.parametrize("d", [0, 1, 11, 12, 16, 20])
def test_scratch_words(d):
    """The layout of bsort::scratch_words: its parts in order, the first
    slots after the zeroed words, the big buckets' area last, nothing
    overlapping."""
    nb = 1 << d
    dc = bucket_plan.coarse_bits(d)
    assert dc == min(d, 8) and dc <= d
    nbc = 1 << dc
    tiles = -(-nbc // bucket_plan.SCAN_TILE)
    zeroed = 2 + (nbc + 1) // 2 + tiles + nb
    base = 1 + zeroed + (nbc + 2) // 2 + (nb + 2) // 2
    assert 8 * ((nbc + 2) // 2) >= 4 * (nbc + 1)
    assert 8 * ((nb + 2) // 2) >= 4 * (nb + 1)
    grid = bucket_plan.MAX_GRID + bucket_plan.MAX_GRID // 2
    assert bucket_plan.scratch_words(d, 0) == base + grid + 4
    n = 5 * bucket_plan.BLOCK + 17
    big = n // (bucket_plan.BLOCK + 1)
    assert bucket_plan.scratch_words(d, n) == (
        base + grid + 3 + big + (n // bucket_plan.BLOCK + big + 2) // 2)


@pytest.mark.parametrize("case", ["even", "one", "all_big", "edge"])
def test_big_area_holds_every_big_bucket(case):
    """However n elements fall into buckets, the big buckets (past a
    block) and their tiles of a block fit the area scratch_words keeps:
    at most n // (BLOCK + 1) buckets and n // BLOCK + that + 1 tiles."""
    B = bucket_plan.BLOCK
    rng = np.random.default_rng(9)
    if case == "even":
        sizes = rng.integers(0, 2 * B, 500)
    elif case == "one":
        sizes = np.array([10**6, 3, 0, 5])
    elif case == "all_big":
        sizes = np.full(300, B + 1)
    else:
        sizes = np.array([B, B + 1, 2 * B, 2 * B + 1, 1])
    n = int(sizes.sum())
    big = sizes[sizes > B]
    tiles = int((-(-big // B)).sum())
    assert big.size <= n // (B + 1)
    assert tiles <= n // B + n // (B + 1) + 1


@pytest.mark.parametrize("V", [1, 64, 4_600_000, (1 << 30) + 7])
def test_edge_bucket_is_a_monotone_function_of_src(V):
    """K14's bucket bits keep 2^d <= span (so the multiplier fits 32 bits
    and (src - lo) * m below 2^63), and its bucket function is monotone in src,
    within one of (src - lo) * 2^d // span, over all V ids and over a
    shard's range with sources on both sides of it."""
    rng = np.random.default_rng(4)
    src = np.sort(rng.integers(0, V, 3000))
    for lo, hi in ((0, V), (V // 4, max(V // 4 + 1, V // 2))):
        span = hi - lo
        for n in (1, 10**5, 10**8, 1 << 40):
            d = bucket_plan.edge_bucket_bits(n, span)
            assert 1 << d <= span and (1 << (32 + d)) // span <= 1 << 32
            b = [edge_bucket(int(s), lo, span, d) for s in src]
            assert min(b) >= 0 and max(b) < 1 << d
            assert all(x <= y for x, y in zip(b, b[1:]))
            for s, x in zip(src.tolist(), b):
                if lo <= s < hi:
                    assert 0 <= (s - lo) * (1 << d) // span - x <= 1


# --- K13: the bucketed order is the stable order -----------------------------

def _seed_inputs(case: str):
    """(reads, valid, lengths) of seed_case, or its poly-A variant (most
    reads all A: their live seeds share one key and one bucket)."""
    if case == "poly_a":
        reads, valid, lens = seed_case(False, M=40)
        reads[5:30] = 0
        return reads, valid, lens
    return seed_case(case == "ragged")


@pytest.mark.parametrize("d", [None, 0, 4])
@pytest.mark.parametrize("s", [32, 12])
@pytest.mark.parametrize("case", ["plain", "ragged", "poly_a"])
def test_bucketed_order_is_seed_rows_order(case, s, d):
    """The live rows in a shuffled order, bucketed and sorted by (key,
    tag | id), give plain.seed_rows' stable order, with the plan's d and
    with others."""
    reads, valid, lens = _seed_inputs(case)
    L = reads.shape[1]
    geo = tdetect.join_geometry(L, 40 if s == 32 else 20, s)
    args = (torch.from_numpy(reads), torch.from_numpy(valid),
            None if lens is None else torch.from_numpy(lens), s, geo.g,
            geo.n_pos, geo.trim)
    s_keys, s_rows, _ = plain.seed_rows(*args)
    n = s_keys.numel()
    perm = np.random.default_rng(5).permutation(n)
    keys, ids = s_keys.numpy()[perm].tolist(), s_rows.numpy()[perm].tolist()
    tags = [_tag(i, geo.R, geo.g) for i in ids]
    if d is None:
        d = bucket_plan.bucket_bits(reads.shape[0] * geo.R)
    got_keys, got_ids = _seed_mirror(keys, tags, ids, d)
    assert got_keys == s_keys.tolist() and got_ids == s_rows.tolist()


@pytest.mark.parametrize("shuffle_slab", [False, True])
def test_bucketed_order_with_a_prior_slab(shuffle_slab):
    """A query chunk sorted with a slab: the slab's row j takes the tag j,
    which gives the stable sort of [slab + chunk] in any slab order."""
    reads, valid, lens = seed_case(True, M=30)
    L = reads.shape[1]
    geo = tdetect.join_geometry(L, 40, 32)
    r, v, ln = (torch.from_numpy(x) for x in (reads, valid, lens))
    common = (32, geo.g, geo.n_pos, geo.trim)
    slab_keys, slab_ids, _ = plain.seed_rows(r[:15], v[:15], ln[:15],
                                             *common, 0, "entries")
    if shuffle_slab:
        p = torch.from_numpy(np.random.default_rng(6).permutation(
            slab_keys.numel()))
        slab_keys, slab_ids = slab_keys[p], slab_ids[p]
    want = plain.seed_rows(r[15:], v[15:], ln[15:], *common, 15, "queries",
                           slab_keys, slab_ids)
    q_keys, q_ids, _ = plain.seed_rows(r[15:], v[15:], ln[15:], *common, 15,
                                       "queries")
    keys = slab_keys.tolist() + q_keys.tolist()
    ids = slab_ids.tolist() + q_ids.tolist()
    tags = list(range(slab_keys.numel())) + [QUERY_TAG | i
                                             for i in q_ids.tolist()]
    order = np.random.default_rng(7).permutation(len(keys))
    pick = lambda xs: [xs[i] for i in order]  # noqa: E731
    for d in (0, 3):
        got = _seed_mirror(pick(keys), pick(tags), pick(ids), d)
        assert got == (want[0].tolist(), want[1].tolist())


@pytest.mark.parametrize("ragged", [False, True])
def test_bucketed_order_matches_reference_seed_rows(ragged):
    """The reference's rows (k_hi, k_lo, tag | id) through the mirror
    give its (hi, lo, packed) lexsort over the valid rows."""
    reads, valid, lens = seed_case(ragged)
    L = reads.shape[1]
    jgeo = jdetect.join_geometry(L, 40, 32)
    k_hi, k_lo, packed, _ = (np.asarray(a) for a in jdetect.build_seed_rows(
        jnp.asarray(reads), jnp.asarray(valid), 32, jgeo,
        lengths=None if lens is None else jnp.asarray(lens)))
    k_hi, k_lo, packed = (a.reshape(-1).astype(np.int64)
                          for a in (k_hi, k_lo, packed))
    live = packed != 0xFFFFFFFF
    order = np.lexsort((packed[live], k_lo[live], k_hi[live]))
    stored = (k_hi[live] - (1 << 31)) * (1 << 32) + k_lo[live]
    ids = (packed[live] & 0x7FFFFFFF).tolist()
    got_keys, got_ids = _seed_mirror(stored.tolist(),
                                     packed[live].tolist(), ids, 3)
    assert got_keys == stored[order].tolist()
    assert got_ids == (packed[live] & 0x7FFFFFFF)[order].tolist()


# --- K14: the bucketed order and the kernel's placement ----------------------

def _edge_mirror(ok, a, b, ovl, V, L, cap, deferred, d=None, sources=None):
    """K14's outputs by the mirror: the ok rows shuffled, bucketed by
    src over ``sources`` (all V ids by default), each bucket sorted; the
    keepers at the slot the look-back in bucket order gives, each
    bucket's duplicates' padding at [n_ok - off_b + kept_b - dups_b, n_ok
    - off_b + kept_b), [n_ok, cap) filled; every slot written exactly
    once."""
    db, ob = plain.edge_key_bits(V, L)
    wide = 2 * db + ob > 63
    rows = np.flatnonzero(ok)
    rows = rows[np.random.default_rng(8).permutation(rows.size)]
    if wide:
        elems = [((int(a[i]) << 32) | int(b[i]), int(ovl[i]) << 32)
                 for i in rows]
        pair = lambda e: e[0]                             # noqa: E731
        dec = lambda e: (e[0] >> 32, e[0] & 0xFFFFFFFF, e[1] >> 32)  # noqa
    else:
        elems = [((int(a[i]) << (db + ob)) | (int(b[i]) << ob) | int(ovl[i]),)
                 for i in rows]
        pair = lambda e: e[0] >> ob                       # noqa: E731
        dec = lambda e: (e[0] >> (db + ob), (e[0] >> ob) & ((1 << db) - 1),
                         e[0] & ((1 << ob) - 1))
    lo, hi = sources or (0, V)
    if d is None:
        d = bucket_plan.edge_bucket_bits(ok.size, hi - lo)
    buckets = [edge_bucket(int(a[i]), lo, hi - lo, d) for i in rows]
    offsets, members, out = _bucketed(elems, buckets, d)
    n_ok = len(out)
    cols = np.full((3, cap), [[I32_MAX], [I32_MAX], [0]], dtype=np.int64)
    writes = np.zeros(cap, np.int64)
    writes[n_ok:] += 1
    kept_before = kept_all = 0
    for off, v in zip(offsets, members):
        keep = [i + 1 == len(v) or pair(v[i]) != pair(v[i + 1])
                for i in range(len(v))]
        kept = sum(keep)
        kept_all += kept
        if deferred:
            for i, e in enumerate(v):
                cols[:, off + i] = dec(e)
                writes[off + i] += 1
            continue
        slot = kept_before
        for e, k in zip(v, keep):
            if k:
                cols[:, slot] = dec(e)
                writes[slot] += 1
                slot += 1
        dups = len(v) - kept
        first = n_ok - off + kept_before - dups
        writes[first:first + dups] += 1
        kept_before += kept
    assert (writes == 1).all()
    res = [torch.from_numpy(c.astype(np.int32)) for c in cols]
    if deferred:
        return (*res, kept_all, n_ok - kept_all)
    return (*res, kept_all)


def _edge_case(case: str):
    """reduce_case's K14 inputs, or a hub (one src holds most ok rows), a
    single candidate, or a mesh shard's (its sources in [16, 32) of 64,
    bucketed over that range). Returns the inputs and the sources'
    range (None: all ids)."""
    if case == "hub":
        ok, a, b, ovl, L, V, cap = reduce_case("all_ok")
        a[:300] = 17
        return (ok, a, b, ovl, L, V, cap), None
    if case == "single":
        ok, a, b, ovl, L, V, cap = reduce_case("all_ok")
        return (ok[:1], a[:1], b[:1], ovl[:1], L, V, 5), None
    if case == "shard":
        ok, a, b, ovl, L, V, cap = reduce_case("all_ok")
        a = (16 + a % 16).astype(np.int32)
        return (ok, a, b, ovl, L, V, cap), (16, 32)
    return reduce_case(case), None


EDGE_CASES = REDUCE_CASES + ("hub", "single", "shard")


@pytest.mark.parametrize("d", [None, 3])
@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_bucketed_edges_are_longest_edges(case, deferred, d):
    """The mirror's keepers, padding and counts equal
    plain.longest_edges (plain.longest_edges_deferred)."""
    (ok, a, b, ovl, L, V, cap), sources = _edge_case(case)
    got = _edge_mirror(ok, a, b, ovl, V, L, cap, deferred, d, sources)
    args = (*(torch.from_numpy(x) for x in (ok, a, b, ovl)), V, L, cap)
    want = (plain.longest_edges_deferred if deferred
            else plain.longest_edges)(*args)
    for x, y in zip(got[:3], want[:3]):
        assert torch.equal(x, y)
    assert [int(x) for x in got[3:]] == [int(y) for y in want[3:]]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_bucketed_edges_match_reference(case):
    """The mirror's edges against the reference's _reduce_fused."""
    (ok, a, b, ovl, L, V, cap), sources = _edge_case(case)
    j = jdetect._reduce_fused(*(jnp.asarray(x) for x in (ok, a, b, ovl)), L,
                              V)
    got = _edge_mirror(ok, a, b, ovl, V, L, cap, False, None, sources)
    assert got[3] == int(j[3])
    n = ok.shape[0]
    for x, y in zip(j[:3], got[:3]):
        np.testing.assert_array_equal(np.asarray(x), y[:n].numpy())


def test_longest_edges_sources_leave_the_rows():
    """``sources`` only splits the buckets: on the CPU, with and without
    it, and with a range the sources do not all lie in, the same rows;
    an empty or negative range is refused on either device."""
    (ok, a, b, ovl, L, V, cap), _ = _edge_case("shard")
    t = [torch.from_numpy(x) for x in (ok, a, b, ovl)]
    want = kernels.longest_edges(*t, V, L, cap)
    for rng in ((16, 32), (20, 24), (0, 64)):
        got = kernels.longest_edges(*t, V, L, cap, sources=rng)
        assert all(torch.equal(x, y) for x, y in zip(got[:3], want[:3]))
        assert got[3] == want[3]
    for rng in ((5, 5), (-1, 8)):
        with pytest.raises(ValueError, match="not a range"):
            kernels.longest_edges(*t, V, L, cap, sources=rng)
