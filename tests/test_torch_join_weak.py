"""K3's run-major candidate slots (kernels/csrc/overlap_join.cu) and K16's
membership table of the solid keys (kernels/csrc/weak_windows.cu), as
Python mirrors of the kernels' index arithmetic, on the CPU.

The K3 mirror takes the sorted seed rows as the runs launch does (run
heads by neighbour comparison, each run's entries from the tile's entry
counts, the tile's last run followed past the tile; the records of the
runs with candidates, their first slots in key order) and writes the
slots as the slots launch does (a tile's covering runs, each run's
staged entry and query rows, the slot of (query rank qi, entry rank ei)
at run_base + qi * e + ei, the verify from the staged rows). It is held
to plain.overlap_join in every mode (in core, ragged with containment
marks, a slot limit inside a run, the streamed two-segment payload, the
meshed permutation, the fixed capacity) and to the reference's
fused_join_core for the fixed, ragged and streamed layouts, with the
kernels' tile sizes and with small ones that put runs across tiles.

The K16 mirror builds the membership table as the build launches do
(the mix, the bucket, the bits kept, the overflow lists, the threshold
filter); membership in it equals "count >= threshold" in the table, and
the weak windows it gives equal plain.weak_windows and the reference's
_phase1_kernel. K17's rule by membership (a weak window's three other
variants probed in that table, its current one only where one of them
is solid, counts looked up only where two or more are solid) gives
plain.fix_windows and the reference's _phase2_kernel, at every window
the same edits as all four variants probed. The
CUDA kernels themselves are held to the plain versions on the card
(tests/test_torch_kernels_cuda.py). Inputs are made
with numpy from a seed; tolerance: exact equality (integer programs).
"""

import bisect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.kmer import correct as jcorrect
from sage2_tpu.kmer.count import KmerTable as JTable
from sage2_tpu.overlap import detect as jdetect
from sage2_tpu_torch import kernels
from sage2_tpu_torch.data import (
    simulate_genome,
    simulate_ragged_reads,
    simulate_reads,
)
from sage2_tpu_torch.kernels import plain
from sage2_tpu_torch.overlap import detect as tdetect
from torch_kernel_cases import (
    SOLID_MIX,
    VOTE_CASES,
    count_table,
    crowded_bucket_table,
    solid_mix as mix,
    solid_unmix as unmix,
    tied_variants_case,
    vote_case,
)
from torch_one_thread import one_thread  # noqa: F401

SEED, MIN_OVERLAP, L = 32, 40, 60


# --- K3: the mirror -------------------------------------------------------

def mirror_runs(keys, rows, R, g, n, tile=kernels.JOIN_COUNT_TILE):
    """The runs launch: (records (first slot, first row, entries) of the
    runs with candidates in key order, the total)."""
    entry = rows % R < g
    records, total = [], 0
    for t0 in range(0, max(n, 1), tile):
        t_end = min(t0 + tile, n)
        heads = [i for i in range(t0, t_end)
                 if i == 0 or keys[i] != keys[i - 1]]
        for k, h in enumerate(heads):
            end = heads[k + 1] if k + 1 < len(heads) else t_end
            e = int(entry[h:end].sum())
            if k + 1 == len(heads) and end < n and keys[end] == keys[h]:
                # the tile's last run goes on past the tile
                inside = end
                while end < n and keys[end] == keys[h]:
                    end += 1
                if e == inside - h:
                    split = inside
                    while split < end and entry[split]:
                        split += 1
                    e = split - h
            q = end - h - e
            if e and q:
                records.append((total, h, e))
                total += e * q
    return records, total


def _verify(a, ta, pa, b, tb, pb, g, trim, min_overlap):
    """(match, ovl, ok) of a query row (read a, slot ta, words pa) and an
    entry row, as the kernel verifies them."""
    Wt = len(pa) - 2
    p = (ta - g + 1) * g
    o = tb
    len_a, len_b = int(pa[Wt + 1]), int(pb[Wt + 1])
    ovl = len_a - (p - o)
    match = a != b
    lc2 = 2 * min(len_a - p, len_b - o)
    for w in range(Wt):
        vb = min(32, max(0, lc2 - (w + trim) * 32))
        if vb > 0 and (int(pa[w]) ^ int(pb[w])) >> (32 - vb):
            match = False
    lhs = int(pa[Wt]) & ((1 << (2 * o)) - 1)
    rhs = 0 if o == 0 else int(pb[Wt]) >> (32 - 2 * o)
    match = match and lhs == rhs
    return match, ovl, match and len_b > ovl >= min_overlap


def mirror_slots(records, total, rows, row_of, n_out, R, g, trim,
                 min_overlap, n_reads=None, st=kernels.JOIN_SLOT_TILE):
    """The slots launch: (ok, cand_a, cand_b, ovl, containment marks) of
    the first n_out slots (past the total, not ok with a, b and ovl 0).
    ``row_of(id, pos)``: the payload words of sorted row pos."""
    bases = [r[0] for r in records] + [total]
    used = min(total, n_out)
    ok = np.zeros(n_out, bool)
    cand = [np.zeros(n_out, np.int32) for _ in range(3)]
    marks = None if n_reads is None else np.zeros(n_reads, np.uint8)
    for s in range(0, n_out, st):
        s_end = min(s + st, n_out)
        live = min(s_end, used)
        if s >= live:
            continue
        cur = bisect.bisect_right(bases, s) - 1
        m = 0
        while bases[cur + m] < live:
            m += 1
        plan, soff = [], 0
        for j in range(m):
            b, start, e = records[cur + j]
            frm = max(s, b)
            lo = frm - b
            n = min(bases[cur + j + 1], live) - frm
            qi0, ei0 = divmod(lo, e)
            ce, cq = min(e, n), (ei0 + n - 1) // e + 1
            plan.append((frm - s, e, ei0, qi0, ce, cq, start, soff))
            soff += ce + cq
        assert soff <= 2 * st          # the stage's size
        staged = []
        for rel, e, ei0, qi0, ce, cq, start, so in plan:
            # the entries in rank order from ei0 (mod e), then the queries
            positions = [start + (ei0 + u) % e for u in range(ce)]
            positions += [start + e + qi0 + v for v in range(cq)]
            for pos in positions:
                rid = int(rows[pos])
                staged.append((rid // R, rid % R, row_of(rid, pos)))
        assert len(staged) == soff
        rrel = [p[0] for p in plan]
        for i in range(s, live):
            rel = i - s
            rel0, e, ei0, qi0, ce, cq, start, so = plan[
                bisect.bisect_right(rrel, rel) - 1]
            t = ei0 + rel - rel0
            qr = t // e
            ue = (t - qr * e - ei0) % e
            a, ta, pa = staged[so + ce + qr]
            b, tb, pb = staged[so + ue]
            match, ovl, is_ok = _verify(a, ta, pa, b, tb, pb, g, trim,
                                        min_overlap)
            ok[i] = is_ok
            cand[0][i], cand[1][i], cand[2][i] = a, b, ovl
            if marks is not None and match and int(pb[-1]) <= ovl:
                marks[b] = 1
    return ok, *cand, marks


def _u32(t):
    return t.numpy().view(np.uint32)


def _reads(ragged, seed=5, hot=12):
    """(reads (M, L) int32, valid, lengths or None): reads of a random
    3 kbp genome, and ``hot`` poly-A reads, whose seeds make one run of
    many entry and query rows (one key)."""
    genome = simulate_genome(3000, seed=seed)
    if ragged:
        reads, lens = simulate_ragged_reads(genome, 45, L, 14, 0.005,
                                            seed=seed + 1)
        reads = reads.astype(np.int32)
        lens = np.concatenate([lens, np.full(hot, L)]).astype(np.int32)
    else:
        reads, _ = simulate_reads(genome, read_len=L, coverage=14,
                                  error_rate=0.005, seed=seed + 1)
        reads, lens = reads.astype(np.int32), None
    reads = np.concatenate([reads, np.zeros((hot, L), np.int32)])
    valid = np.ones(len(reads), bool)
    valid[7] = False
    return reads, valid, lens


def _geo():
    s = min(SEED, MIN_OVERLAP, 32)
    return s, tdetect.join_geometry(L, MIN_OVERLAP, s)


def _incore(reads, valid, lens):
    s, geo = _geo()
    s_keys, s_rows, payload = kernels.seed_rows(
        torch.from_numpy(reads), torch.from_numpy(valid),
        None if lens is None else torch.from_numpy(lens), s, geo.g,
        geo.n_pos, geo.trim)
    return s_keys, s_rows, payload.reshape(-1, geo.Wt + 2), geo


def _plain_marks(n_reads):
    return torch.zeros(n_reads, dtype=torch.uint8)


def _equal(mine, want, n_out):
    ok, a, b, ovl, marks = mine
    np.testing.assert_array_equal(ok, want[0].numpy()[:n_out])
    for x, y in zip((a, b, ovl), want[1:4]):
        np.testing.assert_array_equal(x, y.numpy()[:n_out])


@pytest.mark.parametrize("tiles", ["kernel", "small"])
@pytest.mark.parametrize("ragged", [False, True])
def test_join_mirror_matches_plain_and_reference(ragged, tiles):
    """The slots of (qi, ei) at run_base + qi * e + ei, from the runs
    launch's records and the slots launch's stage, equal plain
    .overlap_join's and the reference's fused_join_core's, containment
    marks included; small tiles put runs across runs tiles and slot
    tiles, and the hot read's run spans many slot tiles."""
    reads, valid, lens = _reads(ragged)
    M = len(reads)
    s_keys, s_rows, payload, geo = _incore(reads, valid, lens)
    keys, rows = s_keys.numpy(), s_rows.numpy()
    tile, st = ((kernels.JOIN_COUNT_TILE, kernels.JOIN_SLOT_TILE)
                if tiles == "kernel" else (64, 32))
    records, total = mirror_runs(keys, rows, geo.R, geo.g, len(keys), tile)
    sizes = np.diff([b for b, _, _ in records] + [total])
    assert sizes.max() > 2 * st         # the hot read's run spans tiles
    words = _u32(payload)
    mine = mirror_slots(records, total, rows, lambda rid, pos: words[rid],
                        total, geo.R, geo.g, geo.trim, MIN_OVERLAP,
                        M if ragged else None, st)
    marks = _plain_marks(M) if ragged else None
    want = plain.overlap_join(s_keys, s_rows, payload, geo.R, geo.g,
                              geo.trim, MIN_OVERLAP, marks)
    assert want[4] == total
    _equal(mine, want, total)
    if ragged:
        np.testing.assert_array_equal(mine[4], marks.numpy())
        assert mine[4].sum() > 0
    if tiles == "small":    # runs whose rows cross a runs tile's end
        heads = np.array([h for _, h, _ in records])
        ends = np.searchsorted(keys, keys[heads], "right")
        assert (heads // tile != (ends - 1) // tile).any()
    # the reference
    jgeo = jdetect.join_geometry(L, MIN_OVERLAP, min(SEED, MIN_OVERLAP, 32))
    k_hi, k_lo, packed, jpay = jdetect.build_seed_rows(
        jnp.asarray(reads), jnp.asarray(valid), min(SEED, MIN_OVERLAP, 32),
        jgeo,
        lengths=None if lens is None else jnp.asarray(lens))
    N = M * jgeo.R
    j_ok, j_cont, j_a, j_b, j_ovl, j_total = (np.asarray(x) for x in (
        jdetect.fused_join_core(k_hi.reshape(-1), k_lo.reshape(-1),
                                packed.reshape(-1),
                                jpay.reshape(N, jgeo.Wt + 2), jgeo, L,
                                total, MIN_OVERLAP,
                                ids_are_positions=True)))
    assert int(j_total) == total
    np.testing.assert_array_equal(mine[0], j_ok)
    for x, y in zip(mine[1:4], (j_a, j_b, j_ovl)):
        np.testing.assert_array_equal(x, y)
    if ragged:
        want_marks = np.zeros(M, np.uint8)
        want_marks[j_b[j_cont]] = 1
        np.testing.assert_array_equal(mine[4], want_marks)


def test_join_mirror_slot_limit_fixed_capacity_and_permutation():
    """A slot limit inside a run writes and marks only the slots below
    it; the fixed capacity writes the candidates and then not-ok slots
    (a, b, ovl 0); the meshed permutation finds each sorted row's payload
    in received order."""
    reads, valid, lens = _reads(True, seed=9)
    M = len(reads)
    s_keys, s_rows, payload, geo = _incore(reads, valid, lens)
    keys, rows = s_keys.numpy(), s_rows.numpy()
    records, total = mirror_runs(keys, rows, geo.R, geo.g, len(keys))
    words = _u32(payload)
    # a limit in the middle of the largest run
    b0, _, e = max(records, key=lambda r: r[2])
    limit = b0 + e + 1
    mine = mirror_slots(records, total, rows, lambda rid, pos: words[rid],
                        limit, geo.R, geo.g, geo.trim, MIN_OVERLAP, M)
    marks = _plain_marks(M)
    want = plain.overlap_join(s_keys, s_rows, payload, geo.R, geo.g,
                              geo.trim, MIN_OVERLAP, marks, limit)
    assert want[0].shape[0] == limit
    _equal(mine, want, limit)
    np.testing.assert_array_equal(mine[4], marks.numpy())
    # the fixed capacity, above and below the total (the stacked rows:
    # the live rows first, dead rows behind them)
    st_keys, st_rows, st_pay, n_live = kernels.seed_rows_stacked(
        torch.from_numpy(reads), torch.from_numpy(valid), *_geo()[:1],
        geo.g, geo.n_pos, geo.trim)
    st_pay = st_pay.reshape(-1, geo.Wt + 2)
    n = int(n_live)
    recs, tot = mirror_runs(st_keys.numpy(), st_rows.numpy(), geo.R, geo.g,
                            n)
    sw = _u32(st_pay)
    for cap in (tot + 300, tot // 2):
        mine = mirror_slots(recs, tot, st_rows.numpy(),
                            lambda rid, pos: sw[rid], cap, geo.R, geo.g,
                            geo.trim, MIN_OVERLAP)
        want = plain.overlap_join_stacked(st_keys, st_rows, st_pay, n_live,
                                          geo.R, geo.g, geo.trim,
                                          MIN_OVERLAP, cap)
        assert int(want[4]) == tot
        _equal(mine, want, cap)
        assert not mine[0][tot:].any() and not mine[1][tot:].any()
    # the meshed join: payload rows in a shuffled received order
    rng = np.random.default_rng(3)
    order = rng.permutation(len(keys))
    recv = payload[s_rows.long()[torch.from_numpy(order)]]
    perm = np.empty_like(order)
    perm[order] = np.arange(len(keys))
    rw = _u32(recv)
    mine = mirror_slots(records, total, rows, lambda rid, pos: rw[perm[pos]],
                        total, geo.R, geo.g, geo.trim, MIN_OVERLAP, M)
    marks = _plain_marks(M)
    want = plain.overlap_join(s_keys, s_rows, recv, geo.R, geo.g, geo.trim,
                              MIN_OVERLAP, marks, None, None, 0, 0,
                              torch.from_numpy(perm))
    _equal(mine, want, total)
    np.testing.assert_array_equal(mine[4], marks.numpy())


def test_join_mirror_streamed_matches_plain_and_reference():
    """The streamed join: an entry slab's rows and a query chunk's, the
    payload in two segments (the slab's (read - base) * g + t, the
    chunk's (read - base) * n_pos + t - g), against plain.overlap_join's
    streamed mode and the reference's fused_join_core over [slab +
    chunk] (sage2_tpu/stream.py:847-875)."""
    reads, valid, lens = _reads(True, seed=13)
    M = len(reads)
    s, geo = _geo()
    g, n_pos, R, W2 = geo.g, geo.n_pos, geo.R, geo.Wt + 2
    q0, q1 = M // 3, M
    t = torch.from_numpy
    e_keys, e_ids, e_pay = kernels.seed_rows(
        t(reads), t(valid), t(lens), s, g, n_pos, geo.trim, 0, "entries")
    s_keys, s_rows, q_pay = kernels.seed_rows(
        t(reads[q0:q1]), t(valid[q0:q1]), t(lens[q0:q1]), s, g, n_pos,
        geo.trim, q0, "queries", e_keys, e_ids)
    e_pay, q_pay = e_pay.reshape(-1, W2), q_pay.reshape(-1, W2)
    keys, rows = s_keys.numpy(), s_rows.numpy()
    records, total = mirror_runs(keys, rows, R, g, len(keys))
    ew, qw = _u32(e_pay), _u32(q_pay)

    def row_of(rid, pos):
        read, slot = divmod(rid, R)
        if slot < g:
            return ew[read * g + slot]
        return qw[(read - q0) * n_pos + slot - g]

    mine = mirror_slots(records, total, rows, row_of, total, R, g, geo.trim,
                        MIN_OVERLAP, M)
    marks = _plain_marks(M)
    want = plain.overlap_join(s_keys, s_rows, q_pay, R, g, geo.trim,
                              MIN_OVERLAP, marks, None, e_pay, 0, q0)
    assert want[4] == total
    _equal(mine, want, total)
    np.testing.assert_array_equal(mine[4], marks.numpy())
    # the reference: the slab's entry rows and the chunk's query rows
    jgeo = jdetect.join_geometry(L, MIN_OVERLAP, s)
    ent = jdetect.build_seed_rows(jnp.asarray(reads), jnp.asarray(valid), s,
                                  jgeo, id_base=jnp.uint32(0),
                                  lengths=jnp.asarray(lens))
    qry = jdetect.build_seed_rows(jnp.asarray(reads[q0:q1]),
                                  jnp.asarray(valid[q0:q1]), s, jgeo,
                                  id_base=jnp.uint32(q0),
                                  lengths=jnp.asarray(lens[q0:q1]))
    cols = [jnp.concatenate([a[:, :g].reshape(-1), b[:, g:].reshape(-1)])
            for a, b in zip(ent[:3], qry[:3])]
    pay = jnp.concatenate([ent[3][:, :g].reshape(-1, W2),
                           qry[3][:, g:].reshape(-1, W2)])
    j_ok, j_cont, j_a, j_b, j_ovl, j_total = (np.asarray(x) for x in (
        jdetect.fused_join_core(*cols, pay, jgeo, L, total, MIN_OVERLAP)))
    assert int(j_total) == total
    np.testing.assert_array_equal(mine[0], j_ok)
    for x, y in zip(mine[1:4], (j_a, j_b, j_ovl)):
        np.testing.assert_array_equal(x, y)
    want_marks = np.zeros(M, np.uint8)
    want_marks[j_b[j_cont]] = 1
    np.testing.assert_array_equal(mine[4], want_marks)


# --- K16: the mirror ------------------------------------------------------

EMPTY, LINK, WAYS = 0xFFFFFFFF, 0x80000000, 8


def solid_layout(keys, counts, k, threshold):
    """K16's membership table as its build launches make it: (bits,
    buckets (2^bits, 8) uint32, overflow list words), or None where
    kernels.solid_bits builds none. Keys go in table order (the kernel's
    order inside a bucket depends on its atomics; membership does not)."""
    bits = kernels.solid_bits(len(keys), k)
    if bits is None or threshold < 1:   # kernels.table_directory's rule
        return None
    B = 2 * k
    low = B - bits
    members = [[] for _ in range(1 << bits)]
    for key, c in zip(keys.tolist(), counts.tolist()):
        if c < threshold or key < 0 or key >> B:
            continue
        h = mix(key, B)
        members[h >> low].append(h & ((1 << low) - 1))
    buckets = np.full((1 << bits, WAYS), EMPTY, np.uint64)
    lists = []
    for b, vals in enumerate(members):
        if len(vals) <= WAYS:
            buckets[b, :len(vals)] = vals
        else:
            buckets[b, :WAYS - 1] = vals[:WAYS - 1]
            buckets[b, WAYS - 1] = LINK | len(lists)
            lists += [len(vals) - (WAYS - 1)] + vals[WAYS - 1:]
    assert all(v < LINK for m in members for v in m)    # below 2^31
    assert len(lists) <= len(keys) + 2                  # kernels.solid_words
    return bits, buckets, lists


def is_member(layout, key, k):
    bits, buckets, lists = layout
    B = 2 * k
    h = mix(key, B)
    row = buckets[h >> (B - bits)]
    v = h & ((1 << (B - bits)) - 1)
    if v in row.tolist():
        return True
    link = int(row[WAYS - 1])
    if link & LINK and link != EMPTY:
        off = link & ~LINK
        return v in lists[off + 1: off + 1 + lists[off]]
    return False


def _table_case(case, k):
    reads, lengths, keys, counts, k, threshold, _ = vote_case(case, k=k)
    return reads, lengths, keys, counts, k, threshold


def test_mix_is_a_bijection_with_an_inverse():
    rng = np.random.default_rng(0)
    for B in (4, 22, 30, 50, 62):
        xs = rng.integers(0, 1 << min(B, 62), 200).tolist()
        assert all(unmix(mix(x, B), B) == x for x in xs)
        assert mix(1, B) == SOLID_MIX & ((1 << B) - 1)
        if B <= 16:
            assert len({mix(x, B) for x in range(1 << B)}) == 1 << B


@pytest.mark.parametrize("case", ("errors", "unpruned", "short", "empty"))
def test_solid_layout_membership_is_the_threshold(case):
    """Membership in the table equals count >= threshold (the build's
    filter: the unpruned table holds counts from 1 up), for every table
    key and for keys absent from the table; a bucket's key and its kept
    bits give back the key."""
    reads, lengths, keys, counts, k, threshold = _table_case(case, 15)
    layout = solid_layout(keys, counts, k, threshold)
    if case == "empty":
        assert kernels.solid_bits(len(keys), k) is None and layout is None
        return
    assert layout is not None
    for key, c in zip(keys.tolist(), counts.tolist()):
        assert is_member(layout, key, k) == (c >= threshold)
    rng = np.random.default_rng(1)
    absent = np.setdiff1d(rng.integers(0, 1 << 30, 500), keys)
    assert not any(is_member(layout, int(x), k) for x in absent)
    if case == "unpruned":
        assert (counts < threshold).any() and (counts >= threshold).any()
    bits, buckets, _ = layout
    low = 2 * k - bits
    for b in range(0, 1 << bits, max(1, (1 << bits) // 50)):
        for v in buckets[b].tolist():
            if v < LINK:
                assert unmix(b << low | v, 2 * k) in set(keys.tolist())


def test_solid_layout_overflow_lists():
    """A bucket of more than eight keys keeps seven and links the rest
    from its last word; membership stays exact for each key of it (the
    threshold keeps half of them) and for an absent key of the bucket."""
    k, B = 11, 22
    keys, counts, crowd = crowded_bucket_table(k, 5, 20)
    layout = solid_layout(keys, counts, k, 2)
    bits = layout[0]
    row = layout[1][5]
    link = int(row[WAYS - 1])
    low = B - bits
    in_bucket = sum(1 for key, c in zip(keys.tolist(), counts.tolist())
                    if c >= 2 and mix(key, B) >> low == 5)
    assert in_bucket > WAYS and link & LINK
    assert layout[2][link & ~LINK] == in_bucket - (WAYS - 1)
    for key, c in zip(keys.tolist(), counts.tolist()):
        assert is_member(layout, key, k) == (c >= 2)
    absent = [unmix(5 << low | v, B) for v in range(1 << low)]
    absent = [x for x in absent if x not in set(keys.tolist())][:5]
    assert absent and not any(is_member(layout, x, k) for x in absent)


def test_solid_bits_and_directory_sizes():
    """The table is built where a bucket keeps at most 31 bits: large
    tables of 25-mers (phase 4's ~5 M solid keys: 2^20 buckets, 32 MB) and
    any table of short k-mers, not 31-mers over a small table nor an
    empty table; an average bucket holds 3-6 keys; the membership table
    starts on a 32-byte boundary after K2's directory."""
    assert kernels.solid_bits(0, 15) is None
    assert kernels.solid_bits(5_128_928, 25) == 20
    assert kernels.solid_bits(1000, 25) is None
    assert kernels.solid_bits(10**6, 31) is None
    for T in (1, 7, 1000, 123_457, 5_279_548):
        bits = kernels.solid_bits(T, 15)
        assert 30 - bits <= 31
        if T > kernels.SOLID_LOAD:
            assert kernels.SOLID_LOAD / 2 < T / (1 << bits) <= \
                kernels.SOLID_LOAD
        off = kernels.solid_offset(T)
        assert off % 4 == 0 and off >= kernels.directory_words(T)
        assert kernels.solid_words(T, bits) == 4 + (4 << bits) + (T + 2) // 2


@pytest.mark.parametrize("case", VOTE_CASES)
def test_weak_windows_by_membership(case):
    """Weak windows are the valid windows whose canonical key is not a
    member: equal to plain.weak_windows and to the reference's
    _phase1_kernel, at k = 15 (every table gets a membership table)."""
    _weak_windows_by_membership(case, None)


@pytest.mark.parametrize("case", VOTE_CASES)
def test_weak_windows_by_membership_at_threshold_zero(case):
    """At threshold 0 no membership table is built (a key absent from the
    table counts 0, not below 0) and no window is weak."""
    _weak_windows_by_membership(case, 0)


def _weak_windows_by_membership(case, at):
    k = 31 if case == "k31" else 15
    reads, lengths, keys, counts, k, threshold = _table_case(case, k)
    if at is not None:
        threshold = at
    N, Lr = reads.shape
    P = Lr - k + 1
    layout = solid_layout(keys, counts, k, threshold)
    if layout is None:          # K2's directory: the count, 0 where absent
        assert case in ("empty", "k31") or threshold < 1
        count = dict(zip(keys.tolist(), counts.tolist())).get

        def member(key):
            return (count(key) or 0) >= threshold
    else:
        def member(key):
            return is_member(layout, key, k)
    canon = plain.kmer_keys(torch.from_numpy(reads), k)[2].numpy()
    ln = np.full(N, Lr) if lengths is None else lengths
    mine = [r * P + w for r in range(N) for w in range(P)
            if w < ln[r] - k + 1 and not member(int(canon[r, w]))]
    got = plain.weak_windows(torch.from_numpy(reads),
                             None if lengths is None
                             else torch.from_numpy(lengths),
                             torch.from_numpy(keys), torch.from_numpy(counts),
                             None, k, threshold)
    np.testing.assert_array_equal(np.array(mine, np.int64), got.numpy())
    jt = JTable(jnp.asarray((keys >> 32).astype(np.uint32)),
                jnp.asarray((keys & 0xFFFFFFFF).astype(np.uint32)),
                jnp.asarray(counts), jnp.int32(len(keys)), k)
    lens = (jnp.asarray(lengths) if lengths is not None
            else jnp.zeros((N,), jnp.int32))
    s_idx, n_weak = jcorrect._phase1_kernel(k, threshold,
                                            lengths is not None)(
        jnp.asarray(reads), jt.hi, jt.lo, jt.count, jt.n_unique, lens)
    np.testing.assert_array_equal(np.array(mine, np.int64),
                                  np.asarray(s_idx)[:int(n_weak)])
    assert (len(mine) == 0) == (case == "clean" or threshold < 1)


def test_table_directory_on_the_cpu_is_none():
    keys, counts = count_table(vote_case("errors", k=15)[0], 15)
    assert kernels.table_directory(torch.from_numpy(keys),
                                   torch.from_numpy(counts), 15, 2) is None


# --- K17: the rule by membership --------------------------------------------

def fix_by_membership(reads, widx, keys, counts, k, threshold, which,
                      eager=False):
    """K17's edits as its kernel makes them (kernels/csrc/fix_windows.cu):
    a window's three variant keys other than the current base's probed
    in the membership table (the kernel's layout, ``solid_layout``), the
    current one only where one of them is solid (with ``eager``, all four
    always); no edit where the current variant is solid or none is, the
    one solid variant where there is one, the counts of the solid ones
    (the others taken as 0) where there are more; without a membership
    table every variant's count. Returns the edited reads and how often
    each branch ran ("current": the current variant probed)."""
    N, L = reads.shape
    P = L - k + 1
    off = k - 1 if which == "last" else 0
    sf, sr = 2 * (k - 1 - off), 2 * off
    count = dict(zip(keys.tolist(), counts.tolist()))
    layout = solid_layout(keys, counts, k, threshold)
    out = reads.copy()
    branches = {"none": 0, "one": 0, "counts": 0, "all": 0, "current": 0}
    for x in widx.tolist():
        r, w = divmod(x, P)
        win = reads[r, w:w + k].astype(np.int64).tolist()
        f = c = 0
        for j, b in enumerate(win):
            f = f * 4 + b
            c |= (3 - b) << (2 * j)
        cur = win[off]
        q = [min((f & ~(3 << sf)) | (b << sf),
                 (c & ~(3 << sr)) | ((3 - b) << sr)) for b in range(4)]
        if layout is None:
            cnt = [count.get(v, 0) for v in q]
            branches["all"] += 1
        else:
            solid = [b != cur and is_member(layout, v, k)
                     for b, v in enumerate(q)]
            if eager or any(solid):
                solid[cur] = is_member(layout, q[cur], k)
                branches["current"] += 1
            if solid[cur] or not any(solid):
                branches["none"] += 1
                continue
            if sum(solid) == 1:
                out[r, w + off] = solid.index(True)
                branches["one"] += 1
                continue
            cnt = [count.get(v, 0) if s else 0 for v, s in zip(q, solid)]
            branches["counts"] += 1
        m = max(cnt)
        if cnt[cur] < threshold and m >= threshold and cnt.count(m) == 1:
            out[r, w + off] = cnt.index(m)
    return out, branches


@pytest.mark.parametrize("which", ["last", "first"])
@pytest.mark.parametrize("case", VOTE_CASES + ("ties",))
def test_fix_windows_by_membership(case, which):
    """K17's rule by membership equals plain.fix_windows and the
    reference's _phase2_kernel at K16's weak windows (k = 15; "k31" and
    "empty" have no membership table and look every variant up), and
    at windows that are not weak; "ties" holds weak windows with two or
    three solid variants, tied at the maximum (no edit) and not (an
    edit to the largest)."""
    if case == "ties":
        reads, lengths, keys, counts, k, threshold = tied_variants_case(15)
    else:
        reads, lengths, keys, counts, k, threshold = _table_case(
            case, 31 if case == "k31" else 15)
    N, Lr = reads.shape
    P = Lr - k + 1
    tk, tc = torch.from_numpy(keys), torch.from_numpy(counts)
    weak = plain.weak_windows(torch.from_numpy(reads),
                              None if lengths is None
                              else torch.from_numpy(lengths), tk, tc, None,
                              k, threshold)
    # every fifth window as well, weak or not (the rule decides)
    widx = torch.unique(torch.cat([weak, torch.arange(0, N * P, 5)]))
    if lengths is not None:     # windows inside their read only
        r, w = widx // P, widx % P
        widx = widx[w < torch.from_numpy(lengths)[r] - k + 1]
    for at in (weak, widx):
        mine, branches = fix_by_membership(reads, at.numpy(), keys, counts,
                                           k, threshold, which)
        got = plain.fix_windows(torch.from_numpy(reads), at, tk, tc, None,
                                k, threshold, which)
        np.testing.assert_array_equal(mine, got.numpy())
        jt = JTable(jnp.asarray((keys >> 32).astype(np.uint32)),
                    jnp.asarray((keys & 0xFFFFFFFF).astype(np.uint32)),
                    jnp.asarray(counts), jnp.int32(len(keys)), k)
        padded = np.concatenate([at.numpy(), np.full(3, N * P, np.int64)])
        ref = np.asarray(jcorrect._phase2_kernel(k, threshold, which)(
            jnp.asarray(reads), jt.hi, jt.lo, jt.count, jt.n_unique,
            jnp.asarray(padded)))
        np.testing.assert_array_equal(mine, ref)
    assert (branches["all"] > 0) == (case in ("empty", "k31"))
    if case == "ties" and which == "last":
        assert branches["counts"] > 10
        assert (mine != reads).any()


@pytest.mark.parametrize("case", VOTE_CASES + ("ties",))
def test_fix_windows_current_probed_beside_a_solid_one(case):
    """K17 probes a window's current variant only where one of the
    other three is solid (where none is, no edit follows whatever the
    current one is): at every window inside its read, both sub-passes,
    the same edits as with all four probed; at K16's weak windows the
    current variant probed exactly where another one is solid: for an
    error, at about one of the up to k windows it makes weak."""
    if case == "ties":
        reads, lengths, keys, counts, k, threshold = tied_variants_case(15)
    else:
        reads, lengths, keys, counts, k, threshold = _table_case(
            case, 31 if case == "k31" else 15)
    N, Lr = reads.shape
    P = Lr - k + 1
    every = np.arange(N * P)
    if lengths is not None:
        every = every[every % P < lengths[every // P] - k + 1]
    weak = plain.weak_windows(torch.from_numpy(reads),
                              None if lengths is None
                              else torch.from_numpy(lengths),
                              torch.from_numpy(keys),
                              torch.from_numpy(counts), None, k,
                              threshold).numpy()
    layout = solid_layout(keys, counts, k, threshold)
    for which in ("last", "first"):
        lazy, lb = fix_by_membership(reads, every, keys, counts, k,
                                     threshold, which)
        eager, eb = fix_by_membership(reads, every, keys, counts, k,
                                      threshold, which, eager=True)
        np.testing.assert_array_equal(lazy, eager)
        assert eb["current"] == (0 if layout is None else len(every))
        assert lb["current"] <= eb["current"]
        _, wb = fix_by_membership(reads, weak, keys, counts, k, threshold,
                                  which)
        # a weak window's current variant is not solid: it is probed
        # exactly where an edit or a count lookup follows
        assert wb["current"] == wb["one"] + wb["counts"]
        if case in ("errors", "close", "tie", "short", "unpruned"):
            assert 0 < 4 * wb["current"] < len(weak)
