"""The port's sharded stages (sage2_tpu_torch.parallel) on 1, 2 and 8
CPU shards against the reference's single-device functions, exactly:
sharded_count_kmers vs count_kmers, sharded_correct_reads vs
correct_reads, sharded_find_overlaps vs find_overlaps,
sharded_transitive_reduction vs transitive_reduction and
sharded_contract_unitigs vs contract_unitigs (the reference's own
tests/test_parallel.py inputs); and the plain versions of kernels K21
``reduce_requests`` and K22 ``window_variants`` against the reference
code they replace (sharded.py:493-537, kmer/correct.py:36-108)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.data import simulate_genome, simulate_reads
from sage2_tpu.graph.reduce import transitive_reduction
from sage2_tpu.graph.traverse import contract_unitigs
from sage2_tpu.kmer import correct as ref_correct
from sage2_tpu.kmer import correct_reads, count_kmers
from sage2_tpu.ops.sort import expand_by_counts, lex_searchsorted
from sage2_tpu.overlap import find_overlaps, prepare_reads
from sage2_tpu_torch.kernels import plain
from sage2_tpu_torch.parallel import (
    gather_cyclic_shards,
    gather_edge_shards,
    make_mesh,
    partition_edges_by_src,
    sharded_contract_unitigs,
    sharded_correct_reads,
    sharded_count_kmers,
    sharded_find_overlaps,
    sharded_transitive_reduction,
)
from torch_one_thread import one_thread  # noqa: F401

SHARDS = [1, 2, 8]


def _reads(seed, n=128, L=40, err=0.01):
    genome = simulate_genome(800, seed=seed)
    reads, _ = simulate_reads(genome, read_len=L, coverage=n * L / 800,
                              error_rate=err, seed=seed + 1)
    return reads[:n].astype(np.int32)


@pytest.fixture(scope="module")
def graphs():
    """The reference's overlap, reduction and labels of two read sets."""
    out = {}
    for name, seed, min_ovl in (("overlap", 221, 20), ("reduce", 231, 16),
                                ("traverse", 241, 16)):
        rs = prepare_reads(jnp.asarray(_reads(seed, err=0.0)))
        res = find_overlaps(rs.reads2, rs.valid2, min_ovl, capacity=1 << 15)
        assert not bool(res.overflow)
        out[name] = (rs, res)
    rs, res = out["traverse"]
    V, L = rs.reads2.shape
    red = transitive_reduction(res.src, res.dst, res.ovl, V, L,
                               capacity=1 << 15)
    out["labels"] = (red, contract_unitigs(red.src, red.dst, red.ovl, V))
    return out


def _table_dict(keys, counts):
    return dict(zip(keys.tolist(), counts.tolist()))


@pytest.mark.parametrize("nd", SHARDS)
def test_sharded_count_matches_single(nd):
    reads = _reads(201)
    single = count_kmers(jnp.asarray(reads), 15)
    n = int(single.n_unique)
    want = _table_dict(
        (np.asarray(single.hi[:n]).astype(np.int64) << 32)
        | np.asarray(single.lo[:n]).astype(np.int64),
        np.asarray(single.count[:n]))
    mesh = make_mesh(nd, devices="cpu")
    tables, overflow = sharded_count_kmers(mesh, reads, 15, route_cap=4096)
    assert not overflow
    got = {}
    for t in tables:        # each key on one shard only
        part = _table_dict(t.keys, t.count)
        assert not set(part) & set(got)
        got.update(part)
    assert got == want
    _, overflow = sharded_count_kmers(mesh, reads, 15, route_cap=8)
    assert overflow


@pytest.mark.parametrize("nd", SHARDS)
def test_sharded_correct_matches_single(nd):
    reads = _reads(211, err=0.02)
    k, thr, rounds = 11, 3, 2
    single = np.asarray(correct_reads(jnp.asarray(reads), k, thr, rounds))
    mesh = make_mesh(nd, devices="cpu")
    cap = 4 * reads.shape[0] * (reads.shape[1] - k + 1) // nd
    out, overflow = sharded_correct_reads(mesh, reads, k, thr, rounds,
                                          route_cap=cap, query_cap=cap)
    assert not overflow
    np.testing.assert_array_equal(out.numpy(), single)
    _, overflow = sharded_correct_reads(mesh, reads, k, thr, 1,
                                        route_cap=cap, query_cap=64)
    assert overflow
    # ragged reads and the voting rule run on the mesh too: reads of
    # full length correct as fixed-length ones, and the voting rule as
    # the reference's single-device one
    full, overflow = sharded_correct_reads(
        mesh, reads, k, thr, rounds, cap, cap,
        lengths=np.full(reads.shape[0], 40))
    assert not overflow
    np.testing.assert_array_equal(full.numpy(), single)
    voted, overflow = sharded_correct_reads(mesh, reads, k, thr, 1, cap, cap,
                                            rule="vote_all_windows")
    assert not overflow
    np.testing.assert_array_equal(voted.numpy(), np.asarray(correct_reads(
        jnp.asarray(reads), k, thr, 1, rule="vote_all_windows")))


@pytest.mark.parametrize("nd", SHARDS)
def test_sharded_overlaps_match_single(graphs, nd):
    rs, single = graphs["overlap"]
    mesh = make_mesh(nd, devices="cpu")
    src, dst, ovl, n_edges, overflow = sharded_find_overlaps(
        mesh, np.asarray(rs.reads2), np.asarray(rs.valid2), 20, seed_len=32,
        row_cap=1 << 14, join_cap=1 << 14)
    assert not overflow
    assert n_edges == int(single.n_edges)
    got = gather_edge_shards(src, dst, ovl, n_edges)
    for a, b in zip(got, (single.src, single.dst, single.ovl)):
        np.testing.assert_array_equal(a[:n_edges], np.asarray(b)[:n_edges])
    *_, overflow = sharded_find_overlaps(
        mesh, np.asarray(rs.reads2), np.asarray(rs.valid2), 20, seed_len=32,
        row_cap=1 << 14, join_cap=64)
    assert overflow


@pytest.mark.parametrize("nd", SHARDS)
def test_sharded_reduction_matches_single(graphs, nd):
    rs, res = graphs["reduce"]
    V, L = rs.reads2.shape
    single = transitive_reduction(res.src, res.dst, res.ovl, V, L,
                                  capacity=1 << 15)
    assert not bool(single.overflow)
    s_sh, d_sh, o_sh, _ = partition_edges_by_src(res.src, res.dst, res.ovl,
                                                 V, nd, pad_multiple=256)
    mesh = make_mesh(nd, devices="cpu")
    src, dst, ovl, n_edges, n_exp, overflow = sharded_transitive_reduction(
        mesh, s_sh, d_sh, o_sh, V, L, req_cap=1 << 14, cand_cap=1 << 14)
    assert not overflow
    assert n_exp == int(single.n_expansions)
    assert n_edges == int(single.n_edges)
    got = gather_edge_shards(src, dst, ovl, n_edges)
    for a, b in zip(got, (single.src, single.dst, single.ovl)):
        np.testing.assert_array_equal(a[:n_edges], np.asarray(b)[:n_edges])
    *_, overflow = sharded_transitive_reduction(
        mesh, s_sh, d_sh, o_sh, V, L, req_cap=1 << 14, cand_cap=8)
    assert overflow


@pytest.mark.parametrize("nd", SHARDS)
def test_sharded_unitig_labels_match_single(graphs, nd):
    rs, _ = graphs["traverse"]
    red, single = graphs["labels"]
    V = rs.reads2.shape[0]
    s_sh, d_sh, o_sh, _ = partition_edges_by_src(red.src, red.dst, red.ovl,
                                                 V, nd, pad_multiple=256)
    mesh = make_mesh(nd, devices="cpu")
    shards, overflow = sharded_contract_unitigs(mesh, s_sh, d_sh, o_sh, V,
                                                route_cap=1 << 12)
    assert not overflow
    names = ["head", "dist", "nxt", "ovl_next", "outdeg", "indeg"]
    for name, sh, want in zip(names, shards, single):
        np.testing.assert_array_equal(gather_cyclic_shards(sh, V),
                                      np.asarray(want), err_msg=name)
    _, overflow = sharded_contract_unitigs(mesh, s_sh, d_sh, o_sh, V,
                                           route_cap=2)
    assert overflow


@pytest.mark.parametrize("which", ["last", "first"])
@pytest.mark.parametrize("k", [11, 25, 31])
def test_window_variants_match_reference(which, k):
    """K22's plain version: the variant keys against variant_keys_last /
    variant_keys_first, and the verdicts against apply_verdicts over
    counts with ties, zeros and the threshold's edges."""
    rng = np.random.default_rng(k)
    reads = rng.integers(0, 4, size=(24, 40)).astype(np.int32)
    fn = (ref_correct.variant_keys_last if which == "last"
          else ref_correct.variant_keys_first)
    ch, cl, cur = fn(jnp.asarray(reads), k)
    want = np.moveaxis((np.asarray(ch).astype(np.int64) << 32)
                       | np.asarray(cl).astype(np.int64), 0, -1)
    got = plain.window_variants(torch.from_numpy(reads), k, which)
    np.testing.assert_array_equal(got.numpy(), want)
    counts = rng.choice([0, 1, 2, 3, 5], size=want.shape).astype(np.int32)
    off = k - 1 if which == "last" else 0
    for thr in (2, 3):
        ref_out = ref_correct.apply_verdicts(
            jnp.asarray(reads), jnp.asarray(counts), cur, off, thr)
        out = plain.apply_verdicts(torch.from_numpy(reads),
                                   torch.from_numpy(counts), k, which, thr)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
        assert (out.numpy() != reads).any()


def _reference_phases(src, dst, ovl, req, cand_cap, read_len):
    """Phases 2 and 4 of the reference's sharded_transitive_reduction
    (sharded.py:493-537) on one shard's arrays."""
    from sage2_tpu.ops.sort import sort_by_keys

    u = lambda x: x.astype(jnp.uint32)  # noqa: E731
    src, dst, ovl = (jnp.asarray(a) for a in (src, dst, ovl))
    is_edge = src != 2**31 - 1
    sl = jnp.where(is_edge, read_len - ovl, 2**31 - 1)
    ss_src, ss_sl, ss_dst = sort_by_keys([src, sl], [dst])
    rv, rw, rsl, rbound = (jnp.asarray(req[:, c]) for c in range(4))
    start = lex_searchsorted(u(ss_src), u(ss_sl), u(rw),
                             jnp.zeros_like(u(rw)), side="left")
    upto = lex_searchsorted(u(ss_src), u(ss_sl), u(rw), u(rbound),
                            side="right")
    counts = upto - start
    e1, rank, ok = expand_by_counts(counts, cand_cap)
    e2 = jnp.minimum(start[e1] + rank, ss_dst.shape[0] - 1)
    cand = jnp.stack([rv[e1], ss_dst[e2], rsl[e1] + ss_sl[e2]], axis=1)
    ok = ok & (cand[:, 1] != cand[:, 0])
    pos = lex_searchsorted(u(src), u(dst), u(cand[:, 0]), u(cand[:, 1]),
                           side="left")
    pos_c = jnp.minimum(pos, src.shape[0] - 1)
    hit = ok & (src[pos_c] == cand[:, 0]) & (dst[pos_c] == cand[:, 1]) & (
        read_len - ovl[pos_c] == cand[:, 2])
    removed = jnp.zeros(src.shape[0], bool).at[
        jnp.where(hit, pos_c, src.shape[0])].set(True, mode="drop")
    return (np.asarray(cand), np.asarray(ok), int(jnp.sum(counts)),
            np.asarray(removed))


@pytest.mark.parametrize("cand_cap", [1 << 14, 100])
def test_reduce_requests_match_reference(graphs, cand_cap):
    """K21's plain version: each edge's request against the shard's own
    adjacency (one shard), candidates in the reference's order up to the
    capacity, and the membership probe's marks."""
    rs, res = graphs["reduce"]
    L = rs.reads2.shape[1]
    src, dst, ovl = (np.asarray(a) for a in (res.src, res.dst, res.ovl))
    is_edge = src != 2**31 - 1
    sl = np.where(is_edge, L - ovl, 0)
    maxsl = np.full(src.max(where=is_edge, initial=0) + 1, -1)
    np.maximum.at(maxsl, src[is_edge], sl[is_edge])
    bound = maxsl[src[is_edge]] - sl[is_edge]
    req = np.stack([src[is_edge], dst[is_edge], sl[is_edge], bound],
                   1).astype(np.int32)
    req = req[bound >= 0]
    want_cand, want_ok, want_total, _ = _reference_phases(
        src, dst, ovl, req, cand_cap, L)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    sl_all = np.where(is_edge, L - ovl, 2**31 - 1)
    ss_key, order = torch.sort((t(src).long() << 32) | t(sl_all).long(),
                               stable=True)
    # one shard of every vertex: its row table
    row = plain.reduce_rows(ss_key, 0, rs.reads2.shape[0])
    cand, ok, total = plain.reduce_requests(ss_key, t(dst)[order], t(req),
                                            cand_cap, row, 0)
    assert total == want_total
    C = min(total, cand_cap)
    assert cand.shape == (C, 3)
    np.testing.assert_array_equal(cand.numpy(), want_cand[:C])
    np.testing.assert_array_equal(ok.numpy(), want_ok[:C])
    assert not want_ok[C:].any()
    # the probe over the candidates that reach v's owner (all ok ones)
    _, _, _, want_removed = _reference_phases(src, dst, ovl, req, 1 << 14, L)
    full, full_ok, _ = plain.reduce_requests(ss_key, t(dst)[order], t(req),
                                             1 << 14, row, 0)
    removed = plain.reduce_probe(t(src), t(dst), t(ovl), full[full_ok], L,
                                 0, row)
    np.testing.assert_array_equal(removed.numpy(), want_removed)
    assert removed.any()


def _shard_phases(src, dst, ovl, req, cand_cap, src_len, probe_len):
    """Phases 2 and 4 of the reference's sharded_transitive_reduction
    (sharded.py:493-537) on one shard's padded arrays, with per-edge
    source lengths ``src_len`` (the adjacency's sl = len(src) - ovl) and
    the probe's length of each candidate's v, ``probe_len(v)``."""
    from sage2_tpu.ops.sort import sort_by_keys

    u = lambda x: x.astype(jnp.uint32)  # noqa: E731
    src, dst, ovl = (jnp.asarray(a) for a in (src, dst, ovl))
    is_edge = src != 2**31 - 1
    sl = jnp.where(is_edge, jnp.asarray(src_len) - ovl, 2**31 - 1)
    ss_src, ss_sl, ss_dst = sort_by_keys([src, sl], [dst])
    rv, rw, rsl, rbound = (jnp.asarray(req[:, c]) for c in range(4))
    start = lex_searchsorted(u(ss_src), u(ss_sl), u(rw),
                             jnp.zeros_like(u(rw)), side="left")
    upto = lex_searchsorted(u(ss_src), u(ss_sl), u(rw), u(rbound),
                            side="right")
    counts = upto - start
    e1, rank, ok = expand_by_counts(counts, cand_cap)
    e2 = jnp.minimum(start[e1] + rank, ss_dst.shape[0] - 1)
    cand = jnp.stack([rv[e1], ss_dst[e2], rsl[e1] + ss_sl[e2]], axis=1)
    ok = ok & (cand[:, 1] != cand[:, 0])
    pos = lex_searchsorted(u(src), u(dst), u(cand[:, 0]), u(cand[:, 1]),
                           side="left")
    pos_c = jnp.minimum(pos, src.shape[0] - 1)
    hit = ok & (src[pos_c] == cand[:, 0]) & (dst[pos_c] == cand[:, 1]) & (
        jnp.asarray(probe_len(np.asarray(cand[:, 0]))) - ovl[pos_c]
        == cand[:, 2])
    removed = jnp.zeros(src.shape[0], bool).at[
        jnp.where(hit, pos_c, src.shape[0])].set(True, mode="drop")
    return (np.asarray(cand), np.asarray(ok), np.asarray(counts),
            np.asarray(removed))


# (shard of 3, ragged lengths, where cand_cap falls)
ROW_TABLE_CASES = [(0, False, "none"), (1, False, "inside"),
                   (2, False, "none"), (1, True, "inside"),
                   (2, True, "none")]


@pytest.mark.parametrize("d,ragged,cut", ROW_TABLE_CASES)
def test_row_table_phases_match_reference(graphs, d, ragged, cut):
    """K21's vertex row table and its plain ranges, expansion and probe
    that start from it, on shard d of 3 (the last shard's range passes
    the vertex count: the clamp), fixed-length or ragged lengths: the
    requests of every edge into the shard's range, in source order, give
    the reference's phase 2 arrays (its searches of the whole adjacency),
    with cand_cap cutting inside a request or not at all; the probe of
    the candidates, the reference's phase 4 marks. Vertices without
    edges have empty runs; requests to them expand to nothing."""
    rs, res = graphs["reduce"]
    V, L = rs.reads2.shape
    n = 3
    v_d = -(-V // n)
    vbase = d * v_d
    I32 = 2**31 - 1
    src, dst, ovl = (np.asarray(a) for a in (res.src, res.dst, res.ovl))
    e = src != I32
    src, dst, ovl = src[e], dst[e], ovl[e]
    lens = (np.random.default_rng(d).integers(L, L + 25, size=V)
            if ragged else np.full(V, L)).astype(np.int32)
    # ragged reads: a read longer than L overlaps its successors by as
    # much more, so the offsets sl (and the transitive edges) stay
    ovl = (ovl + lens[src] - L).astype(np.int32)
    sl = lens[src] - ovl
    maxsl = np.full(V, -1)
    np.maximum.at(maxsl, src, sl)
    bound = maxsl[src] - sl
    owner = np.clip(dst // v_d, 0, n - 1)
    take = (owner == d) & (bound >= 0)
    req = np.stack([src, dst, sl, bound], 1)[take].astype(np.int32)
    # the shard's own edges, (src, dst) order, padded
    mine = (src >= vbase) & (src < vbase + v_d)
    pad = 37
    s_src = np.concatenate([src[mine], np.full(pad, I32)]).astype(np.int32)
    s_dst = np.concatenate([dst[mine], np.full(pad, I32)]).astype(np.int32)
    s_ovl = np.concatenate([ovl[mine], np.zeros(pad)]).astype(np.int32)
    key = s_src.astype(np.int64) << 32 | s_dst
    assert (np.diff(key) >= 0).all()
    s_len = np.concatenate([lens[src[mine]], np.zeros(pad)]).astype(np.int32)
    local = lens[vbase:vbase + v_d]
    if local.shape[0] < v_d:            # the last shard's range
        local = np.concatenate([local, np.zeros(v_d - local.shape[0],
                                                np.int32)])

    def probe_len(v):
        return local[np.clip(v - vbase, 0, v_d - 1)] if ragged else L

    _, _, counts, _ = _shard_phases(s_src, s_dst, s_ovl, req, 1 << 16,
                                    s_len, probe_len)
    total = int(counts.sum())
    cand_cap = 1 << 16
    if cut == "inside":          # inside the largest request's range
        j = int(np.argmax(counts))
        assert counts[j] >= 2
        cand_cap = int(counts[:j].sum()) + int(counts[j]) // 2
    want_cand, want_ok, _, want_removed = _shard_phases(
        s_src, s_dst, s_ovl, req, cand_cap, s_len, probe_len)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    s_sl = np.where(s_src != I32, s_len - s_ovl, I32)
    ss_key, order = torch.sort((t(s_src).long() << 32) | t(s_sl).long(),
                               stable=True)
    ss_dst = t(s_dst)[order].contiguous()
    row = plain.reduce_rows(ss_key, vbase, v_d)
    np.testing.assert_array_equal(
        row.numpy(), np.searchsorted(s_src, vbase + np.arange(v_d + 1)))
    assert (np.diff(row.numpy()) == 0).any()     # vertices without edges
    if d == n - 1:
        assert vbase + v_d > V
    cand, ok, got_total = plain.reduce_requests(ss_key, ss_dst, t(req),
                                                cand_cap, row, vbase)
    assert got_total == total
    C = min(total, cand_cap)
    assert C == (cand_cap if cut == "inside" else total)
    np.testing.assert_array_equal(cand.numpy(), want_cand[:C])
    np.testing.assert_array_equal(ok.numpy(), want_ok[:C])
    assert not want_ok[C:].any()
    # the probe of every ok candidate (those with v in the shard's range
    # hit; the rest have empty runs here and miss), the row table's runs
    # of the (src, dst) order
    full, full_ok, _ = plain.reduce_requests(ss_key, ss_dst, t(req),
                                             1 << 16, row, vbase)
    probed = full[full_ok]
    read_len = t(local) if ragged else L
    removed = plain.reduce_probe(t(s_src), t(s_dst), t(s_ovl), probed,
                                 read_len, vbase, row)
    _, _, _, want_removed = _shard_phases(s_src, s_dst, s_ovl, req, 1 << 16,
                                          s_len, probe_len)
    np.testing.assert_array_equal(removed.numpy(), want_removed)
    assert removed.any()
