"""Streaming on the port's device mesh (sage2_tpu_torch.parallel.
sharded_stream) against the reference on the CPU, exactly, on 2, 4 and
8 CPU shards: the chunked count against count_kmers (and its table_cap
flag at the largest owner's unique-key count), the chunked correction
against correct_reads under both rules, fixed-length and ragged, the
chunked overlaps against find_overlaps_auto/find_overlaps (edges and
containment marks), the owners' join input in the reference's (key,
tag | id) order, gather_edge_shards_spill against the reference's
(byte-equal memmaps), each capacity's flag at the reference's chunked
functions' own threshold, and ``assemble`` with ``mesh_shape=(8,)`` and
``max_device_reads`` below the read count against the reference's
in-core assembly, fixed-length and ragged, with its artifacts, spill
files and resume at ``reduce``. The inputs are the reference's own
(tests/test_parallel.py:217, 246, 306; tests/test_pipeline_mesh.py:56;
tests/test_ragged.py:126); at these sizes the reference's chunked
shard_map steps run in seconds, so the flags and per-shard slices are
held to them directly, and the rest to the reference's in-core and
single-device results."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu import AssemblyConfig as RefConfig
from sage2_tpu.data import simulate_genome, simulate_reads
from sage2_tpu.kmer import correct_reads, count_kmers
from sage2_tpu.overlap import find_overlaps, find_overlaps_auto, prepare_reads
from sage2_tpu.parallel import sharded as ref_sharded
from sage2_tpu.pipeline import assemble as ref_assemble
from sage2_tpu.utils.spill import SpillStore as RefSpillStore
from sage2_tpu_torch import AssemblyConfig, kernels
from sage2_tpu_torch.data import simulate_ragged_reads
from sage2_tpu_torch.parallel import (
    gather_edge_shards,
    gather_edge_shards_spill,
    make_mesh,
    sharded_correct_reads_chunked,
    sharded_count_kmers_chunked,
    sharded_find_overlaps_chunked,
)
from sage2_tpu_torch.pipeline import assemble, load_reference_artifacts
from sage2_tpu_torch.utils.spill import SpillStore
from torch_one_thread import one_thread  # noqa: F401

SHARDS = [2, 8]
K = 13
I32_MAX = 2**31 - 1


def _mesh(nd):
    return make_mesh(nd, devices="cpu")


@pytest.fixture(scope="module")
def fixed_reads():
    """tests/test_parallel.py:217's reads: 1,200 bp, 40 bp, 15x, 2%."""
    genome = simulate_genome(1200, seed=61)
    reads, _ = simulate_reads(genome, read_len=40, coverage=15,
                              error_rate=0.02, seed=62)
    return reads.astype(np.int32)


def _ragged(seed=411, n=128, err=0.03):
    """n ragged reads (28-40 bp, contained ones) of an 800 bp genome,
    zero-padded to 40 (tests/test_torch_parallel_ragged.py's)."""
    genome = simulate_genome(800, seed=seed)
    reads, lens = simulate_ragged_reads(genome, 28, 40, 12.0, err,
                                        seed=seed + 1, contained_frac=0.15)
    return reads[:n].astype(np.int32), lens[:n]


def _ref_keys(t, n):
    return (np.asarray(t.hi)[:n].astype(np.int64) << 32) | np.asarray(
        t.lo)[:n].astype(np.int64)


@pytest.mark.parametrize("nd", SHARDS)
def test_chunked_count_matches_reference(fixed_reads, nd):
    t_ref = count_kmers(jnp.asarray(fixed_reads), K)
    n = int(t_ref.n_unique)
    tables, ovf = sharded_count_kmers_chunked(_mesh(nd), fixed_reads, K, 100,
                                              4096, 4096)
    assert not ovf
    keys = torch.cat([t.keys for t in tables]).numpy()
    counts = torch.cat([t.count for t in tables]).numpy()
    order = np.argsort(keys)
    np.testing.assert_array_equal(keys[order], _ref_keys(t_ref, n))
    np.testing.assert_array_equal(counts[order], np.asarray(t_ref.count)[:n])
    for t in tables:                # each owner's table sorted, unique
        assert (np.diff(t.keys.numpy()) > 0).all()


def test_chunked_count_table_cap_flags_the_largest_owner(fixed_reads):
    """table_cap one below the largest owner's unique-key count (the
    reference's count_kmers keys under its owner hash) flags overflow;
    that count does not."""
    nd = 8
    t_ref = count_kmers(jnp.asarray(fixed_reads), K)
    n = int(t_ref.n_unique)
    owner = np.asarray(ref_sharded._owner(t_ref.hi[:n], t_ref.lo[:n], nd))
    largest = int(np.bincount(owner, minlength=nd).max())
    tables, ovf = sharded_count_kmers_chunked(_mesh(nd), fixed_reads, K, 100,
                                              4096, largest)
    assert not ovf
    assert max(t.n_unique for t in tables) == largest
    tables, ovf = sharded_count_kmers_chunked(_mesh(nd), fixed_reads, K, 100,
                                              4096, largest - 1)
    assert ovf
    assert max(t.n_unique for t in tables) == largest - 1


@pytest.mark.parametrize("nd", SHARDS)
@pytest.mark.parametrize("rule", ["single_window", "vote_all_windows"])
@pytest.mark.parametrize("ragged", [False, True])
def test_chunked_correct_matches_reference(fixed_reads, nd, rule, ragged):
    if ragged:
        reads, lens = _ragged()
        chunk = 48
    else:
        reads, lens = fixed_reads, None
        chunk = 100
    thr, rounds = 3, 2
    want = np.asarray(correct_reads(
        jnp.asarray(reads), K, thr, rounds, rule=rule,
        lengths=None if lens is None else jnp.asarray(lens)), np.int8)
    out = np.zeros(reads.shape, np.int8)       # a destination, as a spill's
    got, ovf = sharded_correct_reads_chunked(
        _mesh(nd), reads.astype(np.int8), K, thr, rounds, chunk, 8192, 8192,
        4096, lengths=lens, rule=rule, out=out)
    assert not ovf
    assert got is out
    np.testing.assert_array_equal(got, want)
    assert (want != reads).any()


@pytest.fixture(scope="module")
def fixed_graph(fixed_reads):
    """The reference's corrected, deduplicated reads of fixed_reads and
    their overlaps (tests/test_parallel.py:246)."""
    corr = np.asarray(correct_reads(jnp.asarray(fixed_reads), K, 3, 2))
    rs = prepare_reads(jnp.asarray(corr))
    res = find_overlaps_auto(rs.reads2, rs.valid2, 20, seed_len=32)
    assert not bool(res.overflow)
    return np.asarray(rs.reads2), np.asarray(rs.valid2), None, res


@pytest.fixture(scope="module")
def ragged_graph():
    """Deduplicated ragged reads and the reference's overlaps of them,
    with containment marks."""
    reads, lens = _ragged(421, err=0.0)
    rs = prepare_reads(jnp.asarray(reads), jnp.asarray(lens))
    res = find_overlaps(rs.reads2, rs.valid2, 20, capacity=1 << 15,
                        lengths=rs.lengths2)
    assert not bool(res.overflow) and bool(res.contained.any())
    return (np.asarray(rs.reads2), np.asarray(rs.valid2),
            np.asarray(rs.lengths2), res)


def _chunked_overlaps(graph, nd, chunk):
    reads2, valid2, lens2, _ = graph
    return sharded_find_overlaps_chunked(
        _mesh(nd), reads2, valid2, 20, 32, chunk, 4096, 4096, 1 << 16, 4096,
        1 << 16, lengths=lens2)


@pytest.mark.parametrize("nd", SHARDS)
@pytest.mark.parametrize("which", ["fixed", "ragged"])
def test_chunked_overlaps_match_reference(fixed_graph, ragged_graph, nd,
                                          which):
    graph = fixed_graph if which == "fixed" else ragged_graph
    reads2, _, lens2, res = graph
    M = reads2.shape[0]
    out = _chunked_overlaps(graph, nd, 160 if which == "fixed" else 64)
    src, dst, ovl, n_edges, ovf = out[:5]
    assert not ovf
    n = int(res.n_edges)
    assert n_edges == n
    # each shard's slice: its source range of ceil(M / nd) reads, sorted
    v_d = -(-M // nd)
    for d, s in enumerate(src):
        live = s.numpy()[s.numpy() != I32_MAX]
        assert ((live // v_d) == d).all()
    got = gather_edge_shards(src, dst, ovl, n_edges)
    for g, want in zip(got, (res.src, res.dst, res.ovl)):
        np.testing.assert_array_equal(g[:n], np.asarray(want)[:n])
    if lens2 is None:
        assert len(out) == 5
    else:
        np.testing.assert_array_equal(out[5], np.asarray(res.contained))


@pytest.mark.parametrize("which", ["fixed", "ragged"])
def test_owner_join_rows_in_reference_order(fixed_graph, ragged_graph,
                                            monkeypatch, which):
    """Each owner's join input, its entries accumulated chunk by chunk and
    source by source and a chunk's queries, lies in the reference's
    (key, tag | id) sort order (sage2_tpu/overlap/detect.py:906-913):
    the port's stable entries-first key sort needs each class in id
    order."""
    from sage2_tpu_torch.overlap.detect import join_geometry

    graph = fixed_graph if which == "fixed" else ragged_graph
    geo = join_geometry(graph[0].shape[1], 20, 20)
    join = kernels.overlap_join
    seen = []

    def check(s_keys, s_rows, *args):
        keys = s_keys.numpy()
        ids = s_rows.numpy().astype(np.int64)
        tag = (ids % geo.R) >= geo.g
        assert (np.lexsort((ids, tag, keys)) == np.arange(len(ids))).all()
        # key runs of two or more entries, of two or more queries: the
        # order within a class is exercised
        run = np.cumsum(np.r_[True, keys[1:] != keys[:-1]]) - 1
        seen.append(((np.bincount(run, weights=~tag) >= 2).sum(),
                     (np.bincount(run, weights=tag) >= 2).sum()))
        return join(s_keys, s_rows, *args)

    monkeypatch.setattr(kernels, "overlap_join", check)
    out = _chunked_overlaps(graph, 8, 64)
    assert not out[4]
    # 8 owners a chunk
    assert len(seen) == 8 * -(-graph[0].shape[0] // 64)
    assert (np.sum(seen, axis=0) > 0).all()


# --------------------------------------------------------------------------
# capacities: each flag fires where the reference's chunked function's does
# --------------------------------------------------------------------------


def _least(overflows, hi: int) -> int:
    """The least cap in [1, hi] at which ``overflows(cap)`` is False (it
    is True at 0 and False at hi, and monotone)."""
    lo = 0
    assert not overflows(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if overflows(mid):
            lo = mid
        else:
            hi = mid
    return hi


OVERLAP_CAPS = dict(row_cap=4096, q_cap=4096, join_cap=1 << 16,
                    edge_chunk_cap=4096, edge_cap=1 << 16)


@pytest.mark.parametrize("cap", list(OVERLAP_CAPS))
def test_chunked_overlap_flags_fire_where_the_reference_does(fixed_graph,
                                                             cap):
    """The least value of each overlap capacity at which the port's
    streamed overlaps do not overflow (the others generous): the
    reference's sharded_find_overlaps_chunked overflows one below it and
    not at it, where its per-shard edge slices (their lengths too) equal
    the port's."""
    from sage2_tpu.parallel import make_mesh as ref_mesh
    from sage2_tpu.parallel import sharded_stream as ref_stream

    reads2, valid2, _, _ = fixed_graph
    nd = 4

    def port(value):
        return sharded_find_overlaps_chunked(
            _mesh(nd), reads2, valid2, 20, 32, 160,
            **dict(OVERLAP_CAPS, **{cap: value}))

    def ref(value):
        return ref_stream.sharded_find_overlaps_chunked(
            ref_mesh(nd), reads2, valid2, 20, 32, chunk_reads=160,
            **dict(OVERLAP_CAPS, **{cap: value}))

    t = _least(lambda v: port(v)[4], OVERLAP_CAPS[cap])
    assert t > 1
    assert ref(t - 1)[4]
    want, got = ref(t), port(t)
    assert not want[4] and want[3] == got[3]
    for w, g in zip(want[:3], got[:3]):
        w = np.asarray(w)
        assert w.shape == (nd, g[0].shape[0])
        np.testing.assert_array_equal(w, torch.stack(g).numpy())


def test_chunked_ragged_overlaps_match_reference_chunked(ragged_graph):
    """Ragged reads2: the reference's sharded_find_overlaps_chunked and
    the port's give the same per-shard edge slices, n_edges and
    containment marks."""
    from sage2_tpu.parallel import make_mesh as ref_mesh
    from sage2_tpu.parallel import sharded_stream as ref_stream

    reads2, valid2, lens2, _ = ragged_graph
    want = ref_stream.sharded_find_overlaps_chunked(
        ref_mesh(4), reads2, valid2, 20, 32, chunk_reads=64,
        lengths=lens2, **OVERLAP_CAPS)
    got = sharded_find_overlaps_chunked(_mesh(4), reads2, valid2, 20, 32, 64,
                                        lengths=lens2, **OVERLAP_CAPS)
    assert not want[4] and not got[4] and want[3] == got[3]
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(np.asarray(w), torch.stack(g).numpy())
    np.testing.assert_array_equal(got[5], want[5])
    assert got[5].any()


def test_chunked_count_and_correct_flags_fire_where_the_reference_does(
        fixed_reads):
    """The least route_cap of the chunked count and the least query_cap
    of the chunked correction at which the port does not overflow: the
    reference's chunked functions overflow one below it and not at it,
    with the port's tables and corrected reads there."""
    from sage2_tpu.parallel import make_mesh as ref_mesh
    from sage2_tpu.parallel import sharded_stream as ref_stream

    nd = 4
    t = _least(lambda v: sharded_count_kmers_chunked(
        _mesh(nd), fixed_reads, K, 100, v, 4096)[1], 4096)
    assert ref_stream.sharded_count_kmers_chunked(
        ref_mesh(nd), fixed_reads, K, 100, t - 1, 4096)[1]
    want, ovf = ref_stream.sharded_count_kmers_chunked(
        ref_mesh(nd), fixed_reads, K, 100, t, 4096)
    assert not ovf
    tables, _ = sharded_count_kmers_chunked(_mesh(nd), fixed_reads, K, 100,
                                            t, 4096)
    for d, table in enumerate(tables):
        n = int(np.asarray(want.n_unique)[d])
        keys = (np.asarray(want.hi)[d, :n].astype(np.int64) << 32) | \
            np.asarray(want.lo)[d, :n].astype(np.int64)
        np.testing.assert_array_equal(table.keys.numpy(), keys)
        np.testing.assert_array_equal(table.count.numpy(),
                                      np.asarray(want.count)[d, :n])
    reads = fixed_reads.astype(np.int8)
    t = _least(lambda v: sharded_correct_reads_chunked(
        _mesh(nd), reads, K, 3, 1, 100, 8192, v, 4096)[1], 8192)
    assert ref_stream.sharded_correct_reads_chunked(
        ref_mesh(nd), reads, K, 3, 1, 100, 8192, t - 1, 4096)[1]
    want, ovf = ref_stream.sharded_correct_reads_chunked(
        ref_mesh(nd), reads, K, 3, 1, 100, 8192, t, 4096)
    assert not ovf
    got, _ = sharded_correct_reads_chunked(_mesh(nd), reads, K, 3, 1, 100,
                                           8192, t, 4096)
    np.testing.assert_array_equal(got, want)


def test_gather_edge_shards_spill_matches_reference(tmp_path):
    """The same (ndev, E_d) shard arrays into the port's and the
    reference's spill stores: byte-equal memmaps, padded to 2^14."""
    rng = np.random.default_rng(5)
    nd, e_d = 4, 3000
    src = np.full((nd, e_d), I32_MAX, np.int32)
    dst = np.full((nd, e_d), I32_MAX, np.int32)
    ovl = np.zeros((nd, e_d), np.int32)
    n_edges = 0
    for d in range(nd):
        n = int(rng.integers(0, e_d))
        src[d, :n] = np.sort(rng.integers(d * 100, (d + 1) * 100, n))
        dst[d, :n] = rng.integers(0, 400, n)
        ovl[d, :n] = rng.integers(20, 40, n)
        n_edges += n
    ref = ref_sharded.gather_edge_shards_spill(
        RefSpillStore(str(tmp_path / "ref")), src, dst, ovl, n_edges)
    port = gather_edge_shards_spill(
        SpillStore(str(tmp_path / "port")),
        [torch.from_numpy(x) for x in src], [torch.from_numpy(x)
                                             for x in dst],
        [torch.from_numpy(x) for x in ovl], n_edges)
    for name, a, b in zip(("src", "dst", "ovl"), ref, port):
        assert a.shape == b.shape == (1 << 14,)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        with open(tmp_path / "ref" / f"edges_{name}.bin", "rb") as f:
            want = f.read()
        with open(tmp_path / "port" / f"edges_{name}.bin", "rb") as f:
            assert f.read() == want
    with pytest.raises(AssertionError):
        gather_edge_shards_spill(SpillStore(str(tmp_path / "bad")),
                                 src, dst, ovl, n_edges + 1)


# --------------------------------------------------------------------------
# assemble: the streamed mesh against the reference's in-core run
# --------------------------------------------------------------------------

CFG = dict(k=15, min_overlap=25, min_contig_len=150)
RAGGED_CFG = dict(k=15, min_overlap=30, min_contig_len=150)


@pytest.fixture(scope="module")
def ref_fixed(tmp_path_factory):
    """tests/test_pipeline_mesh.py:56's input (500 reads of 50 bp, not a
    multiple of 8) and the reference's in-core run of it, artifacts
    written."""
    genome = simulate_genome(2000, seed=501)
    reads, _ = simulate_reads(genome, read_len=50, coverage=12.5,
                              error_rate=0.01, seed=502)
    out = tmp_path_factory.mktemp("stream_mesh") / "ref"
    contigs, stats = ref_assemble(reads, RefConfig(**CFG), outdir=str(out))
    return reads, out, contigs, stats


@pytest.fixture(scope="module")
def ref_ragged():
    """tests/test_ragged.py:126's input (3 kbp, 700 reads of 50-80 bp and
    70 contained ones) and the reference's in-core run of it."""
    genome = simulate_genome(3000, seed=21)
    rng = np.random.default_rng(22)
    reads = []
    for _ in range(700):
        ln = int(rng.integers(50, 81))
        start = int(rng.integers(0, len(genome) - ln))
        r = np.array(genome[start:start + ln], np.int8)
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        reads.append(r)
    for _ in range(70):
        ln = int(rng.integers(35, 48))
        start = int(rng.integers(0, len(genome) - ln))
        reads.append(np.array(genome[start:start + ln], np.int8))
    arr = np.zeros((len(reads), 80), np.int8)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        arr[i, :len(r)] = r
    contigs, stats = ref_assemble(arr, RefConfig(**RAGGED_CFG), lengths=lens)
    return arr, lens, contigs, stats


def _equal(got, want):
    assert got[1] == want[1]
    assert len(got[0]) == len(want[0]) >= 1
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["fixed", "ragged"])
def test_streamed_mesh_assembly_matches_reference(ref_fixed, ref_ragged,
                                                  which):
    if which == "fixed":
        reads, _, *want = ref_fixed
        cfg, lens, chunk = CFG, None, 100
    else:
        reads, lens, *want = ref_ragged
        cfg, chunk = RAGGED_CFG, 200
    assert reads.shape[0] > chunk and reads.shape[0] % 8
    got = assemble(reads, AssemblyConfig(**cfg, mesh_shape=(8,),
                                         max_device_reads=chunk),
                   device="cpu", lengths=lens)
    _equal(got, want)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_streamed_mesh_artifacts_spill_and_resume(ref_fixed, tmp_path):
    """A streamed meshed run with an outdir and a spill dir: contigs.fasta
    and stats.json byte for byte the reference's in-core run; corrected
    reads and reads2 in the spill store, the edges gathered into its
    ``edges_*`` memmaps and edges.npz without them; every artifact equal
    to the reference's; resumed at ``reduce`` from its own artifacts and
    spill dir, the same contigs and stats."""
    reads, ref_out, *want = ref_fixed
    cfg = AssemblyConfig(**CFG, mesh_shape=(8,), max_device_reads=100,
                         spill_dir=str(tmp_path / "spill"))
    out = tmp_path / "port"
    got = assemble(reads, cfg, outdir=str(out), device="cpu")
    _equal(got, want)
    for name in ("contigs.fasta", "stats.json"):
        assert _bytes(out / name) == _bytes(ref_out / name), name
    spilled = set(os.listdir(tmp_path / "spill"))
    assert {"corrected.bin", "reads2.bin", "edges_src.bin", "edges_dst.bin",
            "edges_ovl.bin"} <= spilled
    with np.load(out / "edges.npz") as z:
        assert "src" not in z.files and "reads2" not in z.files
    with pytest.raises(ValueError, match="spill"):
        load_reference_artifacts(str(out))
    port = load_reference_artifacts(str(out), str(tmp_path / "spill"))
    ref = load_reference_artifacts(str(ref_out))
    assert port["manifest"]["spilled"]
    for name in ("corrected", "labels"):
        for key in ref[name]:
            np.testing.assert_array_equal(port[name][key], ref[name][key],
                                          err_msg=f"{name}.{key}")
    for key in ("valid2", "multiplicity", "n_edges"):
        np.testing.assert_array_equal(port["edges"][key], ref["edges"][key])
    # the streamed dedup fills the invalid rows of reads2 otherwise than
    # the in-core one (as on one device); the valid rows are equal
    valid = ref["edges"]["valid2"]
    np.testing.assert_array_equal(port["edges"]["reads2"][valid],
                                  ref["edges"]["reads2"][valid])
    for name in ("edges", "reduced"):
        n = int(np.sum(ref[name]["src"] != I32_MAX))
        for key in ("src", "dst", "ovl"):
            np.testing.assert_array_equal(port[name][key][:n],
                                          ref[name][key][:n])
        assert (port[name]["src"][n:] == I32_MAX).all()
    assert port["edges"]["src"].shape[0] % (1 << 14) == 0
    for name in ("contigs.fasta", "stats.json", "reduced.npz", "labels.npz"):
        os.remove(out / name)
    resumed = assemble(reads, cfg, outdir=str(out), resume_from="reduce",
                       device="cpu")
    _equal(resumed, want)
    for name in ("contigs.fasta", "stats.json"):
        assert _bytes(out / name) == _bytes(ref_out / name), name
