"""The port's sharded stages with ragged reads (``lengths``) on 1, 2 and 8
CPU shards against the reference's sharded functions under shard_map
(the conftest's 8 CPU devices) and its single-device functions, exactly:
sharded_correct_reads (single_window, its window masks),
sharded_find_overlaps (edges and containment marks) and
sharded_transitive_reduction (``lengths_sh``); the plain versions of
K21's ragged probe and K22's ragged verdicts against the reference code
they replace (sharded.py:518-537, kmer/correct.py:86); and the meshed
ragged assembly: ``assemble`` on 2 and 8 shards against the reference's
single-device run, its resume at ``reduce`` from reference-written
artifacts, and ``--mesh 2 --length-policy pad`` byte for byte."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu import AssemblyConfig as RefConfig
from sage2_tpu.cli import main as ref_main
from sage2_tpu.data import simulate_genome
from sage2_tpu.graph.reduce import transitive_reduction
from sage2_tpu.kmer import correct as ref_correct
from sage2_tpu.kmer import correct_reads
from sage2_tpu.overlap import find_overlaps, prepare_reads
from sage2_tpu.parallel import make_mesh as ref_mesh
from sage2_tpu.parallel import sharded as ref_sharded
from sage2_tpu.pipeline import assemble as ref_assemble
from sage2_tpu_torch import AssemblyConfig
from sage2_tpu_torch.cli import main as port_main
from sage2_tpu_torch.data import simulate_ragged_reads
from sage2_tpu_torch.kernels import plain
from sage2_tpu_torch.parallel import (
    gather_edge_shards,
    make_mesh,
    partition_edges_by_src,
    partition_vertex_range,
    sharded_correct_reads,
    sharded_find_overlaps,
    sharded_transitive_reduction,
)
from sage2_tpu_torch.pipeline import assemble
from torch_one_thread import one_thread  # noqa: F401

SHARDS = [1, 2, 8]
I32_MAX = 2**31 - 1


def _ragged(seed, n=128, lo=28, hi=40, err=0.01):
    """n ragged reads (a multiple of 8) of an 800 bp genome, contained
    ones among them, zero-padded to ``hi``."""
    genome = simulate_genome(800, seed=seed)
    reads, lens = simulate_ragged_reads(genome, lo, hi, 12.0, err,
                                        seed=seed + 1, contained_frac=0.15)
    return reads[:n].astype(np.int32), lens[:n]


@pytest.fixture(scope="module")
def graph():
    """Deduplicated ragged reads padded to 8 shards, and the reference's
    overlap (with containment marks) and reduction of them."""
    reads, lens = _ragged(421, err=0.0)
    rs = prepare_reads(jnp.asarray(reads), jnp.asarray(lens))
    M = rs.reads2.shape[0]
    pad = (-M) % 8
    reads2 = np.concatenate([np.asarray(rs.reads2),
                             np.zeros((pad, reads.shape[1]), np.int32)])
    valid2 = np.concatenate([np.asarray(rs.valid2), np.zeros(pad, bool)])
    lens2 = np.concatenate([np.asarray(rs.lengths2),
                            np.zeros(pad, np.int32)])
    res = find_overlaps(jnp.asarray(reads2), jnp.asarray(valid2), 20,
                        capacity=1 << 15, lengths=jnp.asarray(lens2))
    assert not bool(res.overflow) and bool(res.contained.any())
    red = transitive_reduction(res.src, res.dst, res.ovl, M + pad,
                               jnp.asarray(lens2), capacity=1 << 15)
    assert not bool(red.overflow)
    return reads2, valid2, lens2, res, red


@pytest.mark.parametrize("nd", SHARDS)
def test_sharded_ragged_correct_matches_reference(nd):
    reads, lens = _ragged(411, err=0.03)
    k, thr, rounds = 11, 3, 2
    single = np.asarray(correct_reads(jnp.asarray(reads), k, thr, rounds,
                                      lengths=jnp.asarray(lens)))
    cap = 4 * reads.shape[0] * (reads.shape[1] - k + 1) // nd
    ref, ovf = ref_sharded.sharded_correct_reads(
        ref_mesh(nd), jnp.asarray(reads), k, thr, rounds, cap, cap,
        lengths=jnp.asarray(lens))
    assert not bool(ovf)
    np.testing.assert_array_equal(np.asarray(ref), single)
    out, overflow = sharded_correct_reads(make_mesh(nd, devices="cpu"),
                                          reads, k, thr, rounds, cap, cap,
                                          lengths=lens)
    assert not overflow
    np.testing.assert_array_equal(out.numpy(), single)
    assert (single != reads).any()
    # past a read's end nothing is edited
    past = np.arange(reads.shape[1])[None, :] >= lens[:, None]
    assert (out.numpy()[past] == reads[past]).all()


@pytest.mark.parametrize("nd", SHARDS)
def test_sharded_ragged_overlaps_match_reference(graph, nd):
    reads2, valid2, lens2, single, _ = graph
    n_ref = int(single.n_edges)
    ref = ref_sharded.sharded_find_overlaps(
        ref_mesh(nd), jnp.asarray(reads2), jnp.asarray(valid2), 20, 32,
        row_cap=1 << 14, join_cap=1 << 14, lengths=jnp.asarray(lens2))
    out = sharded_find_overlaps(make_mesh(nd, devices="cpu"), reads2,
                                valid2, 20, 32, row_cap=1 << 14,
                                join_cap=1 << 14, lengths=lens2)
    assert len(out) == 6 and not out[4] and not bool(ref[4])
    assert out[3] == int(ref[3]) == n_ref
    got = gather_edge_shards(*out[:3], out[3])
    want = ref_sharded.gather_edge_shards(*ref[:3], ref[3])
    for a, b, c in zip(got, want, (single.src, single.dst, single.ovl)):
        np.testing.assert_array_equal(a[:n_ref], np.asarray(b)[:n_ref])
        np.testing.assert_array_equal(a[:n_ref], np.asarray(c)[:n_ref])
    np.testing.assert_array_equal(out[5].numpy(), np.asarray(ref[5]))
    np.testing.assert_array_equal(out[5].numpy(),
                                  np.asarray(single.contained))


@pytest.mark.parametrize("nd", SHARDS)
def test_sharded_ragged_reduction_matches_reference(graph, nd):
    reads2, _, lens2, res, single = graph
    V = reads2.shape[0]
    L = reads2.shape[1]
    s_sh, d_sh, o_sh, _ = partition_edges_by_src(res.src, res.dst, res.ovl,
                                                 V, nd, pad_multiple=256)
    lens_sh = partition_vertex_range(lens2, V, nd)
    ref = ref_sharded.sharded_transitive_reduction(
        ref_mesh(nd), jnp.asarray(s_sh), jnp.asarray(d_sh),
        jnp.asarray(o_sh), V, L, req_cap=1 << 14, cand_cap=1 << 14,
        lengths_sh=jnp.asarray(lens_sh))
    out = sharded_transitive_reduction(
        make_mesh(nd, devices="cpu"), s_sh, d_sh, o_sh, V, L,
        req_cap=1 << 14, cand_cap=1 << 14, lengths_sh=lens_sh)
    assert not out[5] and not bool(ref[5])
    n = int(single.n_edges)
    assert out[3] == int(ref[3]) == n
    assert out[4] == int(ref[4]) == int(single.n_expansions)
    got = gather_edge_shards(*out[:3], out[3])
    for a, b in zip(got, (single.src, single.dst, single.ovl)):
        np.testing.assert_array_equal(a[:n], np.asarray(b)[:n])
    # the fixed-length offsets would remove other edges
    fixed = sharded_transitive_reduction(
        make_mesh(nd, devices="cpu"), s_sh, d_sh, o_sh, V, L,
        req_cap=1 << 14, cand_cap=1 << 14)
    assert (fixed[3], fixed[4]) != (out[3], out[4])


def test_ragged_probe_and_verdicts_match_reference(graph):
    """K21's probe with a shard's lengths (against the reference's phase
    4, :518-537, for every vertex range of an 8-way split) and K22's
    verdicts with lengths (against apply_verdicts(window_valid=))."""
    reads2, _, lens2, res, _ = graph
    V = reads2.shape[0]
    src, dst, ovl = (np.array(a) for a in (res.src, res.dst, res.ovl))
    is_edge = src != I32_MAX
    rng = np.random.default_rng(5)
    # candidates: every edge, at its true offset or one off, and misses
    v, x = src[is_edge], dst[is_edge]
    sl = lens2[v] - ovl[is_edge] + (rng.random(v.shape[0]) < 0.4)
    cand = np.stack([np.concatenate([v, v[:50]]),
                     np.concatenate([x, (x[:50] + 1) % V]),
                     np.concatenate([sl, sl[:50]])], 1).astype(np.int32)
    v_d = -(-V // 8)
    marked = 0
    for d in range(8):
        mine = (cand[:, 0] // v_d) == d
        c = cand[mine]
        lens_d = partition_vertex_range(lens2, V, 8)[d]
        pos = np.searchsorted(src.astype(np.int64) << 32 | dst,
                              c[:, 0].astype(np.int64) << 32 | c[:, 1])
        pos = np.minimum(pos, src.shape[0] - 1)
        plen = lens_d[np.clip(c[:, 0] - d * v_d, 0, v_d - 1)]
        hit = (src[pos] == c[:, 0]) & (dst[pos] == c[:, 1]) & (
            plen - ovl[pos] == c[:, 2])
        want = np.zeros(src.shape[0], bool)
        want[pos[hit]] = True
        t = torch.from_numpy
        row = plain.reduce_rows(t(src.astype(np.int64) << 32 | dst),
                                d * v_d, v_d)
        got = plain.reduce_probe(t(src), t(dst), t(ovl), t(c),
                                 t(np.ascontiguousarray(lens_d)), d * v_d,
                                 row)
        np.testing.assert_array_equal(got.numpy(), want)
        marked += int(want.sum())
    assert 0 < marked < int(is_edge.sum())
    k = 11
    reads = reads2[:64]
    lens = lens2[:64].copy()
    lens[::7] = k - 2                   # no valid window
    P = reads.shape[1] - k + 1
    wvalid = np.arange(P)[None, :] < (lens[:, None] - (k - 1))
    counts = rng.choice([0, 1, 2, 3, 5], size=(64, P, 4)).astype(np.int32)
    for which, fn in (("last", ref_correct.variant_keys_last),
                      ("first", ref_correct.variant_keys_first)):
        _, _, cur = fn(jnp.asarray(reads), k)
        off = k - 1 if which == "last" else 0
        want = np.asarray(ref_correct.apply_verdicts(
            jnp.asarray(reads), jnp.asarray(counts), cur, off, 2,
            window_valid=jnp.asarray(wvalid)))
        got = plain.apply_verdicts(torch.from_numpy(reads),
                                   torch.from_numpy(counts), k, which, 2,
                                   torch.from_numpy(lens))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want != reads).any()


CFG = dict(k=15, min_overlap=30, min_contig_len=150)


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's single-device ragged run of tests/test_ragged.py:126's
    input (3 kbp, 700 reads of 50-80 bp and contained ones)."""
    genome = simulate_genome(3000, seed=21)
    rng = np.random.default_rng(22)
    reads, lens = [], []
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
    for i, r in enumerate(reads):
        arr[i, :len(r)] = r
        lens.append(len(r))
    lens = np.asarray(lens, np.int32)
    out = tmp_path_factory.mktemp("ragged_mesh") / "ref"
    contigs, stats = ref_assemble(arr, RefConfig(**CFG), outdir=str(out),
                                  lengths=lens)
    return arr, lens, out, contigs, stats


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("nd", [2, 8])
def test_meshed_ragged_assembly_matches_single_device(ref_run, nd):
    reads, lens, _, ref_contigs, ref_stats = ref_run
    assert reads.shape[0] % 8
    contigs, stats = assemble(reads, AssemblyConfig(**CFG, mesh_shape=(nd,)),
                              device="cpu", lengths=lens)
    assert stats == ref_stats
    assert len(contigs) == len(ref_contigs) >= 1
    for a, b in zip(contigs, ref_contigs):
        np.testing.assert_array_equal(a, b)


def test_meshed_ragged_resume_from_reference(ref_run, tmp_path):
    """Resumed at ``reduce`` from the reference's ragged artifacts, the
    meshed run partitions their edges and lengths by vertex range and
    finishes as the reference did, byte for byte."""
    reads, lens, ref_out, _, _ = ref_run
    resumed = tmp_path / "resumed"
    shutil.copytree(ref_out, resumed)
    for name in ("contigs.fasta", "stats.json", "reduced.npz", "labels.npz"):
        os.remove(resumed / name)
    assemble(reads, AssemblyConfig(**CFG, mesh_shape=(2,)),
             outdir=str(resumed), resume_from="reduce", device="cpu",
             lengths=lens)
    for name in ("contigs.fasta", "stats.json", "reduced.npz"):
        if name.endswith(".npz"):
            a, b = (np.load(p / name) for p in (resumed, ref_out))
            n = int(np.sum(b["src"] != I32_MAX))
            for key in ("src", "dst", "ovl"):
                np.testing.assert_array_equal(a[key][:n], b[key][:n])
        else:
            assert _bytes(resumed / name) == _bytes(ref_out / name), name


def test_cli_mesh_ragged_byte_identical(tmp_path):
    """``--mesh 2 --length-policy pad`` of a FASTQ of mixed lengths gives
    the reference CLI's single-device bytes."""
    genome = simulate_genome(2500, seed=31)
    reads, lens = simulate_ragged_reads(genome, 45, 70, 15.0, 0.005,
                                        seed=32)
    fq = tmp_path / "reads.fastq"
    with open(fq, "w") as f:
        for i, (r, n) in enumerate(zip(reads, lens)):
            seq = "".join("ACGT"[c] for c in r[:n])
            f.write(f"@r{i}\n{seq}\n+\n{'I' * n}\n")
    flags = ["--k", "15", "--min-overlap", "25", "--min-contig-len", "150",
             "--length-policy", "pad"]
    assert ref_main(["assemble", *flags, "-o", str(tmp_path / "ref"),
                     str(fq)]) == 0
    assert port_main(["assemble", *flags, "--mesh", "2", "--device", "cpu",
                      "-o", str(tmp_path / "port"), str(fq)]) == 0
    for name in ("contigs.fasta", "stats.json"):
        assert (_bytes(tmp_path / "port" / name)
                == _bytes(tmp_path / "ref" / name)), name
