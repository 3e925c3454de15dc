"""Streamed ragged reads in sage2_tpu_torch (``stream`` with lengths,
the streamed ragged join, ``compact_pad_edges_spill`` and the pipeline's
streamed ragged branch) against sage2_tpu on the CPU, exact equality:
the chunked count, correction (both rules) and dedup with lengths
against sage2_tpu.stream's; the streamed ragged join, single slab and
entry-blocked, into a spill store and not, against the reference's,
edge arrays and containment marks bit for bit; and the streamed ragged
assembly (plain, blocked, spilled, resumed from ``overlap``) against the
reference's in-core ragged assembly, which the reference proves equal to
its streamed one (tests/test_ragged.py:185-242, tests/test_spill.py:122),
at those tests' sizes."""

import os
import numpy as np
import pytest

from sage2_tpu import stream as jstream
from sage2_tpu.config import AssemblyConfig as RefConfig
from sage2_tpu.pipeline import assemble as ref_assemble
from sage2_tpu.utils.spill import SpillStore as RefStore
from sage2_tpu_torch import AssemblyConfig
from sage2_tpu_torch import stream as tstream
from sage2_tpu_torch.data import simulate_genome
from sage2_tpu_torch.pipeline import assemble
from sage2_tpu_torch.utils.spill import SpillStore
from torch_one_thread import one_thread  # noqa: F401

CPU = "cpu"


def _ragged_reads(genome, n, lo, hi, seed, contained_frac=0.1):
    """tests/test_ragged.py:15-36: reads of lo-hi bases from either
    strand, then contained reads of lo // 2 + 10 .. lo - 3, zero-padded."""
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi + 1))
        start = int(rng.integers(0, len(genome) - ln))
        r = np.array(genome[start : start + ln], np.int8)
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        reads.append(r)
    for _ in range(int(n * contained_frac)):
        ln = int(rng.integers(lo // 2 + 10, lo - 2))
        start = int(rng.integers(0, len(genome) - ln))
        reads.append(np.array(genome[start : start + ln], np.int8))
    Lmax = max(len(r) for r in reads)
    arr = np.zeros((len(reads), Lmax), np.int8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        arr[i, : len(r)] = r
        lens[i] = len(r)
    return arr, lens


@pytest.fixture(scope="module")
def ragged():
    """The reads of tests/test_ragged.py's streamed cases, with errors
    (1%) on a few reads so that the correctors have work."""
    genome = simulate_genome(3000, seed=21)
    reads, lens = _ragged_reads(genome, 700, 50, 80, seed=22)
    rng = np.random.default_rng(23)
    for i in rng.choice(len(reads), 60, replace=False):
        p = int(rng.integers(0, lens[i]))
        reads[i, p] = (reads[i, p] + 1) % 4
    return reads, lens


# --- count, correct, dedup ------------------------------------------------

def test_count_kmers_chunked_ragged_matches_reference(ragged):
    reads, lens = ragged
    t = tstream.count_kmers_chunked(reads, 15, 300, device=CPU,
                                    lengths=lens)
    j = jstream.count_kmers_chunked(reads, 15, 300, lengths=lens)
    n = int(j.n_unique)
    keys = (np.asarray(j.hi)[:n].astype(np.int64) << 32) | np.asarray(
        j.lo)[:n].astype(np.int64)
    assert t.n_unique == n
    np.testing.assert_array_equal(t.keys.numpy(), keys)
    np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count)[:n])


@pytest.mark.parametrize("rule", ["single_window", "vote_all_windows"])
def test_correct_reads_chunked_ragged_matches_reference(ragged, rule):
    reads, lens = ragged
    want = jstream.correct_reads_chunked(reads, 15, 2, 2, 300, rule=rule,
                                         lengths=lens)
    got = tstream.correct_reads_chunked(reads, 15, 2, 2, 300, rule=rule,
                                        device=CPU, lengths=lens)
    np.testing.assert_array_equal(got, want)
    assert (got != reads).any()


def test_prepare_reads_chunked_ragged_matches_reference(ragged):
    reads, lens = ragged
    # a duplicate of a read of another length and the same prefix: equal
    # words, different lengths, so different groups
    reads = np.concatenate([reads, reads[:1], reads[:1]])
    lens = np.concatenate([lens, lens[:1], lens[:1] - 1])
    reads[-1, lens[-1]:] = 0
    want = jstream.prepare_reads_chunked(reads, 200, lengths=lens)
    got = tstream.prepare_reads_chunked(reads, 200, device=CPU, lengths=lens)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[5] is not None


@pytest.mark.parametrize("L", [1, 7, 80])
def test_revcomp_ragged_np_matches_reference(L):
    # every length from 0 to L, each on rows of random bases zeroed past it
    rng = np.random.default_rng(L)
    lens = rng.permutation(np.repeat(np.arange(L + 1, dtype=np.int32), 3))
    rows = rng.integers(0, 4, (lens.shape[0], L)).astype(np.int8)
    rows[np.arange(L)[None, :] >= lens[:, None]] = 0
    got = tstream._revcomp_ragged_np(rows, lens)
    np.testing.assert_array_equal(got, jstream._revcomp_ragged_np(rows, lens))
    assert got.dtype == rows.dtype
    # twice is the row itself
    np.testing.assert_array_equal(tstream._revcomp_ragged_np(got, lens), rows)


# --- the streamed ragged join ------------------------------------------

@pytest.fixture(scope="module")
def prepared(ragged):
    reads, lens = ragged
    reads2, valid2, _, _, _, lengths2 = jstream.prepare_reads_chunked(
        reads, 200, lengths=lens)
    return reads2, valid2, lengths2


@pytest.mark.parametrize("block,spill", [(None, False), (None, True),
                                         (300, False), (300, True)])
def test_find_overlaps_chunked_ragged_matches_reference(prepared, tmp_path,
                                                        block, spill):
    reads2, valid2, lengths2 = prepared
    stores = ((RefStore(str(tmp_path / "ref")),
               SpillStore(str(tmp_path / "port"))) if spill
              else (None, None))
    want = jstream.find_overlaps_chunked_ragged(
        reads2, valid2, lengths2, 30, 400, store=stores[0],
        entry_block_reads=block)
    got = tstream.find_overlaps_chunked_ragged(
        reads2, valid2, lengths2, 30, 400, store=stores[1],
        entry_block_reads=block, device=CPU)
    assert got[3] == want[3] > 0 and got[5] == want[5] is False
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(got[4], want[4])
    assert got[4].any()
    if spill:
        assert sorted(os.listdir(tmp_path / "port")) == sorted(
            os.listdir(tmp_path / "ref"))


def test_find_overlaps_chunked_ragged_overflow(prepared, tmp_path):
    """A chunk over its capacity stops the pass: empty edges, overflow
    set, no spill file left, as the reference's."""
    reads2, valid2, lengths2 = prepared
    want = jstream.find_overlaps_chunked_ragged(
        reads2, valid2, lengths2, 30, 400, capacity_per_chunk=1000)
    store = SpillStore(str(tmp_path / "port"))
    got = tstream.find_overlaps_chunked_ragged(
        reads2, valid2, lengths2, 30, 400, capacity_per_chunk=1000,
        store=store, device=CPU)
    assert got[5] and want[5] and got[3] == want[3] == 0
    assert got[0].shape == (0,)
    assert not [f for f in os.listdir(tmp_path / "port")
                if f.startswith("edges")]


def test_find_overlaps_chunked_ragged_31_bit_guard():
    """M * R >= 2^31 - 1 raises before any work, as the reference does
    (stream.py:547-548)."""
    M, L = 1 << 26, 80        # R = g + n_pos = 1 + 50 rows a read
    reads2 = np.lib.stride_tricks.as_strided(np.zeros(1, np.int8), (M, L),
                                             (0, 0))
    valid2 = np.lib.stride_tricks.as_strided(np.zeros(1, bool), (M,), (0,))
    lengths2 = np.lib.stride_tricks.as_strided(np.zeros(1, np.int32), (M,),
                                               (0,))
    for fn, kw in ((jstream.find_overlaps_chunked_ragged, {}),
                   (tstream.find_overlaps_chunked_ragged, {"device": CPU})):
        with pytest.raises(ValueError, match="31-bit"):
            fn(reads2, valid2, lengths2, 30, 1 << 20, **kw)


def test_compact_pad_edges_spill_matches_reference(tmp_path):
    rng = np.random.default_rng(5)
    n, V = 50_000, 3000
    src = np.sort(rng.integers(0, V, n)).astype(np.int32)
    dst = rng.integers(0, V, n).astype(np.int32)
    ovl = rng.integers(30, 80, n).astype(np.int32)
    cont = rng.random(V) < 0.1
    for mask in (cont, None):
        ref = RefStore(str(tmp_path / "ref"))
        port = SpillStore(str(tmp_path / "port"))
        want = jstream.compact_pad_edges_spill(ref, src, dst, ovl, n,
                                               cont=mask, window=7000)
        got = tstream.compact_pad_edges_spill(port, src, dst, ovl, n,
                                              cont=mask, window=7000)
        assert got[3] == want[3]
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert got[0].shape[0] % (1 << 14) == 0
        assert (got[3] < n) == (mask is not None)


# --- the streamed ragged assembly ----------------------------------------

CFG = dict(k=15, min_overlap=30, min_contig_len=150)


@pytest.fixture(scope="module")
def reference_incore():
    genome = simulate_genome(3000, seed=21)
    reads, lens = _ragged_reads(genome, 700, 50, 80, seed=22)
    contigs, stats = ref_assemble(reads, RefConfig(**CFG), lengths=lens)
    return reads, lens, contigs, stats


def _same(result, reference):
    contigs, stats = result
    assert stats == reference[3]
    assert len(contigs) == len(reference[2])
    for a, b in zip(contigs, reference[2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("extra", [dict(max_device_reads=120),
                                   dict(max_device_reads=120,
                                        entry_block_reads=100)])
def test_streamed_ragged_assembly_matches_reference(reference_incore, extra):
    reads, lens = reference_incore[:2]
    _same(assemble(reads, AssemblyConfig(**CFG, **extra), device=CPU,
                   lengths=lens), reference_incore)


@pytest.mark.parametrize("block", [None, 100])
def test_streamed_ragged_spilled_and_resumed(reference_incore, tmp_path,
                                             block):
    """Spilled (raw edges through compact_pad_edges_spill, lengths2 in
    edges.npz), then resumed from the overlap stage with the same spill
    dir: both the reference's in-core result."""
    reads, lens = reference_incore[:2]
    cfg = AssemblyConfig(**CFG, max_device_reads=120, entry_block_reads=block,
                         spill_dir=str(tmp_path / "spill"))
    out = str(tmp_path / "out")
    _same(assemble(reads, cfg, outdir=out, device=CPU, lengths=lens),
          reference_incore)
    store = SpillStore(cfg.spill_dir)
    assert store.exists("edges_raw_src") and store.exists("edges_src")
    with np.load(os.path.join(out, "edges.npz")) as z:
        assert "lengths2" in z.files and "src" not in z.files
    _same(assemble(reads, cfg, outdir=out, resume_from="overlap", device=CPU,
                   lengths=lens), reference_incore)
    _same(assemble(reads, cfg, outdir=out, resume_from="reduce", device=CPU,
                   lengths=lens), reference_incore)


def test_streamed_ragged_cli_runs(reference_incore, tmp_path):
    """``assemble --length-policy pad --max-device-reads`` takes the
    streamed ragged path and writes the reference's in-core stats."""
    import json

    from sage2_tpu_torch.cli import main
    from sage2_tpu_torch.ops.bitpack import decode_to_ascii

    reads, lens = reference_incore[:2]
    path = str(tmp_path / "r.fastq")
    with open(path, "w") as f:
        for i, (row, n) in enumerate(zip(reads, lens)):
            seq = decode_to_ascii(row[:n]).tobytes().decode()
            f.write(f"@r{i}\n{seq}\n+\n{'I' * n}\n")
    out = str(tmp_path / "out")
    flags = ["--k", "15", "--min-overlap", "30", "--min-contig-len", "150"]
    assert main(["assemble", "--device", "cpu", "-o", out, *flags,
                 "--length-policy", "pad", "--max-device-reads", "120",
                 "--entry-block-reads", "100", "--spill-dir",
                 str(tmp_path / "spill"), path]) == 0
    with open(os.path.join(out, "stats.json")) as f:
        assert json.load(f) == reference_incore[3]

