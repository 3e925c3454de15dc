"""The port's spill store and streamed pipeline against sage2_tpu's, on
the CPU: spill-store edge cases, chunked stages writing into memmaps,
the spilled transitive reduction, streamed assemblies (both correction
rules, entry blocks, spill dir, CLI flags) with byte-equal outputs and
spill files, and resuming a spilled run from either package's spill
dir."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from sage2_tpu import AssemblyConfig as RefConfig
from sage2_tpu.cli import main as ref_cli
from sage2_tpu.graph.reduce import transitive_reduction_spill as jreduce_spill
from sage2_tpu.pipeline import assemble as ref_assemble
from sage2_tpu.utils.spill import SpillStore as RefStore
from sage2_tpu_torch import AssemblyConfig
from sage2_tpu_torch import stream as tstream
from sage2_tpu_torch.data import simulate_genome, simulate_reads, write_fastq
from sage2_tpu_torch.graph.reduce import transitive_reduction_spill
from sage2_tpu_torch.io import load_reads
from sage2_tpu_torch.pipeline import assemble, load_reference_artifacts
from sage2_tpu_torch.utils.metrics import MetricsLog
from sage2_tpu_torch.utils.spill import SpillStore
from torch_one_thread import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
# the run of every pipeline test below: 4 chunks of 112 reads; the
# overlap join over 896 vertices in chunks of 224, entry blocks of 300
BASE = dict(k=15, min_overlap=28, min_contig_len=120)
N_READS, CHUNK, BLOCK = 448, 112, 300
FLAGS = ["--k", "15", "--min-overlap", "28", "--min-contig-len", "120",
         "--max-device-reads", str(CHUNK), "--entry-block-reads", str(BLOCK)]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_files(a, b, names):
    for name in names:
        assert _bytes(os.path.join(a, name)) == _bytes(os.path.join(b, name)), \
            name


# --- the store (model: tests/test_spill.py, tests/test_spill_edge.py) --

def test_spill_store_roundtrip_and_reference_layout(tmp_path):
    st = SpillStore(str(tmp_path))
    a = st.empty("a", np.int8, (5, 3))
    a[:] = np.arange(15, dtype=np.int8).reshape(5, 3)
    a.flush()
    np.testing.assert_array_equal(np.asarray(st.load("a")),
                                  np.arange(15).reshape(5, 3))
    w = st.writer("w", np.int32)
    w.append(np.arange(4, dtype=np.int32))
    w.append(np.arange(4, 7, dtype=np.int32))
    out = w.close(pad_to=10, fill=-1)
    np.testing.assert_array_equal(np.asarray(out),
                                  [0, 1, 2, 3, 4, 5, 6, -1, -1, -1])
    # the reference's store reads the port's directory, and back
    ref = RefStore(str(tmp_path))
    assert ref.exists("w") and ref.load("w").shape == (10,)
    np.testing.assert_array_equal(np.asarray(ref.load("a")),
                                  np.asarray(st.load("a")))
    ref.empty("b", np.int32, (3,))[:] = 7
    assert SpillStore(str(tmp_path)).load("b").tolist() == [7, 7, 7]


def test_empty_appender_abort_and_meta(tmp_path):
    st = SpillStore(str(tmp_path))
    out = st.writer("w", np.int32).close()
    assert out.shape == (0,) and out.dtype == np.int32
    assert SpillStore(str(tmp_path)).load("w").shape == (0,)
    w = st.writer("x", np.int32)
    w.append(np.arange(4, dtype=np.int32))
    w.abort()
    assert not st.exists("x") and not os.path.exists(st.path("x"))
    assert st.get_meta("config_digest") is None
    st.set_meta("config_digest", "abc123")
    st2 = SpillStore(str(tmp_path))
    st2.empty("y", np.int8, (3,))
    assert st2.get_meta("config_digest") == "abc123"
    st2.remove("y")
    st2.remove("y")
    assert not st2.exists("y")


# --- chunked stages into the store --------------------------------------

@pytest.fixture(scope="module")
def small():
    g = simulate_genome(700, seed=531)
    reads, _ = simulate_reads(g, read_len=60, coverage=14, error_rate=0.01,
                              seed=532)
    return reads


@pytest.mark.parametrize("rule", ["single_window", "vote_all_windows"])
def test_correct_reads_chunked_into_memmap(small, tmp_path, rule):
    reads = small[:80]
    plain = tstream.correct_reads_chunked(reads, 15, 2, 2, 32, rule=rule,
                                          device=CPU)
    mm = SpillStore(str(tmp_path)).empty("corrected", np.int8, reads.shape)
    out = tstream.correct_reads_chunked(reads, 15, 2, 2, 32, rule=rule,
                                        out=mm, device=CPU)
    assert out is mm
    np.testing.assert_array_equal(np.asarray(out), plain)


def test_prepare_and_overlaps_chunked_into_store(small, tmp_path):
    plain = tstream.prepare_reads_chunked(small, 100, device=CPU)
    st = SpillStore(str(tmp_path))
    spill = tstream.prepare_reads_chunked(small, 100, store=st, device=CPU)
    assert isinstance(spill[0], np.memmap) and spill[3] == plain[3]
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(np.asarray(spill[i]), plain[i])
    r2, v2 = plain[0], plain[1]
    ref = tstream.find_overlaps_chunked(r2, v2, 40, 256, device=CPU)
    n = ref[3]
    assert n > 0
    for block in (None, 70):
        out = tstream.find_overlaps_chunked(r2, v2, 40, 256, store=st,
                                            entry_block_reads=block,
                                            device=CPU)
        assert out[3:] == (n, False)
        for x, y in zip(out[:3], ref[:3]):
            np.testing.assert_array_equal(np.asarray(x)[:n], y)
        # padded to the 2^14 grain with the sentinel rows
        assert out[0].shape[0] % (1 << 14) == 0
        assert (np.asarray(out[0][n:]) == 2**31 - 1).all()
        assert (np.asarray(out[2][n:]) == 0).all()
        assert not any(f.name.startswith("efrag") for f in tmp_path.iterdir())


def test_transitive_reduction_spill_matches_reference(small, tmp_path):
    r2, v2 = tstream.prepare_reads_chunked(small, 100, device=CPU)[:2]
    src, dst, ovl, n, _ = tstream.find_overlaps_chunked(r2, v2, 40, 256,
                                                        device=CPU)
    pad = (1 << 14) - n
    edges = [np.concatenate([a, np.full(pad, fill, np.int32)])
             for a, fill in ((src, 2**31 - 1), (dst, 2**31 - 1), (ovl, 0))]
    V = r2.shape[0]
    ref = jreduce_spill(RefStore(str(tmp_path / "ref")), *edges, V, 60)
    got = transitive_reduction_spill(SpillStore(str(tmp_path / "port")),
                                     *edges, V, 60)
    assert (got.n_edges, got.n_expansions, got.overflow) == (
        int(ref.n_edges), int(ref.n_expansions), bool(ref.overflow))
    assert 0 < got.n_edges < n
    _same_files(tmp_path / "ref", tmp_path / "port",
                sorted(os.listdir(tmp_path / "ref")))


# --- streamed assemblies ------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reads as FASTQ, and one spilled, entry-blocked streamed run
    of each package's CLI on them with the same flags."""
    d = tmp_path_factory.mktemp("stream")
    g = simulate_genome(1500, seed=541)
    reads, _ = simulate_reads(g, read_len=50, coverage=15, error_rate=0.005,
                              seed=542)
    fq = str(d / "reads.fastq")
    write_fastq(fq, reads[:N_READS])
    assert ref_cli(["assemble", "-o", str(d / "ref"), *FLAGS,
                    "--spill-dir", str(d / "ref_spill"), fq]) == 0
    r = subprocess.run(
        [sys.executable, "-m", "sage2_tpu_torch", "assemble", "--device",
         "cpu", "-o", str(d / "port"), *FLAGS, "--spill-dir",
         str(d / "port_spill"), fq],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    return d, load_reads([fq])


def test_cli_streaming_flags_byte_identical(runs):
    d, reads = runs
    assert reads.shape == (N_READS, 50)
    _same_files(d / "ref", d / "port", ["contigs.fasta", "stats.json"])
    with open(d / "port" / "stats.json") as f:
        assert json.load(f)["n_contigs"] >= 1


def test_spill_files_byte_identical(runs):
    d, _ = runs
    names = sorted(os.listdir(d / "ref_spill"))
    assert sorted(os.listdir(d / "port_spill")) == names
    assert {"corrected.bin", "reads2.bin", "edges_src.bin",
            "reduced_src.bin", "reduce_marks.bin", "spill.json"} <= set(names)
    _same_files(d / "ref_spill", d / "port_spill", names)
    for a in ("ref", "port"):
        with open(d / a / "manifest.json") as f:
            assert json.load(f)["spilled"] is True
        with np.load(d / a / "edges.npz") as z:
            assert "src" not in z and "reads2" not in z


@pytest.mark.parametrize("rule", ["single_window", "vote_all_windows"])
def test_streamed_assemble_matches_reference_and_incore(runs, tmp_path,
                                                        rule):
    """max_device_reads = N // 4 with each rule: contigs.fasta and
    stats.json byte-equal to the reference's streamed run (for
    single_window, the spilled CLI run above: spill dir and entry
    blocks change placement only), and contigs and stats equal to the
    port's in-core run."""
    d, reads = runs
    cfg = dict(BASE, correction_rule=rule)
    if rule == "single_window":
        ref_dir = d / "ref"
    else:
        ref_dir = tmp_path / "ref"
        ref_assemble(reads, RefConfig(**cfg, max_device_reads=CHUNK),
                     outdir=str(ref_dir))
    log = MetricsLog(echo=False)
    contigs, stats = assemble(
        reads, AssemblyConfig(**cfg, max_device_reads=CHUNK),
        outdir=str(tmp_path / "port"), metrics=log, device=CPU)
    _same_files(ref_dir, tmp_path / "port", ["contigs.fasta", "stats.json"])
    assert [r["chunk_reads"] for r in log.records
            if r["stage"] == "streaming"] == [CHUNK]
    incore = assemble(reads, AssemblyConfig(**cfg), device=CPU)
    assert incore[1] == stats and len(incore[0]) == len(contigs)
    for a, b in zip(incore[0], contigs):
        np.testing.assert_array_equal(a, b)


def _copy_run(runs, tmp_path, which):
    d, _ = runs
    out, spill = tmp_path / "out", tmp_path / "spill"
    shutil.copytree(d / which, out)
    shutil.copytree(d / f"{which}_spill", spill)
    return out, spill


@pytest.mark.parametrize("which", ["port", "ref"])
def test_resume_from_reduce_with_spill_dir(runs, tmp_path, which):
    """resume_from="reduce" on a spilled run of either package reads the
    edges and reads2 from the spill dir and finishes as the run did."""
    d, reads = runs
    out, spill = _copy_run(runs, tmp_path, which)
    for name in ("contigs.fasta", "stats.json"):
        os.remove(out / name)
    cfg = AssemblyConfig(**BASE, max_device_reads=CHUNK,
                         entry_block_reads=BLOCK, spill_dir=str(spill))
    assemble(reads, cfg, outdir=str(out), resume_from="reduce", device=CPU)
    _same_files(d / which, out, ["contigs.fasta", "stats.json"])
    got = load_reference_artifacts(str(out), str(spill))
    assert isinstance(got["edges"]["src"], np.memmap)
    assert got["reduced"]["src"].shape[0] % (1 << 14) == 0


def test_resume_refuses_a_mismatched_or_missing_spill_dir(runs, tmp_path):
    _, reads = runs
    out, spill = _copy_run(runs, tmp_path, "port")
    cfg = AssemblyConfig(**BASE, max_device_reads=CHUNK, spill_dir=str(spill))
    bad = AssemblyConfig(**dict(BASE, min_overlap=27),
                         max_device_reads=CHUNK, spill_dir=str(spill))
    with pytest.raises(ValueError, match="different config"):
        assemble(reads, bad, outdir=str(out), resume_from="reduce",
                 device=CPU)
    no_spill = AssemblyConfig(**BASE, max_device_reads=CHUNK)
    with pytest.raises(ValueError, match="spill"):
        assemble(reads, no_spill, outdir=str(out), resume_from="reduce",
                 device=CPU)
    with pytest.raises(ValueError, match="spill"):
        load_reference_artifacts(str(out))
    # with its own spill dir the run resumes from any later stage
    _, stats = assemble(reads, cfg, outdir=str(out), resume_from="traverse",
                        device=CPU)
    with open(runs[0] / "port" / "stats.json") as f:
        assert json.load(f) == json.loads(json.dumps(stats))


def test_spill_dir_without_streaming_is_skipped(runs, tmp_path):
    _, reads = runs
    log = MetricsLog(echo=False)
    got = assemble(reads, AssemblyConfig(**BASE, spill_dir=str(tmp_path)),
                   metrics=log, device=CPU)
    assert "spill_skipped" in [r["stage"] for r in log.records]
    assert os.listdir(tmp_path) == []
    assert got[1] == assemble(reads, AssemblyConfig(**BASE), device=CPU)[1]


def test_overlap_overflow_retries_with_doubled_capacity(runs, monkeypatch):
    """A streamed overlap pass that overflows its candidate capacity is
    run again at twice the capacity (the overlap_retry record), and the
    assembly is unchanged."""
    from sage2_tpu_torch import pipeline

    _, reads = runs
    real = pipeline.find_overlaps_chunked
    caps = []

    def first_overflows(*args, capacity_per_chunk, **kw):
        caps.append(capacity_per_chunk)
        return real(*args, capacity_per_chunk=(
            8 if len(caps) == 1 else capacity_per_chunk), **kw)

    monkeypatch.setattr(pipeline, "find_overlaps_chunked", first_overflows)
    log = MetricsLog(echo=False)
    cfg = AssemblyConfig(**BASE, max_device_reads=CHUNK)
    _, stats = assemble(reads, cfg, metrics=log, device=CPU)
    assert caps == [1 << 16, 1 << 17]
    assert [r["capacity_per_chunk"] for r in log.records
            if r["stage"] == "overlap_retry"] == [1 << 17]
    with open(runs[0] / "port" / "stats.json") as f:
        assert json.load(f) == json.loads(json.dumps(stats))
