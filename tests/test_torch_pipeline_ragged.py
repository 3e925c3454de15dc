"""sage2_tpu_torch.pipeline.assemble on ragged reads (``lengths``)
against sage2_tpu.pipeline.assemble, on the CPU: byte-identical
contigs.fasta and stats.json and identical stage artifacts (edges.npz
with lengths2 and the containment-filtered valid2) under the default
config and under voting + device reduction; a ragged resume; and
``assemble --length-policy pad`` through both command lines.
"""

import copy
import os
import shutil

import numpy as np
import pytest

from sage2_tpu import AssemblyConfig as RefConfig
from sage2_tpu.cli import main as ref_main
from sage2_tpu.graph.finish import pop_bubbles as ref_pop_bubbles
from sage2_tpu.pipeline import assemble as ref_assemble
from sage2_tpu_torch import AssemblyConfig
from sage2_tpu_torch import pipeline
from sage2_tpu_torch.cli import main as port_main
from sage2_tpu_torch.data import simulate_genome, simulate_ragged_reads
from sage2_tpu_torch.ops.bitpack import decode_to_ascii
from sage2_tpu_torch.pipeline import assemble, load_reference_artifacts
from sage2_tpu_torch.utils.stats import genome_fraction
from torch_one_thread import one_thread  # noqa: F401

BASE = dict(k=15, min_overlap=35, min_contig_len=120)
CONFIGS = {
    "default": {},
    "vote_device": dict(correction_rule="vote_all_windows",
                        reduce_backend="device"),
}
FLAGS = ["--k", "15", "--min-overlap", "35", "--min-contig-len", "120",
         "--length-policy", "pad"]


@pytest.fixture(scope="module")
def ragged():
    """~610 mixed-length reads (50-80 bp and contained ones) of a
    3,000 bp genome with errors, as tests/test_torch_ragged.py."""
    genome = simulate_genome(3000, seed=31)
    return simulate_ragged_reads(genome, 50, 80, 12.0, 0.01, seed=32)


@pytest.fixture(scope="module")
def runs(ragged, tmp_path_factory):
    """{config: outdir} of one sage2_tpu run ("ref") and one port run
    ("port") per config."""
    reads, lens = ragged
    d = tmp_path_factory.mktemp("ragged")
    for name, kw in CONFIGS.items():
        ref_assemble(reads, RefConfig(**BASE, **kw),
                     outdir=str(d / name / "ref"), lengths=lens)
        assemble(reads, AssemblyConfig(**BASE, **kw),
                 outdir=str(d / name / "port"), lengths=lens, device="cpu")
    return d


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_outputs(a, b):
    for name in ("contigs.fasta", "stats.json"):
        assert _bytes(a / name) == _bytes(b / name), name


@pytest.mark.parametrize("config", list(CONFIGS))
def test_ragged_assembly_byte_identical(runs, config):
    _same_outputs(runs / config / "ref", runs / config / "port")
    assert len(_bytes(runs / config / "port" / "contigs.fasta")) > 2000


@pytest.mark.parametrize("config", list(CONFIGS))
def test_ragged_artifacts_identical(runs, ragged, config):
    ref = load_reference_artifacts(str(runs / config / "ref"))
    port = load_reference_artifacts(str(runs / config / "port"))
    assert port["manifest"] == ref["manifest"]
    for name in ("corrected", "edges", "reduced", "labels"):
        assert ref[name].keys() == port[name].keys(), name
        for key in ref[name]:
            np.testing.assert_array_equal(ref[name][key], port[name][key],
                                          err_msg=f"{name}.{key}")
            assert ref[name][key].dtype == port[name][key].dtype
    # contained reads left the graph: fewer valid vertices than unique
    # reads, and a length for every vertex
    edges = port["edges"]
    assert "lengths2" in edges
    n_vertices = int((edges["lengths2"] > 0).sum())
    assert 0 < edges["valid2"].sum() < n_vertices
    assert edges["lengths2"].max() <= ragged[0].shape[1]


@pytest.mark.parametrize("source", ["port", "ref"])
def test_ragged_resume_from_reduce(runs, ragged, source, tmp_path):
    """Resume at the reduction from a port run or a sage2_tpu run: the
    per-vertex lengths come back from edges.npz."""
    out = tmp_path / "resumed"
    shutil.copytree(runs / "default" / source, out)
    for name in ("contigs.fasta", "stats.json", "reduced.npz"):
        os.remove(out / name)
    assemble(ragged[0], AssemblyConfig(**BASE), outdir=str(out),
             resume_from="reduce", device="cpu")
    _same_outputs(out, runs / "default" / "ref")


def _write_fastq(path, reads, lens):
    with open(path, "w") as f:
        for i, (row, n) in enumerate(zip(reads, lens)):
            seq = decode_to_ascii(row[:n]).tobytes().decode()
            f.write(f"@r{i}\n{seq}\n+\n{'I' * n}\n")


@pytest.fixture(scope="module")
def uniform(ragged, tmp_path_factory):
    """Every read cut to 50 bp: a FASTQ, the reads, and both command
    lines' ``--length-policy pad`` runs on it."""
    reads = np.ascontiguousarray(ragged[0][:, :50])
    lens = np.full(reads.shape[0], 50, np.int32)
    d = tmp_path_factory.mktemp("uniform")
    fq = str(d / "reads.fastq")
    _write_fastq(fq, reads, lens)
    assert ref_main(["assemble", "-o", str(d / "ref"), *FLAGS,
                     "--platform", "cpu", fq]) == 0
    assert port_main(["assemble", "-o", str(d / "port"), *FLAGS,
                      "--device", "cpu", fq]) == 0
    return d, reads, lens


def test_cli_length_policy_pad_matches_reference(runs, ragged, tmp_path):
    fq = str(tmp_path / "reads.fastq")
    _write_fastq(fq, *ragged)
    for main, name, dev in ((ref_main, "ref", ["--platform", "cpu"]),
                            (port_main, "port", ["--device", "cpu"])):
        assert main(["assemble", "-o", str(tmp_path / name), *FLAGS, *dev,
                     fq]) == 0
    _same_outputs(tmp_path / "ref", tmp_path / "port")
    _same_outputs(tmp_path / "port", runs / "default" / "ref")


def test_cli_length_policy_pad_uniform_file(uniform):
    """A file whose reads all have one length takes the fixed path in
    both command lines."""
    d, _, _ = uniform
    _same_outputs(d / "ref", d / "port")
    assert "lengths2" not in load_reference_artifacts(str(d / "port"))[
        "edges"]


def test_uniform_lengths_give_the_fixed_result(uniform, tmp_path):
    d, reads, lens = uniform
    assemble(reads, AssemblyConfig(**BASE), outdir=str(tmp_path / "r"),
             lengths=lens, device="cpu")
    _same_outputs(tmp_path / "r", d / "ref")


def test_bubble_popping_skips_twins_popped_earlier(monkeypatch):
    """On these 75-150 bp reads a bubble's twin is popped with it before
    the twin's own group comes up: the reference's pop_bubbles then
    looks up the removed unitig and raises KeyError. The port skips it
    and assembles."""
    genome = simulate_genome(3000, seed=1)
    reads, lens = simulate_ragged_reads(genome, 75, 150, 50.0, 0.005,
                                        seed=101)
    port_pop = pipeline.pop_bubbles
    calls = []

    def both(g, cap, max_reads, ratio):
        with pytest.raises(KeyError):
            ref_pop_bubbles(copy.deepcopy(g), cap, max_reads, ratio)
        calls.append(cap)
        return port_pop(g, cap, max_reads, ratio)

    monkeypatch.setattr(pipeline, "pop_bubbles", both)
    contigs, _ = assemble(reads, AssemblyConfig(), lengths=lens,
                          device="cpu")
    assert calls
    assert genome_fraction(contigs, genome) > 0.99


def test_cli_refuses_paired(uniform, tmp_path, capsys):
    """--paired is not ported: the command line says so and names the
    ROADMAP item, and writes nothing."""
    d, _, _ = uniform
    out = tmp_path / "out"
    assert port_main(["assemble", "-o", str(out), "--paired", "--device",
                      "cpu", str(d / "reads.fastq")]) == 2
    assert "ROADMAP Queue 1 item 14" in capsys.readouterr().err
    assert not out.exists()
