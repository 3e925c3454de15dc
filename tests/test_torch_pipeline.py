"""sage2_tpu_torch.pipeline.assemble against sage2_tpu.pipeline.assemble
on the CPU: byte-identical contigs.fasta and stats.json, identical stage
artifacts, and resumes that continue a sage2_tpu run."""

import os
import shutil

import numpy as np
import pytest

from sage2_tpu import AssemblyConfig as RefConfig
from sage2_tpu.data import simulate_genome, simulate_reads
from sage2_tpu.pipeline import assemble as ref_assemble
from sage2_tpu_torch import AssemblyConfig
from sage2_tpu_torch.pipeline import assemble, load_reference_artifacts

ARRAYS = ("corrected", "edges", "reduced", "labels")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One sage2_tpu run and one port run of the same 2,000 reads."""
    genome = simulate_genome(8000, seed=61)
    reads, _ = simulate_reads(genome, read_len=100, coverage=25,
                              error_rate=0.005, seed=62)
    d = tmp_path_factory.mktemp("asm")
    ref = ref_assemble(reads, RefConfig(), outdir=str(d / "ref"))
    port = assemble(reads, AssemblyConfig(), outdir=str(d / "port"),
                    device="cpu")
    return reads, genome, d, ref, port


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_contigs_and_stats_byte_identical(runs):
    reads, genome, d, ref, port = runs
    assert reads.shape[0] <= 2000
    for name in ("contigs.fasta", "stats.json"):
        assert _bytes(d / "ref" / name) == _bytes(d / "port" / name), name
    assert port[1] == ref[1]
    assert len(port[0]) == len(ref[0]) >= 1
    for a, b in zip(port[0], ref[0]):
        np.testing.assert_array_equal(a, b)


def test_stage_artifacts_identical(runs):
    _, _, d, _, _ = runs
    ref = load_reference_artifacts(str(d / "ref"))
    port = load_reference_artifacts(str(d / "port"))
    assert port["manifest"] == ref["manifest"]
    for name in ARRAYS:
        assert ref[name].keys() == port[name].keys(), name
        for key in ref[name]:
            np.testing.assert_array_equal(ref[name][key], port[name][key],
                                          err_msg=f"{name}.{key}")
            assert ref[name][key].dtype == port[name][key].dtype


@pytest.mark.parametrize("stage", ["overlap", "reduce", "traverse",
                                   "finish"])
def test_resume_continues_a_reference_run(runs, stage, tmp_path):
    reads, _, d, _, _ = runs
    out = tmp_path / "resumed"
    shutil.copytree(d / "ref", out)
    for name in ("contigs.fasta", "stats.json"):
        os.remove(out / name)
    assemble(reads, AssemblyConfig(), outdir=str(out), resume_from=stage,
             device="cpu")
    for name in ("contigs.fasta", "stats.json"):
        assert _bytes(out / name) == _bytes(d / "ref" / name), name


def test_unported_paths_raise(runs):
    reads = runs[0]
    for cfg, kw in [(AssemblyConfig(mesh_shape=(2,)), {}),
                    (AssemblyConfig(max_device_reads=5), {}),
                    (AssemblyConfig(correction_rule="vote_all_windows"), {}),
                    (AssemblyConfig(reduce_backend="device"), {}),
                    (AssemblyConfig(), {"mate_of": np.arange(10)}),
                    (AssemblyConfig(), {"lengths": np.full(10, 100)})]:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            assemble(reads[:10], cfg, device="cpu", **kw)
