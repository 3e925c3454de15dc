"""sage2_tpu_torch.pipeline.assemble on a device mesh of 1, 2 and 8 CPU
shards against sage2_tpu.pipeline.assemble on one device: equal contigs
and stats, on the reference's tests/test_pipeline_mesh.py input (500
reads, not a multiple of 8); the meshed run's artifacts, and its resume
at ``reduce`` from the artifacts the reference wrote; ``--mesh 2``
through the port's CLI, byte for byte the reference's assembly."""

import os
import shutil
from dataclasses import replace

import numpy as np
import pytest

from sage2_tpu import AssemblyConfig as RefConfig
from sage2_tpu.cli import main as ref_main
from sage2_tpu.data import simulate_genome, simulate_reads
from sage2_tpu.pipeline import assemble as ref_assemble
from sage2_tpu_torch import AssemblyConfig
from sage2_tpu_torch.cli import main as port_main
from sage2_tpu_torch.pipeline import assemble, load_reference_artifacts
from torch_one_thread import one_thread  # noqa: F401

CFG = dict(k=15, min_overlap=25, min_contig_len=150)


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    genome = simulate_genome(2000, seed=501)
    reads, _ = simulate_reads(genome, read_len=50, coverage=12.5,
                              error_rate=0.01, seed=502)
    assert reads.shape[0] % 8       # padded to the mesh
    out = tmp_path_factory.mktemp("mesh") / "ref"
    contigs, stats = ref_assemble(reads, RefConfig(**CFG), outdir=str(out))
    return reads, out, contigs, stats


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("nd", [1, 2, 8])
def test_meshed_assembly_matches_single_device(ref_run, nd):
    reads, _, ref_contigs, ref_stats = ref_run
    contigs, stats = assemble(reads, AssemblyConfig(**CFG, mesh_shape=(nd,)),
                              device="cpu")
    assert stats == ref_stats
    assert len(contigs) == len(ref_contigs) >= 1
    for a, b in zip(contigs, ref_contigs):
        np.testing.assert_array_equal(a, b)


def test_meshed_artifacts_and_resume_from_reference(ref_run, tmp_path):
    """A meshed run writes every stage artifact (the edge slices gathered
    on the host); resumed at ``reduce`` from the reference's artifacts it
    partitions their edges by src range and finishes as the reference
    did, byte for byte."""
    reads, ref_out, _, _ = ref_run
    cfg = AssemblyConfig(**CFG, mesh_shape=(8,))
    out = tmp_path / "port"
    assemble(reads, cfg, outdir=str(out), device="cpu")
    for name in ("contigs.fasta", "stats.json"):
        assert _bytes(out / name) == _bytes(ref_out / name), name
    port = load_reference_artifacts(str(out))
    ref = load_reference_artifacts(str(ref_out))
    for name in ("corrected", "labels"):
        for key in ref[name]:
            np.testing.assert_array_equal(port[name][key], ref[name][key],
                                          err_msg=f"{name}.{key}")
    for key in ("reads2", "valid2", "multiplicity", "n_edges"):
        np.testing.assert_array_equal(port["edges"][key], ref["edges"][key])
    for name in ("edges", "reduced"):       # padded to the mesh's slices
        n = int(np.sum(ref[name]["src"] != 2**31 - 1))
        for key in ("src", "dst", "ovl"):
            np.testing.assert_array_equal(port[name][key][:n],
                                          ref[name][key][:n])
            assert (port[name]["src"][n:] == 2**31 - 1).all()
    resumed = tmp_path / "resumed"
    shutil.copytree(ref_out, resumed)
    for name in ("contigs.fasta", "stats.json", "reduced.npz", "labels.npz"):
        os.remove(resumed / name)
    assemble(reads, replace(cfg, mesh_shape=(2,)), outdir=str(resumed),
             resume_from="reduce", device="cpu")
    for name in ("contigs.fasta", "stats.json"):
        assert _bytes(resumed / name) == _bytes(ref_out / name), name


def test_cli_mesh_byte_identical(tmp_path):
    fq = str(tmp_path / "reads.fastq")
    assert port_main(["simulate", "-o", fq, "--genome-len", "3000",
                      "--read-len", "60", "--coverage", "15", "--seed",
                      "9"]) == 0
    flags = ["--k", "15", "--min-overlap", "25", "--min-contig-len", "150"]
    assert ref_main(["assemble", *flags, "-o", str(tmp_path / "ref"),
                     fq]) == 0
    assert port_main(["assemble", *flags, "--mesh", "2", "--device", "cpu",
                      "-o", str(tmp_path / "port"), fq]) == 0
    for name in ("contigs.fasta", "stats.json"):
        assert (_bytes(tmp_path / "port" / name)
                == _bytes(tmp_path / "ref" / name)), name
