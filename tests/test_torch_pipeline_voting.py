"""sage2_tpu_torch.pipeline.assemble with the voting corrector and the
device reduction against sage2_tpu.pipeline.assemble with the same
config, on the CPU: byte-identical contigs.fasta and stats.json and
identical stage artifacts."""

import os
import re
import shutil

import numpy as np
import pytest

from sage2_tpu import AssemblyConfig as RefConfig
from sage2_tpu.data import simulate_genome, simulate_reads
from sage2_tpu.pipeline import assemble as ref_assemble
from sage2_tpu_torch import AssemblyConfig
from sage2_tpu_torch.pipeline import (
    _unsupported,
    assemble,
    load_reference_artifacts,
)
from torch_one_thread import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(correction_rule="vote_all_windows", reduce_backend="device")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One sage2_tpu run and one port run of the same 2,000 reads."""
    genome = simulate_genome(8000, seed=61)
    reads, _ = simulate_reads(genome, read_len=100, coverage=25,
                              error_rate=0.005, seed=62)
    d = tmp_path_factory.mktemp("asm")
    ref = ref_assemble(reads, RefConfig(**CONFIG), outdir=str(d / "ref"))
    port = assemble(reads, AssemblyConfig(**CONFIG), outdir=str(d / "port"),
                    device="cpu")
    return reads, d, ref, port


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_voting_device_assembly_byte_identical(runs):
    reads, d, ref, port = runs
    assert reads.shape[0] <= 2000
    for name in ("contigs.fasta", "stats.json"):
        assert _bytes(d / "ref" / name) == _bytes(d / "port" / name), name
    assert port[1] == ref[1]
    assert len(port[0]) == len(ref[0]) >= 1


def test_voting_device_artifacts_identical(runs):
    _, d, _, _ = runs
    ref = load_reference_artifacts(str(d / "ref"))
    port = load_reference_artifacts(str(d / "port"))
    assert port["manifest"] == ref["manifest"]
    for name in ("corrected", "edges", "reduced", "labels"):
        assert ref[name].keys() == port[name].keys(), name
        for key in ref[name]:
            np.testing.assert_array_equal(ref[name][key], port[name][key],
                                          err_msg=f"{name}.{key}")
            assert ref[name][key].dtype == port[name][key].dtype


def test_resume_from_reduce_on_the_device(runs, tmp_path):
    """--resume-from reduce onto a sage2_tpu run reduces its edges on
    the device and finishes as the reference did."""
    reads, d, _, _ = runs
    out = tmp_path / "resumed"
    shutil.copytree(d / "ref", out)
    for name in ("contigs.fasta", "stats.json", "reduced.npz"):
        os.remove(out / name)
    assemble(reads, AssemblyConfig(**CONFIG), outdir=str(out),
             resume_from="reduce", device="cpu")
    for name in ("contigs.fasta", "stats.json"):
        assert _bytes(out / name) == _bytes(d / "ref" / name), name


def _roadmap_items():
    """{item number: title} of ROADMAP.md's Queue 1."""
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        text = f.read()
    queue = text.split("### Queue 1")[1].split("### Queue 2")[0]
    return {int(n): title for n, title in
            re.findall(r"^(\d+)\. (.*)$", queue, re.M)}


def test_unsupported_names_current_roadmap_items():
    """Both correction rules, every reduce backend, ragged reads,
    streaming with entry blocks and a spill dir for fixed-length and
    ragged reads, and the device mesh, in core and streamed, for
    fixed-length and ragged reads under either rule are ported; the one
    remaining refusal, paired reads, names the open ROADMAP item that
    ports it."""
    for rule in ("single_window", "vote_all_windows"):
        for backend in ("auto", "native", "device"):
            cfg = AssemblyConfig(correction_rule=rule,
                                 reduce_backend=backend)
            assert _unsupported(cfg, 10, None, None) is None
            assert _unsupported(cfg, 10, None, np.full(10, 100)) is None
    for cfg in (AssemblyConfig(max_device_reads=5),
                AssemblyConfig(max_device_reads=5, entry_block_reads=3,
                               spill_dir="x"),
                AssemblyConfig(spill_dir="x"),
                AssemblyConfig(max_device_reads=10, spill_dir="x")):
        assert _unsupported(cfg, 10, None, None) is None
    assert _unsupported(AssemblyConfig(max_device_reads=10), 10, None,
                        np.full(10, 100)) is None
    # streamed ragged reads, with entry blocks and a spill dir
    for cfg in (AssemblyConfig(max_device_reads=5),
                AssemblyConfig(max_device_reads=5, entry_block_reads=3,
                               spill_dir="x")):
        assert _unsupported(cfg, 10, None, np.full(10, 100)) is None
    # the mesh, whatever the reduce backend and the rule, for fixed-length
    # and ragged reads: in core (a max_device_reads above the read count
    # keeps the run in core) and streamed, with a spill dir too
    for backend in ("auto", "native", "device"):
        for rule in ("single_window", "vote_all_windows"):
            for cfg in (AssemblyConfig(mesh_shape=(2,), reduce_backend=backend,
                                       correction_rule=rule),
                        AssemblyConfig(mesh_shape=(8,), max_device_reads=10,
                                       reduce_backend=backend,
                                       correction_rule=rule),
                        AssemblyConfig(mesh_shape=(2,), max_device_reads=5,
                                       reduce_backend=backend,
                                       correction_rule=rule),
                        AssemblyConfig(mesh_shape=(2,), max_device_reads=5,
                                       spill_dir="x", reduce_backend=backend,
                                       correction_rule=rule)):
                assert _unsupported(cfg, 10, None, None) is None
                assert _unsupported(cfg, 10, None, np.full(10, 100)) is None
    items = _roadmap_items()
    assert not any("Ragged" in title for title in items.values())
    assert not any("streaming" in title for title in items.values())
    for cfg, mate_of, lengths, word in [
            (AssemblyConfig(), np.arange(10), None, "Paired"),
            (AssemblyConfig(mesh_shape=(2,), max_device_reads=5),
             np.arange(10), None, "Paired")]:
        msg = _unsupported(cfg, 10, mate_of, lengths)
        n = int(re.search(r"ROADMAP Queue 1 item (\d+)", msg).group(1))
        assert word in items[n], (msg, items[n])
        assert "~~" not in items[n], (msg, items[n])
