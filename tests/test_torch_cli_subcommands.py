"""The port's ``correct`` and ``overlap`` subcommands against
sage2_tpu.cli.main on one FASTQ (CPU): byte-identical output files and
the same return codes, the candidate-overflow exit 2 included."""

import pytest

from sage2_tpu.cli import main as ref_main
from sage2_tpu_torch.cli import main as port_main
from torch_one_thread import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    path = str(d / "reads.fastq")
    assert port_main(["simulate", "-o", path, "--genome-len", "4000",
                      "--read-len", "80", "--coverage", "20",
                      "--error-rate", "0.01", "--seed", "5"]) == 0
    return path


def _both(tmp_path, fastq, cmd, suffix, *flags):
    outs = []
    for name, main, extra in (("ref", ref_main, ()),
                              ("port", port_main, ("--device", "cpu"))):
        out = str(tmp_path / f"{name}.{suffix}")
        rc = main([cmd, *flags, *extra, "-o", out, fastq])
        outs.append((rc, out))
    (rc_ref, ref), (rc_port, port) = outs
    assert rc_port == rc_ref
    return rc_ref, ref, port


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        data = fa.read()
        assert data == fb.read()
    return data


@pytest.mark.parametrize("flags", [(), ("--k", "21", "--solid-threshold",
                                        "3", "--correction-rounds", "1"),
                                   ("--correction-rule", "vote_all_windows")])
def test_correct_subcommand_byte_identical(tmp_path, fastq, flags):
    rc, ref, port = _both(tmp_path, fastq, "correct", "fasta", *flags)
    assert rc == 0
    assert _same_file(ref, port).startswith(b">read_0 len=80\n")


@pytest.mark.parametrize("flags", [(), ("--no-correct",), ("--no-reduce",),
                                   ("--no-correct", "--no-reduce"),
                                   ("--reduce-capacity", "500")])
def test_overlap_subcommand_byte_identical(tmp_path, fastq, flags):
    rc, ref, port = _both(tmp_path, fastq, "overlap", "tsv", *flags)
    assert rc == 0
    data = _same_file(ref, port)
    assert data.startswith(b"#src\tdst\toverlap\n") and data.count(b"\n") > 1


def test_overlap_candidate_overflow_returns_2(tmp_path, fastq):
    rc, _, _ = _both(tmp_path, fastq, "overlap", "tsv",
                     "--candidate-capacity", "64")
    assert rc == 2
