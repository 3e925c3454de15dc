"""The port's native layer (sage2_tpu_torch.io.native): the C++ FASTQ/FASTA
parser against sage2_tpu's native parser and the Python reader, and the
C++ overlap baseline, built by the port into its own build folder,
against both packages' verified overlap counts. On the CPU; tolerance:
exact equality."""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.data import simulate_genome, simulate_reads, write_fastq
from sage2_tpu.io import native as jnative
from sage2_tpu.overlap import find_overlaps_auto as jfind_auto
from sage2_tpu_torch.io import fastq, native
from sage2_tpu_torch.overlap import find_overlaps_auto
from sage2_tpu_torch.utils import native_build
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ compiler")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    genome = simulate_genome(2000, seed=301)
    reads, _ = simulate_reads(genome, read_len=60, coverage=15,
                              error_rate=0.01, seed=302)
    fq = str(d / "reads.fastq.gz")
    write_fastq(fq, reads)
    # FASTA with wrapped sequence lines, a comment line and CRLF endings
    letters = np.frombuffer(b"ACGT", np.uint8)
    fa = d / "reads.fasta"
    with open(fa, "wb") as f:
        f.write(b";a legacy comment\r\n")
        for i, r in enumerate(reads):
            seq = letters[r].tobytes()
            f.write(b">r%d\r\n%s\r\n%s\n" % (i, seq[:25], seq[25:]))
    return d, fq, str(fa), reads


def _python_reader(path, fasta, policy="strict"):
    with fastq._open(path) as f:
        data = f.read()
    seqs = fastq._parse_fasta_py(data) if fasta else fastq._parse_fastq_py(
        data)
    return fastq._to_array(seqs, policy)


@pytest.mark.parametrize("fasta", [False, True])
def test_native_parser_matches_reference_and_python(dataset, fasta):
    _, fq, fa, reads = dataset
    path = fa if fasta else fq
    parse = native.parse_fasta if fasta else native.parse_fastq
    ref = jnative.parse_fasta if fasta else jnative.parse_fastq
    got = parse(path)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, reads)
    np.testing.assert_array_equal(got, _python_reader(path, fasta))
    if jnative.available():
        np.testing.assert_array_equal(got, ref(path))
    reader = fastq.read_fasta if fasta else fastq.read_fastq
    np.testing.assert_array_equal(reader(path), got)
    assert native._lib is not None      # the readers took the native parser


def test_read_fasta_matches_reference_reader(tmp_path):
    """read_fasta and load_reads against sage2_tpu's on a FASTA file with
    sequence text before the first header and spaces around sequence
    lines, where the native FASTA parser reads other bases."""
    from sage2_tpu.io import fastq as jfastq

    p = tmp_path / "odd.fasta"
    p.write_bytes(b"ACGTACGTAC\n>a\nACGTA \n CGTAC\r\n>b\n\tTTGCA\nGTACG  \n"
                  b";comment\n>c\nGGGGG\nCCCCC\n")
    want = jfastq.read_fasta(str(p))
    assert want.shape == (4, 10)
    np.testing.assert_array_equal(fastq.read_fasta(str(p)), want)
    np.testing.assert_array_equal(fastq.load_reads([str(p)]),
                                  jfastq.load_reads([str(p)]))
    assert native.parse_fasta(str(p), "filter").shape[0] < 4


@pytest.mark.parametrize("policy", ["strict", "trim", "filter"])
def test_native_parser_length_policies(tmp_path, policy):
    p = tmp_path / "mixed.fastq"
    p.write_text("@a\nACGTACGT\n+\nIIIIIIII\n@b\nACGTAC\n+\nIIIIII\n"
                 "@c\nACGTACGN\n+\nIIIIIIII\n@d\nTTGCAGTACG\n+\nIIIIIIIIII\n")
    if policy == "strict":
        with pytest.raises(ValueError, match="mixed"):
            native.parse_fastq(str(p))
        with pytest.raises(ValueError, match="mixed"):
            _python_reader(str(p), False)
        return
    got = native.parse_fastq(str(p), policy)
    np.testing.assert_array_equal(got, _python_reader(str(p), False, policy))
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.parse_fastq(str(p),
                                                               policy))
    assert got.shape == ((3, 8) if policy == "trim" else (2, 8))


def test_native_parser_error_message(tmp_path):
    """The malformed-input error of tests/test_cli_io.py:39-45, from the
    port's parser and its reader alike."""
    bad = tmp_path / "bad.fastq"
    bad.write_text("not a fastq\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError, match="malformed"):
        native.parse_fastq(str(bad))
    with pytest.raises(ValueError, match="malformed"):
        fastq.read_fastq(str(bad))
    if jnative.available():
        with pytest.raises(ValueError, match="malformed"):
            jnative.parse_fastq(str(bad))
    with pytest.raises(ValueError, match="cannot read"):
        native.parse_fastq(str(tmp_path / "missing.fastq"))


def test_baseline_builds_into_the_port_and_matches_both_packages(tmp_path):
    """baseline_binary() builds csrc/baseline_cpu.cpp into the port's
    _build folder under a hashed name; its verified count on a
    2,000-read shard equals the port's and the reference's n_verified."""
    path = native.baseline_binary()
    assert os.path.dirname(path) == native_build.BUILD_DIR
    name = os.path.basename(path)
    assert name.startswith("baseline_cpu-") and not name.endswith(".so")
    assert os.stat(path).st_mode & stat.S_IXUSR
    assert native.baseline_binary() == path     # reused, not rebuilt
    assert "csrc" + os.sep + "build" not in path

    genome = simulate_genome(4444, seed=7)
    reads, _ = simulate_reads(genome, read_len=100, coverage=45.0,
                              error_rate=0.005, seed=8)
    reads = reads[:2000]
    raw = tmp_path / "reads.bin"
    reads.astype(np.int8).tofile(raw)
    import subprocess

    r = subprocess.run([path, "overlap", str(raw), str(reads.shape[0]),
                        "100", "40"], capture_output=True, text=True,
                       timeout=300, check=True)
    verified = int(r.stdout.split()[0])
    t = find_overlaps_auto(torch.from_numpy(reads.astype(np.int32)),
                           torch.ones(reads.shape[0], dtype=torch.bool), 40)
    j = jfind_auto(jnp.asarray(reads.astype(np.int32)),
                   jnp.ones(reads.shape[0], bool), 40)
    assert verified == t.n_verified == int(j.n_verified) > 0


def test_executable_spec_is_named_by_its_sources_and_command(tmp_path):
    src = tmp_path / "hello.cpp"
    src.write_text("int main() { return 3; }\n")
    a = native_build.LibSpec("hello", ["g++", "-O1"], [str(src)],
                             executable=True)
    b = a._replace(command=["g++", "-O2"])
    lib = a._replace(executable=False)
    pa, pb, pl = (native_build.library_path(s) for s in (a, b, lib))
    assert pa != pb and os.path.basename(pa).startswith("hello-")
    assert os.path.basename(pl).startswith("libhello-") and pl.endswith(
        ".so")
    (built,) = native_build.build_all([a])
    import subprocess

    assert built == pa and subprocess.run([built]).returncode == 3
    os.remove(built)
    src.write_text("int main() { return 4 }\n")     # does not compile
    with pytest.raises(native_build.BuildError, match="hello"):
        native_build.build_all([a])
