"""``python -m sage2_tpu_torch`` simulate + assemble --device cpu on a
small FASTQ, against the in-process port and sage2_tpu."""

import json
import os
import subprocess
import sys

import numpy as np

from sage2_tpu import AssemblyConfig as RefConfig
from sage2_tpu.pipeline import assemble as ref_assemble
from sage2_tpu_torch.io import load_reads
from torch_one_thread import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*args, check=True):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "sage2_tpu_torch", *args],
                          capture_output=True, text=True, env=env,
                          timeout=600, check=check)


def test_cli_simulate_and_assemble_on_cpu(tmp_path):
    fq = str(tmp_path / "reads.fastq.gz")
    _cli("simulate", "-o", fq, "--genome-out", str(tmp_path / "g.fasta"),
         "--genome-len", "5000", "--coverage", "20", "--seed", "3")
    out = tmp_path / "out"
    r = _cli("assemble", "--device", "cpu", "-o", str(out), fq)
    stats = json.loads(r.stdout)
    with open(out / "stats.json") as f:
        assert json.load(f) == stats
    reads = load_reads([fq])
    assert reads.shape == (1000, 100)
    _, ref_stats = ref_assemble(reads, RefConfig(),
                                outdir=str(tmp_path / "ref"))
    assert stats == json.loads(json.dumps(ref_stats))
    for name in ("contigs.fasta", "stats.json"):
        with open(out / name, "rb") as a, open(tmp_path / "ref" / name,
                                               "rb") as b:
            assert a.read() == b.read()
    # the default device is the GPU: without one the run fails
    r = _cli("assemble", "-o", str(tmp_path / "none"), fq, check=False)
    assert r.returncode != 0 and "cuda" in r.stderr
    assert not np.any([os.path.exists(tmp_path / "none" / "stats.json")])
