"""bench_gpu.py and bench_e2e_gpu.py, the port's twins of bench.py and
bench_e2e.py, run on the CPU at a small size: one JSON line each with
the reference benches' keys (read from their sources), and bench_gpu's
per-shard parity with the C++ baseline (asserted inside main)."""

import ast
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_e2e_gpu  # noqa: E402
import bench_gpu  # noqa: E402
from sage2_tpu_torch.io import native  # noqa: E402
from torch_one_thread import one_thread  # noqa: F401


def _printed_keys(script: str) -> dict:
    """{"": top-level keys, "detail": its keys} of the json.dumps dict
    literal that ``script`` prints."""
    with open(os.path.join(ROOT, script)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "dumps" and node.args and (
                isinstance(node.args[0], ast.Dict)):
            d = node.args[0]
            keys = {"": {k.value for k in d.keys}}
            for k, v in zip(d.keys, d.values):
                if isinstance(v, ast.Dict):
                    keys[k.value] = {kk.value for kk in v.keys}
            return keys
    raise AssertionError(f"no json.dumps of a dict in {script}")


def _one_json_line(capsys) -> dict:
    lines = [x for x in capsys.readouterr().out.splitlines() if x.strip()]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.skipif(not native.available(), reason="no C++ compiler")
def test_bench_gpu_on_the_cpu(monkeypatch, capsys):
    for k, v in dict(SAGE2_BENCH_DEVICE="cpu", SAGE2_BENCH_READS="1000",
                     SAGE2_BENCH_STACK="2", SAGE2_BENCH_REPEATS="1").items():
        monkeypatch.setenv(k, v)
    assert bench_gpu.main() == 0
    out = _one_json_line(capsys)
    want = _printed_keys("bench.py")
    assert set(out) == want[""]
    assert set(out["detail"]) == want["detail"] | {"device",
                                                   "power_limit_w"}
    assert out["metric"] == "overlap_detection_reads_per_s_per_chip"
    assert out["value"] > 0 and out["detail"]["n_shards_per_dispatch"] == 2
    assert out["detail"]["verified_overlaps_shard0"] > 0
    assert out["detail"]["device"] == "cpu"


def test_bench_e2e_gpu_on_the_cpu(monkeypatch, capsys):
    for k, v in dict(SAGE2_BENCH_DEVICE="cpu",
                     SAGE2_E2E_GENOME="20000").items():
        monkeypatch.setenv(k, v)
    assert bench_e2e_gpu.main() == 0
    out = _one_json_line(capsys)
    want = _printed_keys("bench_e2e.py")
    assert set(out) == want[""] and set(out["detail"]) == want["detail"]
    assert out["metric"] == "e2e_assembly_wall_clock_s"
    assert out["detail"]["n_contigs"] >= 1
    assert out["detail"]["genome_fraction"] > 0.99


def test_stacked_bytes_counts_every_row_and_slot():
    """The bound under bench_gpu's timing gate grows with the shard and
    the capacity: 38 bytes a candidate slot (K3 writes 13, K14 reads 13
    and writes 12)."""
    a = bench_gpu.stacked_bytes(1000, 100, 40, 1 << 16)
    assert bench_gpu.stacked_bytes(1000, 100, 40, (1 << 16) + 1) - a == 38
    assert bench_gpu.stacked_bytes(2000, 100, 40, 1 << 16) > a
