"""sage2_tpu_torch, chip_smoke.py and the benches bench_gpu.py and
bench_e2e_gpu.py stand alone: no JAX, no sage2_tpu, and no silent fall
back to the CPU."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch
from torch_one_thread import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = sorted(glob.glob(os.path.join(ROOT, "sage2_tpu_torch", "**",
                                          "*.py"), recursive=True))
    return files + [os.path.join(ROOT, name) for name in (
        "chip_smoke.py", "bench_gpu.py", "bench_e2e_gpu.py")]


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module"):
            for a in node.args:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    yield a.value


def test_no_jax_or_reference_imports():
    files = _port_files()
    assert len(files) > 20
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "sage2_tpu"):
                bad.append((os.path.relpath(path, ROOT), mod))
    assert bad == []


_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["sage2_tpu"] = None
import numpy as np
from sage2_tpu_torch.data import simulate_genome, simulate_reads
from sage2_tpu_torch.pipeline import assemble
from sage2_tpu_torch import AssemblyConfig
g = simulate_genome(3000, seed=5)
r, _ = simulate_reads(g, read_len=100, coverage=20, seed=6)
contigs, stats = assemble(r, AssemblyConfig(), device="cpu")
assert stats["n_contigs"] >= 1, stats
assert not any(m == "jax" or m.startswith(("jax.", "sage2_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok", stats["n50"])
"""


def test_assemble_runs_with_jax_and_reference_blocked():
    r = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT,
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("ok")


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    from sage2_tpu_torch.pipeline import assemble
    from sage2_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reads = torch.zeros((4, 100), dtype=torch.int8).numpy()
    with pytest.raises(RuntimeError, match="cuda"):
        assemble(reads)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_kernel_wrappers_take_plain_versions_only_on_cpu():
    from sage2_tpu_torch import kernels

    kernels.reset_launch_counts()
    p = torch.arange(8, dtype=torch.int32).flip(0)
    out, _ = kernels.pointer_jump(p)
    assert torch.equal(out, torch.arange(8, dtype=torch.int32))
    assert kernels.LAUNCHES == {k: 0 for k in kernels.KERNELS}
    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="devices"):
        kernels.pointer_jump(meta)


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """Without CUDA, and alone in a directory, chip_smoke.py exits
    non-zero and prints no result."""
    src = os.path.join(ROOT, "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    with open(src) as f:
        lone.write_text(f.read())
    for cwd, script in ((ROOT, src), (tmp_path, str(lone))):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
