"""Each CUDA kernel of sage2_tpu_torch against its plain PyTorch version,
on the card (skipped without one).

Imports neither JAX nor sage2_tpu, so it runs on a GPU machine without
JAX. There, run it without the suite's conftest (which pins JAX to the
CPU):

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels_cuda.py

Tolerance: bit equality (integer kernels).
"""

import numpy as np
import pytest
import torch

from sage2_tpu_torch import kernels
from sage2_tpu_torch.data import simulate_genome, simulate_reads
from sage2_tpu_torch.kernels import plain
from sage2_tpu_torch.kmer.correct import prune_table_for_correction
from sage2_tpu_torch.kmer.count import count_kmers
from sage2_tpu_torch.overlap.detect import (
    build_seed_rows,
    join_geometry,
    sorted_seed_rows,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    kernels.load_all()
    return torch.device("cuda")


def _reads(n_genome=30_000, seed=7, err=0.01):
    g = simulate_genome(n_genome, seed=seed)
    r, _ = simulate_reads(g, read_len=100, coverage=30, error_rate=err,
                          seed=seed + 1)
    return torch.from_numpy(r.astype(np.int32))


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x.cpu(), y.cpu())
        else:
            assert x == y


@pytest.mark.parametrize("k", [15, 25, 31, 32])
def test_kmer_keys_kernel(cuda, k):
    r = _reads().to(cuda)
    before = kernels.LAUNCHES["kmer_keys"]
    _equal(kernels.kmer_keys(r, k), plain.kmer_keys(r, k))
    assert kernels.LAUNCHES["kmer_keys"] == before + 1


def test_lookup_counts_kernel(cuda):
    r = _reads().to(cuda)
    t = prune_table_for_correction(count_kmers(r, 25), 2)
    _, _, canon = kernels.kmer_keys(r, 25)
    q = torch.cat([canon.reshape(-1),
                   torch.randint(0, 1 << 50, (10_000,), device=cuda)])
    _equal([kernels.lookup_counts(t.keys, t.count, q)],
           [plain.lookup_counts(t.keys, t.count, q)])
    empty = t.keys[:0]
    _equal([kernels.lookup_counts(empty, t.count[:0], q)],
           [plain.lookup_counts(empty, t.count[:0], q)])


@pytest.mark.parametrize("seed", [7, 8])
def test_overlap_join_kernel(cuda, seed):
    r = _reads(seed=seed, err=0.002).to(cuda)
    geo = join_geometry(100, 40, 32)
    keys, live, payload = build_seed_rows(
        r, torch.ones(r.shape[0], dtype=torch.bool, device=cuda), 32, geo)
    s_keys, s_rows = sorted_seed_rows(keys, live, geo)
    args = (s_keys, s_rows, payload.reshape(-1, geo.Wt + 2), geo.R, geo.g,
            geo.trim, 40)
    before = kernels.LAUNCHES["overlap_join"]
    got = kernels.overlap_join(*args)
    assert kernels.LAUNCHES["overlap_join"] == before + 2   # count + write
    assert got[4] > 0
    _equal(got, plain.overlap_join(*args))


@pytest.mark.parametrize("op", ["none", "min", "add"])
def test_pointer_jump_kernel(cuda, op):
    rng = np.random.default_rng(3)
    V = 100_003
    p = torch.from_numpy(rng.integers(0, V, V).astype(np.int32)).to(cuda)
    val = None if op == "none" else torch.from_numpy(
        rng.integers(-1000, 1000, V).astype(np.int32)).to(cuda)
    before = kernels.LAUNCHES["pointer_jump"]
    _equal(kernels.pointer_jump(p, val, op), plain.pointer_jump(p, val, op))
    assert kernels.LAUNCHES["pointer_jump"] == before + 1
