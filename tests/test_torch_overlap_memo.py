"""find_overlaps_auto's capacity memo against sage2_tpu's, on the CPU:
over a sequence of same-shape calls (first call, second call, unchecked
and checked validate=False calls, denser inputs) the port picks the
reference's candidate capacity every time, so the padded edge arrays
have the reference's length and contents, and both memos hold the same
entries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.overlap import detect as jdetect
from sage2_tpu.overlap import prepare_reads as jprepare
from sage2_tpu_torch.data import (
    simulate_genome,
    simulate_ragged_reads,
    simulate_reads,
)
from sage2_tpu_torch.overlap import detect as tdetect
from sage2_tpu_torch.overlap import prepare_reads as tprepare
from torch_one_thread import one_thread  # noqa: F401

N_READS = 3000


def _fixed(genome_len, seed):
    """3,000 error-free 100 bp reads; a smaller genome is a denser
    input of the same shape."""
    g = simulate_genome(genome_len, seed=seed)
    r, _ = simulate_reads(g, read_len=100,
                          coverage=N_READS * 100 / genome_len + 1,
                          error_rate=0.0, seed=seed + 1)
    return r[:N_READS].astype(np.int32), None


def _ragged(genome_len, seed):
    g = simulate_genome(genome_len, seed=seed)
    r, lens = simulate_ragged_reads(g, 60, 100,
                                    N_READS * 80 / genome_len + 1,
                                    seed=seed + 1)
    return r[:N_READS].astype(np.int32), lens[:N_READS]


def _both(reads, lens):
    j = jprepare(jnp.asarray(reads),
                 lengths=None if lens is None else jnp.asarray(lens))
    t = tprepare(torch.from_numpy(reads),
                 None if lens is None else torch.from_numpy(lens))
    return j, t


@pytest.fixture
def memos():
    # xdist runs a file's tests in one process: start from empty memos
    jdetect._CAP_MEMO.clear()
    tdetect._CAP_MEMO.clear()
    yield
    jdetect._CAP_MEMO.clear()
    tdetect._CAP_MEMO.clear()


def _call(j, t, validate):
    jr = jdetect.find_overlaps_auto(j.reads2, j.valid2, 40,
                                    lengths=j.lengths2, validate=validate)
    tr = tdetect.find_overlaps_auto(t.reads2, t.valid2, 40,
                                    lengths=t.lengths2, validate=validate)
    for f in ("src", "dst", "ovl", "contained"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                      getattr(tr, f).numpy(), err_msg=f)
    for f in ("n_edges", "n_candidates", "n_verified", "overflow",
              "n_contained"):
        assert int(getattr(jr, f)) == int(getattr(tr, f)), f
    assert jdetect._CAP_MEMO == tdetect._CAP_MEMO
    return tr.src.shape[0], tr.n_candidates, tr.overflow


@pytest.mark.parametrize("make", [_fixed, _ragged], ids=["fixed", "ragged"])
def test_capacity_memo_sequence_matches_reference(memos, make):
    sparse = _both(*make(100_000, 3))
    dense = _both(*make(10_000, 5))
    # first call: 16 candidates a read; a tight capacity is memoized
    n1, c1, _ = _call(*sparse, True)
    assert n1 == 131_072 > c1
    # second same-shape call: starts from the memo
    n2, _, _ = _call(*sparse, True)
    assert n2 == 65_536
    # unchecked (steady) memo: a denser input comes back overflowed
    n3, c3, ovf3 = _call(*dense, False)
    assert (n3, ovf3) == (65_536, True) and c3 > n3
    # checked: resized past the denser input's candidates
    n4, c4, ovf4 = _call(*dense, True)
    assert n4 >= c4 and not ovf4
    # the first validate=False call after a resize checks once
    assert _call(*dense, False)[0] == n4


def test_unconfirmed_memo_resizes_on_overflow(memos):
    """validate=False before the memo was confirmed: one check, and a
    denser input re-enters the sizing instead of overflowing."""
    sparse = _both(*_ragged(100_000, 3))
    dense = _both(*_ragged(10_000, 5))
    _call(*sparse, True)
    n, c, ovf = _call(*dense, False)
    assert c > 65_536 and n >= c and not ovf
