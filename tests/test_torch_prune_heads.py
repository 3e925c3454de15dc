"""K15 (``kernels.prune_table``) and K20's heads (``kernels.dedup_heads``)
at the size and tail cases of their card tests (tests/torch_kernel_cases.py:
tables from one entry to several tiles with every entry kept, none, or a
few in the last tile; sorted requests in long runs, runs into an
INT32_MAX tail that starts inside a tile or on its boundary, all invalid),
through their plain versions on the CPU, against sage2_tpu's
``_prune_impl`` and the reference's request dedup (sharded.py:592-601) on
CPU JAX. The plain versions have no tiles: the cases are built at small
nominal tiles, and the card tests (tests/test_torch_kernels_cuda.py) build
them at the kernels' own. Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.kmer import correct as jcorrect
from sage2_tpu.kmer.count import KmerTable as JTable
from sage2_tpu_torch import kernels
from test_torch_parallel_routing import _heads_want
from torch_kernel_cases import (
    HEADS_CASES,
    PRUNE_KEEPS,
    PRUNE_SIZES,
    heads_case,
    prune_case,
    prune_size,
)
from torch_one_thread import one_thread  # noqa: F401

PRUNE_TILE, HEAD_TILE = 512, 256        # nominal tiles of the cases


@pytest.mark.parametrize("keep", PRUNE_KEEPS)
@pytest.mark.parametrize("size", PRUNE_SIZES)
def test_prune_cases_match_reference(size, keep):
    T = prune_size(size, PRUNE_TILE)
    keys, counts = prune_case(T, keep, PRUNE_TILE, seed=T)
    jt = JTable(jnp.asarray((keys >> 32).astype(np.uint32)),
                jnp.asarray((keys & 0xFFFFFFFF).astype(np.uint32)),
                jnp.asarray(counts), jnp.int32(T), 25)
    s_hi, s_lo, s_cnt, n = jcorrect._prune_impl(jt.hi, jt.lo, jt.count, 2)
    n = int(n)
    want = ((np.asarray(s_hi)[:n].astype(np.int64) << 32)
            | np.asarray(s_lo)[:n].astype(np.int64))
    got_keys, got_counts = kernels.prune_table(torch.from_numpy(keys),
                                               torch.from_numpy(counts), 2)
    np.testing.assert_array_equal(got_keys.numpy(), want)
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(s_cnt)[:n])
    assert n == {"all": T, "none": 0}.get(keep, n)


@pytest.mark.parametrize("case", HEADS_CASES)
def test_heads_cases_match_reference(case):
    s_key, s_ord = heads_case(case, HEAD_TILE)
    # the requests in input order, which the reference sorts itself
    keys = np.empty_like(s_key)
    keys[s_ord] = s_key
    uniq, pos = kernels.dedup_heads(torch.from_numpy(s_key),
                                    torch.from_numpy(s_ord))
    want_uniq, want_pos = _heads_want(keys, np.arange(keys.size))
    np.testing.assert_array_equal(uniq.numpy(), want_uniq)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
