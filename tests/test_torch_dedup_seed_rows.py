"""The dedup (kernel K12), the join's seed rows (K13) and the longest
overlap per pair (K14) of sage2_tpu_torch against the functions of
sage2_tpu they port, on the CPU (the kernels' plain versions).

Inputs are made with numpy from a seed and handed to both packages; each
is the smallest that reaches its branch. Tolerance: exact equality
(integer programs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.overlap import detect as jdetect
from sage2_tpu.overlap import find_overlaps as jfind
from sage2_tpu.overlap import prepare_reads as jprepare
from sage2_tpu_torch import kernels
from sage2_tpu_torch.overlap import detect as tdetect
from sage2_tpu_torch.overlap import find_overlaps as tfind
from sage2_tpu_torch.overlap import prepare_reads as tprepare
from torch_kernel_cases import (
    DEDUP_CASES,
    REDUCE_CASES,
    dedup_case,
    reduce_case,
    seed_case,
)
from torch_one_thread import one_thread  # noqa: F401

I32_MAX = 2**31 - 1


@pytest.mark.parametrize("case", DEDUP_CASES)
def test_prepare_reads_matches_reference(case):
    """Every field of the ReadSet: K12's order, groups, representatives,
    multiplicities, vertices and lengths."""
    reads, lens = dedup_case(case)
    if lens is None:
        j = jprepare(jnp.asarray(reads))
        t = tprepare(torch.from_numpy(reads))
    else:
        j = jprepare(jnp.asarray(reads), jnp.asarray(lens))
        t = tprepare(torch.from_numpy(reads), torch.from_numpy(lens))
    assert t.n_unique == int(j.n_unique)
    fields = ["reads2", "valid2", "multiplicity", "vertex_of_read"]
    if lens is not None:
        fields.append("lengths2")
    else:
        assert t.lengths2 is None
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=f)
    if case == "all_equal":
        assert t.n_unique == 1 and int(t.multiplicity[0]) == reads.shape[0]
    if case == "ragged_wide":
        assert len(kernels.plain.dedup_keys(
            *kernels.plain.canonical_reads(torch.from_numpy(reads),
                                           torch.from_numpy(lens))[1:],
            torch.from_numpy(lens), 159)) == 6


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("seed_len,min_overlap", [(32, 40), (12, 20)])
def test_build_seed_rows_matches_reference(ragged, seed_len, min_overlap):
    """K13's sorted keys and row ids against the reference's (k_hi, k_lo,
    tag | id) sort over its valid rows, and its payload bit for bit."""
    reads, valid, lens = seed_case(ragged)
    L = reads.shape[1]
    s = min(seed_len, min_overlap, 32)
    jgeo = jdetect.join_geometry(L, min_overlap, s)
    k_hi, k_lo, packed, payload = (np.asarray(a) for a in (
        jdetect.build_seed_rows(jnp.asarray(reads), jnp.asarray(valid), s,
                                jgeo, lengths=None if lens is None
                                else jnp.asarray(lens))))
    k_hi, k_lo, packed = (a.reshape(-1).astype(np.int64)
                          for a in (k_hi, k_lo, packed))
    live = packed != 0xFFFFFFFF
    order = np.lexsort((packed[live], k_lo[live], k_hi[live]))
    want_keys = ((k_hi[live] - (1 << 31)) * (1 << 32) + k_lo[live])[order]
    want_rows = (packed[live] & 0x7FFFFFFF)[order]

    tgeo = tdetect.join_geometry(L, min_overlap, s)
    assert tuple(tgeo) == tuple(jgeo)
    s_keys, s_rows, t_payload = tdetect.build_seed_rows(
        torch.from_numpy(reads), torch.from_numpy(valid), s, tgeo,
        None if lens is None else torch.from_numpy(lens))
    np.testing.assert_array_equal(s_keys.numpy(), want_keys)
    np.testing.assert_array_equal(s_rows.numpy(), want_rows)
    np.testing.assert_array_equal(t_payload.numpy(), payload.view(np.int32))
    assert s_rows.dtype == torch.int32 and t_payload.dtype == torch.int32
    if s == 32:     # the poly-T read's live seeds hold the largest key
        assert s_keys[-1] == 2**63 - 1


def test_seed_rows_rejects_a_seed_past_the_read():
    reads = torch.zeros((2, 20), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds read length"):
        kernels.seed_rows(reads, torch.ones(2, dtype=torch.bool), None, 16,
                          2, 3, 1)


@pytest.mark.parametrize("case", REDUCE_CASES)
def test_reduce_fused_matches_reference(case):
    """K14's (src, dst, ovl, n_edges) against the reference's
    _reduce_fused, padded alike; the wide case takes the two-sort
    order."""
    ok, a, b, ovl, L, V, cap = reduce_case(case)
    db, ob = kernels.plain.edge_key_bits(V, L)
    assert (2 * db + ob > 63) == (case == "wide")
    j = jdetect._reduce_fused(*(jnp.asarray(x) for x in (ok, a, b, ovl)), L,
                              V)
    t = tdetect._reduce_fused(*(torch.from_numpy(x) for x in (ok, a, b, ovl)),
                              L, cap, V)
    assert t[3] == int(j[3])
    n = ok.shape[0]
    for x, y, fill in zip(j[:3], t[:3], (I32_MAX, I32_MAX, 0)):
        assert y.dtype == torch.int32 and y.shape == (cap,)
        np.testing.assert_array_equal(np.asarray(x), y[:n].numpy())
        assert bool((y[n:] == fill).all())
    if case == "periodic":
        got = dict(zip(zip(t[0][:t[3]].tolist(), t[1][:t[3]].tolist()),
                       t[2][:t[3]].tolist()))
        assert got[(5, 9)] == ovl[:60].max() and got[(7, 2)] == (
            ovl[60:90].max())
    if case == "no_ok":
        assert t[3] == 0


def test_find_overlaps_periodic_reads_match_reference():
    """Reads of a period-7 repeat verify one pair at several overlap
    lengths; the whole join (K13, K3, K14) keeps the longest, as the
    reference does."""
    rng = np.random.default_rng(17)
    unit = rng.integers(0, 4, 7)
    genome = np.concatenate([rng.integers(0, 4, 30), np.tile(unit, 20),
                             rng.integers(0, 4, 30)])
    reads = np.stack([genome[i: i + 60] for i in range(0, 140, 5)]).astype(
        np.int32)
    reads2 = np.concatenate([reads, (3 - reads)[:, ::-1]])
    valid = np.ones(reads2.shape[0], bool)
    j = jfind(jnp.asarray(reads2), jnp.asarray(valid), 30, capacity=1 << 14)
    t = tfind(torch.from_numpy(reads2), torch.from_numpy(valid), 30,
              capacity=1 << 14)
    assert (t.n_edges, t.n_candidates, t.n_verified) == (
        int(j.n_edges), int(j.n_candidates), int(j.n_verified))
    assert t.n_verified > t.n_edges     # pairs verified more than once
    for f in ("src", "dst", "ovl"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=f)
