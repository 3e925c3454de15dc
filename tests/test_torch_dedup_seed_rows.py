"""The dedup (kernel K12), the join's seed rows (K13) and the longest
overlap per pair (K14) of sage2_tpu_torch against the functions of
sage2_tpu they port, on the CPU (the kernels' plain versions).

Inputs are made with numpy from a seed and handed to both packages; each
is the smallest that reaches its branch. Tolerance: exact equality
(integer programs).

K12's premise (kernels/csrc/dedup_reads.cu): none of its outputs depends
on the order inside a group of equal key strings, nor on which member
stands for the group. A Python mirror of the kernel's order (each read's
string and index sorted whole, or in passes from the string's last
segment, each group's last member its representative) gives the plain
version's outputs and the reference's for any order inside the groups.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.overlap import detect as jdetect
from sage2_tpu.overlap import find_overlaps as jfind
from sage2_tpu.overlap import prepare_reads as jprepare
from sage2_tpu_torch import kernels
from sage2_tpu_torch.kernels import bucket_plan, plain
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


def dedup_mirror(reads, lens, tie):
    """K12's outputs (uniq, mult, vertex_of_read, n_unique, lens_u) as
    its kernel makes them: each read's key string (lb bits of its
    clamped length, then its canonical words) cut into 32-bit words and
    sorted with the read's index, in one pass or in the passes of
    bucket_plan.dedup_passes (each after the first also sorted by the
    previous pass's group id); the group of a read is the dense rank of
    its string, and each group's last member its representative.
    ``tie``: the order inside a group ("index": the kernel's; "reversed";
    "random")."""
    N, L = reads.shape
    t = torch.from_numpy(reads)
    tl = None if lens is None else torch.from_numpy(lens)
    rc, fwd_w, rc_w, take_rc = plain.canonical_reads(t, tl)
    flip = take_rc.numpy()
    words = np.where(flip[:, None], rc_w.numpy(), fwd_w.numpy()).astype(
        np.uint64)
    lb = 0 if lens is None else L.bit_length()
    S = bucket_plan.dedup_string_words(L, lb)
    # the string's bits: lb of length, then the 32-bit words
    big = [int(x) for x in (np.clip(lens, 0, L) if lens is not None
                            else np.zeros(N, np.int64))]
    for r in range(N):
        v = big[r]
        for wv in words[r].tolist():
            v = (v << 32) | int(wv)
        shift = 32 * S - lb - 32 * words.shape[1]   # past 2 L + lb: zeros
        big[r] = v << shift if shift >= 0 else v >> -shift
    sw = np.array([[(v >> (32 * (S - 1 - j))) & 0xFFFFFFFF
                    for j in range(S)] for v in big], np.int64).reshape(N, S)
    rng = np.random.default_rng(3)
    tiebreak = {"index": np.arange(N), "reversed": -np.arange(N),
                "random": rng.permutation(N)}[tie]
    gid = None
    for s0, ns, _ in bucket_plan.dedup_passes(L, lb):
        cols = [sw[:, s0 + j] for j in range(ns)]
        if gid is not None:
            cols.append(gid)
        order = np.lexsort([tiebreak] + cols[::-1])
        key = np.stack(cols, 1)[order]
        head = np.r_[True, (key[1:] != key[:-1]).any(1)]
        gid = np.empty(N, np.int64)
        gid[order] = np.cumsum(head) - 1
    n_unique = int(gid.max()) + 1
    last = np.r_[head[1:], True]
    rep = order[last]
    mult = np.zeros(N, np.int32)
    mult[:n_unique] = np.bincount(gid, minlength=n_unique)
    canon = np.where(flip[:, None], rc.numpy(), reads)
    uniq = np.zeros_like(reads)
    uniq[:n_unique] = canon[rep]
    lens_u = None
    if lens is not None:
        lens_u = np.zeros_like(lens)
        lens_u[:n_unique] = lens[rep]
        past = np.arange(L)[None, :] >= np.clip(lens_u, 0, L)[:, None]
        uniq[past] = 0
    vertex = (gid + flip.astype(np.int64) * N).astype(np.int32)
    return uniq, mult, vertex, n_unique, lens_u


@pytest.mark.parametrize("tie", ["index", "reversed", "random"])
@pytest.mark.parametrize("case", DEDUP_CASES)
def test_dedup_order_inside_groups_is_free(case, tie):
    """K12 sorts each string once with its index and no stable chain:
    whatever the order inside each group of equal strings (and whichever
    member stands for it), the outputs are plain.dedup_reads' and the
    reference prepare_reads' ReadSet: fixed and ragged reads, all-equal
    reads, reads sharing their first 64-bit key and differing in the
    last word ("same_lead", "ragged_same_lead"), a string sorted in two
    passes ("long")."""
    reads, lens = dedup_case(case)
    got = dedup_mirror(reads, lens, tie)
    t = torch.from_numpy(reads)
    tl = None if lens is None else torch.from_numpy(lens)
    want = plain.dedup_reads(t, tl, *plain.canonical_reads(t, tl))
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        elif isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(a, b.numpy())
        else:
            assert a == b
    j = (jprepare(jnp.asarray(reads)) if lens is None
         else jprepare(jnp.asarray(reads), jnp.asarray(lens)))
    N = reads.shape[0]
    assert got[3] == int(j.n_unique)
    np.testing.assert_array_equal(got[0], np.asarray(j.reads2)[:N])
    np.testing.assert_array_equal(got[1], np.asarray(j.multiplicity)[:N])
    np.testing.assert_array_equal(got[2], np.asarray(j.vertex_of_read))
    if lens is not None:
        np.testing.assert_array_equal(got[4], np.asarray(j.lengths2)[:N])
    if case == "long":
        assert len(bucket_plan.dedup_passes(reads.shape[1], 0)) == 2
