"""K8 (``kernels.canonical_reads``) in its three modes, K12 without K8's
reverse-complement rows, the dedup building reads2 in place, and K18's
labeling on the real edge rows alone, on the CPU: the kernels' plain
versions against each other and against the sage2_tpu functions they
port, and a Python mirror of the K8 tile kernel's index arithmetic
(kernels/csrc/canonical_reads.cu: the 2-bit stream in shared memory, the
funnel-shifted word windows, the ballots, the rows' unaligned ends) held
to the plain version.

Inputs are made with numpy from a seed. Tolerance: exact equality
(integer programs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.graph.traverse import contract_unitigs as jcontract
from sage2_tpu.overlap import prepare_reads as jprepare
from sage2_tpu_torch import kernels, pipeline
from sage2_tpu_torch.graph.traverse import contract_unitigs as tcontract
from sage2_tpu_torch.kernels import bucket_plan, plain
from sage2_tpu_torch.overlap import prepare_reads as tprepare
from torch_kernel_cases import (
    CANON_LENGTHS,
    CHAIN_CASES,
    canon_case,
    canon_tile_reads,
    chain_case,
)
from torch_one_thread import one_thread  # noqa: F401

I32_MAX = 2**31 - 1
U32 = 0xFFFFFFFF


def _tensors(reads, lens):
    return (torch.from_numpy(reads),
            None if lens is None else torch.from_numpy(lens))


# --- K8's modes ----------------------------------------------------------------

@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("L", [17, 100, 150, 300])
def test_canonical_words_only_equals_full_call(L, ragged):
    """The words-only mode gives the full call's words and choice and no
    rows; the rows-only mode into a view of a larger array gives the full
    call's rows there and leaves the rest of the array alone."""
    r, lens = _tensors(*canon_case(L, ragged))
    rc, fwd_w, rc_w, take_rc = kernels.canonical_reads(r, lens)
    none, f2, c2, t2 = kernels.canonical_reads(r, lens, False, True)
    assert none is None
    for a, b in ((fwd_w, f2), (rc_w, c2), (take_rc, t2)):
        assert torch.equal(a, b)
    assert take_rc.any() and not take_rc.all()
    N = r.shape[0]
    big = torch.full((2 * N, L), -5, dtype=torch.int32)
    got = kernels.canonical_reads(r, lens, True, False, big[N:])
    assert got[1:] == (None, None, None)
    assert got[0].data_ptr() == big[N:].data_ptr()
    assert torch.equal(big[N:], rc)
    assert bool((big[:N] == -5).all())
    with pytest.raises(ValueError):
        kernels.canonical_reads(r, lens, True, True)
    with pytest.raises(ValueError):
        kernels.canonical_reads(r, lens, False, True, big[N:])


def _funnel(lo: int, hi: int, sh: int) -> int:
    """__funnelshift_l(lo, hi, sh) for sh < 32."""
    return ((((hi << 32) | lo) << sh) >> 32) & U32


def _reverse_groups(x: int) -> int:
    y = int(f"{x:032b}"[::-1], 2)
    return ((y >> 1) & 0x55555555) | ((y & 0x55555555) << 1)


def k8_mirror(reads, lengths, in_shift, out_shift, words=True, rows=True,
              seed=0):
    """canonical_tile_kernel's arithmetic, tile by tile: the (N, L) codes
    start ``in_shift`` elements past a 16-byte boundary and the rows
    ``out_shift``; a tile's shared memory starts as random words (only
    what the kernel writes may reach an output). Returns (rc, fwd_w,
    rc_w, take_rc) as numpy arrays, unwritten cells -7."""
    rng = np.random.default_rng(seed)
    N, L = reads.shape
    W = -(-L // 16)
    R = canon_tile_reads(L)
    SW = (R * L + 18) // 16 + 2
    flat = reads.reshape(-1)
    rc = np.full(N * L, -7, np.int64)
    fwd_w = np.full((N, W), -7, np.int64)
    rc_w = np.full((N, W), -7, np.int64)
    take = np.full(N, -7, np.int64)
    for r0 in range(0, N, R):
        n = min(R, N - r0)
        cnt = n * L
        shift = (in_shift + r0 * L) % 4
        smem = [int(x) for x in rng.integers(0, 1 << 32, SW)]
        for c in range((shift + cnt + 3) // 4):
            lo = 4 * c - shift
            e = [int(flat[r0 * L + lo + i]) if 0 <= lo + i < cnt else 0
                 for i in range(4)]
            byte = ((e[0] & 3) << 6) | ((e[1] & 3) << 4) | (
                (e[2] & 3) << 2) | (e[3] & 3)
            w, b = 1 + c // 4, 8 * (3 - c % 4)
            smem[w] = (smem[w] & ~(0xFF << b) & U32) | (byte << b)
        s_len = [L if lengths is None else min(max(int(lengths[r0 + r]), 0),
                                               L) for r in range(n)]
        smem[0] = smem[SW - 1] = 0

        def window(q):
            i, o = (q + 16) >> 4, (q + 16) & 15
            assert 0 <= i and i + 1 < SW
            return _funnel(smem[i + 1], smem[i], 2 * o)

        if words:
            RW = n * W
            RW32 = -(-RW // 32) * 32
            diff, less = [0] * (RW32 // 32), [0] * (RW32 // 32)
            for it in range(RW32):
                f = c = 0
                if it < RW:
                    r, t = divmod(it, W)
                    ln = s_len[r]
                    fill = min(max(ln - 16 * t, 0), 16)
                    if fill:
                        keep = U32 if fill == 16 else ~(U32 >> 2 * fill) & U32
                        q0 = shift + r * L
                        f = window(q0 + 16 * t) & keep
                        c = ~_reverse_groups(
                            window(q0 + ln - 16 - 16 * t)) & keep
                    fwd_w[r0 + r, t], rc_w[r0 + r, t] = f, c
                diff[it // 32] |= (f != c) << (it % 32)
                less[it // 32] |= (c < f) << (it % 32)
            for r in range(n):
                pos, end, lt = r * W, r * W + W, 0
                while pos < end:
                    w, b = divmod(pos, 32)
                    bits = diff[w] >> b
                    if end - pos < 32 - b:
                        bits &= (1 << (end - pos)) - 1
                    if bits:
                        first = (bits & -bits).bit_length() - 1
                        lt = (less[w] >> (b + first)) & 1
                        break
                    pos += 32 - b
                take[r0 + r] = lt
        if rows and cnt:
            oshift = (out_shift + r0 * L) % 4
            for c in range((oshift + cnt + 3) // 4):
                lo = 4 * c - oshift
                r, j = divmod(max(lo, 0), L)
                for i in range(4):
                    if not 0 <= lo + i < cnt:
                        continue
                    ln, code = s_len[r], 0
                    if j < ln:
                        q = shift + r * L + ln - 1 - j
                        code = 3 - ((smem[1 + (q >> 4)] >> (30 - 2 * (
                            q & 15))) & 3)
                    rc[r0 * L + lo + i] = code
                    j += 1
                    if j == L:
                        r, j = r + 1, 0
    return rc.reshape(N, L), fwd_w, rc_w, take


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("L", CANON_LENGTHS)
def test_k8_tile_mirror_equals_plain(L, ragged):
    """The mirror of K8's tile kernel at every alignment of the codes'
    and the rows' tiles (a tile starts r0 L elements in; reads and rows
    are views at any 4-byte offset), all three modes."""
    reads, lens = canon_case(L, ragged)
    want = [a.numpy().astype(np.int64) for a in plain.canonical_reads(
        *_tensors(reads, lens))]
    for in_shift, out_shift, words, rows in ((0, 0, True, True),
                                             (3, 1, True, False),
                                             (1, 2, False, True),
                                             (2, 3, True, True)):
        got = k8_mirror(reads, lens, in_shift, out_shift, words, rows,
                        seed=in_shift)
        if rows:
            np.testing.assert_array_equal(got[0], want[0])
        if words:
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_array_equal(g, w)


# --- K12 without K8's rows; reads2 built in place ------------------------------

@pytest.mark.parametrize("L,ragged", [(240, False), (241, False),
                                      (235, True), (236, True), (237, True)])
def test_dedup_reads_without_rc(L, ragged):
    """Where K12 sorts in one pass, ``rc=None`` gives the call with K8's
    rows, into ``out`` too; where it goes in passes, None raises."""
    rng = np.random.default_rng(L)
    reads = rng.integers(0, 4, (40, L), dtype=np.int32)
    reads[20:30] = reads[:10]
    lens = rng.integers(L - 3, L + 1, 40).astype(np.int32) if ragged \
        else None
    if ragged:
        lens[20:30] = lens[:10]
    r, tl = _tensors(reads, lens)
    k8 = kernels.canonical_reads(r, tl)
    lb = L.bit_length() if ragged else 0
    passes = len(bucket_plan.dedup_passes(L, lb))
    assert kernels.dedup_reads_rc(L, ragged) == (passes > 1)
    want = kernels.dedup_reads(r, tl, *k8)
    if passes > 1:
        with pytest.raises(ValueError, match="passes"):
            kernels.dedup_reads(r, tl, None, *k8[1:])
        return
    out = torch.full((2, 40, L), -5, dtype=torch.int32)
    got = kernels.dedup_reads(r, tl, None, *k8[1:], out[1])
    assert got[0].data_ptr() == out[1].data_ptr()
    assert bool((out[0] == -5).all())
    assert got[3] == want[3] < 40
    for g, w in zip(got[:3] + got[4:], want[:3] + want[4:]):
        if w is None:
            assert g is None
        else:
            assert torch.equal(g, w)


@pytest.mark.parametrize("L,ragged", [(100, False), (150, True),
                                      (250, False), (250, True)])
def test_prepare_reads_in_place_matches_reference(L, ragged):
    """The port's prepare_reads (K8 words only where K12 sorts in one
    pass, reads2's halves written in place) against
    sage2_tpu.overlap.prepare.prepare_reads, also past one pass (L =
    250): duplicates, reverse complements of other reads, palindromes."""
    reads, lens = canon_case(L, ragged)
    reads = reads[:60].copy()
    reads[40:45] = reads[10:15]
    for i in range(45, 50):
        n = L if lens is None else int(lens[i - 30])
        reads[i, :n] = (3 - reads[i - 30, :n])[::-1]
    if lens is not None:
        lens = lens[:60].copy()
        lens[40:45] = lens[10:15]
        lens[45:50] = lens[15:20]
        past = np.arange(L)[None, :] >= lens[:, None]
        reads = np.where(past, 0, reads).astype(np.int32)
        j = jprepare(jnp.asarray(reads), jnp.asarray(lens))
    else:
        j = jprepare(jnp.asarray(reads))
    t = tprepare(*_tensors(reads, lens))
    assert t.n_unique == int(j.n_unique) < 60
    fields = ["reads2", "valid2", "multiplicity", "vertex_of_read"]
    for f in fields + ([] if lens is None else ["lengths2"]):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=f)


# --- K18 on the real rows ------------------------------------------------------

@pytest.mark.parametrize("case", CHAIN_CASES)
def test_contract_unitigs_real_rows_match_reference(case):
    """The port's labeling of the real rows alone, in a random order,
    equals the reference's of the padded rows: cycles, branches, a
    self-loop, isolated vertices, no rows."""
    src, dst, ovl, V = chain_case(case)
    if V == 0:
        return
    real = src != I32_MAX
    perm = np.random.default_rng(V).permutation(int(real.sum()))
    rows = [torch.from_numpy(a[real][perm].copy()) for a in (src, dst, ovl)]
    got = tcontract(*rows, V)
    want = jcontract(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ovl),
                     V)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_real_rows_of_reduced_edges():
    """The traverse stage's upload: a ReducedGraph's first n_edges rows,
    or (a resumed run) the rows whose src is not padding."""
    src, dst, ovl, _ = chain_case("unsorted")
    real = src != I32_MAX
    for got in (pipeline._real_rows((src, dst, ovl), None),
                pipeline._real_rows((np.sort(src), dst, ovl),
                                    int(real.sum()))):
        assert len(got) == 3 and got[0].shape == (int(real.sum()),)
        assert not (got[0] == I32_MAX).any()
    got = pipeline._real_rows((src, dst, ovl), None)
    for g, a in zip(got, (src, dst, ovl)):
        np.testing.assert_array_equal(g, a[real])
