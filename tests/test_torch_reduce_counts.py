"""K6's semantics on the CPU: ``plain.reduce_counts`` (the version every
CUDA launch of ``kernels.reduce_counts`` is held to) against the
reference's ``_reduce_prep`` (sage2_tpu/graph/reduce.py:133, jitted on
CPU JAX) on the smallest graphs that reach each edge case of the
kernel's design (tests/torch_kernel_cases.py ``counts_case``): a hub, runs
of vertices without out-edges, bounds equal to an sl of dst's run, the
last vertex with edges, all padding, and negative bounds; fixed and
per-vertex lengths. ``start`` and ``counts`` exactly, ``maxsl`` against a
numpy segment maximum, ``startd`` against ``np.searchsorted`` of src, and
the identity the kernel's one vertex row table rests on: ``start ==
startd[:V]``. A Python mirror of the table's warp loop
(kernels/csrc/vertex_rows.cuh, K6's with maxsl and K21's without) is
held to the plain version's ``startd`` and ``maxsl`` on the same graphs,
on a hub whose run spans many batches, without padding, and on no
edges; a mirror of the counts launch (a run read by the aligned 16-byte
chunks of an 8-bit saturated copy of the sl, a hub's run bisected, the
keys bisected for a bound past the copy) to the plain version's
``counts``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage2_tpu.graph.reduce import _reduce_prep
from sage2_tpu_torch.kernels import plain
from sage2_tpu_torch.ops.sort import sort_by_pair
from torch_kernel_cases import COUNTS_CASES, I32_MAX, counts_case
from torch_one_thread import one_thread  # noqa: F401


def _keys(src, ovl, V, read_len):
    """The caller's sorted (src, sl) keys (graph/reduce.py _device_reduce)."""
    s, o = torch.from_numpy(src), torch.from_numpy(ovl)
    if isinstance(read_len, np.ndarray):
        length = torch.from_numpy(read_len)[s.clamp(0, V - 1).long()]
    else:
        length = read_len
    sl = torch.where(s != I32_MAX, length - o, I32_MAX)
    return sort_by_pair(s, sl)[0]


def _plain(src, dst, ovl, V, read_len, keys=None):
    keys = _keys(src, ovl, V, read_len) if keys is None else keys
    rl = (torch.from_numpy(read_len) if isinstance(read_len, np.ndarray)
          else read_len)
    return [t.numpy() for t in plain.reduce_counts(
        keys, torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(ovl), V, rl)]


def _segment_max(src, ovl, V, read_len):
    real = src != I32_MAX
    s = src[real].astype(np.int64)
    length = read_len[s] if isinstance(read_len, np.ndarray) else read_len
    out = np.full(V, -1, np.int64)
    np.maximum.at(out, s, length - ovl[real].astype(np.int64))
    return out


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("case", COUNTS_CASES)
def test_plain_reduce_counts_matches_reference(case, ragged):
    src, dst, ovl, V, read_len = counts_case(case, ragged)
    start, maxsl, startd, counts = _plain(src, dst, ovl, V, read_len)
    fixed = None if ragged else read_len
    lens = jnp.asarray(read_len) if ragged else None
    _, _, _, r_start, r_counts, _ = _reduce_prep(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ovl), V, fixed, lens)
    np.testing.assert_array_equal(start, np.asarray(r_start))
    np.testing.assert_array_equal(counts, np.asarray(r_counts))
    np.testing.assert_array_equal(maxsl, _segment_max(src, ovl, V, read_len))
    np.testing.assert_array_equal(
        startd, np.searchsorted(src, np.arange(V + 1, dtype=np.int32)))
    if case == "padding":
        assert not counts.any() and (maxsl == -1).all()
        assert not startd.any()
    else:
        assert counts.sum() > 0


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("case", COUNTS_CASES)
def test_start_is_startd_prefix(case, ragged):
    """Both edge orders sort by src first with the padding last, so the
    (src, sl) run starts are the (src, dst) ones: one table serves both."""
    src, dst, ovl, V, read_len = counts_case(case, ragged)
    start, _, startd, _ = _plain(src, dst, ovl, V, read_len)
    np.testing.assert_array_equal(start, startd[:V])
    assert startd[V] == int((src != I32_MAX).sum())


def test_tie_counts_take_the_equal_sl():
    """The tie case by hand: edge 1 -> 2 (sl 10, maxsl(1) = 30) has bound
    20 over 2's run of sl 19, 20, 20, 21, so it counts 3 (the upper
    bound takes both 20s); 1 -> 3 has bound 0, below 3's sl 5 and 6."""
    src, dst, ovl, V, read_len = counts_case("tie", False)
    counts = _plain(src, dst, ovl, V, read_len)[3]
    at = {(int(s), int(d)): int(c) for s, d, c in zip(src, dst, counts)}
    assert at[(1, 2)] == 3 and at[(1, 3)] == 0


@pytest.mark.parametrize("ragged", [False, True])
def test_negative_bounds_count_zero(ragged):
    """A bound below 0 counts nothing. The reference's own keys never give
    one (maxsl(v) is the largest sl of v's edges), so here the counts read
    lengths 40 longer than the ones the keys' sl came from: each edge's
    bound falls by 40, and against the reference's formula written out
    with numpy (``_reduce_prep``'s lines, np.searchsorted for the
    lexicographic searches) the edges whose bound went negative count
    0."""
    src, dst, ovl, V, read_len = counts_case("random", ragged)
    keys = _keys(src, ovl, V, read_len)
    longer = read_len + 40
    start, maxsl, _, counts = _plain(src, dst, ovl, V, longer, keys)
    k = keys.numpy()
    real = src != I32_MAX
    s = np.minimum(src, V - 1).astype(np.int64)
    length = longer[s] if ragged else longer
    bound = np.where(real, maxsl[s] - (length - ovl), -1)
    w = np.where(real, dst, 0).astype(np.int64)
    upto = np.searchsorted(k, (w << 32) | np.maximum(bound, 0),
                           side="right")
    want = np.where(real & (bound >= 0), upto - start[w], 0)
    np.testing.assert_array_equal(counts, want)
    assert (real & (bound < 0)).any() and (want > 0).any()


def _warp_partition(a, b, pred):
    """vertex_rows.cuh warp_partition: 32 probes a round."""
    while b - a > 32:
        n = b - a
        t = sum(bool(pred(a + n * (lane + 1) // 32 - 1))
                for lane in range(32))
        a, b = (a if t == 0 else a + n * t // 32,
                b if t == 32 else a + n * (t + 1) // 32 - 1)
    return a + sum(1 for lane in range(32) if a + lane < b and pred(a + lane))


def _mirror_rows(keys, V, with_maxsl, rows_per=4):
    """vertex_rows.cuh build() over vbase = 0, v_d = V, its warps one
    after another (each writes only its own 32 vertices), its lanes as
    numpy columns and its shuffles as shifts: (row (V + 1,), maxsl (V,)
    or None); entries it never writes stay -7."""
    E = keys.shape[0]
    row = np.full(V + 1, -7, np.int64)
    maxsl = np.full(V, -7, np.int64) if with_maxsl else None
    lane = np.arange(32)
    for vlo in range(0, V + 1, 32):
        vhi = min(vlo + 31, V)
        stop = min(vhi + 1, V) if with_maxsl else vhi
        w0 = _warp_partition(0, E, lambda i: keys[i] < (vlo << 32))
        last, last_key = vlo - 1, 0
        while last < stop:
            i = w0 + 32 * np.arange(rows_per)[:, None] + lane
            key = np.where(i < E, keys[np.minimum(i, max(E - 1, 0))]
                           if E else 0, 0)
            src = np.where(i < E, key >> 32, V)
            head = int(src[0, 0])
            for k in range(rows_per):
                prev = np.r_[last, src[k, :31]]
                prev_key = np.r_[last_key, key[k, :31]]
                last, last_key = int(src[k, 31]), int(key[k, 31])
                for l in np.flatnonzero(i[k] <= E):
                    p, sk = int(prev[l]), int(src[k, l])
                    for v in range(max(p + 1, vlo), min(sk, vhi) + 1):
                        row[v] = i[k, l]
                        if with_maxsl and v < sk and v < V:
                            maxsl[v] = -1
                    if with_maxsl and p < sk and vlo <= p <= vhi and p < V:
                        maxsl[p] = int(prev_key[l]) & 0xFFFFFFFF
            w0 += 32 * rows_per
            if head == last and last < stop:
                nxt = (last + 1) << 32
                w0 = _warp_partition(w0, E, lambda j: keys[j] < nxt)
                if with_maxsl:
                    last_key = int(keys[w0 - 1])
    return row, maxsl


def _hub_graph(padded):
    """700 vertices: a hub of 3,000 out-edges, 40 out-edges of the last
    vertex, runs of 250 and 200 vertices without edges."""
    rng = np.random.default_rng(41)
    V, hub = 700, 123
    some = np.r_[0:50, 300:400, 600:V]
    s = np.r_[np.full(3000, hub), rng.choice(some, 2300), np.full(40, V - 1)]
    d = rng.integers(0, V, s.shape[0])
    sl = rng.integers(1, 60, s.shape[0])
    order = np.lexsort((d, s))
    pad = np.full(7 if padded else 0, I32_MAX)
    return (np.r_[s[order], pad].astype(np.int32),
            np.r_[d[order], pad].astype(np.int32),
            np.r_[100 - sl[order], np.zeros(pad.shape[0])].astype(np.int32),
            V, 100)


MIRROR_CASES = [(c, r) for c in COUNTS_CASES for r in (False, True)] + [
    ("hub_padded", False), ("hub_unpadded", False), ("no_edges", False)]


@pytest.mark.parametrize("case,ragged", MIRROR_CASES)
def test_row_table_mirror_matches_plain(case, ragged):
    if case in ("hub_padded", "hub_unpadded"):
        graph = _hub_graph(case == "hub_padded")
    elif case == "no_edges":
        empty = np.zeros(0, np.int32)
        graph = (empty, empty, empty, 40, 100)
    else:
        graph = counts_case(case, ragged)
    src, dst, ovl, V, read_len = graph
    keys = _keys(src, ovl, V, read_len)
    _, maxsl, startd, _ = _plain(src, dst, ovl, V, read_len, keys)
    row, m = _mirror_rows(keys.numpy(), V, True)
    np.testing.assert_array_equal(row, startd)
    np.testing.assert_array_equal(m, maxsl)
    np.testing.assert_array_equal(_mirror_rows(keys.numpy(), V, False)[0],
                                  startd)


SCAN_RUN = 128         # reduce_counts.cu kScanRun
SAT = 255              # and kSat


def _mirror_count_run(sl8, lo, hi, cut):
    """reduce_counts.cu count_run: #{i in [lo, hi): sl8[i] <= cut}, cut <
    SAT, by the 16-byte chunks (16 bytes) that cover the run, each byte
    masked to [lo, hi); a run past SCAN_RUN bisected."""
    if hi - lo > SCAN_RUN:
        a, b = lo, hi
        while a < b:
            mid = (a + b) >> 1
            a, b = (mid + 1, b) if sl8[mid] <= cut else (a, mid)
        return a - lo
    n = 0
    for c in range(lo >> 4, (hi + 15) >> 4):
        base = c << 4
        a, b = max(lo - base, 0), min(hi - base, 16)
        inside = ((1 << b) - 1) & ~((1 << a) - 1) if b > a else 0
        le = sum(1 << h for h in range(16) if sl8[base + h] <= cut)
        n += bin(le & inside).count("1")
    return n


def _mirror_edges(keys, src, dst, ovl, V, read_len, row, maxsl):
    """reduce_counts.cu's edge launch: the rows past row[V] count 0 unread;
    a bound below SAT counts from the saturated 8-bit copy of the real
    keys' sl (16-byte chunks up to row[V]), a larger one bisects the
    keys."""
    E, real = src.shape[0], int(row[V])
    sl = keys & 0xFFFFFFFF
    sl8 = np.minimum(sl[:real], SAT)
    sl8 = np.r_[sl8, np.full(-real % 16, SAT)]
    got = np.zeros(E, np.int64)
    for e in range(real):
        v, w = int(src[e]), int(dst[e])
        length = (int(read_len[v]) if isinstance(read_len, np.ndarray)
                  else read_len)
        bound = int(maxsl[v]) - (length - int(ovl[e]))
        lo, hi = int(row[w]), int(row[w + 1])
        if 0 <= bound < SAT:
            got[e] = _mirror_count_run(sl8, lo, hi, bound)
        elif bound >= SAT:
            got[e] = np.searchsorted(sl[lo:hi], bound, side="right")
    return got


@pytest.mark.parametrize("case,ragged", MIRROR_CASES[:-1])
def test_edge_launch_mirror_matches_plain(case, ragged):
    hubs = ("hub_padded", "hub_unpadded")
    graph = (_hub_graph(case == "hub_padded") if case in hubs
             else counts_case(case, ragged))
    src, dst, ovl, V, read_len = graph
    keys = _keys(src, ovl, V, read_len)
    _, maxsl, row, counts = _plain(src, dst, ovl, V, read_len, keys)
    got = _mirror_edges(keys.numpy(), src, dst, ovl, V, read_len, row,
                        maxsl)
    np.testing.assert_array_equal(got, counts)
    if case == "long":
        sl = keys.numpy()[: int(row[V])] & 0xFFFFFFFF
        assert (sl >= SAT).any() and (sl < SAT).any()
