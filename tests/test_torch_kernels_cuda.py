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
from sage2_tpu_torch.data import (
    simulate_genome,
    simulate_ragged_reads,
    simulate_reads,
)
from sage2_tpu_torch import stream
from sage2_tpu_torch.graph import reduce as reduce_mod
from sage2_tpu_torch.graph.traverse import contract_unitigs
from sage2_tpu_torch.kernels import bucket_plan, plain
from sage2_tpu_torch.kmer.correct import (
    prune_table_for_correction,
    twophase_round,
)
from sage2_tpu_torch.kmer.count import count_kmers
from sage2_tpu_torch.ops.bitpack import pack_read_words
from sage2_tpu_torch.utils import native_build
from sage2_tpu_torch.ops.sort import sort_by_pair
from sage2_tpu_torch.overlap import (
    compact_stacked_result,
    find_overlaps,
    find_overlaps_auto,
    find_overlaps_stacked,
    prepare_reads,
)
from sage2_tpu_torch.overlap.detect import build_seed_rows, join_geometry
from torch_kernel_cases import (
    CANON_LENGTHS,
    CHAIN_CASES,
    COUNTS_CASES,
    HEADS_CASES,
    I32_MAX,
    DEDUP_CASES,
    MARKS_READ_LEN,
    PRUNE_KEEPS,
    PRUNE_SIZES,
    REDUCE_CASES,
    SIGNED_CASES,
    UNSIGNED_CASES,
    VOTE_CASES,
    bucket_geometry,
    canon_case,
    chain_case,
    counts_case,
    crowded_bucket_table,
    kmer_codes,
    lookup_case,
    marks_graph,
    oracle_lookup,
    dedup_case,
    heads_case,
    prune_case,
    prune_size,
    reduce_case,
    seed_case,
    slot_splits,
    solid_mix,
    tied_variants_case,
    vote_case,
)
from torch_one_thread import one_thread  # noqa: F401

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
    before = kernels.LAUNCHES["lookup_counts"]
    got = kernels.lookup_counts(t.keys, t.count, q)
    assert kernels.LAUNCHES["lookup_counts"] == before + 2  # index + lookup
    _equal([got], [plain.lookup_counts(t.keys, t.count, q)])
    # the (n, 4) variants of phase 2; an 8- but not 16-byte aligned slice
    q4 = q[: q.numel() // 4 * 4].reshape(-1, 4)
    _equal([kernels.lookup_counts(t.keys, t.count, q4)],
           [plain.lookup_counts(t.keys, t.count, q4)])
    odd = q[1:]
    assert odd.data_ptr() % 16 == 8
    _equal([kernels.lookup_counts(t.keys, t.count, odd)],
           [plain.lookup_counts(t.keys, t.count, odd)])
    empty = t.keys[:0]
    _equal([kernels.lookup_counts(empty, t.count[:0], q)],
           [plain.lookup_counts(empty, t.count[:0], q)])
    before = kernels.LAUNCHES["lookup_counts"]
    none = kernels.lookup_counts(t.keys, t.count, q[:0])
    assert none.shape == (0,) and none.dtype == torch.int32
    assert kernels.LAUNCHES["lookup_counts"] == before


@pytest.mark.parametrize("case", UNSIGNED_CASES + SIGNED_CASES)
def test_lookup_counts_kernel_edges(cuda, case):
    """Every key, each +- 1, the keys just outside the span and every
    bucket edge +- 1 (tests/torch_kernel_cases.py): a one-bucket skew,
    T = 1 and 2, keys over 50 bits, negative keys, the int64 extremes;
    against the plain version and a dictionary, whole, as (n, 4) and as a
    misaligned slice."""
    keys, counts, q = (torch.from_numpy(a).to(cuda)
                       for a in lookup_case(case))
    want = torch.from_numpy(oracle_lookup(*(a.cpu().numpy()
                                            for a in (keys, counts, q))))
    _equal([kernels.lookup_counts(keys, counts, q)],
           [plain.lookup_counts(keys, counts, q)])
    _equal([kernels.lookup_counts(keys, counts, q)], [want])
    q4 = q[: q.numel() // 4 * 4].reshape(-1, 4)
    _equal([kernels.lookup_counts(keys, counts, q4)],
           [want[: q4.numel()].reshape(-1, 4)])
    _equal([kernels.lookup_counts(keys, counts, q[1:])], [want[1:]])
    # the packed entries where the buckets are at most 2^32 apart
    _, _, shift = bucket_geometry(keys.cpu().numpy())
    assert int(kernels.lookup_directory(keys, counts)[3]) == (shift <= 32)


@pytest.mark.parametrize("span_bits,packed", [(50, 1), (51, 1), (52, 0)])
def test_lookup_counts_kernel_packed(cuda, span_bits, packed):
    """A table of 2^20 + 1 keys (2^19 buckets) over span_bits bits: the
    buckets are 2^31, 2^32 or 2^33 apart, so its entries are packed as
    (uint32 offset, count) for the first two and not for the third;
    every key, each +- 1, random keys and the span's ends."""
    g = torch.Generator(device=cuda).manual_seed(span_bits)
    T = (1 << 20) + 1
    keys = torch.unique(torch.randint(0, 1 << span_bits, (T + T // 4,),
                                      generator=g, device=cuda))[:T - 1]
    keys = torch.cat([keys.new_tensor([0]), keys[1:],
                      keys.new_tensor([(1 << span_bits) - 1])])
    keys = torch.unique(keys)
    counts = torch.randint(1, 1 << 30, keys.shape, generator=g, device=cuda,
                           dtype=torch.int32)
    q = torch.cat([keys, keys - 1, keys + 1,
                   torch.randint(-5, 1 << span_bits, (1 << 20,), generator=g,
                                 device=cuda)])
    want = plain.lookup_counts(keys, counts, q)
    scratch = kernels.lookup_directory(keys, counts)
    assert (int(scratch[2]), int(scratch[3])) == (span_bits - 19, packed)
    _equal([kernels.lookup_counts(keys, counts, q)], [want])
    _equal([kernels.lookup_counts(keys, counts, q[1:])], [want[1:]])


@pytest.mark.parametrize("seed", [7, 8])
def test_overlap_join_kernel(cuda, seed):
    r = _reads(seed=seed, err=0.002).to(cuda)
    geo = join_geometry(100, 40, 32)
    s_keys, s_rows, payload = build_seed_rows(
        r, torch.ones(r.shape[0], dtype=torch.bool, device=cuda), 32, geo)
    args = (s_keys, s_rows, payload.reshape(-1, geo.Wt + 2), geo.R, geo.g,
            geo.trim, 40)
    before = kernels.LAUNCHES["overlap_join"]
    got = kernels.overlap_join(*args)
    assert kernels.LAUNCHES["overlap_join"] == before + 2   # count + write
    assert got[4] > 0
    _equal(got, plain.overlap_join(*args))


def _jump_pointers(layout, rng):
    """(V,) int32 parent pointers: one vertex; a random functional graph
    whose V is not a multiple of 4, or larger than one cooperative wave
    (132 SMs x 8 blocks x 256 threads x 4 vertices); one chain of length
    V, which needs every step; disjoint rings of a permutation."""
    if layout == "one":
        return np.zeros(1, np.int32)
    if layout == "ragged":
        return rng.integers(0, 100_003, 100_003).astype(np.int32)
    if layout == "waves":
        return rng.integers(0, 3_000_001, 3_000_001).astype(np.int32)
    if layout == "chain":
        return np.maximum(np.arange(1 << 20) - 1, 0).astype(np.int32)
    perm = rng.permutation(100_000)
    p = np.empty(perm.shape[0], np.int32)
    for ring in np.array_split(perm, 13):
        p[ring] = np.roll(ring, 1)
    return p


@pytest.mark.parametrize("layout", ["one", "ragged", "waves", "chain",
                                    "rings"])
@pytest.mark.parametrize("steps", [1, 2, 24])
@pytest.mark.parametrize("op", ["none", "min", "add"])
def test_pointer_jump_kernel(cuda, op, steps, layout):
    """A whole doubling loop in one launch, bit-equal to the plain steps;
    the inputs stay as they were (every step writes the other half of a
    ping-pong pair). Add values span int32, so the sums wrap."""
    rng = np.random.default_rng(5)
    p = torch.from_numpy(_jump_pointers(layout, rng)).to(cuda)
    V = p.shape[0]
    val = None
    if op == "min":
        val = torch.from_numpy(rng.integers(-1000, 1000, V).astype(
            np.int32)).to(cuda)
    elif op == "add":
        val = torch.from_numpy(rng.integers(-2**31, 2**31, V, dtype=np.int64)
                               .astype(np.int32)).to(cuda)
    kept = [t.clone() for t in (p, val) if t is not None]
    before = kernels.LAUNCHES["pointer_jump"]
    got = kernels.pointer_jump(p, val, op, steps)
    assert kernels.LAUNCHES["pointer_jump"] == before + 1
    _equal(got, plain.pointer_jump(p, val, op, steps))
    _equal([t for t in (p, val) if t is not None], kept)
    if layout == "chain" and steps == 24:
        assert not got[0].any()


@pytest.mark.parametrize("k,threshold,pruned", [(25, 2, True), (25, 2, False),
                                                (15, 3, True), (31, 2, True)])
def test_vote_windows_kernel(cuda, k, threshold, pruned):
    r = _reads().to(cuda)
    t = count_kmers(r, k)
    if pruned:
        t = prune_table_for_correction(t, threshold)
    args = (r, t.keys, t.count, k, threshold)
    before = kernels.LAUNCHES["vote_windows"]
    got = kernels.vote_windows(*args)
    assert kernels.LAUNCHES["vote_windows"] == before + 2  # index + vote
    assert (got != r).any()
    _equal([got], [plain.vote_windows(*args)])


@pytest.mark.parametrize("case", VOTE_CASES)
def test_vote_windows_kernel_cases(cuda, case):
    """tests/torch_kernel_cases.py's K5 cases (hundreds of reads, eight a
    block): no error (every base skipped), errors at the first, middle
    and last base, two errors closer than k, a tie, ragged reads of k -
    1 and k bases, a table that is not pruned, an empty pruned table,
    k = 31."""
    reads, lengths, keys, counts, k, threshold, truth = vote_case(case)
    args = tuple(torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray)
                 else a for a in (reads, keys, counts, k, threshold,
                                  lengths))
    got = kernels.vote_windows(*args)
    _equal([got], [plain.vote_windows(*args)])
    _equal([got], [torch.from_numpy(reads if case == "empty" else truth)])


def test_vote_windows_kernel_long_reads(cuda):
    """Reads of 3,000 bases: a read's shared memory (~100 KB) leaves room
    for two warps a block, not eight."""
    g = simulate_genome(20_000, seed=3)
    r, _ = simulate_reads(g, read_len=3000, coverage=10, error_rate=0.01,
                          seed=4)
    r = torch.from_numpy(r.astype(np.int32)).to(cuda)
    t = prune_table_for_correction(count_kmers(r, 25), 2)
    args = (r, t.keys, t.count, 25, 2)
    got = kernels.vote_windows(*args)
    assert (got != r).any()
    _equal([got], [plain.vote_windows(*args)])


def _device_graph(cuda, seed=7):
    r = _reads(seed=seed, err=0.0).to(cuda)
    rs = prepare_reads(r)
    res = find_overlaps_auto(rs.reads2, rs.valid2, 40, 32)
    return res.src, res.dst, res.ovl, rs.reads2.shape[0]


def test_reduce_kernels(cuda):
    src, dst, ovl, V = _device_graph(cuda)
    L = 100
    sl = torch.where(src != 2**31 - 1, L - ovl, 2**31 - 1)
    keys, order = sort_by_pair(src, sl)
    before = kernels.LAUNCHES["reduce_counts"]
    got = kernels.reduce_counts(keys, src, dst, ovl, V, L)
    assert kernels.LAUNCHES["reduce_counts"] == before + 2
    _equal(got, plain.reduce_counts(keys, src, dst, ovl, V, L))
    start, _, startd, counts = got
    offsets = torch.cumsum(counts, 0, dtype=torch.int64)
    total = int(offsets[-1])
    assert total > 0
    ss_sl = (keys & 0xFFFFFFFF).to(torch.int32)
    rest = (offsets, src, dst, ovl, ss_sl, dst[order], start, startd, L)
    for j0, j1 in [(0, total), (total // 3, total // 2), (total, total)]:
        removed = torch.zeros_like(src, dtype=torch.uint8)
        before = kernels.LAUNCHES["reduce_marks"]
        a = kernels.reduce_marks(removed.clone(), *rest, j0, j1)
        assert kernels.LAUNCHES["reduce_marks"] == before + (j1 > j0)
        _equal([a], [plain.reduce_marks(removed.clone(), *rest, j0, j1)])


def _counts_inputs(cuda, src, dst, ovl, V, read_len, key_len=None):
    """K6's inputs on the card: the edges, the caller's sorted (src, sl)
    keys (sl from ``key_len``, by default ``read_len``) and the length
    argument."""
    src, dst, ovl = (torch.from_numpy(a).to(cuda) for a in (src, dst, ovl))
    lens = (torch.from_numpy(read_len).to(cuda)
            if isinstance(read_len, np.ndarray) else read_len)
    kl = lens if key_len is None else key_len
    length = (kl[src.clamp(0, V - 1).long()] if isinstance(kl, torch.Tensor)
              else kl)
    keys, _ = sort_by_pair(src, torch.where(src != I32_MAX, length - ovl,
                                            I32_MAX))
    return keys, src, dst, ovl, V, lens


def _check_counts(args):
    before = kernels.LAUNCHES["reduce_counts"]
    got = kernels.reduce_counts(*args)
    assert kernels.LAUNCHES["reduce_counts"] == before + 2
    _equal(got, plain.reduce_counts(*(a.cpu() if isinstance(
        a, torch.Tensor) else a for a in args)))
    return got


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("case", COUNTS_CASES + ("longer", "saturated",
                                                  "mixed"))
def test_reduce_counts_kernel_cases(cuda, case, ragged):
    """K6 on tests/torch_kernel_cases.py's graphs (a hub, runs of vertices
    without edges, sl ties, the last vertex with edges, all padding, sl
    and bounds on both sides of the 8-bit copy's 255), and on its random
    graph as "longer" (the counts read lengths 40 longer than the keys'
    sl came from: negative bounds), "saturated" (lengths 70,000 longer:
    every sl saturated in the copy) and "mixed" (one vertex's sl
    saturated): each output bit-equal to the plain version's."""
    base = "random" if case in ("longer", "saturated", "mixed") else case
    src, dst, ovl, V, read_len = counts_case(base, ragged)
    key_len = None
    if case == "longer":
        key_len = torch.from_numpy(read_len).to(cuda) if ragged else read_len
        read_len = read_len + 40
    elif case == "saturated":
        read_len = read_len + 70_000
    elif case == "mixed":
        lens = (read_len if ragged else np.full(V, read_len)).astype(np.int32)
        lens[int(src[0])] += 70_000
        read_len = lens
    _check_counts(_counts_inputs(cuda, src, dst, ovl, V, read_len, key_len))


@pytest.mark.parametrize("ragged", [False, True])
def test_reduce_counts_kernel_hub(cuda, ragged):
    """A hub of 20,000 out-edges (its rows span many batches of the row
    table's loop, which jumps the run by a search) that 3,000 edges point
    at (their bisections take 15 steps), runs of hundreds of vertices
    without edges (warps with no rows of their own), and the last vertex
    with edges, against the plain version."""
    rng = np.random.default_rng(41)
    V, hub = 5000, 1234
    some = np.r_[0:300, 2000:2400, 4000:V]     # the others: no edges
    s = np.r_[np.full(20_000, hub), rng.choice(some, 3000),
              np.full(200, V - 1), rng.choice(some, 30_000)]
    d = np.r_[rng.integers(0, V, 20_000), np.full(3000, hub),
              rng.integers(0, V, 200), rng.integers(0, V, 30_000)]
    d[rng.random(d.shape[0]) < 0.1] = V - 1
    lens = rng.integers(80, 121, V).astype(np.int32)
    sl = rng.integers(1, 60, s.shape[0])
    order = np.lexsort((d, s))
    s, d, sl = s[order], d[order], sl[order]
    read_len = lens if ragged else 100
    length = lens[s] if ragged else 100
    pad = np.full(77, I32_MAX)
    src = np.r_[s, pad].astype(np.int32)
    dst = np.r_[d, pad].astype(np.int32)
    ovl = np.r_[length - sl, np.zeros(77)].astype(np.int32)
    start, maxsl, startd, counts = _check_counts(
        _counts_inputs(cuda, src, dst, ovl, V, read_len))
    assert int(startd[hub + 1] - startd[hub]) == 20_000
    assert int(maxsl[2500]) == -1 and int(maxsl[V - 1]) >= 0
    assert int(counts.max()) > 1000


@pytest.mark.parametrize("split", ["one", "mid-hub", "edge-first",
                                   "zero-run", "every-1000"])
def test_reduce_marks_kernel_splits(cuda, split):
    """tests/torch_kernel_cases.py's K7 graph (a hub whose expansion of
    5,000 slots spans three tiles of 2,048 merge-path items, a run of 600
    zero-count edges; 12 tiles in all) in consecutive slot ranges cut
    mid-hub, at an edge's first slot, around the zero-count run or every
    1,000 slots: each range's marks equal the plain version's, and
    together they equal one range's."""
    src, dst, ovl, V = (torch.from_numpy(a).to(cuda)
                        if isinstance(a, np.ndarray) else a
                        for a in marks_graph())
    L = MARKS_READ_LEN
    keys, order = sort_by_pair(src, L - ovl)
    start, _, startd, counts = kernels.reduce_counts(keys, src, dst, ovl, V,
                                                     L)
    offsets = torch.cumsum(counts, 0, dtype=torch.int64)
    rest = (offsets, src, dst, ovl, (keys & 0xFFFFFFFF).to(torch.int32),
            dst[order], start, startd, L)
    total = int(offsets[-1])
    one = kernels.reduce_marks(torch.zeros_like(src, dtype=torch.uint8),
                               *rest, 0, total)
    _equal([one], [plain.reduce_marks(
        torch.zeros_like(src, dtype=torch.uint8), *rest, 0, total)])
    removed = torch.zeros_like(src, dtype=torch.uint8)
    j0 = 0
    for j1 in slot_splits(offsets.cpu().numpy(), src.cpu().numpy())[split]:
        fresh = torch.zeros_like(removed)
        _equal([kernels.reduce_marks(fresh, *rest, j0, j1)],
               [plain.reduce_marks(torch.zeros_like(removed), *rest, j0,
                                   j1)])
        removed |= fresh
        j0 = j1
    _equal([removed], [one])


@pytest.mark.parametrize("capacity", [None, 5000])
def test_device_reduction_matches_native(cuda, capacity):
    src, dst, ovl, V = _device_graph(cuda, seed=8)
    if capacity is None:
        dev = reduce_mod.transitive_reduction_auto(src, dst, ovl, V, 100,
                                                   backend="device")
    else:
        dev = reduce_mod.transitive_reduction(src, dst, ovl, V, 100,
                                              capacity=capacity)
        assert dev.overflow
    cpu = reduce_mod._device_reduce(src.cpu(), dst.cpu(), ovl.cpu(), V, 100,
                                    capacity)
    _equal(dev, cpu)
    if capacity is None:
        nat = reduce_mod.transitive_reduction_native(
            *(a.cpu().numpy() for a in (src, dst, ovl)), V, 100)
        _equal(dev, tuple(torch.from_numpy(a) if isinstance(a, np.ndarray)
                          else a for a in nat))


@pytest.mark.parametrize("N,W,axis", [
    (65536, 128, 0), (1 << 20, 128, 0), (2048, 2048, 1), (1000, 3, 1),
    (777, 3, 0), (513, 5, 0), (513, 5, 1), (300, 4095, 0), (300, 4095, 1),
    (1, 4095, 0), (1, 4095, 1), (1, 1, 0), (3, 49153, 1), (2, 60000, 0),
    (5000, 2047, 1)])
def test_gather_along_kernel(cuda, N, W, axis):
    """The probe's shapes; W = 3, 5 and 4095 (not a multiple of 4); N = 1;
    rows wider than the 49,152 staged on axis 1; several rows a block."""
    g = torch.Generator(device=cuda).manual_seed(0)
    tbl = torch.arange(N * W, dtype=torch.int32, device=cuda).reshape(N, W)
    idx = torch.randint(0, N if axis == 0 else W, (N, W), generator=g,
                        dtype=torch.int32, device=cuda)
    before = kernels.LAUNCHES["gather_along"]
    got = kernels.gather_along(tbl, idx, axis)
    assert kernels.LAUNCHES["gather_along"] == before + 1
    _equal([got], [plain.gather_along(tbl, idx, axis)])
    _equal([got], [torch.gather(tbl, axis, idx.long())])


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shift", [1, 2, 3])
def test_gather_along_kernel_misaligned(cuda, axis, shift):
    """Contiguous table and index that start 4, 8 or 12 bytes past a
    16-byte boundary ([shift:] slices of flat tensors, reshaped), with
    the output aligned; an index constant on axis 0."""
    N, W = 300, 256
    g = torch.Generator(device=cuda).manual_seed(shift)
    flat = torch.randint(0, 1 << 30, (N * W + shift,), generator=g,
                         dtype=torch.int32, device=cuda)
    tbl = flat[shift:].reshape(N, W)
    ext = N if axis == 0 else W
    iflat = torch.randint(0, ext, (N * W + 4 - shift,), generator=g,
                          dtype=torch.int32, device=cuda)
    idx = iflat[4 - shift:].reshape(N, W)
    assert tbl.data_ptr() % 16 and idx.data_ptr() % 16
    _equal([kernels.gather_along(tbl, idx, axis)],
           [plain.gather_along(tbl, idx, axis)])
    const = torch.full((N, W), N // 2, dtype=torch.int32, device=cuda)
    _equal([kernels.gather_along(tbl, const, 0)],
           [plain.gather_along(tbl, const, 0)])


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("bad", [-1, "extent"])
def test_gather_along_kernel_out_of_range(cuda, axis, bad):
    """An index outside [0, extent) raises IndexError, once, and the next
    call on the same process succeeds."""
    for N, W in ((64, 128), (4, 60000), (300, 5)):
        tbl = torch.arange(N * W, dtype=torch.int32,
                           device=cuda).reshape(N, W)
        idx = torch.zeros((N, W), dtype=torch.int32, device=cuda)
        idx[N - 1, W - 1] = tbl.shape[axis] if bad == "extent" else bad
        with pytest.raises(IndexError):
            kernels.gather_along(tbl, idx, axis)
        idx[N - 1, W - 1] = tbl.shape[axis] - 1
        _equal([kernels.gather_along(tbl, idx, axis)],
               [plain.gather_along(tbl, idx, axis)])


def _ragged(seed=7, n_genome=30_000):
    """Mixed-length reads (60-100 bp plus contained ones) and lengths."""
    g = simulate_genome(n_genome, seed=seed)
    r, lens = simulate_ragged_reads(g, 60, 100, 30, 0.002, seed=seed + 1)
    return (torch.from_numpy(r.astype(np.int32)),
            torch.from_numpy(lens))


@pytest.mark.parametrize("ragged", [False, True])
def test_canonical_reads_kernel(cuda, ragged):
    r, lens = _ragged()
    r, lens = r.to(cuda), (lens.to(cuda) if ragged else None)
    before = kernels.LAUNCHES["canonical_reads"]
    got = kernels.canonical_reads(r, lens)
    _equal(got, plain.canonical_reads(r, lens))
    assert got[3].any() and not got[3].all()
    _equal(kernels.canonical_reads(r, lens, rc_only=True)[:1], got[:1])
    _equal(kernels.canonical_reads(r, lens, words_only=True),
           (None,) + got[1:])
    assert kernels.LAUNCHES["canonical_reads"] == before + 3


def _misaligned(t, offset):
    """A copy of ``t`` that starts ``offset`` int32 elements into a larger
    buffer (an address 4 offset bytes past a 16-byte boundary)."""
    buf = torch.full((t.numel() + 4,), -9, dtype=t.dtype, device=t.device)
    view = buf[offset : offset + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("L", CANON_LENGTHS)
def test_canonical_tile_kernel(cuda, L, ragged):
    """K8's tile kernel in its three modes against the plain version: N
    not a multiple of a tile, palindromes and copies, ragged lengths from
    0 to L with codes past them; the codes and the rows at every 4-byte
    alignment (views into larger arrays: reads2's halves)."""
    reads, lens = canon_case(L, ragged)
    r = torch.from_numpy(reads).to(cuda)
    ln = None if lens is None else torch.from_numpy(lens).to(cuda)
    want = plain.canonical_reads(r, ln)
    before = kernels.LAUNCHES["canonical_reads"]
    _equal(kernels.canonical_reads(r, ln), want)
    for shift in range(4):
        rs = _misaligned(r, shift)
        _equal(kernels.canonical_reads(rs, ln, False, True),
               (None,) + want[1:])
        big = torch.full((reads.size + 4,), -9, dtype=torch.int32,
                         device=cuda)
        out = big[3 - shift : 3 - shift + reads.size].view(reads.shape)
        got = kernels.canonical_reads(rs, ln, True, False, out)
        assert got[0].data_ptr() == out.data_ptr() and got[1:] == (
            None, None, None)
        _equal((out,), want[:1])
        assert bool((big[: 3 - shift] == -9).all())
        assert bool((big[3 - shift + reads.size :] == -9).all())
        _equal(kernels.canonical_reads(rs, ln, False, False, out)[1:],
               want[1:])
        _equal((out,), want[:1])
    assert kernels.LAUNCHES["canonical_reads"] == before + 13


def _ragged_rows(cuda, min_overlap=40):
    r, lens = _ragged()
    rs = prepare_reads(r.to(cuda), lens.to(cuda))
    geo = join_geometry(r.shape[1], min_overlap, 32)
    s_keys, s_rows, payload = build_seed_rows(rs.reads2, rs.valid2, 32, geo,
                                              rs.lengths2)
    return rs, (s_keys, s_rows, payload.reshape(-1, geo.Wt + 2), geo.R,
                geo.g, geo.trim, min_overlap)


def _half(total):
    return total // 2


@pytest.mark.parametrize("slot_limit", [None, 5000, _half])
def test_overlap_join_kernel_ragged(cuda, slot_limit):
    rs, args = _ragged_rows(cuda)
    M = rs.reads2.shape[0]
    cont = [torch.zeros(M, dtype=torch.uint8, device=cuda) for _ in range(2)]
    before = kernels.LAUNCHES["overlap_join"]
    got = kernels.overlap_join(*args, cont[0], slot_limit)
    assert kernels.LAUNCHES["overlap_join"] == before + 2
    _equal(got, plain.overlap_join(*args, cont[1], slot_limit))
    assert torch.equal(cont[0], cont[1]) and cont[0].any()
    if slot_limit is not None:
        limit = _half(got[4]) if slot_limit is _half else slot_limit
        assert got[0].shape[0] == limit < got[4]


def test_vote_windows_kernel_ragged(cuda):
    r, lens = _ragged()
    r, lens = r.to(cuda), lens.to(cuda)
    t = prune_table_for_correction(count_kmers(r, 25, lens), 2)
    args = (r, t.keys, t.count, 25, 2, lens)
    before = kernels.LAUNCHES["vote_windows"]
    got = kernels.vote_windows(*args)
    assert kernels.LAUNCHES["vote_windows"] == before + 2
    assert (got != r).any()
    _equal([got], [plain.vote_windows(*args)])


def test_reduce_kernels_ragged(cuda):
    rs, _ = _ragged_rows(cuda)
    res = find_overlaps_auto(rs.reads2, rs.valid2, 40, 32,
                             lengths=rs.lengths2)
    src, dst, ovl, lens = res.src, res.dst, res.ovl, rs.lengths2
    V = rs.reads2.shape[0]
    sl = torch.where(src != 2**31 - 1,
                     lens[src.clamp(max=V - 1).long()] - ovl, 2**31 - 1)
    keys, order = sort_by_pair(src, sl)
    before = kernels.LAUNCHES["reduce_counts"]
    got = kernels.reduce_counts(keys, src, dst, ovl, V, lens)
    assert kernels.LAUNCHES["reduce_counts"] == before + 2
    _equal(got, plain.reduce_counts(keys, src, dst, ovl, V, lens))
    start, _, startd, counts = got
    offsets = torch.cumsum(counts, 0, dtype=torch.int64)
    total = int(offsets[-1])
    assert total > 0
    ss_sl = (keys & 0xFFFFFFFF).to(torch.int32)
    rest = (offsets, src, dst, ovl, ss_sl, dst[order], start, startd, lens)
    removed = torch.zeros_like(src, dtype=torch.uint8)
    before = kernels.LAUNCHES["reduce_marks"]
    a = kernels.reduce_marks(removed.clone(), *rest, 0, total)
    assert kernels.LAUNCHES["reduce_marks"] == before + 1
    _equal([a], [plain.reduce_marks(removed.clone(), *rest, 0, total)])
    assert a.any()
    dev = reduce_mod.transitive_reduction_auto(src, dst, ovl, V, lens,
                                               backend="device")
    nat = reduce_mod.transitive_reduction_native(
        src.cpu().numpy(), dst.cpu().numpy(), ovl.cpu().numpy(), V,
        lens.cpu().numpy())
    _equal(dev, tuple(torch.from_numpy(a) if isinstance(a, np.ndarray)
                      else a for a in nat))


def _stream_reads(cuda):
    """Deduplicated reads2 and valid2 of the 30 kbp reads, on the card."""
    rs = prepare_reads(_reads(err=0.002).to(cuda))
    return rs.reads2, rs.valid2


@pytest.mark.parametrize("base,bits,skewed", [(0, 20, False),
                                              (777, 26, False),
                                              (5, 26, True)])
def test_seed_table_kernel(cuda, base, bits, skewed):
    reads2, valid2 = _stream_reads(cuda)
    if skewed:  # one hot bucket: 4,000 copies of one read, 8 entries each
        reads2 = torch.cat([reads2[:1].expand(4000, -1), reads2[1:301]])
        valid2 = torch.ones(reads2.shape[0], dtype=torch.bool, device=cuda)
    words0 = pack_read_words(reads2)
    args = (words0, valid2, 100, 32, 8, bits, base)
    before = kernels.LAUNCHES["seed_table"]
    got = kernels.seed_table(*args)
    assert kernels.LAUNCHES["seed_table"] == before + 2   # keys + table
    _equal(got, plain.seed_table(*args))
    table = got[0]
    assert int(table[:, 1].sum()) == 8 * int(valid2.sum())
    assert not skewed or int(table[:, 1].max()) >= 4000
    # all-invalid reads: every bucket empty, starting at slot 0
    none = kernels.seed_table(words0, torch.zeros_like(valid2), 100, 32, 8,
                              bits, base)
    _equal(none, plain.seed_table(words0, torch.zeros_like(valid2), 100, 32,
                                  8, bits, base))


@pytest.mark.parametrize("i,capacity", [(0, None), (3000, None),
                                        (0, 1000)])
def test_probe_join_kernel(cuda, i, capacity):
    reads2, valid2 = _stream_reads(cuda)
    words0 = pack_read_words(reads2)
    table, slab = kernels.seed_table(words0, valid2, 100, 32, 8, 22, 0)
    chunk = slice(i, i + 4000)
    args = (words0[chunk], valid2[chunk], table, slab, 100, 32, 8, 60, i,
            capacity)
    before = kernels.LAUNCHES["probe_join"]
    got = kernels.probe_join(*args)
    _equal(got, plain.probe_join(*args))
    if capacity is None:
        assert kernels.LAUNCHES["probe_join"] == before + 2
        assert got[0].any() and got[4] == got[0].shape[0] > 0
    else:                                 # overflowed: the count pass only
        assert kernels.LAUNCHES["probe_join"] == before + 1
        assert got[4] > capacity and got[0].shape == (0,)


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_merge_runs_kernel(cuda, weighted, skewed):
    r = _reads().to(cuda)
    keys = kernels.kmer_keys(r, 25)[2].reshape(-1)
    if skewed:  # a run of 2,000,000 equal keys (a k-mer of a repeat)
        keys = torch.cat([keys, torch.full((2_000_000,), int(keys[0]),
                                           dtype=torch.int64, device=cuda)])
    keys = torch.sort(keys).values
    w = (torch.randint(0, 1000, keys.shape, dtype=torch.int32, device=cuda)
         if weighted else None)
    before = kernels.LAUNCHES["merge_runs"]
    got = kernels.merge_runs(keys, w)
    assert kernels.LAUNCHES["merge_runs"] == before + 1
    _equal(got, plain.merge_runs(keys, w))
    if not weighted:
        _equal(got, torch.unique_consecutive(keys, return_counts=True))
        assert not skewed or int(got[1].max()) > 2_000_000


def _merge_keys(layout, rng):
    """Sorted int64 keys laid out against K11's tiles: n of 1, a tile
    less one, a tile, a tile and one, three tiles and one (random runs);
    all keys equal (one run through every tile); all distinct; runs of
    length 1 and 2 across every tile edge."""
    T = kernels.MERGE_TILE
    sizes = {"one": 1, "tile-1": T - 1, "tile": T, "tile+1": T + 1,
             "3tiles+1": 3 * T + 1}
    if layout in sizes:
        n = sizes[layout]
        return np.sort(rng.integers(-2**62, 2**62, max(1, n // 3))[
            rng.integers(0, max(1, n // 3), n)])
    if layout == "equal":
        return np.full(5 * T + 3, -7, np.int64)
    if layout == "distinct":
        return np.sort(rng.choice(2**40, 5 * T + 3, replace=False)) - 2**39
    keys, v = [], 0          # "edges": around every edge e*T, a run of 2
    for e in range(1, 6):    # over it, then runs of 1 on both sides
        while len(keys) < e * T - 2:
            keys.append(v)
            v += 1
        keys += [v, v + 1, v + 1, v + 2]
        v += 3
    return np.array(keys, np.int64)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("layout", ["one", "tile-1", "tile", "tile+1",
                                    "3tiles+1", "equal", "distinct",
                                    "edges"])
def test_merge_runs_kernel_tiles(cuda, layout, weighted):
    rng = np.random.default_rng(9)
    keys = torch.from_numpy(_merge_keys(layout, rng)).to(cuda)
    w = (torch.randint(-1000, 1000, keys.shape, dtype=torch.int32,
                       device=cuda) if weighted else None)
    before = kernels.LAUNCHES["merge_runs"]
    got = kernels.merge_runs(keys, w)
    assert kernels.LAUNCHES["merge_runs"] == before + 1
    _equal(got, plain.merge_runs(keys, w))
    if not weighted:
        _equal(got, torch.unique_consecutive(keys, return_counts=True))


def test_merge_runs_kernel_wraps(cuda):
    """Weighted sums of runs across tiles past 2^31 wrap in int32, as the
    reference's segment_sum."""
    T = kernels.MERGE_TILE
    keys = torch.cat([torch.zeros(3 * T + 1, dtype=torch.int64),
                      torch.arange(1, 100, dtype=torch.int64).repeat_interleave(
                          7)]).to(cuda)
    w = torch.full(keys.shape, 2**30 + 12345, dtype=torch.int32, device=cuda)
    got = kernels.merge_runs(keys, w)
    _equal(got, plain.merge_runs(keys, w))
    runs = torch.unique_consecutive(keys, return_counts=True)[1].cpu()
    want = (runs.to(torch.int64) * (2**30 + 12345) + 2**31) % 2**32 - 2**31
    assert torch.equal(got[1].cpu().to(torch.int64), want)
    assert (want != runs.to(torch.int64) * (2**30 + 12345)).all()


def _dedup_inputs(cuda, case):
    """(reads, lengths) on the card: a case of torch_kernel_cases, or the
    30 kbp reads ("sim"; "sim_ragged" the mixed-length ones) with copies
    and reverse complements of some of them."""
    if case.startswith("sim"):
        r, lens = _ragged() if case == "sim_ragged" else (_reads(), None)
        some = None if lens is None else lens[500:900]
        rc = plain.canonical_reads(r[500:900], some, True)[0]
        r = torch.cat([r, r[:500], rc])
        if lens is not None:
            lens = torch.cat([lens, lens[:500], some])
    else:
        r, lens = dedup_case(case)
        r = torch.from_numpy(r)
        lens = None if lens is None else torch.from_numpy(lens)
    return r.to(cuda), None if lens is None else lens.to(cuda)


@pytest.mark.parametrize("case", DEDUP_CASES + ("sim", "sim_ragged"))
def test_dedup_reads_kernel(cuda, case):
    r, lens = _dedup_inputs(cuda, case)
    k8 = kernels.canonical_reads(r, lens)
    L = r.shape[1]
    lb = 0 if lens is None else L.bit_length()
    before = kernels.LAUNCHES["dedup_reads"]
    got = kernels.dedup_reads(r, lens, *k8)
    assert kernels.LAUNCHES["dedup_reads"] == before + 7 * len(
        bucket_plan.dedup_passes(L, lb)) + 1
    _equal(got[:4], plain.dedup_reads(r, lens, *k8)[:4])
    if lens is not None:
        _equal(got[4:], plain.dedup_reads(r, lens, *k8)[4:])
    assert 0 < got[3] <= r.shape[0]
    # without K8's rows (one pass) and into a view of reads2's first half
    if kernels.dedup_reads_rc(L, lens is not None):
        with pytest.raises(ValueError, match="passes"):
            kernels.dedup_reads(r, lens, None, *k8[1:])
        return
    reads2 = torch.empty((2 * r.shape[0], L), dtype=torch.int32,
                         device=cuda)
    again = kernels.dedup_reads(r, lens, None, *k8[1:],
                                reads2[: r.shape[0]])
    assert again[0].data_ptr() == reads2.data_ptr()
    _equal(again, got)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("seed_len,min_overlap", [(32, 40), (12, 20)])
@pytest.mark.parametrize("sim", [False, True])
def test_seed_rows_kernel(cuda, sim, ragged, seed_len, min_overlap):
    if sim:
        r, lens = _ragged() if ragged else (_reads(), None)
        valid = torch.ones(r.shape[0], dtype=torch.bool)
        valid[::7] = False
    else:
        r, valid, lens = (None if a is None else torch.from_numpy(a)
                          for a in seed_case(ragged))
    r, valid = r.to(cuda), valid.to(cuda)
    lens = None if lens is None else lens.to(cuda)
    s = min(seed_len, min_overlap, 32)
    geo = join_geometry(r.shape[1], min_overlap, s)
    args = (r, valid, lens, s, geo.g, geo.n_pos, geo.trim)
    before = kernels.LAUNCHES["seed_rows"]
    got = kernels.seed_rows(*args)
    # the rows, then the bucketed sort: scan, two scatter passes, the big
    # buckets, the sort
    assert kernels.LAUNCHES["seed_rows"] == before + 6
    _equal(got, plain.seed_rows(*args))
    assert got[0].numel() > 0


def _join_candidates(cuda):
    """(ok, cand_a, cand_b, ovl, M, L) of K3 on the 30 kbp reads."""
    rs = prepare_reads(_reads(err=0.002).to(cuda))
    geo = join_geometry(100, 40, 32)
    s_keys, s_rows, payload = build_seed_rows(rs.reads2, rs.valid2, 32, geo)
    ok, a, b, ovl, _ = kernels.overlap_join(
        s_keys, s_rows, payload.reshape(-1, geo.Wt + 2), geo.R, geo.g,
        geo.trim, 40)
    return ok, a, b, ovl, rs.reads2.shape[0], 100


@pytest.mark.parametrize("case", REDUCE_CASES + ("join", "join_wide"))
def test_longest_edges_kernel(cuda, case):
    if case.startswith("join"):
        ok, a, b, ovl, V, L = _join_candidates(cuda)
        cap = ok.shape[0] + 777
        if case == "join_wide":     # the same pairs at ids near 2^30
            V += 1 << 30
            a, b = a + (1 << 30), b + (1 << 30)
    else:
        ok, a, b, ovl, L, V, cap = reduce_case(case)
        ok, a, b, ovl = (torch.from_numpy(x).to(cuda)
                         for x in (ok, a, b, ovl))
    db, ob = plain.edge_key_bits(V, L)
    wide = 2 * db + ob > 63
    assert wide == case.endswith("wide")
    args = (ok, a, b, ovl, V, L, cap)
    before = kernels.LAUNCHES["longest_edges"]
    got = kernels.longest_edges(*args)
    n_launches = kernels.LAUNCHES["longest_edges"] - before
    # histogram, scan, two scatter passes, the big buckets, the sort
    assert n_launches == 6
    _equal(got, plain.longest_edges(*args))
    if case == "no_ok":
        assert got[3] == 0 and bool((got[0] == 2**31 - 1).all())


# --- K15-K17: the two-phase corrector ----------------------------------------

@pytest.mark.parametrize("threshold", [1, 2, 3, 10**6])
@pytest.mark.parametrize("ragged", [False, True])
def test_prune_table_kernel(cuda, ragged, threshold):
    r, lens = _ragged() if ragged else (_reads(), None)
    t = count_kmers(r.to(cuda), 25, None if lens is None else lens.to(cuda))
    before = kernels.LAUNCHES["prune_table"]
    got = kernels.prune_table(t.keys, t.count, threshold)
    assert kernels.LAUNCHES["prune_table"] == before + 1   # one launch
    _equal(got, plain.prune_table(t.keys, t.count, threshold))
    assert got[0].numel() == int((t.count >= threshold).sum())
    empty = t.keys[:0], t.count[:0]
    _equal(kernels.prune_table(*empty, threshold), empty)


@pytest.mark.parametrize("keep", PRUNE_KEEPS)
@pytest.mark.parametrize("size", PRUNE_SIZES + ("many",))
def test_prune_table_kernel_tiles(cuda, size, keep):
    """K15 around its tiles (their size read from the kernel's library):
    one entry, a tile less one, a tile, a tile and one, many tiles (the
    look-back's chain); every entry kept, none, a few in the last tile
    alone; and the same table as views one entry in, whose loads are not
    16-byte aligned (the scalar path)."""
    tile = kernels.prune_tile()
    T = prune_size(size, tile)
    keys, counts = (torch.from_numpy(a)
                    for a in prune_case(T, keep, tile, T))
    for off in (0, 1):
        if T - off < 1:
            continue
        k, c = keys[off:], counts[off:]
        before = kernels.LAUNCHES["prune_table"]
        got = kernels.prune_table(keys.to(cuda)[off:], counts.to(cuda)[off:],
                                  2)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["prune_table"] == before + 1
        _equal(got, plain.prune_table(k, c, 2))


def _phase_inputs(cuda, case, k):
    if case in ("sim", "sim_ragged"):
        r, lens = _ragged() if case == "sim_ragged" else (_reads(), None)
        r = r.to(cuda)
        lens = None if lens is None else lens.to(cuda)
        t = prune_table_for_correction(count_kmers(r, k, lens), 2)
        return r, lens, t.keys, t.count, k, 2
    reads, lengths, keys, counts, k, threshold, _ = vote_case(case, k=k)
    return (torch.from_numpy(reads).to(cuda),
            None if lengths is None else torch.from_numpy(lengths).to(cuda),
            torch.from_numpy(keys).to(cuda),
            torch.from_numpy(counts).to(cuda), k, threshold)


@pytest.mark.parametrize("k", [15, 25])
@pytest.mark.parametrize("case", VOTE_CASES + ("sim", "sim_ragged"))
def test_weak_and_fix_windows_kernels(cuda, case, k):
    r, lens, keys, counts, k, threshold = _phase_inputs(cuda, case, k)
    before = dict(kernels.LAUNCHES)
    directory = kernels.table_directory(keys, counts)
    widx = kernels.weak_windows(r, lens, keys, counts, directory, k,
                                threshold)
    _equal([widx], [plain.weak_windows(r, lens, keys, counts, None, k,
                                       threshold)])
    assert (widx.numel() == 0) == (case == "clean")
    for which in ("last", "first"):
        got = kernels.fix_windows(r, widx, keys, counts, directory, k,
                                  threshold, which)
        _equal([got], [plain.fix_windows(r, widx, keys, counts, None, k,
                                         threshold, which)])
    assert kernels.LAUNCHES["lookup_counts"] == before["lookup_counts"] + 1
    assert kernels.LAUNCHES["weak_windows"] == before["weak_windows"] + 2
    assert kernels.LAUNCHES["fix_windows"] == before["fix_windows"] + (
        4 if widx.numel() else 0)
    # on the card each needs the round's directory
    with pytest.raises(ValueError, match="bucket directory"):
        kernels.weak_windows(r, lens, keys, counts, None, k, threshold)
    if widx.numel():
        with pytest.raises(ValueError, match="bucket directory"):
            kernels.fix_windows(r, widx, keys, counts, None, k, threshold,
                                "last")


@pytest.mark.parametrize("ragged", [False, True])
def test_twophase_round_kernels(cuda, ragged):
    r, lens = _ragged() if ragged else (_reads(), None)
    t = prune_table_for_correction(count_kmers(r, 25, lens), 2)
    want = twophase_round(r, t, 25, 2, lens)
    rc, lc = r.to(cuda), None if lens is None else lens.to(cuda)
    tc = prune_table_for_correction(count_kmers(rc, 25, lc), 2)
    got = twophase_round(rc, tc, 25, 2, lc)
    _equal([got], [want])
    assert (got.cpu() != r).any()


def test_fix_windows_kernel_long_reads(cuda):
    g = simulate_genome(20_000, seed=3)
    r, _ = simulate_reads(g, read_len=300, coverage=20, error_rate=0.01,
                          seed=4)
    r = torch.from_numpy(r.astype(np.int32)).to(cuda)
    t = prune_table_for_correction(count_kmers(r, 31), 2)
    directory = kernels.table_directory(t.keys, t.count)
    widx = kernels.weak_windows(r, None, t.keys, t.count, directory, 31, 2)
    _equal([widx], [plain.weak_windows(r, None, t.keys, t.count, None, 31,
                                       2)])
    _equal([kernels.fix_windows(r, widx, t.keys, t.count, directory, 31, 2,
                                "first")],
           [plain.fix_windows(r, widx, t.keys, t.count, None, 31, 2,
                              "first")])


def _fix_inputs(cuda, case):
    """(reads, keys, counts, k, threshold) on the card for K17's cases."""
    if case == "ties":
        reads, _, keys, counts, k, threshold = tied_variants_case(15)
    else:
        reads, _, keys, counts, k, threshold, _ = vote_case("errors", k=15)
    return (torch.from_numpy(reads).to(cuda), torch.from_numpy(keys).to(cuda),
            torch.from_numpy(counts).to(cuda), k, threshold)


@pytest.mark.parametrize("case", ["non_weak", "threshold0", "threshold1",
                                  "no_membership", "ties", "ties_directory"])
def test_fix_windows_kernel_cases(cuda, case):
    """K17 equal to plain.fix_windows, both sub-passes: at windows that
    are not weak as well (every third window with K16's); at thresholds 0
    (no membership table: K2's directory for every variant) and 1; with a
    directory that holds no membership table; at weak windows with two or
    three solid variants, tied and not, through the membership table and
    through K2's directory alone. Two launches a call."""
    r, keys, counts, k, threshold = _fix_inputs(cuda, case)
    if case.startswith("threshold"):
        threshold = int(case[-1])
    if case in ("no_membership", "ties_directory"):
        directory = kernels.lookup_directory(keys, counts)
    else:
        directory = kernels.table_directory(keys, counts, k, threshold)
    at = kernels.solid_offset(keys.numel())
    assert (directory.numel() > at) == (case not in (
        "no_membership", "ties_directory", "threshold0"))
    N, L = r.shape
    P = L - k + 1
    widx = plain.weak_windows(r, None, keys, counts, None, k, threshold)
    if case in ("non_weak", "threshold0", "threshold1"):
        widx = torch.unique(torch.cat([widx, torch.arange(
            0, N * P, 3, device=cuda)]))
    assert widx.numel() > 0
    for which in ("last", "first"):
        before = kernels.LAUNCHES["fix_windows"]
        got = kernels.fix_windows(r, widx, keys, counts, directory, k,
                                  threshold, which)
        assert kernels.LAUNCHES["fix_windows"] == before + 2
        want = plain.fix_windows(r, widx, keys, counts, None, k, threshold,
                                 which)
        _equal([got], [want])
        if case.startswith("ties") and which == "last":
            assert (want != r).any()


@pytest.mark.parametrize("case", VOTE_CASES + ("ties",))
def test_fix_windows_kernel_at_weak_windows(cuda, case):
    """K17 at K16's weak windows (the pipeline's calls: the current
    base's variant probed only beside a solid one) equal to
    plain.fix_windows at k = 15, both sub-passes, through the membership
    table where the case has one."""
    if case == "ties":
        reads, lengths, keys, counts, k, threshold = tied_variants_case(15)
    else:
        reads, lengths, keys, counts, k, threshold, _ = vote_case(
            case, k=31 if case == "k31" else 15)
    r, t_keys, t_counts = (torch.from_numpy(x).to(cuda)
                           for x in (reads, keys, counts))
    lens = None if lengths is None else torch.from_numpy(lengths).to(cuda)
    directory = kernels.table_directory(t_keys, t_counts, k, threshold)
    widx = kernels.weak_windows(r, lens, t_keys, t_counts, directory, k,
                                threshold)
    for which in ("last", "first"):
        _equal([kernels.fix_windows(r, widx, t_keys, t_counts, directory, k,
                                    threshold, which)],
               [plain.fix_windows(r, widx, t_keys, t_counts, None, k,
                                  threshold, which)])


def test_fix_windows_kernel_overflow_bucket(cuda):
    """K17 where a variant's key lies in an overfull bucket of the
    membership table (seven in its sector, the rest in its list): reads
    whose windows end in each of the bucket's keys, solid or filtered
    out, their last bases changed so that the variants probe the bucket."""
    k = 11
    keys, counts, crowd = crowded_bucket_table(k, 5, 24)
    rng = np.random.default_rng(6)
    reads = rng.integers(0, 4, (2 * len(crowd) + 8, 40)).astype(np.int32)
    for i, x in enumerate(crowd.tolist()):
        reads[i, 10:10 + k] = kmer_codes(x, k)
        reads[len(crowd) + i, 10:10 + k] = kmer_codes(x, k)
        reads[len(crowd) + i, 10 + k - 1] = (reads[i, 10 + k - 1] + 1) % 4
    r, t_keys, t_counts = (torch.from_numpy(x).to(cuda)
                           for x in (reads, keys, counts))
    directory = kernels.table_directory(t_keys, t_counts, k, 2)
    P = 40 - k + 1
    widx = torch.arange(0, r.shape[0] * P, device=cuda)
    for which in ("last", "first"):
        _equal([kernels.fix_windows(r, widx, t_keys, t_counts, directory, k,
                                    2, which)],
               [plain.fix_windows(r, widx, t_keys, t_counts, None, k, 2,
                                  which)])


def test_fix_windows_kernel_longer_reads(cuda):
    """K17 on reads of 1,000 bases (tiles of a few reads) and of 37 (rows
    of no whole 16-byte words), both sub-passes; on reads of 50,000 (a
    read a tile, past 48 KB of shared memory); reads past a block's
    shared memory (60,000 bases) raise ValueError."""
    rng = np.random.default_rng(10)
    s = rng.integers(0, 4, 50_000).astype(np.int32)
    bad = s.copy()
    bad[rng.choice(50_000, 40, replace=False)] ^= 1
    r = torch.from_numpy(np.stack([s, s, bad]))
    t = prune_table_for_correction(count_kmers(r, 21), 2)
    widx = plain.weak_windows(r, None, t.keys, t.count, None, 21, 2)
    r, widx, keys, counts = (x.to(cuda) for x in (r, widx, t.keys, t.count))
    directory = kernels.table_directory(keys, counts, 21, 2)
    assert widx.numel() > 0
    for which in ("last", "first"):
        got = kernels.fix_windows(r, widx, keys, counts, directory, 21, 2,
                                  which)
        _equal([got], [plain.fix_windows(r, widx, keys, counts, None, 21, 2,
                                         which)])
        assert (got != r).any()
    long = torch.zeros((1, 60_000), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fix_windows(long, torch.arange(3, device=cuda), keys, counts,
                            directory, 21, 2, "last")
    for L, n, seed in ((1000, 60, 8), (37, 3000, 9)):
        g = simulate_genome(6_000, seed=seed)
        r, _ = simulate_reads(g, read_len=L, coverage=n * L / 6_000,
                              error_rate=0.02, seed=seed + 1)
        r = torch.from_numpy(r.astype(np.int32)).to(cuda)
        t = prune_table_for_correction(count_kmers(r, 21), 2)
        directory = kernels.table_directory(t.keys, t.count, 21, 2)
        widx = kernels.weak_windows(r, None, t.keys, t.count, directory, 21,
                                    2)
        assert widx.numel() > 0
        for which in ("last", "first"):
            _equal([kernels.fix_windows(r, widx, t.keys, t.count, directory,
                                        21, 2, which)],
                   [plain.fix_windows(r, widx, t.keys, t.count, None, 21, 2,
                                      which)])


@pytest.mark.parametrize("ragged", [False, True])
def test_dedup_reads_kernel_big_run(cuda, ragged):
    """K12 with a run of equal leading 64-bit words past a block (6,000
    reads led by the same 32 bases, of one length; 2,048 elements a
    block): its bucket sorted by the whole grid, with copies inside the
    run and beside it; equal to plain.dedup_reads."""
    rng = np.random.default_rng(11)
    N, L = 20_000, 150 if ragged else 100
    reads = rng.integers(0, 4, (N, L)).astype(np.int32)
    reads[:6000, :32] = 0
    reads[6000:6600] = reads[:600]
    reads[7000:7100] = reads[8000:8100]
    lens = None
    if ragged:
        lens = rng.integers(75, L + 1, N).astype(np.int32)
        lens[:6600] = L
        lens[7000:7100] = lens[8000:8100]
        reads[np.arange(L)[None, :] >= lens[:, None]] = 0
    r = torch.from_numpy(reads).to(cuda)
    ln = None if lens is None else torch.from_numpy(lens).to(cuda)
    k8 = kernels.canonical_reads(r, ln)
    lead = torch.where(k8[3][:, None], k8[2][:, :2], k8[1][:, :2])
    assert int(torch.unique(lead, dim=0, return_counts=True)[1].max()) > \
        bucket_plan.BLOCK
    got = kernels.dedup_reads(r, ln, *k8)
    want = plain.dedup_reads(r, ln, *k8)
    _equal(got[:4], want[:4])
    if ragged:
        _equal(got[4:], want[4:])
    assert got[3] < N


# --- K18: chain links and the cycle cut -------------------------------------

@pytest.mark.parametrize("case", CHAIN_CASES)
def test_chain_links_kernel(cuda, case):
    *arrays, V = chain_case(case)
    src, dst, ovl = (torch.from_numpy(a) for a in arrays)
    gpu = [a.to(cuda) for a in (src, dst, ovl)]
    before = kernels.LAUNCHES["chain_links"]
    links = kernels.chain_links(*gpu, V)
    _equal(links, plain.chain_links(src, dst, ovl, V))
    outdeg, indeg, nxt, ovl_next, p = links
    steps = max(1, int(np.ceil(np.log2(max(V, 2)))) + 1)
    ids = torch.arange(V, dtype=torch.int32, device=cuda)
    pf, _ = kernels.pointer_jump(p, None, "none", steps)
    _, m = kernels.pointer_jump(p, ids, "min", steps)
    n2, o2 = nxt.clone(), ovl_next.clone()
    got = kernels.chain_cut(p, pf, m, nxt, ovl_next)
    want = plain.chain_cut(p, pf, m, n2, o2)
    _equal(got + (nxt, ovl_next), want + (n2, o2))
    # links: two passes over the rows where there are rows, two over the
    # vertices; the cut
    assert kernels.LAUNCHES["chain_links"] == before + (
        (5 if src.numel() else 3) if V else 0)
    if case == "rings":
        assert int((got[0] == ids).sum()) > int((p == ids).sum())
    _equal(contract_unitigs(*gpu, V), contract_unitigs(src, dst, ovl, V))


# --- K13 and K3 in the streamed join's mode ---------------------------------

@pytest.mark.parametrize("chunk", [1000, 2500])
def test_streamed_join_kernels(cuda, chunk):
    """K13's entry slab and query chunks and K3's two-segment payload
    against their plain versions, and the streamed ragged join's edges
    and containment marks against the in-core join's."""
    r, lens = _ragged()
    rs = prepare_reads(r.to(cuda), lens.to(cuda))
    M, L = rs.reads2.shape
    s, min_overlap = 32, 40
    geo = join_geometry(L, min_overlap, s)
    valid, lengths = rs.valid2, rs.lengths2
    keys, ids, pays = [], [], []
    for i in range(0, M, chunk):
        args = (rs.reads2[i : i + chunk], valid[i : i + chunk],
                lengths[i : i + chunk], s, geo.g, geo.n_pos, geo.trim, i,
                "entries")
        before = kernels.LAUNCHES["seed_rows"]
        got = kernels.seed_rows(*args)
        assert kernels.LAUNCHES["seed_rows"] == before + 2  # rows, compact
        _equal(got, plain.seed_rows(*args))
        keys.append(got[0])
        ids.append(got[1])
        pays.append(got[2].reshape(-1, geo.Wt + 2))
    slab = torch.cat(keys), torch.cat(ids), torch.cat(pays)
    i = chunk
    args = (rs.reads2[i : i + chunk], valid[i : i + chunk],
            lengths[i : i + chunk], s, geo.g, geo.n_pos, geo.trim, i,
            "queries", slab[0], slab[1])
    rows = kernels.seed_rows(*args)
    _equal(rows, plain.seed_rows(*args))
    cont = [torch.zeros(M, dtype=torch.uint8, device=cuda) for _ in range(2)]
    join = (rows[0], rows[1], rows[2].reshape(-1, geo.Wt + 2), geo.R, geo.g,
            geo.trim, min_overlap)
    got = kernels.overlap_join(*join, cont[0], None, slab[2], 0, i)
    _equal(got, plain.overlap_join(*join, cont[1], None, slab[2], 0, i))
    assert got[4] > 0 and torch.equal(cont[0], cont[1])

    incore = find_overlaps(rs.reads2, valid, min_overlap, s, 1 << 22,
                           lengths=lengths)
    v2, l2 = valid.cpu().numpy(), lengths.cpu().numpy()
    r2 = rs.reads2.cpu().numpy().astype(np.int8)
    for block in (None, 3000):
        e_src, e_dst, e_ovl, n, cont_s, overflow = (
            stream.find_overlaps_chunked_ragged(
                r2, v2, l2, min_overlap, chunk, s, 1 << 22,
                entry_block_reads=block, device=cuda))
        assert not overflow and n == incore.n_edges
        for a, b in ((e_src, incore.src), (e_dst, incore.dst),
                     (e_ovl, incore.ovl)):
            np.testing.assert_array_equal(a, b[:n].cpu().numpy())
        np.testing.assert_array_equal(cont_s, incore.contained.cpu().numpy())


def test_wrapper_raises_when_its_build_fails(cuda, monkeypatch):
    """A wrapper given CUDA tensors launches its kernel or raises: with no
    library and a build that fails it raises, and nothing falls back to
    its plain version."""
    keys = torch.arange(10, dtype=torch.int64, device=cuda)
    counts = torch.ones(10, dtype=torch.int32, device=cuda)

    def fail(specs, *a, **kw):
        raise native_build.BuildError("nvcc failed")

    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(native_build, "build_all", fail)
    with pytest.raises(native_build.BuildError):
        kernels.prune_table(keys, counts, 2)
    src = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(native_build.BuildError):
        kernels.chain_links(src, src, src, 2)


# --- the stacked path: K13 and K3 at a fixed capacity, K14 deferred ----------

def _stacked_rows_inputs(cuda, case):
    """(reads2, valid2, s, geo, min_overlap) of a fixed-capacity K13/K3
    case: seed_case's (a poly-T read among two invalid ones, whose dead
    rows share its INT64_MAX key), or simulated reads with every 7th
    invalid."""
    if case == "sim":
        r = _reads()
        valid = torch.ones(r.shape[0], dtype=torch.bool)
        valid[::7] = False
    else:
        r, valid, _ = (None if a is None else torch.from_numpy(a)
                       for a in seed_case(False))
    s = 32
    geo = join_geometry(r.shape[1], 40, s)
    return r.to(cuda), valid.to(cuda), s, geo, 40


@pytest.mark.parametrize("case", ["seed_case", "sim"])
def test_seed_rows_stacked_kernel(cuda, case):
    r, valid, s, geo, _ = _stacked_rows_inputs(cuda, case)
    args = (r, valid, s, geo.g, geo.n_pos, geo.trim)
    before = kernels.LAUNCHES["seed_rows"]
    got = kernels.seed_rows_stacked(*args)
    assert kernels.LAUNCHES["seed_rows"] == before + 6
    _equal(got, plain.seed_rows_stacked(*args))
    n = int(got[3])
    assert 0 < n < got[0].numel()
    if case == "seed_case":     # a live all-T row before the dead rows
        assert bool((got[0][:n] == plain.I64_MAX).any())


@pytest.mark.parametrize("capacity", ["below", "equal", "above"])
@pytest.mark.parametrize("case", ["seed_case", "sim"])
def test_overlap_join_stacked_kernel(cuda, case, capacity):
    r, valid, s, geo, min_overlap = _stacked_rows_inputs(cuda, case)
    keys, rows, payload, n_live = kernels.seed_rows_stacked(
        r, valid, s, geo.g, geo.n_pos, geo.trim)
    flat = payload.reshape(-1, geo.Wt + 2)
    total = plain.overlap_join_stacked(keys, rows, flat, n_live, geo.R,
                                       geo.g, geo.trim, min_overlap, 1)[4]
    C = {"below": int(total) // 2, "equal": int(total),
         "above": int(total) + 999}[capacity]
    args = (keys, rows, flat, n_live, geo.R, geo.g, geo.trim, min_overlap,
            C)
    before = kernels.LAUNCHES["overlap_join"]
    got = kernels.overlap_join_stacked(*args)
    assert kernels.LAUNCHES["overlap_join"] == before + 2
    _equal(got, plain.overlap_join_stacked(*args))
    assert got[4].device.type == cuda.type and int(got[4]) == int(total) > 0


@pytest.mark.parametrize("case", REDUCE_CASES + ("join", "join_dups",
                                                 "join_wide"))
def test_longest_edges_deferred_kernel(cuda, case):
    if case.startswith("join"):
        ok, a, b, ovl, V, L = _join_candidates(cuda)
        cap = ok.shape[0] + 777
        if case == "join_dups":     # 1% of the ok rows again, shorter
            pick = torch.nonzero(ok).flatten()[::100]
            ok, a, b = (torch.cat([x, x[pick]]) for x in (ok, a, b))
            ovl = torch.cat([ovl, ovl[pick] - 1])
            cap = ok.shape[0]
        if case == "join_wide":     # the same pairs at ids near 2^30
            V += 1 << 30
            a, b = a + (1 << 30), b + (1 << 30)
    else:
        ok, a, b, ovl, L, V, cap = reduce_case(case)
        ok, a, b, ovl = (torch.from_numpy(x).to(cuda)
                         for x in (ok, a, b, ovl))
    db, ob = plain.edge_key_bits(V, L)
    wide = 2 * db + ob > 63
    assert wide == case.endswith("wide")
    args = (ok, a, b, ovl, V, L, cap)
    before = kernels.LAUNCHES["longest_edges"]
    got = kernels.longest_edges_deferred(*args)
    assert kernels.LAUNCHES["longest_edges"] - before == 6
    _equal(got, plain.longest_edges_deferred(*args))
    assert got[3].device.type == got[4].device.type == cuda.type
    if case in ("periodic", "join_dups"):
        assert int(got[4]) > 0
    assert int(got[3]) + int(got[4]) == int(ok.sum())
    # the keepers are longest_edges' edges
    want = kernels.longest_edges(*args)
    assert int(got[3]) == want[3]
    out = tuple(torch.empty(cap, dtype=torch.int32, device=cuda)
                for _ in range(3))
    again = kernels.longest_edges_deferred(*args, out=out)
    assert all(x is y for x, y in zip(again[:3], out))
    _equal(again, got)


def test_reduce_fused_deferred_fallback_is_sync_free(cuda):
    """Where the reference's packing does not fit (ids near 2^30 at read
    length 100), the deferred reduction returns longest_edges' compacted
    list with n_dups 0, its counts on the card and nothing read to the
    host."""
    from sage2_tpu_torch.overlap.detect import _reduce_fused

    ok, a, b, ovl, V, L = _join_candidates(cuda)
    V += 1 << 30
    a, b = a + (1 << 30), b + (1 << 30)
    cap = ok.shape[0] + 777
    assert V >= 1 << (31 - L.bit_length())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _reduce_fused(ok, a, b, ovl, L, cap, V, defer_dup_compact=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = kernels.longest_edges(ok, a, b, ovl, V, L, cap)
    _equal(got[:3], want[:3])
    assert got[3].device.type == cuda.type and int(got[3]) == want[3]
    assert int(got[4]) == 0


# --- K13 and K14's bucketed sort: skew and odd sizes -------------------------

def _skew_reads(cuda, case):
    """(reads2, valid2, lengths) for K13's bucketed sort: "one_key" most
    reads poly-A (24,000 live rows of one key: one bucket past a block's
    2,048), "all_t" most reads poly-T beside invalid reads (live rows of
    key INT64_MAX before the stacked mode's dead rows), "many_keys" four
    big buckets of different sizes (poly-A, -C, -G and -T reads: 9,600,
    4,800, 2,400 and 2,064 live rows, the last one row past a block's
    2,048 with the ragged lengths' dead rows aside), "one" a single read,
    "odd" 1,237 reads (no tile's multiple)."""
    rng = np.random.default_rng(21)
    M = {"one_key": 1500, "all_t": 900, "many_keys": 1400, "one": 1,
         "odd": 1237}[case]
    L = 100
    r = rng.integers(0, 4, (M, L)).astype(np.int32)
    valid = np.ones(M, bool)
    if case == "one_key":
        r[: M - 50] = 0
    if case == "all_t":
        r[: M // 2] = 3
        valid[M // 3 : 2 * M // 3] = False
    if case == "many_keys":
        r[:600], r[600:900], r[900:1050], r[1050:1179] = 0, 1, 2, 3
    if case == "odd":
        valid[::11] = False
    lens = rng.integers(60, L + 1, M).astype(np.int32)
    return (torch.from_numpy(r).to(cuda), torch.from_numpy(valid).to(cuda),
            torch.from_numpy(lens).to(cuda))


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("case", ["one_key", "all_t", "many_keys", "one",
                                  "odd"])
def test_seed_rows_kernel_skew(cuda, case, ragged):
    r, valid, lens = _skew_reads(cuda, case)
    geo = join_geometry(100, 40, 32)
    args = (r, valid, lens if ragged else None, 32, geo.g, geo.n_pos,
            geo.trim)
    before = kernels.LAUNCHES["seed_rows"]
    got = kernels.seed_rows(*args)
    assert kernels.LAUNCHES["seed_rows"] == before + 6
    _equal(got, plain.seed_rows(*args))
    # a query chunk sorted with a slab of the first half's entry rows
    h = r.shape[0] // 2
    e = (r[:h], valid[:h], lens[:h] if ragged else None, *args[3:], 0,
         "entries")
    slab = kernels.seed_rows(*e)
    _equal(slab, plain.seed_rows(*e))
    q = (r[h:], valid[h:], lens[h:] if ragged else None, *args[3:], h,
         "queries", slab[0], slab[1])
    _equal(kernels.seed_rows(*q), plain.seed_rows(*q))
    if not ragged:
        st = (r, valid, 32, geo.g, geo.n_pos, geo.trim)
        before = kernels.LAUNCHES["seed_rows"]
        got = kernels.seed_rows_stacked(*st)
        assert kernels.LAUNCHES["seed_rows"] == before + 6
        _equal(got, plain.seed_rows_stacked(*st))
        if case == "all_t":     # live all-T rows, then the dead rows
            n = int(got[3])
            assert bool((got[0][:n] == plain.I64_MAX).any())
            assert bool((got[1][n:] == -1).all()) and n < got[0].numel()


def _skew_edges(cuda, case):
    """(ok, a, b, ovl, V, L, cap) for K14's bucketed sort: "hub" one src
    in most ok rows (a bucket past a block), "hub_wide" the same at ids
    near 2^30, "hubs" four hubs of 20,000, 5,000, 2,049 and 2,048 ok
    rows (the last two in one bucket: big buckets of different sizes),
    "shard" a
    mesh shard's candidates, sources in [1250, 2500) of 5,000 with a hub,
    bucketed over that range, "none_ok" 100,000 candidates and none ok,
    "one" a single candidate, "odd" 13,525 candidates (no tile's
    multiple) with duplicate pairs. Returns the arguments and the
    sources' range (None: all ids)."""
    rng = np.random.default_rng(22)
    n = {"hub": 60_000, "hub_wide": 60_000, "hubs": 60_000, "shard": 60_000,
         "none_ok": 100_000, "one": 1, "odd": 13_525}[case]
    V, L = 5000, 100
    a = rng.integers(0, V, n)
    b = rng.integers(0, V, n)
    ovl = rng.integers(40, L, n)
    ok = rng.random(n) < 0.65
    if case in ("hub", "hub_wide"):
        a[: 50_000] = 7
    if case == "hubs":
        ok[:29_097] = True
        a[:20_000], a[20_000:25_000] = 7, 4000
        a[25_000:27_049], a[27_049:29_097] = 2500, 2501
        a[29_097:] = np.where(np.isin(a[29_097:], [7, 4000, 2500, 2501]),
                              8, a[29_097:])
    if case == "shard":
        a = 1250 + a % 1250
        a[:10_000] = 1300
    if case == "none_ok":
        ok[:] = False
    if case == "one":
        ok[:] = True
    if case == "odd":
        a[: 3000], b[: 3000] = a[3000:6000], b[3000:6000]
    if case == "hub_wide":
        V += 1 << 30
        a, b = a + (1 << 30), b + (1 << 30)
    t = [torch.from_numpy(x).to(cuda) for x in (
        ok, a.astype(np.int32), b.astype(np.int32), ovl.astype(np.int32))]
    return (*t, V, L, n + 99), ((1250, 2500) if case == "shard" else None)


@pytest.mark.parametrize("case", ["hub", "hub_wide", "hubs", "shard",
                                  "none_ok", "one", "odd"])
def test_longest_edges_kernel_skew(cuda, case):
    args, sources = _skew_edges(cuda, case)
    before = kernels.LAUNCHES["longest_edges"]
    got = kernels.longest_edges(*args, sources=sources)
    assert kernels.LAUNCHES["longest_edges"] == before + 6
    _equal(got, plain.longest_edges(*args))
    got = kernels.longest_edges_deferred(*args)
    _equal(got, plain.longest_edges_deferred(*args))
    if case == "none_ok":
        assert int(got[3]) == 0 and bool((got[0] == 2**31 - 1).all())


def _stacked_shards(cuda, K=3, n=20_000):
    reads = []
    for k in range(K):
        g = simulate_genome(n * 100 // 45, seed=7 + 1000 * k)
        r, _ = simulate_reads(g, read_len=100, coverage=45,
                              error_rate=0.005, seed=8 + 1000 * k)
        reads.append(r[:n].astype(np.int32))
    reads3 = torch.from_numpy(np.stack(reads)).to(cuda)
    valid3 = torch.ones(reads3.shape[:2], dtype=torch.bool, device=cuda)
    valid3[1, ::5] = False
    return reads3, valid3


def test_find_overlaps_stacked_is_sync_free(cuda):
    """No host synchronisation from the first launch to the return
    (set_sync_debug_mode("error") raises on one), every shard's row
    equal to find_overlaps on the card at that capacity and to the
    plain versions on the CPU."""
    reads3, valid3 = _stacked_shards(cuda)
    cap = 1 << 20
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = find_overlaps_stacked(reads3, valid3, 40, capacity=cap,
                                    device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cpu = find_overlaps_stacked(reads3.cpu(), valid3.cpu(), 40, capacity=cap,
                                device="cpu")
    _equal(out, cpu)
    assert not bool(out[6].any()) and not bool(out[7].any())
    for k in range(reads3.shape[0]):
        res = find_overlaps(reads3[k], valid3[k], 40, capacity=cap,
                            defer_dup_compact=True)
        for i, name in enumerate(("src", "dst", "ovl", "n_edges",
                                  "n_candidates", "n_verified", "overflow",
                                  "n_dups")):
            want = getattr(res, name)
            if isinstance(want, torch.Tensor):
                assert torch.equal(out[i][k], want)
            else:
                assert out[i][k].item() == want
    src, dst, ovl = compact_stacked_result(out, 100)
    assert np.array_equal(src, out[0].cpu().numpy())


def test_find_overlaps_stacked_periodic_duplicates(cuda):
    """Poly-T reads verify pairs at several lengths: their duplicate rows
    stay, counted in n_dups, on the card as in the plain versions."""
    r, valid, _ = seed_case(False)
    r[5:] = 3
    reads3 = torch.from_numpy(np.stack([r, r])).to(cuda)
    valid3 = torch.from_numpy(np.stack([valid, np.ones_like(valid)])).to(
        cuda)
    out = find_overlaps_stacked(reads3, valid3, 30, capacity=4096,
                                device=cuda)
    cpu = find_overlaps_stacked(reads3.cpu(), valid3.cpu(), 30,
                                capacity=4096, device="cpu")
    _equal(out, cpu)
    assert bool((out[7] > 0).all())


# --- the device mesh: K19-K22 and K3's payload permutation ----------------


def _route_equal(a, b):
    for name in ("send", "dest", "rank", "sent_ok", "offsets"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x.cpu(), y.cpu()), name
    assert a.counts == b.counts and a.overflow == b.overflow


def _route_case(n, Q, K, seed, hot=False):
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, n, size=Q).astype(np.int32)
    if hot and n > 1:
        owner[: Q // 2] = n - 1
        owner[owner == 0] = 1       # owner 0 gets no rows
    valid = rng.random(Q) < 0.9
    rows = rng.integers(-2**31, 2**31, size=(Q, K)).astype(np.int32)
    return (torch.from_numpy(rows), torch.from_numpy(owner),
            torch.from_numpy(valid))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("Q,K", [(0, 1), (1, 2), (1023, 3), (5000, 9)])
def test_route_rows_kernel(cuda, n, Q, K):
    rows, owner, valid = _route_case(n, Q, K, seed=n * 31 + Q)
    want = plain.route_rows(rows, n, Q + 1, owner=owner, valid=valid)
    got = kernels.route_rows(rows.to(cuda), n, Q + 1, owner=owner.to(cuda),
                             valid=valid.to(cuda))
    _route_equal(got, want)
    assert not got.overflow


@pytest.mark.parametrize("n", [1, 4, 8])
def test_route_rows_kernel_caps(cuda, n):
    """Capacities at the busiest owner's count, one below and one above
    it (ranks cap - 1 and cap), an owner with no rows, no valid mask."""
    rows, owner, _ = _route_case(n, 3000, 3, seed=n, hot=True)
    busiest = int(torch.bincount(owner.long(), minlength=n).max())
    for cap in (busiest - 1, busiest, busiest + 1, 1):
        want = plain.route_rows(rows, n, cap, owner=owner)
        got = kernels.route_rows(rows.to(cuda), n, cap, owner=owner.to(cuda))
        _route_equal(got, want)
        assert got.overflow == (cap < busiest)
        if n > 1:
            assert got.counts[0] == 0


def test_route_rows_kernel_cap_past_int32(cuda):
    """A capacity of 2^31 or more (the correction's 4 N P / n at tens of
    millions of reads) routes every row, as the plain version does: the
    launch's int32 cap must not wrap."""
    rows, owner, valid = _route_case(4, 3000, 3, seed=11, hot=True)
    for cap in (2**31 - 1, 2**31 + 5, 2**32 + 1):
        want = plain.route_rows(rows, 4, cap, owner=owner, valid=valid)
        got = kernels.route_rows(rows.to(cuda), 4, cap, owner=owner.to(cuda),
                                 valid=valid.to(cuda))
        _route_equal(got, want)
        assert not got.overflow and sum(got.counts) == int(valid.sum())


@pytest.mark.parametrize("answers", [True, False])
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_route_rows_kernel_hash(cuda, n, flip, same, answers):
    """Owners from the hash of int64 keys (k-mer keys, or 32-base seed
    keys with their top bit flipped), at keys near the extremes; the rows
    the keys themselves (the scatter hashes the rows it holds) or a copy
    of them; both modes."""
    rng = np.random.default_rng(n)
    keys = rng.integers(-2**63, 2**63 - 1, size=4100, dtype=np.int64)
    keys[:4] = [-2**63, 2**63 - 1, 0, -1]
    keys = torch.from_numpy(keys)
    valid = torch.from_numpy(rng.random(4100) < 0.7)
    rows = keys.view(torch.int32).reshape(-1, 2)
    want = plain.route_rows(rows, n, 700, None, keys, flip, valid, answers)
    gkeys = keys.to(cuda)
    grows = gkeys.view(torch.int32).reshape(-1, 2) if same else rows.to(cuda)
    got = kernels.route_rows(grows, n, 700, None, gkeys, flip,
                             valid.to(cuda), answers)
    _route_equal(got, want)


T = kernels.ROUTE_TILE
# (Q, n, K, owners, cap): K19 at one tile and one row either side of it,
# several thousand tiles, every row to one owner, every row invalid, and
# caps that cut inside a tile and across tiles (None: no cut)
ROUTE_MODE_CASES = [
    (0, 4, 3, "uniform", None), (1, 1, 1, "uniform", None),
    (1, 8, 2, "uniform", None), (T - 1, 3, 3, "uniform", None),
    (T, 5, 4, "uniform", None), (T + 1, 8, 9, "uniform", None),
    (5000 * T + 17, 4, 3, "uniform", None), (3 * T + 5, 6, 12, "one", None),
    (3 * T + 5, 2, 1, "invalid", None), (4 * T, 7, 3, "hot", T // 3),
    (4 * T, 4, 2, "hot", 2 * T + 100), (2 * T + 3, 8, 12, "hot", T + 1),
    (3 * T + 7, 5, 5, "uniform", None), (4 * T + 1, 6, 6, "hot", T + 9),
]


@pytest.mark.parametrize("Q,n,K,owners,cap", ROUTE_MODE_CASES)
def test_route_rows_kernel_modes(cuda, Q, n, K, owners, cap):
    """K19's two modes against the plain version: the two-way route
    (dest, rank, sent_ok) and the one-way route (none of them; the same
    send buffer, counts, overflow and offsets)."""
    rng = np.random.default_rng(Q + 7 * n + K)
    if owners == "one":
        owner = np.full(Q, n // 2, np.int32)
    else:
        owner = rng.integers(0, n, size=Q).astype(np.int32)
    if owners == "hot":
        owner[rng.random(Q) < 0.6] = n - 1
    valid = rng.random(Q) < (0.0 if owners == "invalid" else 0.9)
    rows = torch.from_numpy(rng.integers(-2**31, 2**31, size=(Q, K))
                            .astype(np.int32))
    owner, valid = torch.from_numpy(owner), torch.from_numpy(valid)
    c = Q + 1 if cap is None else cap
    got = {}
    for answers in (True, False):
        want = plain.route_rows(rows, n, c, owner, None, False, valid,
                                answers)
        got[answers] = kernels.route_rows(
            rows.to(cuda), n, c, owner.to(cuda), None, False, valid.to(cuda),
            answers)
        _route_equal(got[answers], want)
        assert want.overflow == (cap is not None)
    _route_equal(got[False], got[True]._replace(dest=None, rank=None,
                                                sent_ok=None))
    if owners == "invalid":
        assert sum(got[True].counts) == 0
        assert bool((got[True].rank >= 0).all())


def test_routed_gather_kernels(cuda):
    """K20: the way back (with and without pos and valid), the request
    dedup's heads, and the owner's gather of one and two tables."""
    rows, owner, valid = _route_case(4, 2000, 1, seed=3, hot=True)
    route = plain.route_rows(rows, 4, 300, owner=owner, valid=valid)
    groute = kernels.route_rows(rows.to(cuda), 4, 300, owner=owner.to(cuda),
                                valid=valid.to(cuda))
    back = torch.arange(sum(route.counts) * 2, dtype=torch.int32).reshape(
        -1, 2)
    pos = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2000, size=777).astype(np.int32))
    pvalid = torch.rand(777, generator=torch.Generator().manual_seed(2)) < .6
    for p, v in ((None, None), (pos, pvalid), (pos, None)):
        want = plain.route_back(back, route.dest, route.rank, route.sent_ok,
                                route.offsets, p, v)
        got = kernels.route_back(back.to(cuda), groute.dest, groute.rank,
                                 groute.sent_ok, groute.offsets,
                                 None if p is None else p.to(cuda),
                                 None if v is None else v.to(cuda))
        assert torch.equal(got.cpu(), want)
    for keys in ([3, 3, 5, 9, 9, 9, 2**31 - 1, 2**31 - 1], [2**31 - 1] * 5,
                 sorted(np.random.default_rng(4).integers(0, 50, 3000))):
        key = torch.tensor(keys, dtype=torch.int32)
        order = torch.randperm(len(keys),
                               generator=torch.Generator().manual_seed(5))
        want = plain.dedup_heads(key, order)
        got = kernels.dedup_heads(key.to(cuda), order.to(cuda))
        _equal(got, want)
    t1 = torch.arange(100, dtype=torch.int32) * 7
    t2 = -torch.arange(100, dtype=torch.int32)
    idx = torch.from_numpy(np.random.default_rng(6).integers(
        0, 800, size=999).astype(np.int32))
    for tables in ((t1,), (t1, t2)):
        want = plain.gather_rows(idx, 8, *tables)
        got = kernels.gather_rows(idx.to(cuda), 8,
                                  *(t.to(cuda) for t in tables))
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("case", HEADS_CASES + ("huge",))
def test_dedup_heads_kernel_cases(cuda, case):
    """K20's heads around its tiles of sorted requests (their size read
    from the kernel's library; one request, a tile less or more one, one
    run over every tile, a valid run across tiles into the INT32_MAX
    tail, a tail from the middle of a tile and from a tile's start, every
    request invalid, many tiles), a pointer-doubling-like shard of 1.2 M
    requests on few targets, and views one request in (the scalar path);
    one launch a call."""
    if case == "huge":
        rng = np.random.default_rng(8)
        k = rng.integers(0, 40, size=1_200_000)
        k[rng.random(k.size) < 0.02] = rng.integers(0, 1 << 30)
        k[rng.random(k.size) < 0.1] = 2**31 - 1
        s_key = np.sort(k).astype(np.int32)
        s_ord = rng.permutation(k.size).astype(np.int64)
    else:
        s_key, s_ord = heads_case(case, kernels.heads_tile())
    s_key, s_ord = torch.from_numpy(s_key), torch.from_numpy(s_ord)
    for off in (0, 1):
        if s_key.numel() - off < 1:
            continue
        key = s_key[off:]
        # the view's input positions, 0 .. Q - 1, one int64 into a buffer
        order = torch.argsort(torch.argsort(s_ord[off:])) if off else s_ord
        before = kernels.LAUNCHES["routed_gather"]
        got = kernels.dedup_heads(
            s_key.to(cuda)[off:],
            torch.cat([order[:off], order]).to(cuda)[off:])
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["routed_gather"] == before + 1
        _equal(got, plain.dedup_heads(key, order))


@pytest.mark.parametrize("cand_cap", [10, 1000, 1 << 20])
def test_reduce_requests_kernels(cuda, cand_cap):
    """K21 on a dense random graph: requests that expand past cand_cap,
    then the membership probe of every candidate."""
    rng = np.random.default_rng(cand_cap)
    V, E, L = 300, 4000, 100
    pairs = np.unique(rng.integers(0, V, size=(E, 2)), axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    ovl = rng.integers(40, 99, size=pairs.shape[0]).astype(np.int32)
    pad = 64
    src = np.concatenate([pairs[:, 0], np.full(pad, 2**31 - 1)]).astype(
        np.int32)
    dst = np.concatenate([pairs[:, 1], np.full(pad, 2**31 - 1)]).astype(
        np.int32)
    ovl = np.concatenate([ovl, np.zeros(pad, np.int32)])
    sl = np.where(src != 2**31 - 1, L - ovl, 2**31 - 1)
    t = torch.from_numpy
    ss_key, order = torch.sort((t(src).long() << 32) | t(sl).long(),
                               stable=True)
    ss_dst = t(dst)[order].contiguous()
    n_e = pairs.shape[0]
    bound = rng.integers(0, 60, size=n_e)
    req = torch.from_numpy(np.stack([src[:n_e], dst[:n_e], sl[:n_e], bound],
                                    1).astype(np.int32))
    # one shard of every vertex: its row table
    row = plain.reduce_rows(ss_key, 0, V)
    grow = kernels.reduce_rows(ss_key.to(cuda), 0, V)
    assert torch.equal(grow.cpu(), row)
    want = plain.reduce_requests(ss_key, ss_dst, req, cand_cap, row, 0)
    got = kernels.reduce_requests(ss_key.to(cuda), ss_dst.to(cuda),
                                  req.to(cuda), cand_cap, grow, 0)
    _equal(got, want)
    assert want[2] > 10
    cand = want[0][want[1]]
    removed = plain.reduce_probe(t(src), t(dst), t(ovl), cand, L, 0, row)
    got = kernels.reduce_probe(t(src).to(cuda), t(dst).to(cuda),
                               t(ovl).to(cuda), cand.to(cuda), L, 0, grow)
    assert torch.equal(got.cpu(), removed)


def _hub_shard(rng, vbase, v_d, hub_degree):
    """One shard's (src, dst, ovl) edges of [vbase, vbase + v_d) in (src,
    dst) order, padded: ~8 out-edges a vertex, every third vertex none,
    one hub with ``hub_degree``; and its (src, sl)-sorted adjacency."""
    I32 = 2**31 - 1
    src, dst = [], []
    for v in range(vbase, vbase + v_d):
        deg = 0 if v % 3 == 1 else int(rng.integers(1, 16))
        if v == vbase + v_d // 2:
            deg = hub_degree
        nb = np.unique(rng.integers(0, vbase + v_d + 50, size=deg))
        nb = nb[nb != v]
        src.append(np.full(nb.shape[0], v))
        dst.append(nb)
    src, dst = np.concatenate(src), np.concatenate(dst)
    ovl = rng.integers(40, 99, size=src.shape[0])
    pad = 33
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(  # noqa
        np.int32))
    src = t(np.concatenate([src, np.full(pad, I32)]))
    dst = t(np.concatenate([dst, np.full(pad, I32)]))
    ovl = t(np.concatenate([ovl, np.zeros(pad)]))
    sl = torch.where(src != I32, 100 - ovl, I32)
    ss_key, order = torch.sort((src.long() << 32) | sl.long(), stable=True)
    return src, dst, ovl, ss_key, dst[order].contiguous()


@pytest.mark.parametrize("cut", ["none", "inside", "hub"])
def test_reduce_requests_kernels_row_table(cuda, cut):
    """K21 with the shard's vertex row table: a hub request whose
    candidates span many merge-path tiles, runs of thousands of
    zero-count requests (vertices without edges, bounds below every
    offset), requests to vertices outside the shard (empty runs),
    cand_cap inside a request (or inside the hub's), then the
    probe of the candidates with a read length and with ragged lengths;
    each launch against the plain version, and the table's launch too."""
    rng = np.random.default_rng(len(cut))
    vbase, v_d = 3000, 4000
    src, dst, ovl, ss_key, ss_dst = _hub_shard(rng, vbase, v_d, 30_000)
    hub = vbase + v_d // 2
    R = 60_000
    w = rng.integers(vbase - 40, vbase + v_d + 40, size=R)
    w[1000:6000] = vbase + 1            # no out-edges: zero counts
    w[20_000] = hub
    bound = rng.integers(0, 62, size=R)
    bound[7000:12_000] = 0              # below every offset: zero counts
    bound[20_000] = 10_000
    v = rng.integers(vbase, vbase + v_d, size=R)
    req = torch.from_numpy(np.stack([v, w, rng.integers(1, 60, size=R),
                                     bound], 1).astype(np.int32))
    row = plain.reduce_rows(ss_key, vbase, v_d)
    grow = kernels.reduce_rows(ss_key.to(cuda), vbase, v_d)
    assert torch.equal(grow.cpu(), row)
    _, _, total = plain.reduce_requests(ss_key, ss_dst, req, 1 << 40, row,
                                        vbase)
    counts = plain.reduce_requests(ss_key, ss_dst, req[:20_000], 1 << 40,
                                   row, vbase)[2]
    cap = {"none": 1 << 40, "inside": total // 3 + 1,
           "hub": counts + 12_345}[cut]
    want = plain.reduce_requests(ss_key, ss_dst, req, cap, row, vbase)
    got = kernels.reduce_requests(ss_key.to(cuda), ss_dst.to(cuda),
                                  req.to(cuda), cap, grow, vbase)
    _equal(got, want)
    assert want[2] == total > 30_000 and want[0].shape[0] == min(total, cap)
    cand = want[0][want[1]]
    lens = torch.from_numpy(rng.integers(90, 110, size=v_d).astype(
        np.int32))
    for read_len in (100, lens):
        removed = plain.reduce_probe(src, dst, ovl, cand, read_len, vbase,
                                     row)
        g_len = read_len if isinstance(read_len, int) else read_len.to(cuda)
        got = kernels.reduce_probe(src.to(cuda), dst.to(cuda), ovl.to(cuda),
                                   cand.to(cuda), g_len, vbase, grow)
        assert torch.equal(got.cpu(), removed)


@pytest.mark.parametrize("which", ["last", "first"])
@pytest.mark.parametrize("k", [11, 25, 31])
def test_window_variants_kernels(cuda, k, which):
    reads = _reads(n_genome=5000)[:300]
    want = plain.window_variants(reads, k, which)
    got = kernels.window_variants(reads.to(cuda), k, which)
    assert torch.equal(got.cpu(), want)
    counts = torch.from_numpy(np.random.default_rng(k).choice(
        [0, 1, 2, 3, 7], size=tuple(want.shape)).astype(np.int32))
    for thr in (2, 3):
        want = plain.apply_verdicts(reads, counts, k, which, thr)
        got = kernels.apply_verdicts(reads.to(cuda), counts.to(cuda), k,
                                     which, thr)
        assert torch.equal(got.cpu(), want)


def test_overlap_join_payload_perm_kernel(cuda):
    """K3's meshed mode: the payload in a shuffled order with the sort's
    permutation gives the in-core join's candidates."""
    r, valid, _ = seed_case(False)
    reads2, valid2 = torch.from_numpy(r), torch.from_numpy(valid)
    geo = join_geometry(reads2.shape[1], 30, 30)
    s_keys, s_rows, payload = build_seed_rows(reads2, valid2, 30, geo)
    flat = payload.reshape(-1, geo.Wt + 2)
    want = kernels.overlap_join(s_keys, s_rows, flat, geo.R, geo.g,
                                geo.trim, 30)
    shuffle = torch.randperm(s_rows.shape[0],
                             generator=torch.Generator().manual_seed(3))
    received = flat[s_rows.long()][shuffle]
    perm = torch.argsort(shuffle)
    args = (s_keys, s_rows, received, geo.R, geo.g, geo.trim, 30, None, None)
    plain_out = kernels.overlap_join(*args, payload_perm=perm)
    _equal(plain_out, want)
    got = kernels.overlap_join(*(a.to(cuda) if isinstance(a, torch.Tensor)
                                 else a for a in args),
                               payload_perm=perm.to(cuda))
    _equal(got, want)


def test_sharded_stages_on_one_card(cuda):
    """The meshed stages with 4 shards on one card against the same
    stages on a CPU mesh (the plain versions), down to the labels."""
    _sharded_stages_match_cpu(cuda)


@pytest.fixture
def cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more GPUs")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_sharded_stages_on_several_cards(cards):
    """The same with the 4 shards spread over every visible card (shard d
    on card d % their count)."""
    _sharded_stages_match_cpu(None)


def _sharded_stages_match_cpu(devices):
    from sage2_tpu_torch.parallel import (
        gather_cyclic_shards,
        gather_edge_shards,
        make_mesh,
        partition_edges_by_src,
        sharded_contract_unitigs,
        sharded_correct_reads,
        sharded_find_overlaps,
        sharded_transitive_reduction,
    )

    reads = _reads(n_genome=20_000).numpy()[:4000]
    out = {}
    for name, dev in (("cpu", "cpu"), ("cuda", devices)):
        mesh = make_mesh(4, devices=dev)
        if dev is None:
            assert len({mesh.device_of(d) for d in range(4)}) > 1
        corrected, ovf = sharded_correct_reads(mesh, reads, 25, 2, 2,
                                               1 << 20, 1 << 20)
        assert not ovf
        rs = prepare_reads(corrected)
        M = rs.reads2.shape[0] + (-rs.reads2.shape[0]) % 4
        pad = M - rs.reads2.shape[0]
        reads2 = torch.cat([rs.reads2, rs.reads2.new_zeros((pad, 100))])
        valid2 = torch.cat([rs.valid2, rs.valid2.new_zeros(pad)])
        src, dst, ovl, n_edges, ovf = sharded_find_overlaps(
            mesh, reads2, valid2, 40, 32, row_cap=1 << 17, join_cap=1 << 18)
        assert not ovf
        V = rs.reads2.shape[0]
        red = sharded_transitive_reduction(mesh, src, dst, ovl, V, 100,
                                           req_cap=1 << 17,
                                           cand_cap=1 << 20)
        assert not red[5]
        edges = gather_edge_shards(*red[:3], red[3])
        s_sh, d_sh, o_sh, _ = partition_edges_by_src(*edges, V, 4)
        labels, ovf = sharded_contract_unitigs(mesh, s_sh, d_sh, o_sh, V,
                                               route_cap=1 << 16)
        assert not ovf
        out[name] = (corrected.cpu(), n_edges, red[3:5],
                     [gather_cyclic_shards(x, V) for x in labels])
    a, b = out["cpu"], out["cuda"]
    assert torch.equal(a[0], b[0]) and a[1] == b[1] and a[2] == b[2]
    for x, y in zip(a[3], b[3]):
        assert np.array_equal(x, y)


def test_kernels_on_another_card(cards):
    """Wrappers called with their tensors on a card other than the
    current one launch there (on that card's stream) and leave the
    current card as it was; inputs on two cards are refused."""
    other = cards[1]
    assert torch.cuda.current_device() == 0
    reads = _reads(n_genome=5_000)[:500]
    keys = plain.kmer_keys(reads, 25)[2]
    got = kernels.kmer_keys(reads.to(other), 25)[2]
    assert got.device == other and torch.equal(got.cpu(), keys)
    table = count_kmers(reads.to(other), 25)
    assert table.keys.device == other
    ref = count_kmers(reads, 25)
    assert torch.equal(table.keys.cpu(), ref.keys)
    assert torch.equal(table.count.cpu(), ref.count)
    variants = kernels.window_variants(reads.to(other), 25, "last")
    want = plain.lookup_counts(ref.keys, ref.count, variants.cpu())
    got = kernels.lookup_counts(table.keys, table.count, variants)
    assert torch.equal(got.cpu(), want)
    rows, owner, valid = _route_case(4, 3000, 3, seed=5)
    _route_equal(kernels.route_rows(rows.to(other), 4, 700,
                                    owner=owner.to(other),
                                    valid=valid.to(other)),
                 plain.route_rows(rows, 4, 700, owner=owner, valid=valid))
    assert torch.cuda.current_device() == 0
    with pytest.raises(ValueError):
        kernels.route_rows(rows.to(cards[0]), 4, 700, owner=owner.to(other))


def test_meshed_assembly_on_several_cards(cards):
    """assemble(mesh_shape=(4,)) with the shards spread over every visible
    card gives the single-device run's contigs and stats."""
    from dataclasses import replace

    from sage2_tpu_torch import AssemblyConfig
    from sage2_tpu_torch.pipeline import assemble

    reads = _reads(n_genome=20_000).numpy()[:4001]     # padded to the mesh
    cfg = AssemblyConfig(min_contig_len=500)
    contigs, stats = assemble(reads, cfg, device="cuda:0")
    m_contigs, m_stats = assemble(reads, replace(cfg, mesh_shape=(4,)),
                                  device="cuda")
    assert m_stats == stats and len(m_contigs) == len(contigs) >= 1
    for a, b in zip(m_contigs, contigs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("k", [11, 25])
def test_vote_add_and_apply_kernels(cuda, k, ragged):
    """K5's routed mode: each position's votes from the counts of K22's
    variant keys (as the owners send them back), then the rule; each
    launch bit-equal to its plain version, and the round equal to K5's
    fused round over the same table."""
    r, lens = _ragged() if ragged else (_reads(), None)
    r = r[:3000]
    lens = None if lens is None else lens[:3000]
    t = prune_table_for_correction(count_kmers(r, k, lens), 2)
    N, L = r.shape
    votes = torch.zeros((N, L, 4), dtype=torch.uint8)
    gvotes = votes.to(cuda)
    glens = None if lens is None else lens.to(cuda)
    before = kernels.LAUNCHES["vote_windows"]
    for j in range(k):
        counts = plain._count_of(t.keys, t.count,
                                 plain.window_variants(r, k, j))
        plain.vote_add(votes, counts, j, k, 2, lens)
        got = kernels.vote_add(gvotes, counts.to(cuda), j, k, 2, glens)
        assert got is gvotes
        assert torch.equal(gvotes.cpu(), votes)
    want = plain.vote_apply(r, votes)
    got = kernels.vote_apply(r.to(cuda), gvotes)
    assert kernels.LAUNCHES["vote_windows"] == before + k + 1
    assert torch.equal(got.cpu(), want)
    assert (want != r).any()
    assert torch.equal(want, plain.vote_windows(r, t.keys, t.count, k, 2,
                                                lens))


@pytest.mark.parametrize("L,k", [(40, 11), (150, 25), (300, 31)])
@pytest.mark.parametrize("ragged", [False, True])
def test_vote_add_kernel_every_position(cuda, ragged, L, k):
    """vote_add at every window position j on votes that start nonzero,
    with counts around the threshold (equal to it too), P = 30, 126 and
    270 windows (none a multiple of a warp's 128-window step); ragged:
    lengths below k (no window), of exactly k (one), of L (all) and
    between; each launch bit-equal to the plain version."""
    rng = np.random.default_rng(L + k)
    N, P, thr = 333, L - k + 1, 3
    lens = None
    if ragged:
        lens = rng.integers(1, L + 1, N).astype(np.int32)
        lens[:40] = np.arange(40) % (k - 1) + 1
        lens[40:60], lens[60:80] = k, L
        lens = torch.from_numpy(lens)
    votes = torch.from_numpy(rng.integers(0, 4, (N, L, 4)).astype(np.uint8))
    gvotes = votes.to(cuda)
    glens = None if lens is None else lens.to(cuda)
    for j in range(k):
        counts = torch.from_numpy(
            rng.integers(0, 2 * thr, (N, P, 4)).astype(np.int32))
        plain.vote_add(votes, counts, j, k, thr, lens)
        kernels.vote_add(gvotes, counts.to(cuda), j, k, thr, glens)
        assert torch.equal(gvotes.cpu(), votes), j
    if ragged:
        assert not (votes[:40].int() > 3).any()


@pytest.mark.parametrize("k", [11, 25, 31])
def test_window_variants_kernel_positions(cuda, k):
    """K22 at every window position j, and its verdicts with lengths."""
    reads = _reads(n_genome=5000)[:300]
    for j in range(k):
        want = plain.window_variants(reads, k, j)
        got = kernels.window_variants(reads.to(cuda), k, j)
        assert torch.equal(got.cpu(), want), j
    lens = torch.from_numpy(np.random.default_rng(k).integers(
        k - 3, 101, size=300).astype(np.int32))
    counts = torch.from_numpy(np.random.default_rng(k + 1).choice(
        [0, 1, 2, 3, 7], size=(300, 101 - k, 4)).astype(np.int32))
    for which in plain.WHICH:
        want = plain.apply_verdicts(reads, counts, k, which, 2, lens)
        got = kernels.apply_verdicts(reads.to(cuda), counts.to(cuda), k,
                                     which, 2, lens.to(cuda))
        assert torch.equal(got.cpu(), want)
        assert not torch.equal(want, plain.apply_verdicts(
            reads, counts, k, which, 2))


@pytest.mark.parametrize("vbase", [0, 150])
def test_reduce_probe_kernel_ragged(cuda, vbase):
    """K21's probe with a shard's own lengths: len(v) of vertices
    [vbase, vbase + v_d), clipped."""
    rng = np.random.default_rng(vbase)
    V, v_d = 300, 200
    pairs = np.unique(rng.integers(0, V, size=(3000, 2)), axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    lens = rng.integers(60, 101, size=v_d).astype(np.int32)
    src = pairs[:, 0].astype(np.int32)
    dst = pairs[:, 1].astype(np.int32)
    ovl = rng.integers(40, 60, size=src.shape[0]).astype(np.int32)
    local = np.clip(src.astype(np.int64) - vbase, 0, v_d - 1)
    # a candidate for every edge, half of them at its true offset
    sl = lens[local] - ovl + (rng.random(src.shape[0]) < 0.5)
    cand = np.stack([src, dst, sl], 1).astype(np.int32)
    t = torch.from_numpy
    key = (t(src).long() << 32) | t(dst).long()
    row = plain.reduce_rows(key, vbase, v_d)
    want = plain.reduce_probe(t(src), t(dst), t(ovl), t(cand), t(lens),
                              vbase, row)
    got = kernels.reduce_probe(t(src).to(cuda), t(dst).to(cuda),
                               t(ovl).to(cuda), t(cand).to(cuda),
                               t(lens).to(cuda), vbase,
                               kernels.reduce_rows(key.to(cuda), vbase, v_d))
    assert torch.equal(got.cpu(), want)
    assert want.any() and not want.all()


def test_overlap_join_payload_perm_contained_kernel(cuda):
    """K3 with the owners' payload permutation and containment marks at
    once (the meshed ragged join): the in-core join's candidates and
    marks."""
    rs, args = _ragged_rows(cuda)
    s_keys, s_rows, flat = args[:3]
    M = rs.reads2.shape[0]
    want_cont = torch.zeros(M, dtype=torch.uint8, device=cuda)
    want = kernels.overlap_join(*args, want_cont)
    shuffle = torch.randperm(s_rows.shape[0],
                             generator=torch.Generator().manual_seed(4)
                             ).to(cuda)
    received = flat[s_rows.long()][shuffle]
    perm = torch.argsort(shuffle)
    rest = (s_keys, s_rows, received) + args[3:]
    plain_cont = torch.zeros(M, dtype=torch.uint8)
    plain_out = plain.overlap_join(*(a.cpu() if isinstance(a, torch.Tensor)
                                     else a for a in rest), plain_cont,
                                   None, None, 0, 0, perm.cpu())
    cont = torch.zeros(M, dtype=torch.uint8, device=cuda)
    before = kernels.LAUNCHES["overlap_join"]
    got = kernels.overlap_join(*rest, cont, None, None, 0, 0, perm)
    assert kernels.LAUNCHES["overlap_join"] == before + 2
    _equal(got, plain_out)
    _equal(got, want)
    assert torch.equal(cont.cpu(), plain_cont)
    assert torch.equal(cont, want_cont) and cont.any()


def test_sharded_ragged_and_voting_stages_on_one_card(cuda):
    """The meshed stages of ragged reads (both rules: the routed vote,
    the ragged verdicts, the join's marks, the reduction with the
    shards' lengths) with 4 shards on one card, against the same on a
    CPU mesh."""
    _sharded_ragged_stages_match_cpu(cuda)


def test_sharded_ragged_stages_on_several_cards(cards):
    _sharded_ragged_stages_match_cpu(None)


def _sharded_ragged_stages_match_cpu(devices):
    from sage2_tpu_torch.parallel import (
        gather_edge_shards,
        make_mesh,
        partition_vertex_range,
        sharded_correct_reads,
        sharded_find_overlaps,
        sharded_transitive_reduction,
    )

    r, lens = _ragged(n_genome=20_000)
    n = r.shape[0] - r.shape[0] % 4
    reads, lens = r[:n].numpy(), lens[:n].numpy()
    out = {}
    for name, dev in (("cpu", "cpu"), ("cuda", devices)):
        mesh = make_mesh(4, devices=dev)
        got = []
        for rule in ("single_window", "vote_all_windows"):
            corrected, ovf = sharded_correct_reads(
                mesh, reads, 25, 2, 2, 1 << 20, 1 << 20, lengths=lens,
                rule=rule)
            assert not ovf
            got.append(corrected.cpu())
        rs = prepare_reads(corrected, torch.from_numpy(lens).to(
            corrected.device))
        M = rs.reads2.shape[0]
        pad = (-M) % 4
        L = rs.reads2.shape[1]
        reads2 = torch.cat([rs.reads2, rs.reads2.new_zeros((pad, L))])
        valid2 = torch.cat([rs.valid2, rs.valid2.new_zeros(pad)])
        lens2 = torch.cat([rs.lengths2, rs.lengths2.new_zeros(pad)])
        src, dst, ovl, n_edges, ovf, cont = sharded_find_overlaps(
            mesh, reads2, valid2, 40, 32, row_cap=1 << 17,
            join_cap=1 << 18, lengths=lens2)
        assert not ovf and bool(cont.any())
        lens_sh = partition_vertex_range(rs.lengths2.cpu().numpy(), M, 4)
        red = sharded_transitive_reduction(mesh, src, dst, ovl, M, L,
                                           req_cap=1 << 17,
                                           cand_cap=1 << 20,
                                           lengths_sh=lens_sh)
        assert not red[5]
        got += [n_edges, cont.cpu(), red[3:5],
                gather_edge_shards(*red[:3], red[3])]
        out[name] = got
    a, b = out["cpu"], out["cuda"]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], a[1])
    assert a[2] == b[2] and torch.equal(a[3], b[3]) and a[4] == b[4]
    for x, y in zip(a[5], b[5]):
        assert np.array_equal(x, y)


def test_meshed_ragged_voting_assembly_on_several_cards(cards):
    """assemble(mesh_shape=(4,), lengths=...) with the voting rule, the
    shards spread over every visible card: the single-device run's
    contigs and stats."""
    from dataclasses import replace

    from sage2_tpu_torch import AssemblyConfig
    from sage2_tpu_torch.pipeline import assemble

    r, lens = _ragged(n_genome=20_000)
    reads, lens = r.numpy(), lens.numpy()
    cfg = AssemblyConfig(min_contig_len=500,
                         correction_rule="vote_all_windows")
    contigs, stats = assemble(reads, cfg, device="cuda:0", lengths=lens)
    m_contigs, m_stats = assemble(reads, replace(cfg, mesh_shape=(4,)),
                                  device="cuda", lengths=lens)
    assert m_stats == stats and len(m_contigs) == len(contigs) >= 1
    for a, b in zip(m_contigs, contigs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ragged", [False, True])
def test_streamed_mesh_assembly_on_one_card(cuda, ragged, tmp_path):
    """assemble(mesh_shape=(4,), max_device_reads=1000) with a spill dir
    and an outdir on one card (the streamed mesh: the chunked count and
    correction, the owners' accumulated entry rows and query-chunk joins;
    the voting rule for ragged reads): the single-device in-core run's
    contigs and stats."""
    from dataclasses import replace

    from sage2_tpu_torch import AssemblyConfig
    from sage2_tpu_torch.pipeline import assemble

    if ragged:
        r, lens = _ragged(n_genome=20_000)
        reads, lens = r.numpy(), lens.numpy()
        cfg = AssemblyConfig(min_contig_len=500,
                             correction_rule="vote_all_windows")
    else:
        reads, lens = _reads(n_genome=20_000).numpy()[:4001], None
        cfg = AssemblyConfig(min_contig_len=500)
    contigs, stats = assemble(reads, cfg, device="cuda", lengths=lens)
    m_contigs, m_stats = assemble(
        reads, replace(cfg, mesh_shape=(4,), max_device_reads=1000,
                       spill_dir=str(tmp_path / "spill")),
        outdir=str(tmp_path / "out"), device="cuda", lengths=lens)
    assert m_stats == stats and len(m_contigs) == len(contigs) >= 1
    for a, b in zip(m_contigs, contigs):
        np.testing.assert_array_equal(a, b)


# --- K3's run-major slots and K16's membership table ------------------------

def _hot_reads(n_hot, ragged, seed=21):
    """(reads2 (M, 100) int32, valid2, lengths or None): simulated reads of
    a 30 kbp genome and ``n_hot`` poly-A reads, whose seeds make one run
    of 8 n_hot entry and 8 n_hot query rows, more than a slots tile of K3
    stages (2 x 128 rows), spread over many slot tiles."""
    g = simulate_genome(30_000, seed=seed)
    r, _ = simulate_reads(g, read_len=100, coverage=10, error_rate=0.002,
                          seed=seed + 1)
    r = np.concatenate([r.astype(np.int32),
                        np.zeros((n_hot, 100), np.int32)])
    valid = np.ones(len(r), bool)
    valid[::11] = False
    lens = None
    if ragged:
        rng = np.random.default_rng(seed)
        lens = rng.integers(60, 101, len(r)).astype(np.int32)
        lens[-n_hot:] = 100
        r[np.arange(100)[None, :] >= lens[:, None]] = 0
        lens = torch.from_numpy(lens)
    return torch.from_numpy(r), torch.from_numpy(valid), lens


def _hot_join(cuda, ragged, n_hot=48):
    r, valid, lens = _hot_reads(n_hot, ragged)
    geo = join_geometry(100, 40, 32)
    s_keys, s_rows, payload = build_seed_rows(
        r.to(cuda), valid.to(cuda), 32, geo,
        None if lens is None else lens.to(cuda))
    return r.shape[0], geo, (s_keys, s_rows, payload.reshape(-1, geo.Wt + 2),
                             geo.R, geo.g, geo.trim, 40)


@pytest.mark.parametrize("limit", [None, "inside"])
@pytest.mark.parametrize("ragged", [False, True])
def test_overlap_join_kernel_hot_run(cuda, ragged, limit):
    """K3 over a run larger than a slots tile stages, with runs across
    slot tiles everywhere; a slot limit that cuts inside a query of the
    hot run writes and marks only the slots below it (the marks of the
    slots past it stay unset)."""
    M, geo, args = _hot_join(cuda, ragged)
    keys = args[0]
    _, counts = torch.unique_consecutive(keys, return_counts=True)
    assert int(counts.max()) > 2 * kernels.JOIN_SLOT_TILE
    full = plain.overlap_join(*args)
    total = full[4]
    assert total > 100 * kernels.JOIN_SLOT_TILE
    slot_limit = None
    if limit == "inside":       # a query's candidates cut in two
        a = full[1]
        same = torch.nonzero(a[1:] == a[:-1]).flatten() + 1
        slot_limit = int(same[len(same) // 2])
    cont = [torch.zeros(M, dtype=torch.uint8, device=cuda) for _ in range(2)]
    marks = (None, None) if not ragged else cont
    before = kernels.LAUNCHES["overlap_join"]
    got = kernels.overlap_join(*args, marks[0], slot_limit)
    assert kernels.LAUNCHES["overlap_join"] == before + 2
    _equal(got, plain.overlap_join(*args, marks[1], slot_limit))
    if ragged:
        assert torch.equal(cont[0], cont[1])
        assert cont[0].any() or slot_limit is not None
    if slot_limit is not None:
        assert got[0].shape[0] == slot_limit < total
        if ragged:              # the marks of the full join hold more
            every = torch.zeros(M, dtype=torch.uint8, device=cuda)
            plain.overlap_join(*args, every)
            assert int(every.sum()) > int(cont[0].sum())


@pytest.mark.parametrize("capacity", ["below", "above"])
def test_overlap_join_stacked_kernel_hot_run(cuda, capacity):
    """The fixed-capacity mode over the hot run: exactly C slots, the
    candidates below min(total, C) and not-ok slots past the total."""
    r, valid, _ = _hot_reads(48, False)
    geo = join_geometry(100, 40, 32)
    keys, rows, payload, n_live = kernels.seed_rows_stacked(
        r.to(cuda), valid.to(cuda), 32, geo.g, geo.n_pos, geo.trim)
    flat = payload.reshape(-1, geo.Wt + 2)
    total = int(plain.overlap_join_stacked(keys, rows, flat, n_live, geo.R,
                                           geo.g, geo.trim, 40, 1)[4])
    C = total // 3 if capacity == "below" else total + 1000
    args = (keys, rows, flat, n_live, geo.R, geo.g, geo.trim, 40, C)
    got = kernels.overlap_join_stacked(*args)
    _equal(got, plain.overlap_join_stacked(*args))
    assert int(got[4]) == total and got[0].shape[0] == C
    if capacity == "above":
        assert not got[0][total:].any() and not got[1][total:].any()


def test_overlap_join_kernel_hot_run_streamed_and_meshed(cuda):
    """The hot run through the streamed join's two-segment payload (an
    entry slab and a query chunk) and the meshed join's permutation."""
    r, valid, lens = _hot_reads(48, True)
    M = r.shape[0]
    geo = join_geometry(100, 40, 32)
    g, n_pos, W2 = geo.g, geo.n_pos, geo.Wt + 2
    rc, vc, lc = r.to(cuda), valid.to(cuda), lens.to(cuda)
    e_keys, e_ids, e_pay = kernels.seed_rows(rc, vc, lc, 32, g, n_pos,
                                             geo.trim, 0, "entries")
    q0 = M // 2
    s_keys, s_rows, q_pay = kernels.seed_rows(
        rc[q0:], vc[q0:], lc[q0:], 32, g, n_pos, geo.trim, q0, "queries",
        e_keys, e_ids)
    args = (s_keys, s_rows, q_pay.reshape(-1, W2), geo.R, g, geo.trim, 40)
    cont = [torch.zeros(M, dtype=torch.uint8, device=cuda) for _ in range(2)]
    tail = (e_pay.reshape(-1, W2), 0, q0)
    got = kernels.overlap_join(*args, cont[0], None, *tail)
    _equal(got, plain.overlap_join(*args, cont[1], None, *tail))
    assert torch.equal(cont[0], cont[1]) and got[4] > 0
    # meshed: the in-core rows with their payload in a shuffled order
    _, _, margs = _hot_join(cuda, True)
    keys, rows, flat = margs[:3]
    shuffle = torch.randperm(rows.shape[0], device=cuda,
                             generator=torch.Generator(cuda).manual_seed(5))
    received = flat[rows.long()][shuffle]
    perm = torch.argsort(shuffle)
    pargs = (keys, rows, received) + margs[3:]
    cont = [torch.zeros(M, dtype=torch.uint8, device=cuda) for _ in range(2)]
    got = kernels.overlap_join(*pargs, cont[0], None, None, 0, 0, perm)
    _equal(got, plain.overlap_join(*pargs, cont[1], None, None, 0, 0, perm))
    _equal(got[:4], plain.overlap_join(*margs)[:4])
    assert torch.equal(cont[0], cont[1]) and cont[0].any()


def _solid_part(directory, T):
    off = kernels.solid_offset(T)
    return directory[off:] if directory.numel() > off else None


@pytest.mark.parametrize("case", VOTE_CASES)
def test_weak_windows_kernel_membership(cuda, case):
    """K16 through the membership table of the solid keys (k = 15: every
    non-empty table gets one; k31: none, K2's directory): equal to
    plain.weak_windows, fixed and ragged ("short" holds reads shorter
    than k), filtered by the threshold ("unpruned"), none weak ("clean"),
    the empty table; the build's three launches once, two a call; K17
    takes the same directory; a call at another threshold than the
    table's looks up through K2's directory, as does a table asked for at
    threshold 0."""
    k = 31 if case == "k31" else 15
    reads, lengths, keys, counts, k, threshold, _ = vote_case(case, k=k)
    r, t_keys, t_counts = (torch.from_numpy(x).to(cuda)
                           for x in (reads, keys, counts))
    lens = None if lengths is None else torch.from_numpy(lengths).to(cuda)
    before = dict(kernels.LAUNCHES)
    directory = kernels.table_directory(t_keys, t_counts, k, threshold)
    bits = kernels.solid_bits(len(keys), k)
    assert (bits is None) == (case in ("empty", "k31"))
    assert (_solid_part(directory, len(keys)) is None) == (bits is None)
    assert kernels.LAUNCHES["lookup_counts"] == before["lookup_counts"] + 1
    assert kernels.LAUNCHES["weak_windows"] == before["weak_windows"] + (
        0 if bits is None else 3)
    if bits is not None:        # the header: built, k, threshold, bits
        head = _solid_part(directory, len(keys))[:4].tolist()
        assert head == [1, k, threshold, bits]
    mid = dict(kernels.LAUNCHES)
    widx = kernels.weak_windows(r, lens, t_keys, t_counts, directory, k,
                                threshold)
    assert kernels.LAUNCHES["weak_windows"] == mid["weak_windows"] + 2
    want = plain.weak_windows(r, lens, t_keys, t_counts, None, k, threshold)
    _equal([widx], [want])
    assert (widx.numel() == 0) == (case == "clean")
    if case == "empty":         # every valid window is weak
        valid = (reads.shape[1] - k + 1) * reads.shape[0]
        assert widx.numel() == valid
    for which in ("last", "first"):
        _equal([kernels.fix_windows(r, widx, t_keys, t_counts, directory, k,
                                    threshold, which)],
               [plain.fix_windows(r, widx, t_keys, t_counts, None, k,
                                  threshold, which)])
    other = kernels.weak_windows(r, lens, t_keys, t_counts, directory, k,
                                 threshold + 1)
    _equal([other], [plain.weak_windows(r, lens, t_keys, t_counts, None, k,
                                        threshold + 1)])
    # at threshold 0 no window is weak, a key absent from the table
    # included: no membership table is built, K2's directory decides
    zero = kernels.table_directory(t_keys, t_counts, k, 0)
    assert _solid_part(zero, len(keys)) is None
    for d in (zero, directory):
        got = kernels.weak_windows(r, lens, t_keys, t_counts, d, k, 0)
        _equal([got], [plain.weak_windows(r, lens, t_keys, t_counts, None,
                                          k, 0)])
        assert got.numel() == 0


def test_weak_windows_kernel_overflow_bucket(cuda):
    """A bucket of more than eight solid keys: seven in its sector, the
    rest in its overflow list (its last word links it); reads whose
    windows hit each of the bucket's keys, solid or filtered out by the
    threshold, and keys absent from the table; then a table without the
    bucket's keys.""" 
    k = 11
    keys, counts, crowd = crowded_bucket_table(k, 5, 24)
    rng = np.random.default_rng(4)
    # a read a crowd key: the key's k-mer inside random flanks
    reads = rng.integers(0, 4, (len(crowd) + 8, 40)).astype(np.int32)
    for i, x in enumerate(crowd.tolist()):
        reads[i, 10:10 + k] = kmer_codes(x, k)
    r, t_keys, t_counts = (torch.from_numpy(x).to(cuda)
                           for x in (reads, keys, counts))
    directory = kernels.table_directory(t_keys, t_counts, k, 2)
    bits = kernels.solid_bits(len(keys), k)
    low = 2 * k - bits
    solid = _solid_part(directory, len(keys))
    words = solid[4:4 + (4 << bits)].view(torch.int32).view(-1, 8).cpu()
    link = int(words[5, 7]) & 0xFFFFFFFF
    n_in = sum(1 for x, c in zip(keys.tolist(), counts.tolist())
               if c >= 2 and solid_mix(x, 2 * k) >> low == 5)
    assert n_in > 8 and link >> 31 == 1
    widx = kernels.weak_windows(r, None, t_keys, t_counts, directory, k, 2)
    want = plain.weak_windows(r, None, t_keys, t_counts, None, k, 2)
    _equal([widx], [want])
    P = 40 - k + 1
    hit = set(widx.tolist())
    for i, c in enumerate(counts[np.searchsorted(keys, crowd)].tolist()):
        assert ((i * P + 10) in hit) == (c < 2)
    # a table without the crowd's keys
    none = torch.from_numpy(np.setdiff1d(keys, crowd)).to(cuda)
    ones = torch.full_like(none, 3, dtype=torch.int32)
    d2 = kernels.table_directory(none, ones, k, 2)
    got = kernels.weak_windows(r[len(crowd):], None, none, ones, d2, k, 2)
    _equal([got], [plain.weak_windows(r[len(crowd):], None, none, ones, None,
                                      k, 2)])
