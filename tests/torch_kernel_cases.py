"""Inputs shared by the CPU and the CUDA tests of kernels K2
(``kernels.lookup_counts``, with the geometry of its bucket directory,
kernels/csrc/bucket_search.cuh), K5, K6, K7, K12-K15 and K20's heads,
made with numpy from a seed.

Imports neither JAX nor sage2_tpu, so the CUDA tests can use it on a
machine without JAX."""

import numpy as np

from sage2_tpu_torch.kernels import lookup_bits

INT64_MIN, INT64_MAX = -(1 << 63), (1 << 63) - 1

# tables whose keys are >= 0, which the reference's (hi, lo) uint32 split
# carries; the rest hold negative keys or the int64 extremes
UNSIGNED_CASES = ("skew", "single", "outside", "bits50")
SIGNED_CASES = ("pair", "negative", "extremes")


def _table(case: str, rng) -> np.ndarray:
    if case == "skew":          # every key but one in bucket 0
        return np.append(np.arange(999, dtype=np.int64), (1 << 62) - 12345)
    if case == "single":        # T = 1
        return np.array([123_456_789], np.int64)
    if case == "outside":       # queried just outside both ends
        return np.arange(1000, 5000, 3, dtype=np.int64)
    if case == "bits50":        # keys spread over all 50 bits
        return np.unique(np.append(rng.integers(0, 1 << 50, 5000),
                                   [0, (1 << 50) - 1]))
    if case == "pair":          # T = 2
        return np.array([-7, 1 << 40], np.int64)
    if case == "negative":
        return np.unique(rng.integers(-(1 << 45), 1 << 20, 3000))
    if case == "extremes":      # the span is all of int64
        return np.unique(np.concatenate([
            [INT64_MIN, INT64_MIN + 1, INT64_MAX - 1, INT64_MAX],
            rng.integers(INT64_MIN, INT64_MAX, 2000)]))
    raise ValueError(case)


def bucket_geometry(keys: np.ndarray):
    """(bits, lo, shift) of K2's directory over the sorted ``keys``."""
    T = len(keys)
    bits = lookup_bits(T)
    if T == 0:
        return bits, 0, 0
    lo, span = int(keys[0]), int(keys[-1]) - int(keys[0])
    return bits, lo, max(0, span.bit_length() - bits)


def lookup_case(case: str, seed: int = 0):
    """(keys int64 sorted unique, counts int32, queries int64): every key,
    each key +- 1, the keys just outside the table's span, every bucket's
    lowest key +- 1 (lo + (j << shift)), and random keys over the span."""
    rng = np.random.default_rng(seed)
    keys = _table(case, rng)
    counts = rng.integers(1, 1 << 20, len(keys)).astype(np.int32)
    bits, lo, shift = bucket_geometry(keys)
    hi = int(keys[-1])
    q = [int(k) + d for k in keys for d in (-1, 0, 1)]
    q += [lo - 2, lo - 1, hi + 1, hi + 2]
    q += [lo + (j << shift) + d for j in range(1 << bits) for d in (-1, 0, 1)]
    q += [int(v) for v in rng.integers(lo, hi, 2000, endpoint=True)]
    q = [v for v in q if INT64_MIN <= v <= INT64_MAX]
    if case in UNSIGNED_CASES:
        q = [v for v in q if v >= 0]
    return keys, counts, np.array(q, np.int64)


def oracle_lookup(keys: np.ndarray, counts: np.ndarray,
                  queries: np.ndarray) -> np.ndarray:
    """counts of each query key, 0 where absent, by a dictionary."""
    d = dict(zip(keys.tolist(), counts.tolist()))
    return np.array([d.get(v, 0) for v in queries.reshape(-1).tolist()],
                    np.int32).reshape(queries.shape)


# --- kernel K5 (kernels.vote_windows) --------------------------------------

VOTE_CASES = ("clean", "errors", "close", "tie", "short", "unpruned",
              "empty", "k31")


def canonical_keys(reads: np.ndarray, k: int,
                   lengths: np.ndarray = None) -> np.ndarray:
    """(N, L - k + 1) int64 canonical keys of every window (the smaller
    of the forward key, first base in the top bits, and the reverse
    complement's), -1 for a window past its read's length."""
    N, L = reads.shape
    P = L - k + 1
    r = reads.astype(np.int64)
    fwd = np.zeros((N, P), np.int64)
    rc = np.zeros((N, P), np.int64)
    for j in range(k):
        fwd = fwd * 4 + r[:, j : j + P]
        rc += (3 - r[:, j : j + P]) << (2 * j)
    canon = np.minimum(fwd, rc)
    if lengths is not None:
        canon[np.arange(P)[None, :] >= (lengths[:, None] - k + 1)] = -1
    return canon


def count_table(reads: np.ndarray, k: int, lengths: np.ndarray = None,
                threshold: int = None):
    """(keys int64 sorted unique, counts int32) of the reads' valid
    windows; only the keys counted ``threshold`` times or more where it
    is given (the pruned table)."""
    canon = canonical_keys(reads, k, lengths)
    keys, counts = np.unique(canon[canon >= 0], return_counts=True)
    if threshold is not None:
        keys, counts = keys[counts >= threshold], counts[counts >= threshold]
    return keys.astype(np.int64), counts.astype(np.int32)


def _tiled(genome: np.ndarray, L: int, copies: int) -> np.ndarray:
    """Every read of length L of the genome, ``copies`` times each."""
    starts = np.repeat(np.arange(len(genome) - L + 1), copies)
    return genome[starts[:, None] + np.arange(L)[None, :]]


def vote_case(case: str, seed: int = 0, k: int = None):
    """(reads (N, L) int32, lengths (N,) int32 or None, keys, counts, k,
    threshold, truth (N, L) int32) for kernel K5: error-free reads
    tiling a random genome twice over, so that every window is solid,
    and after them the reads that the case is about (``truth`` holds
    them without their errors):

      clean     no errors: every base is skipped;
      errors    one read with an error at its first base, one at its
                middle base, one at its last;
      close     one read with two errors 5 bases apart (closer than k);
      tie       the genome twice, with A or C at one site, and a read
                with G there: A and C tie, so G stays;
      short     ragged reads (zero-padded): lengths k - 1, k (with an
                error at its middle base) and L - 3 (with an error);
      unpruned  the table of reads tiling the genome once, not pruned:
                counts from 1 up, many below the threshold of 3;
      empty     a pruned table with no key (threshold above every count);
      k31       the errors case at k = 31.

    ``k``: the k-mer length of every case but k31 (25 by default)."""
    rng = np.random.default_rng(seed)
    k = 31 if case == "k31" else (k or 25)
    threshold, L = 2, 60
    genome = rng.integers(0, 4, 400).astype(np.int32)
    reads = _tiled(genome, L, 1 if case == "unpruned" else 2)
    extra, lengths = [], None

    def with_errors(start, at):
        read = genome[start : start + L].copy()
        for p in at:
            read[p] = (read[p] + 1 + rng.integers(0, 3)) % 4
        return read, genome[start : start + L].copy()

    if case in ("errors", "k31", "unpruned", "empty"):
        extra = [with_errors(40, [0]), with_errors(120, [L // 2]),
                 with_errors(200, [L - 1])]
    elif case == "close":
        extra = [with_errors(150, [L // 2 - 2, L // 2 + 3])]
    elif case == "tie":
        site = 230
        other = genome.copy()
        genome[site], other[site] = 0, 1
        reads = np.concatenate([_tiled(genome, L, 2), _tiled(other, L, 2)])
        read = genome[site - 30 : site - 30 + L].copy()
        read[30] = 2
        extra = [(read, read.copy())]
    elif case == "short":
        lens = [k - 1, k, L - 3]
        for n, start in zip(lens, (10, 90, 170)):
            read, good = with_errors(start, [n // 2] if n >= k else [])
            read[n:] = good[n:] = 0
            extra.append((read, good))
        lengths = np.concatenate([np.full(len(reads), L, np.int32),
                                  np.array(lens, np.int32)])
    truth = np.concatenate([reads] + [t[None] for _, t in extra])
    reads = np.concatenate([reads] + [r[None] for r, _ in extra])
    if case == "empty":
        threshold = 10**6
    keys, counts = count_table(reads, k, lengths,
                               None if case == "unpruned" else threshold)
    if case == "unpruned":
        threshold = 3
    return (reads.astype(np.int32), lengths, keys, counts, k, threshold,
            truth.astype(np.int32))


def tied_variants_case(k: int = 15, seed: int = 3):
    """(reads, lengths, keys, counts, k, threshold) for kernel K17: the
    "errors" case of ``vote_case`` with its table grown so that many weak
    windows have two or more solid variants of their last base: two or
    three of them, tied at the maximum or not (the current base's variant
    stays weak)."""
    reads, lengths, keys, counts, k, threshold, _ = vote_case(
        "errors", seed, k)
    count = dict(zip(keys.tolist(), counts.tolist()))
    canon = canonical_keys(reads, k)
    N, P = canon.shape
    weak = [(r, w) for r in range(N) for w in range(P)
            if count.get(int(canon[r, w]), 0) < threshold]
    patterns = ((1, 1), (1, 4), (2, 2, 7), (3, 3, 3), (5,), (2, 6))
    for i, (r, w) in enumerate(weak):
        win = reads[r, w:w + k].astype(np.int64).tolist()
        f = c = 0
        for j, b in enumerate(win):
            f = f * 4 + b
            c |= (3 - b) << (2 * j)
        cur, sr = win[-1], 2 * (k - 1)
        others = [b for b in range(4) if b != cur]
        for b, extra in zip(others, patterns[i % len(patterns)]):
            q = min((f & ~3) | b, (c & ~(3 << sr)) | ((3 - b) << sr))
            count[q] = threshold + extra
    keys = np.array(sorted(count), np.int64)
    counts = np.array([count[x] for x in keys.tolist()], np.int32)
    return reads, lengths, keys, counts, k, threshold


def weak_covered(reads: np.ndarray, keys: np.ndarray, counts: np.ndarray,
                 k: int, threshold: int, lengths: np.ndarray = None):
    """(N, L) bool: the bases with a weak valid covering window (count
    below ``threshold``, 0 for an absent key), the only bases a voting
    round can change."""
    canon = canonical_keys(reads, k, lengths)
    N, P = canon.shape
    at = np.searchsorted(keys, canon).clip(max=max(len(keys) - 1, 0))
    found = (len(keys) > 0) & (keys[at] == canon) if len(keys) else \
        np.zeros(canon.shape, bool)
    weak = (np.where(found, counts[at] if len(keys) else 0, 0) < threshold)
    weak &= canon >= 0
    out = np.zeros(reads.shape, bool)
    for j in range(k):
        out[:, j : j + P] |= weak
    return out


# --- kernel K7 (kernels.reduce_marks) --------------------------------------

MARKS_READ_LEN = 100


def marks_graph(seed: int = 0, hub: int = 5000, sinks: int = 600):
    """(src, dst, ovl) int32 sorted by (src, dst), and n_vertices, for
    kernel K7 (read length MARKS_READ_LEN, sl = 100 - ovl):

      * an overlap graph of 1,500 reads at distinct random positions of a
        30 kbp genome, an edge i -> j where 0 < pos[j] - pos[i] <= 60;
      * a hub: vertex h0 -> h1 (sl 1), h1 -> each of ``hub`` leaves (sl
        1), and h0 -> every third leaf (sl 2), so that the expansion of
        h0 -> h1 alone is ``hub`` slots, more than one tile of K7, and
        marks h0's edges to the leaves;
      * a vertex with edges to ``sinks`` vertices that have no out-edges:
        a run of zero-count edges in the middle of the edge order."""
    rng = np.random.default_rng(seed)
    n_reads = 1500
    pos = np.sort(rng.choice(30_000, n_reads, replace=False))
    edges = []
    for i in range(n_reads):
        for j in range(i + 1, n_reads):
            d = pos[j] - pos[i]
            if d > 60:
                break
            edges.append((i, j, 100 - d))
    # the zero-count run, from a read in the middle of the genome's order
    sink0 = n_reads
    mid = n_reads // 2
    edges += [(mid, sink0 + s, 95) for s in range(sinks)]
    h0 = sink0 + sinks
    h1, leaf0 = h0 + 1, h0 + 2
    edges.append((h0, h1, 99))
    edges += [(h1, leaf0 + x, 99) for x in range(hub)]
    edges += [(h0, leaf0 + x, 98) for x in range(0, hub, 3)]
    e = np.array(sorted(edges), np.int64)
    return (e[:, 0].astype(np.int32), e[:, 1].astype(np.int32),
            e[:, 2].astype(np.int32), leaf0 + hub)


def slot_splits(offsets: np.ndarray, src: np.ndarray, n_reads: int = 1500):
    """Cut points of K7's slot space [0, total), each list ending at
    total: mid-edge in the hub's expansion, at an edge's first slot, on
    both sides of the zero-count run (an edge of read n_reads // 2 to a
    sink vertex), at every 1,000th slot, and one range."""
    total = int(offsets[-1])
    counts = np.diff(offsets, prepend=0)
    first = offsets - counts                 # each edge's first slot
    hub = int(np.argmax(counts))
    zero = np.flatnonzero((counts == 0) & (src == n_reads // 2))
    before, after = int(first[zero[0]]), int(offsets[zero[-1]])
    busy = np.flatnonzero(counts > 3)
    at_edge = int(first[busy[len(busy) // 2]])
    return {
        "one": [total],
        "mid-hub": [int(first[hub]) + 1234, int(first[hub]) + 2 * 1234, total],
        "edge-first": [at_edge, at_edge + 1, total],
        "zero-run": [max(before - 3, 0), after + 3, total],
        "every-1000": list(range(1000, total, 1000)) + [total],
    }


# K12 (the dedup): equal reads, a read equal to another's reverse
# complement, reverse palindromes, one read, poly-T reads; ragged reads
# whose words agree and whose lengths differ, and a width whose key
# string ends inside its last word
COUNTS_CASES = ("hub", "empty_runs", "tie", "last", "padding", "random",
                "long")
COUNTS_READ_LEN = 100
I32_MAX = 2**31 - 1


def counts_case(case: str, ragged: bool, seed: int = 21):
    """(src, dst, ovl, n_vertices, read_len) of a K6 case: int32 edges
    sorted by (src, dst), padding rows (INT32_MAX, INT32_MAX, 0) at the
    tail; read_len COUNTS_READ_LEN, or (V,) int32 lengths in [80, 120]
    when ``ragged`` (long: 500, or lengths in [450, 550]). Edges are made
    as (src, dst, sl) and ovl = len(src) - sl, so a case's sl ties hold
    under either length:

      * hub: vertex 7 with out-edges to 30 vertices (a long run to
        bisect) and 25 vertices' edges into it;
      * empty_runs: vertices without out-edges at the start (0-4), in a
        run (15-20) and at the end (35-39), all of them also dst;
      * tie: bounds equal to an sl of dst's run (the upper bound's tie),
        repeated sl in a run, and a bound below dst's smallest sl;
      * last: the last vertex with out-edges, and many edges into it;
      * padding: every row padding;
      * random: 60 vertices, 300 random edges;
      * long: 60 vertices, 300 random edges of sl in [1, 400): bounds
        and sl on both sides of 255 (K6's 8-bit copy saturates there)."""
    rng = np.random.default_rng(seed + COUNTS_CASES.index(case))
    V = {"hub": 40, "empty_runs": 40, "tie": 12, "last": 30,
         "padding": 6, "random": 60, "long": 60}[case]
    edges = []                          # (src, dst, sl)

    def rand(n, srcs, dsts, lo=1, hi=60):
        for _ in range(n):
            edges.append((int(rng.choice(srcs)), int(rng.choice(dsts)),
                          int(rng.integers(lo, hi))))

    every = np.arange(V)
    if case == "hub":
        for d in rng.choice(np.delete(every, 7), 30, replace=False):
            edges.append((7, int(d), int(rng.integers(1, 60))))
        for s in rng.choice(np.delete(every, 7), 25, replace=False):
            edges.append((int(s), 7, int(rng.integers(1, 60))))
        rand(80, every, every)
    elif case == "empty_runs":
        out = np.setdiff1d(every, np.r_[0:5, 15:21, 35:40])
        rand(120, out, every)
    elif case == "tie":
        # 1 -> 2 at sl 10 with maxsl(1) = 30: bound 20 in 2's run, which
        # holds sl 19, 20, 20 and 21; 1 -> 3 at sl 30: bound 0, below
        # every sl of 3's run
        edges += [(1, 2, 10), (1, 3, 30), (2, 4, 19), (2, 5, 20),
                  (2, 6, 20), (2, 7, 21), (3, 8, 5), (3, 9, 6),
                  (4, 2, 3), (4, 5, 23), (5, 2, 3), (5, 6, 1), (6, 7, 2)]
    elif case == "last":
        for d in rng.choice(V - 1, 12, replace=False):
            edges.append((V - 1, int(d), int(rng.integers(1, 60))))
        for s in rng.choice(V - 1, 20, replace=False):
            edges.append((int(s), V - 1, int(rng.integers(1, 60))))
        rand(60, every[:-1], every)
    elif case == "random":
        rand(300, every, every)
    elif case == "long":
        rand(300, every, every, 1, 400)
    long = 400 if case == "long" else 0
    lens = (rng.integers(80 + long, 121 + long, V).astype(np.int32)
            if ragged else None)
    e = np.array(edges, np.int64).reshape(-1, 3)
    order = np.lexsort((e[:, 1], e[:, 0]))
    e = e[order]
    length = (lens[e[:, 0]] if ragged else COUNTS_READ_LEN + long)
    pad = 5 if case != "padding" else 8
    src = np.r_[e[:, 0], np.full(pad, I32_MAX)].astype(np.int32)
    dst = np.r_[e[:, 1], np.full(pad, I32_MAX)].astype(np.int32)
    ovl = np.r_[length - e[:, 2], np.zeros(pad)].astype(np.int32)
    return src, dst, ovl, V, (lens if ragged else COUNTS_READ_LEN + long)


DEDUP_CASES = ("all_equal", "rc_of_another", "palindromes", "single",
               "poly_t", "ragged_poly_t", "ragged_same_words", "ragged_wide",
               "same_lead", "ragged_same_lead", "long")
# K14 (the longest overlap per pair)
REDUCE_CASES = ("periodic", "no_ok", "all_ok", "capacity", "wide")


def _rc(row, n):
    """Reverse complement of the first n codes, zero-padded to len(row)."""
    out = np.zeros_like(row)
    out[:n] = (3 - row[:n])[::-1]
    return out


def dedup_case(case: str, seed: int = 5):
    """(reads (N, L) int32, lengths (N,) int32 or None) of a dedup case."""
    rng = np.random.default_rng(seed)
    L = 40
    rand = rng.integers(0, 4, (12, L), dtype=np.int32)
    if case == "all_equal":
        return np.repeat(rand[:1], 9, axis=0), None
    if case == "rc_of_another":
        return np.concatenate([rand, _rc(rand[3], L)[None],
                               _rc(rand[7], L)[None]]), None
    if case == "palindromes":
        half = rng.integers(0, 4, (4, L // 2), dtype=np.int32)
        pal = np.concatenate([half, (3 - half)[:, ::-1]], axis=1)
        return np.concatenate([pal, pal[:2], rand[:4]]), None
    if case == "single":
        return rand[:1], None
    if case == "poly_t":
        return np.concatenate([np.full((2, L), 3, np.int32),
                               np.zeros((1, L), np.int32), rand[:5]]), None
    if case == "same_lead":
        # one first 64-bit key (32 bases), told apart in the last word
        # only, some twice; A-led, so that each read is its own canonical
        lead = rand[:7].copy()
        lead[:, :32] = 0
        lead[:, 32:] = rng.integers(0, 4, (7, L - 32))
        lead[3] = lead[1]
        return np.concatenate([lead, lead[:2], rand[7:]]), None
    if case == "long":
        # a key string past the widest element: K12 sorts it in passes
        L = 300
        base = rng.integers(0, 4, (5, L), dtype=np.int32)
        reads = np.concatenate([base, base[:2], base[:4]])
        reads[5, 250:] = rng.integers(0, 4, 50)      # differs late only
        reads[8, :10] = rng.integers(0, 4, 10)       # differs early only
        return np.concatenate([reads, _rc(reads[0], L)[None]]), None
    lens = rng.integers(20, L + 1, 12).astype(np.int32)
    if case == "ragged_poly_t":
        reads = np.concatenate([np.full((3, L), 3, np.int32), rand[:5]])
        lens = np.concatenate([[L, 30, 30], lens[:5]]).astype(np.int32)
    elif case == "ragged_same_words":
        # reads ending in A cut by up to three bases: the same packed
        # words, told apart by the length alone; and their copies
        ends_a = rand.copy()
        ends_a[:, 30:] = 0
        reads = np.concatenate([ends_a[:4], ends_a[:4], ends_a[:4], rand])
        lens = np.concatenate([[33, 34, 35, 40], [32, 34, 31, 40],
                               [33, 34, 35, 40], lens]).astype(np.int32)
    elif case == "ragged_same_lead":
        # one length and first 64-bit key, told apart late or by the
        # length alone
        lead = np.repeat(rand[:1], 8, axis=0)
        lead[:, 34:] = rng.integers(0, 4, (8, L - 34))
        lead[2] = lead[1]
        reads = np.concatenate([lead, rand[:4]])
        lens = np.concatenate([[40, 40, 40, 40, 39, 39, 38, 40],
                               lens[:4]]).astype(np.int32)
    else:                               # a width whose key string ends
        L = 159                         # inside word 10: 6 keys with lengths
        base = rng.integers(0, 4, (6, L), dtype=np.int32)
        reads = np.concatenate([base, base[:3], rng.integers(
            0, 4, (3, L), dtype=np.int32)])
        reads[6:9, 150:] = rng.integers(0, 4, (3, 9))
        lens = np.array([159, 158, 150, 159, 100, 80, 159, 158, 150, 159, 40,
                         1], np.int32)
        reads = np.concatenate([reads, _rc(reads[0], 159)[None],
                                _rc(reads[1], 158)[None]])
        lens = np.concatenate([lens, [159, 158]]).astype(np.int32)
    # codes past a read's length are not part of it
    past = np.arange(reads.shape[1])[None, :] >= lens[:, None]
    reads = np.where(past, rng.integers(0, 4, reads.shape), reads)
    return reads.astype(np.int32), lens


def seed_case(ragged: bool, seed: int = 9, L: int = 60, M: int = 10):
    """(reads (M, L) int32, valid (M,) bool, lengths or None) of a seed-row
    case: a poly-T read, two equal reads, two invalid ones."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (M, L), dtype=np.int32)
    reads[2] = 3                        # poly-T: all-ones seed keys
    reads[3] = reads[1]                 # equal keys across reads
    valid = np.ones(M, bool)
    valid[[4, 8]] = False
    lens = None
    if ragged:
        lens = rng.integers(30, L + 1, M).astype(np.int32)
        lens[2] = L
        reads[np.arange(L)[None, :] >= lens[:, None]] = 0
    return reads, valid, lens


def reduce_case(case: str, seed: int = 13):
    """(ok, cand_a, cand_b, cand_ovl, read_len, n_vertices, capacity) of a
    K14 case (numpy)."""
    rng = np.random.default_rng(seed)
    L, V, n = 100, 64, 400
    a = rng.integers(0, V, n)
    b = rng.integers(0, V, n)
    ovl = rng.integers(40, L, n)
    ok = rng.random(n) < 0.6
    cap = n
    if case == "periodic":      # pairs verified at several overlaps
        a[:60], b[:60] = 5, 9
        a[60:90], b[60:90] = 7, 2
        ok[:90] = True
    elif case == "no_ok":
        ok[:] = False
    elif case == "all_ok":
        ok[:] = True
    elif case == "capacity":
        cap = n + 1000
    elif case == "wide":        # 2 db + ob > 63: the two-sort order
        V = (1 << 30) + 7
        a = rng.integers(V - 50, V, n)
        b = rng.integers(V - 50, V, n)
        a[:40], b[:40] = V - 1, V - 2
    return (ok, a.astype(np.int32), b.astype(np.int32), ovl.astype(np.int32),
            L, V, cap)


# --- kernel K18 (kernels.chain_links, kernels.chain_cut) -------------------

CHAIN_CASES = ("random", "rings", "branches", "empty", "padding", "real",
               "unsorted", "no_edges")


def chain_case(case: str, seed: int = 0):
    """(src, dst, ovl int32 edge rows, V) for unitig labeling, sorted by
    (src, dst) with 7 padding rows at the end unless said:

      random    chains, branches and a ring among 400 vertices, and
                isolated vertices;
      rings     three cycles (one of two vertices, one of three, one of
                50) and a chain that runs into the third, which then
                holds no cycle of chain edges;
      branches  vertices of out- and in-degree 2 and 3 on both ends of
                chains, and a vertex with a self-loop;
      empty     no vertex and no edge;
      padding   300 vertices and only padding rows;
      real      random's rows without padding (the traverse stage's
                input);
      unsorted  random's rows and padding in a random order;
      no_edges  50 vertices and no row at all."""
    rng = np.random.default_rng(seed)
    I32 = 2**31 - 1
    edges = {}
    if case in ("random", "real", "unsorted"):
        V = 400
        order = rng.permutation(V)
        for i in range(300):
            if rng.random() < 0.9:
                edges[(int(order[i]), int(order[i + 1]))] = int(
                    rng.integers(20, 60))
        ring = [int(v) for v in order[310:330]]
        for a, b in zip(ring, ring[1:] + ring[:1]):
            edges[(a, b)] = 33
        for _ in range(40):
            a, b = (int(x) for x in rng.integers(0, V, 2))
            if a != b:
                edges[(a, b)] = int(rng.integers(20, 60))
    elif case == "rings":
        V = 120
        for ring in ([7, 3], [11, 40, 2], list(range(60, 110))):
            for a, b in zip(ring, ring[1:] + ring[:1]):
                edges[(a, b)] = int(rng.integers(20, 60))
        for a, b in ((20, 21), (21, 22), (22, 60)):
            edges[(a, b)] = 41
    elif case == "branches":
        V = 200
        for a in range(0, 150, 3):
            edges[(a, a + 1)] = 30
            edges[(a + 1, a + 2)] = 31
            if a % 9 == 0:
                edges[(a, a + 2)] = 25           # out 2 at a, in 2 at a + 2
            if a % 27 == 0:
                edges[(a, 199)] = 26             # out 3 at a, in many at 199
        edges[(170, 170)] = 44                   # a self-loop
        edges[(171, 172)] = 45
    elif case == "empty":
        V = 0
    elif case == "no_edges":
        V = 50
    else:
        V = 300
    e = sorted(edges)
    pad = 0 if case in ("empty", "real", "no_edges") else 7
    src = np.array([a for a, _ in e] + [I32] * pad, np.int32)
    dst = np.array([b for _, b in e] + [I32] * pad, np.int32)
    ovl = np.array([edges[x] for x in e] + [0] * pad, np.int32)
    if case == "unsorted":
        perm = rng.permutation(len(src))
        src, dst, ovl = src[perm], dst[perm], ovl[perm]
    return src, dst, ovl, V


# --- kernel K8 (kernels.canonical_reads) ------------------------------------

# the read widths of K8's cases: one code, a word less one, one word, a word
# and one, the main paths' 100 and 150, the dedup's strings in passes (300),
# and a tile of 4 reads (1000)
CANON_LENGTHS = (1, 15, 16, 17, 100, 150, 300, 1000)


def canon_tile_reads(L: int) -> int:
    """Reads a tile of K8 (kTileCodes and kMaxTileReads in
    kernels/csrc/canonical_reads.cu)."""
    return min(512, max(1, 4096 // L)) if L else 512


def canon_case(L: int, ragged: bool, seed: int = 17):
    """(reads (N, L) int32, lengths (N,) int32 or None) for K8: N three
    and a half tiles and one read (not a multiple of a tile), random
    codes, reads equal to their own reverse complement (palindromes; the
    choice falls to the forward words) and copies of reads; ragged
    lengths from 0 to L, with random codes past each length."""
    rng = np.random.default_rng(seed + L)
    R = canon_tile_reads(L)
    N = 3 * R + R // 2 + 1
    reads = rng.integers(0, 4, (N, L), dtype=np.int32)
    lens = rng.integers(0, L + 1, N).astype(np.int32)
    lens[:3] = (0, L, max(L - 1, 0))
    for i in range(3, min(N, 9)):       # palindromes of an even length
        n = (L if not ragged else int(lens[i])) // 2 * 2
        half = rng.integers(0, 4, n // 2, dtype=np.int32)
        reads[i, :n] = np.concatenate([half, (3 - half)[::-1]])
        if ragged:
            lens[i] = n
    reads[N // 2 : N // 2 + 3] = reads[3:6]
    lens[N // 2 : N // 2 + 3] = lens[3:6]
    return reads, (lens if ragged else None)


# K16's membership table of the solid keys (kernels/csrc/weak_windows.cu):
# a key x of B = 2k bits goes by its mix to bucket mix(x) >> (B - bits)
SOLID_MIX = 0x9E3779B97F4A7C15


def solid_mix(x: int, B: int) -> int:
    """The kernel's mix of a B-bit key: x ^= x >> B/2, then times
    SOLID_MIX mod 2^B (a bijection of [0, 2^B))."""
    x ^= x >> (B // 2)
    return (x * SOLID_MIX) & ((1 << B) - 1)


def solid_unmix(h: int, B: int) -> int:
    """The key whose mix is h: the inverse multiply, then x ^= x >> B/2
    undone."""
    x = (h * pow(SOLID_MIX, -1, 1 << B)) & ((1 << B) - 1)
    y = x
    for _ in range(3):
        y = x ^ (y >> (B // 2))
    return y


def kmer_codes(key: int, k: int) -> np.ndarray:
    """The k codes (0-3) of a 2k-bit key, first base in the top bits."""
    return np.array([(key >> (2 * (k - 1 - i))) & 3 for i in range(k)],
                    np.int32)


def crowded_bucket_table(k: int, bucket: int, n_crowd: int, seed: int = 0):
    """(keys, counts, crowd): a sorted table of canonical k-mer keys whose
    membership table (kernels.solid_bits of its size) puts ``n_crowd`` of
    them in one bucket, past its eight words; the crowd's counts alternate
    3 and 1 (threshold 2 keeps half), the rest count 3."""
    from sage2_tpu_torch.kernels import solid_bits

    rng = np.random.default_rng(seed)
    B = 2 * k

    def canonical(x):
        rc = sum((3 - ((x >> (2 * i)) & 3)) << (2 * (k - 1 - i))
                 for i in range(k))
        return x <= rc

    base = [int(x) for x in rng.integers(0, 1 << B, 4000) if canonical(int(x))]
    bits = solid_bits(len(base) + 4 * n_crowd, k)
    low = B - bits
    crowd = []
    for v in range(1, 1 << low):
        x = solid_unmix(bucket << low | v, B)
        if canonical(x):
            crowd.append(x)
            if len(crowd) == n_crowd:
                break
    keys = np.unique(np.array(base + crowd, np.int64))
    if solid_bits(len(keys), k) != bits:
        raise ValueError("the table's size changed its bucket count")
    counts = np.full(len(keys), 3, np.int32)
    where = np.searchsorted(keys, np.array(crowd, np.int64))
    counts[where[1::2]] = 1
    return keys, counts, np.array(crowd, np.int64)


# K15's tables around its tiles (``kernels.prune_tile()`` entries on the
# card): T from one entry to many tiles; every entry kept, none, a few in
# the last tile alone, or mixed
PRUNE_SIZES = ("one", "tile_minus_one", "tile", "tile_plus_one",
               "three_tiles")
PRUNE_KEEPS = ("mixed", "all", "none", "last_tile")


def prune_size(size: str, tile: int) -> int:
    """The entries of the PRUNE_SIZES case ``size`` (or "many": 300
    tiles and 3) at tiles of ``tile`` entries."""
    return {"one": 1, "tile_minus_one": tile - 1, "tile": tile,
            "tile_plus_one": tile + 1, "three_tiles": 3 * tile + 517,
            "many": 300 * tile + 3}[size]


def prune_case(T: int, keep: str, tile: int, seed: int = 0):
    """(keys, counts): a sorted table of T int64 keys with int32 counts
    of which those >= 2 are kept as ``keep`` says (tiles of ``tile``
    entries)."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(1 << 40, size=T, replace=False)).astype(
        np.int64)
    counts = rng.integers(1, 4, size=T).astype(np.int32)
    if keep == "all":
        counts[:] = 5
    elif keep == "none":
        counts[:] = 1
    elif keep == "last_tile":
        counts[:] = 1
        last = (T - 1) // tile * tile
        counts[last + rng.integers(0, T - last, size=3)] = 5
    return keys, counts


# K20's heads: sorted requests around its tiles (``kernels.heads_tile()``
# on the card), INT32_MAX the invalid ones
I32_MAX_REQ = 2**31 - 1
HEADS_CASES = ("one", "tile_minus_one", "tile_plus_one", "one_run",
               "run_into_tail", "tail_mid_tile", "tail_on_boundary",
               "all_invalid", "minus_one_first", "many_tiles")


def heads_case(case: str, tile: int, seed: int = 0):
    """(s_key int32, s_ord int64): sorted requests and a permutation of
    their input positions, at tiles of ``tile`` requests."""
    rng = np.random.default_rng(seed + len(case))
    H = tile
    if case == "one":
        k = np.array([3])
    elif case == "tile_minus_one":
        k = np.sort(rng.integers(0, 900, size=H - 1))
    elif case == "tile_plus_one":
        k = np.sort(rng.integers(0, 900, size=H + 1))
    elif case == "one_run":             # one run over every tile
        k = np.full(3 * H + 5, 11)
    elif case == "run_into_tail":       # a valid run across tiles to the tail
        k = np.concatenate([np.arange(700), np.full(2 * H, 700),
                            np.full(H + 33, I32_MAX_REQ)])
    elif case == "tail_mid_tile":
        k = np.sort(rng.integers(0, 5000, size=4 * H))
        k[H + 999 * H // 1024:] = I32_MAX_REQ
    elif case == "tail_on_boundary":
        k = np.sort(rng.integers(0, 50, size=3 * H))
        k[2 * H:] = I32_MAX_REQ
    elif case == "all_invalid":
        k = np.full(2 * H + 1, I32_MAX_REQ)
    elif case == "minus_one_first":     # -1 before the first key: no head
        k = np.concatenate([np.full(H + 3, -1), [4, 4, 9]])
    elif case == "many_tiles":
        k = np.sort(rng.integers(0, 200, size=5 * H + 77))
    else:
        raise ValueError(case)
    return k.astype(np.int32), rng.permutation(k.size).astype(np.int64)
