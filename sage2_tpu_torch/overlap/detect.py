"""All-pairs exact suffix-prefix overlap detection (port of
sage2_tpu/overlap/detect.py, fixed-length and ragged reads).

Every read contributes R = g + n_pos seed rows: ENTRY rows at prefix
offsets o in [0, g) and QUERY rows at probe positions p in {g, 2g, ...};
a hit (a, p) x (b, o) means an overlap starting at p0 = p - o in read a,
and every true overlap >= min_overlap has exactly one such pair. The
rows are sorted by their exact seed key (``torch.sort``), and kernel K3
does the rest: each query's entry range, the candidate expansion and
the word-wise verify. The longest overlap per (src, dst) is kept.

Ragged reads (``lengths``): a seed row is live only where its whole seed
lies inside its read, each payload row carries its read's length, and
K3 also marks the reads that lie whole inside another (``contained``).

The streamed join (``sage2_tpu_torch.stream``) takes another form, the
reference's bucket table (:226-500): entry seeds at the first g offsets
of each read, grouped by the top B bits of their 16-base word into a
2^B-bucket start table, and probed by each read's query seeds; every
candidate of a bucket is verified against the whole overlap from the
reads' unshifted words. The functions below are its plain definitions;
kernels K9 (``seed_table``) and K10 (``probe_join``) compute them on the
card. Both joins keep the longest overlap per (src, dst) with kernel K14
(``longest_edges``); K13 (``seed_rows``) builds the in-core join's rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sage2_tpu_torch import kernels
from sage2_tpu_torch.ops import bitpack
from sage2_tpu_torch.ops.sort import I32_MAX
from sage2_tpu_torch.utils.metrics import mark_part

# find_overlaps_auto's last good candidate capacity per problem shape
# (M, L, min_overlap, seed_len, stride, ragged): [capacity,
# steady_validated], as sage2_tpu/overlap/detect.py keeps it.
# steady_validated turns True once a validate=False call has confirmed
# the capacity on the caller's inputs; later validate=False calls then
# take it unchecked. Bounded; the oldest entry goes first.
_CAP_MEMO: dict = {}
_CAP_MEMO_MAX = 256


def _memo_put(key, value) -> None:
    if key not in _CAP_MEMO and len(_CAP_MEMO) >= _CAP_MEMO_MAX:
        _CAP_MEMO.pop(next(iter(_CAP_MEMO)))
    _CAP_MEMO[key] = value


class OverlapResult(NamedTuple):
    """Edge list with static capacity, sorted by (src, dst).

    src, dst: int32 vertex ids (padding rows INT32_MAX); ovl: int32
    overlap length (padding 0); n_edges, n_candidates, n_verified: ints;
    overflow: candidates exceeded the capacity (an explicit ``capacity``
    to find_overlaps, or a memoized one taken unchecked); contained:
    (M,) bool, the read lies whole inside a longer one (ragged reads;
    all False for fixed-length reads); n_contained: its count; n_dups:
    0, except with ``defer_dup_compact`` the rows of the edge arrays that
    are not the last of their (src, dst) pair (compact_reduced_edges
    drops them).
    """

    src: torch.Tensor
    dst: torch.Tensor
    ovl: torch.Tensor
    n_edges: int
    n_candidates: int
    n_verified: int
    overflow: bool
    contained: torch.Tensor
    n_contained: int
    n_dups: int = 0


def auto_stride(min_overlap: int, seed_len: int, pa: int) -> int:
    """Largest lossless probe stride g (offset seed stays inside the
    guaranteed match region: o + s <= min_overlap)."""
    s = min(seed_len, min_overlap, 32)
    return max(1, min(8, min_overlap - s + 1, pa))


class JoinGeometry(NamedTuple):
    """Static shape parameters of the strided join."""

    g: int          # probe stride == B-side offset count
    n_pos: int      # A-side probe positions (at g, 2g, ...)
    R: int          # seed rows per read == g + n_pos
    pa: int         # last possible overlap start == L - min_overlap
    Wp: int         # full verify-span words == ceil((L - g) / 16)
    trim: int = 0   # leading words guaranteed equal by the seed key

    @property
    def Wt(self) -> int:
        """Payload words per row after the seed trim."""
        return self.Wp - self.trim


def join_geometry(
    L: int, min_overlap: int, s: int, stride: Optional[int] = None
) -> JoinGeometry:
    if min_overlap >= L:
        raise ValueError(f"min_overlap ({min_overlap}) must be < read len ({L})")
    pa = L - min_overlap
    g = auto_stride(min_overlap, s, pa) if stride is None else stride
    if not 1 <= g <= min(16, min_overlap - s + 1):
        raise ValueError(f"stride {g} invalid for min_overlap={min_overlap}, "
                         f"seed={s}")
    n_pos = -(-pa // g)
    Wp = -(-(L - g) // 16)
    trim = min((1 if s >= 16 else 0) + (1 if s == 32 else 0), Wp)
    return JoinGeometry(g, n_pos, g + n_pos, pa, Wp, trim)


def _mask_top(word: torch.Tensor, n_bases: int) -> torch.Tensor:
    return word & ((0xFFFFFFFF << (32 - 2 * n_bases)) & 0xFFFFFFFF)


def seed_keys(words0: torch.Tensor, s: int, pos: int) -> torch.Tensor:
    """int64 key of the s-base seed at ``pos`` of every read: the
    reference's left-aligned (hi, lo) pair (seed_keys_at_positions)
    as one value with its top bit flipped, so int64 order is (hi, lo)
    order."""
    hi = bitpack.word_at(words0, pos)
    if s < 16:
        hi = _mask_top(hi, s)
    lo = torch.zeros_like(hi)
    if s > 16:
        lo = bitpack.word_at(words0, pos + 16)
        if s < 32:
            lo = _mask_top(lo, s - 16)
    return (hi - (1 << 31)) * (1 << 32) + lo


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same bits as int32."""
    return (words - (words >= 1 << 31).to(torch.int64) * (1 << 32)).to(
        torch.int32)


def word_at_positions(words0: torch.Tensor, positions) -> list:
    """The word of bases [p, p + 16) for each static p (int64 holding a
    uint32), from the unshifted packing ``words0`` (..., W); zero past
    the read's end (:226)."""
    return [bitpack.word_at(words0, p) for p in positions]


def seed_keys_from_words0(words0: torch.Tensor, s: int, positions,
                          L: int):
    """(hi, lo), each (..., len(positions)) int64 holding a uint32: the
    reference's left-aligned seed key at each position, masked to s
    bases (:258)."""
    for p in positions:
        if p + s > L:
            raise ValueError(f"seed position {p} + seed length {s} exceeds "
                             f"read length {L}")
    hi = torch.stack(word_at_positions(words0, positions), dim=-1)
    if s < 16:
        hi = _mask_top(hi, s)
    if s > 16:
        lo = torch.stack(
            word_at_positions(words0, [p + 16 for p in positions]), dim=-1)
        if s < 32:
            lo = _mask_top(lo, s - 16)
    else:
        lo = torch.zeros_like(hi)
    return hi, lo


def verify_candidates_words0(
    words0_a: torch.Tensor, cand_a: torch.Tensor, cand_p: torch.Tensor,
    b_words: torch.Tensor, L: int, max_p: Optional[int] = None,
    chunk: int = 1 << 20,
) -> torch.Tensor:
    """reads_a[a][p:] == reads_b[:L - p] for each candidate, from a's
    unshifted words (``words0_a`` (M, W), a row per candidate) and b's
    pre-gathered words ``b_words`` (C, W) (all int64 holding uint32):
    a's row is shifted by p // 16 words (only offsets up to max_p // 16,
    as the reference's select loop) and by p % 16 bases, then compared
    word by word over L - p bases (:287). ``chunk`` candidates at a
    time."""
    M, W = words0_a.shape
    max_w0 = (max_p if max_p is not None else L - 1) >> 4
    dev = words0_a.device
    t16 = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    C = cand_a.shape[0]
    out = torch.empty(C, dtype=torch.bool, device=dev)
    for c0 in range(0, C, chunk):
        sl = slice(c0, c0 + chunk)
        a = cand_a[sl].to(torch.int64).clamp(0, M - 1)
        p = cand_p[sl].to(torch.int64)
        aw = words0_a[a]
        w0 = p >> 4
        idx = t16 + w0[:, None]
        shifted = torch.where(idx < W, aw.gather(1, idx.clamp(max=W - 1)), 0)
        a_shift = torch.where((w0 <= max_w0)[:, None], shifted, aw)
        r2 = (2 * (p & 15))[:, None]
        nxt = torch.cat([a_shift[:, 1:], torch.zeros_like(a_shift[:, :1])],
                        dim=1)
        a_al = torch.where(
            r2 == 0, a_shift,
            ((a_shift << r2) & 0xFFFFFFFF) | (nxt >> (32 - r2)))
        diff = a_al ^ b_words[sl]
        vb = (2 * (L - p)[:, None] - 32 * t16).clamp(0, 32)
        shift = (32 - vb).clamp(0, 31)
        ok_word = (vb == 0) | torch.where(vb == 32, diff == 0,
                                          (diff >> shift) == 0)
        out[sl] = ok_word.all(dim=1)
    return out


def _pick_bucket_bits(n_table: int, n_queries: int, seed_bits: int,
                      bucket_bits: Optional[int]) -> int:
    """The reference's bucket count rule (:390): 2^B near sqrt(20 * Q *
    T), at least 2^18, capped by the seed bits and at 2^26."""
    if bucket_bits is None:
        bucket_bits = max(
            (20 * n_queries * max(n_table, 1)).bit_length() // 2, 18)
    return min(bucket_bits, seed_bits, 31, 26)


class SeedTable(NamedTuple):
    """Bucket index over sorted seed keys (:403).

    entry: (T,) entry ids in key-sorted order (invalid last); packed:
    (2^B, 2) int32, per bucket [start slot, entry count]; bucket_bits:
    B.
    """

    entry: torch.Tensor
    packed: torch.Tensor
    bucket_bits: int


def sort_hi_packed(hi: torch.Tensor, packed: torch.Tensor):
    """(hi, packed) sorted by hi, then packed (both int64 holding
    uint32), as the reference's two-operand sort: one int64 key with its
    top bit flipped, so signed order is the unsigned (hi, packed)
    order."""
    key = ((hi - (1 << 31)) << 32) | packed
    key = torch.sort(key).values
    return (key >> 32) + (1 << 31), key & 0xFFFFFFFF


def build_seed_table(p_hi: torch.Tensor, p_valid: torch.Tensor,
                     bucket_bits: int, first_id: int = 0) -> SeedTable:
    """Group the seeds by the top ``bucket_bits`` of ``hi`` (invalid ones
    after every valid one) and build the bucket start table (:416).
    Probes return whole buckets, so only the grouping matters, not the
    full (hi, lo) order: the reference's ``p_lo`` is not taken. Entry
    ids count from ``first_id`` (a streamed entry block's first id)."""
    Mg = p_hi.shape[0]
    if first_id + Mg >= 1 << 31:
        raise ValueError(f"seed table too large: entry ids up to "
                         f"{first_id + Mg} >= 2^31")
    q_hi = torch.where(p_valid, p_hi, 0xFFFFFFFF)
    packed = torch.where(p_valid, 0, 1 << 31) | (first_id + torch.arange(
        Mg, device=p_hi.device))
    b_hi, b_packed = sort_hi_packed(q_hi, packed)
    n_valid = int(p_valid.sum())
    b_val = (torch.arange(Mg, device=p_hi.device) < n_valid).to(torch.int32)
    return table_from_sorted(b_hi, b_packed & 0x7FFFFFFF, b_val, bucket_bits)


def table_from_sorted(b_hi: torch.Tensor, b_entry: torch.Tensor,
                      b_val: torch.Tensor, bucket_bits: int) -> SeedTable:
    """Bucket start table over an already sorted entry list, valid
    entries first (:446): each bucket's first valid slot by a scatter
    min, empty buckets filled from the right by a reverse cummin, the
    end at n_valid."""
    B = bucket_bits
    Mg = b_hi.shape[0]
    nb = 1 << B
    dev = b_hi.device
    bucket = b_hi >> (32 - B)
    tbl = torch.full((nb + 1,), Mg, dtype=torch.int64, device=dev)
    tbl.scatter_reduce_(0, torch.where(b_val == 1, bucket, nb),
                        torch.arange(Mg, dtype=torch.int64, device=dev),
                        "amin")
    tbl[nb] = min(int(tbl[nb]), int(b_val.sum()))
    start = torch.cummin(tbl.flip(0), 0).values.flip(0)
    packed = torch.stack([start[:-1], start[1:] - start[:-1]], dim=1)
    return SeedTable(b_entry, packed.to(torch.int32), B)


def probe_seed_table(st: SeedTable, a_hi: torch.Tensor,
                     a_row_valid: torch.Tensor):
    """(bucket start slot, candidate count) of each query seed; count 0
    for an invalid row (:476). a_hi (..., P), a_row_valid (...,)."""
    row = st.packed[a_hi >> (32 - st.bucket_bits)]
    lo_idx = row[..., 0]
    counts = torch.where(a_row_valid[..., None], row[..., 1], 0)
    return lo_idx, counts


def build_seed_rows(
    reads2: torch.Tensor, valid2: torch.Tensor, s: int, geo: JoinGeometry,
    lengths: Optional[torch.Tensor] = None, split=None,
):
    """The join's seed rows of (M, L) reads (kernel K13): (s_keys int64,
    s_rows int32, payload (M, R, Wt + 2) int32).

    Row t of read m has id m * R + t. Payload row = [aw_0 .. aw_{Wt-1},
    xw, len]: aw_t the word of bases [pos + 16 (trim + t), +16); xw is,
    for ENTRY rows, the read's first word (the B side of the prefix
    check), for QUERY rows the word ending at pos (base pos - 1 in its
    low 2 bits; the A side); len the read length (the reference's
    _row_payload, :562): L, or ``lengths[m]`` for ragged reads. Rows of
    invalid reads are not live, nor for ragged reads the rows whose seed
    passes the read's end (pos + s > len, :676-678).

    The reference sorted (hi, lo, packed) with packed = tag | row id, so
    within a key entries (tag 0) precede queries, each by row id: the
    live rows are laid out in that order and sorted stably by their
    exact seed key (``s_keys``, with ``s_rows`` their ids).
    """
    return kernels.seed_rows(
        reads2, valid2, None if lengths is None else lengths.to(torch.int32),
        s, geo.g, geo.n_pos, geo.trim, split=split)


def _reduce_fused(ok, cand_a, cand_b, cand_ovl, read_len: int,
                  capacity: int, n_vertices: int,
                  defer_dup_compact: bool = False, out=None, sources=None):
    """Longest overlap per (src, dst), sorted by (src, dst), padded to
    ``capacity`` rows (INT32_MAX, INT32_MAX, 0); vertex ids below
    ``n_vertices``, overlaps up to ``read_len`` (kernel K14, which packs
    (src, dst, ovl) into one sort key where they fit). Returns (src, dst,
    ovl, n_edges, n_dups), the counts ints.

    ``defer_dup_compact`` (:1015-1079): every ok row stays, sorted by
    (src, dst, ovl); a pair verified at several lengths keeps all of its
    rows, its last the longest; n_edges counts the pairs and n_dups the
    other rows, both 0-d int32 tensors that nothing waits for. Where
    ``n_vertices`` >= 2^(31 - bit_length(read_len)) the reference's
    packing does not fit and it returns the compacted list with n_dups 0
    (:1042-1048): so does this. ``out`` (deferred only): three
    (capacity,) int32 tensors to write into. ``sources`` (not deferred):
    see kernels.longest_edges."""
    if not defer_dup_compact:
        if out is not None:
            raise ValueError("out is taken only with defer_dup_compact")
        return (*kernels.longest_edges(ok, cand_a, cand_b, cand_ovl,
                                       n_vertices, read_len, capacity,
                                       sources), 0)
    if n_vertices >= 1 << (31 - int(read_len).bit_length()):
        src, dst, ovl, n_edges = kernels._longest_edges_unread(
            ok, cand_a, cand_b, cand_ovl, n_vertices, read_len, capacity,
            out)
        return src, dst, ovl, n_edges, torch.zeros_like(n_edges)
    return kernels.longest_edges_deferred(ok, cand_a, cand_b, cand_ovl,
                                          n_vertices, read_len, capacity,
                                          out=out)


def reduce_edge_candidates(ok, cand_a, cand_b, cand_ovl, read_len: int,
                           n_vertices: int, sources=None):
    """Longest overlap per (src, dst) of the ok candidates, sorted by
    (src, dst) and padded to the candidate count (:488). Returns (src,
    dst, ovl, n_edges); the first n_edges rows are the reference's.
    ``sources``: (lo, hi), the ids the sources lie in where narrower than
    all vertices (a streamed query chunk's reads; see
    kernels.longest_edges)."""
    return _reduce_fused(ok, cand_a, cand_b, cand_ovl, read_len,
                         ok.shape[0], n_vertices, sources=sources)[:4]


def _detect(reads2, valid2, min_overlap, seed_len, stride, capacity_of,
            lengths=None, split=None, defer_dup_compact=False):
    M, L = reads2.shape
    s = min(seed_len, min_overlap, 32)
    geo = join_geometry(L, min_overlap, s, stride)
    s_keys, s_rows, payload = build_seed_rows(reads2, valid2, s, geo,
                                              lengths, split)
    cont = (None if lengths is None else
            torch.zeros(M, dtype=torch.uint8, device=reads2.device))
    caps = []

    def limit(total):
        # the capacity from K3's count pass: like the reference, only the
        # first C candidate slots are written and marked for containment
        caps.append(capacity_of(total))
        return caps[0]

    ok, cand_a, cand_b, ovl, total = kernels.overlap_join(
        s_keys, s_rows, payload.reshape(-1, geo.Wt + 2), geo.R, geo.g,
        geo.trim, min_overlap, cont, limit)
    del s_keys, s_rows, payload
    mark_part(split, "join")
    C = caps[0]
    src, dst, e_ovl, n_edges, n_dups = _reduce_fused(
        ok, cand_a, cand_b, ovl, L, C, M, defer_dup_compact)
    mark_part(split, "reduce")
    if cont is None:
        contained, n_contained = torch.zeros(
            M, dtype=torch.bool, device=reads2.device), 0
    else:
        contained = cont.bool()
        n_contained = int(contained.sum())
    return OverlapResult(src, dst, e_ovl, int(n_edges), total,
                         int(ok.sum()), total > C, contained, n_contained,
                         int(n_dups))


def find_overlaps(
    reads2: torch.Tensor,
    valid2: torch.Tensor,
    min_overlap: int,
    seed_len: int = 32,
    capacity: int = 1 << 20,
    stride: Optional[int] = None,
    lengths: Optional[torch.Tensor] = None,
    defer_dup_compact: bool = False,
) -> OverlapResult:
    """All maximal proper exact suffix-prefix overlaps >= min_overlap of
    the valid rows of (M, L) int32 ``reads2``, with a fixed candidate
    ``capacity`` (``overflow`` set when exceeded). ``lengths``: (M,)
    per-read lengths of ragged (0-padded) reads; containments are then
    marked in ``contained``. ``defer_dup_compact``: the edge arrays keep
    the rows of a pair verified at several lengths, counted in
    ``n_dups`` (see _reduce_fused; compact_reduced_edges drops them)."""
    return _detect(reads2, valid2, min_overlap, seed_len, stride,
                   lambda total: capacity, lengths,
                   defer_dup_compact=defer_dup_compact)


def find_overlaps_auto(
    reads2: torch.Tensor,
    valid2: torch.Tensor,
    min_overlap: int,
    seed_len: int = 32,
    min_capacity: int = 1 << 14,
    stride: Optional[int] = None,
    lengths: Optional[torch.Tensor] = None,
    validate: bool = True,
    split=None,
) -> OverlapResult:
    """find_overlaps with the reference's self-sizing capacity
    (sage2_tpu/overlap/detect.py:1190-1277), which sets the length of
    the padded edge arrays.

    The first call of a problem shape starts at 16 candidates per read
    on a 64k grain and, when the candidates exceed that, takes the exact
    count plus 5% (rounded to the grain) until they fit; it then
    memoizes the tight capacity (count plus 5%) for the shape, and
    later calls start from it. ``validate=False`` with a memoized
    capacity: the first such call checks it once against its inputs
    (re-entering the sizing on overflow), later ones take it unchecked,
    so a denser same-shape input may then come back with ``overflow``
    set. K3's count pass knows the exact candidate count before anything
    is written, so the sizing costs no second join here. ``split``
    (utils.metrics.DeviceSplit) gets the ends of the seed rows, the row
    sort, the join and the reduction.
    """
    M = reads2.shape[0]
    grain = 1 << 16

    def round_up(n):
        return max(min_capacity, -(-int(n) // grain) * grain)

    key = (M, reads2.shape[1], min_overlap, seed_len, stride,
           lengths is not None)

    def capacity_of(total: int) -> int:
        memo = _CAP_MEMO.get(key)
        if not validate and memo is not None:
            if memo[1]:
                return memo[0]
            if total <= memo[0]:
                memo[1] = True
                return memo[0]
        cap = (memo[0] if memo else None) or round_up(16 * M)
        while total > cap:
            cap = max(round_up(total * 1.05), cap + grain)
        new_cap = round_up(total * 1.05)
        if memo is not None and memo[0] == new_cap:
            memo[1] = True
        else:
            _memo_put(key, [new_cap, False])
        return cap

    return _detect(reads2, valid2, min_overlap, seed_len, stride,
                   capacity_of, lengths, split)


def compact_reduced_edges(src, dst, ovl, read_len: int):
    """Host numpy fix-up of a deferred edge list with n_dups > 0 (:1082):
    drop every row but the last of each (src, dst) pair (the last holds
    the longest overlap); (src, dst, ovl) int32 arrays padded alike."""
    src, dst, ovl = (np.asarray(x) for x in (src, dst, ovl))
    keep = np.ones(src.shape[0], bool)
    keep[:-1] = (src[:-1] != src[1:]) | (dst[:-1] != dst[1:])
    keep &= src != I32_MAX
    kept = int(keep.sum())
    out = (np.full(src.shape[0], I32_MAX, np.int32),
           np.full(src.shape[0], I32_MAX, np.int32),
           np.zeros(src.shape[0], np.int32))
    for o, x in zip(out, (src, dst, ovl)):
        o[:kept] = x[keep]
    return out


def find_overlaps_stacked(
    reads3, valid3, min_overlap: int, seed_len: int = 32,
    capacity: int = 1 << 20, stride: Optional[int] = None, device="cuda",
):
    """K independent read shards (``reads3`` (K, M, L) int codes,
    ``valid3`` (K, M) bool, tensors or arrays; placed on ``device``)
    through the join at a fixed candidate ``capacity`` C, one shard after
    another on the current stream: the reference's
    find_overlaps_stacked (sage2_tpu/overlap/detect.py:1108-1156).

    Returns (src, dst, ovl (K, C) int32, n_edges, n_candidates,
    n_verified, n_dups (K,) int32, overflow (K,) bool), each shard's row
    as ``find_overlaps(..., capacity=C, defer_dup_compact=True)`` gives
    it. Between its first launch and its return nothing waits on the
    host: K13 and K3 run in their fixed-capacity modes (the live rows
    and the candidate total stay on the card) and K14 in its deferred
    mode, so a shard with n_dups > 0 still holds its duplicate rows
    (compact_stacked_result drops them). That is the GPU's counterpart
    of the reference's one dispatch for K shards: the host enqueues all
    K shards while the card works."""
    dev = torch.device(device)
    reads3 = torch.as_tensor(reads3, device=dev).to(torch.int32)
    valid3 = torch.as_tensor(valid3, device=dev).to(torch.bool)
    K, M, L = reads3.shape
    s = min(seed_len, min_overlap, 32)
    geo = join_geometry(L, min_overlap, s, stride)
    C = capacity
    src3, dst3, ovl3 = (torch.empty((K, C), dtype=torch.int32, device=dev)
                        for _ in range(3))
    counts = torch.empty((4, K), dtype=torch.int32, device=dev)
    overflow3 = torch.empty(K, dtype=torch.bool, device=dev)
    for k in range(K):
        s_keys, s_rows, payload, n_live = kernels.seed_rows_stacked(
            reads3[k], valid3[k], s, geo.g, geo.n_pos, geo.trim)
        ok, cand_a, cand_b, ovl, total = kernels.overlap_join_stacked(
            s_keys, s_rows, payload.reshape(-1, geo.Wt + 2), n_live, geo.R,
            geo.g, geo.trim, min_overlap, C)
        del s_keys, s_rows, payload
        _, _, _, n_edges, n_dups = _reduce_fused(
            ok, cand_a, cand_b, ovl, L, C, M, defer_dup_compact=True,
            out=(src3[k], dst3[k], ovl3[k]))
        counts[0, k] = n_edges
        counts[1, k] = total
        counts[2, k] = ok.sum()
        counts[3, k] = n_dups
        overflow3[k] = total > C
    return (src3, dst3, ovl3, counts[0], counts[1], counts[2], overflow3,
            counts[3])


def compact_stacked_result(out, read_len: int):
    """Host fix-up of find_overlaps_stacked's result (:1159): every shard
    with n_dups > 0 compacted (compact_reduced_edges). Returns (src, dst,
    ovl) (K, C) int32 numpy arrays."""
    src, dst, ovl = (_to_numpy(x).copy() for x in out[:3])
    for k in np.flatnonzero(_to_numpy(out[7])):
        src[k], dst[k], ovl[k] = compact_reduced_edges(src[k], dst[k],
                                                       ovl[k], read_len)
    return src, dst, ovl


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
