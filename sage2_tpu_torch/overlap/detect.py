"""All-pairs exact suffix-prefix overlap detection (port of
sage2_tpu/overlap/detect.py, fixed-length reads).

Every read contributes R = g + n_pos seed rows: ENTRY rows at prefix
offsets o in [0, g) and QUERY rows at probe positions p in {g, 2g, ...};
a hit (a, p) x (b, o) means an overlap starting at p0 = p - o in read a,
and every true overlap >= min_overlap has exactly one such pair. The
rows are sorted by their exact seed key (``torch.sort``), and kernel K3
does the rest: each query's entry range, the candidate expansion and
the word-wise verify. The longest overlap per (src, dst) is kept.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sage2_tpu_torch import kernels
from sage2_tpu_torch.ops import bitpack
from sage2_tpu_torch.ops.sort import I32_MAX

_RAGGED = "ragged reads are not ported yet (ROADMAP Queue 1 item 10)"


class OverlapResult(NamedTuple):
    """Edge list with static capacity, sorted by (src, dst).

    src, dst: int32 vertex ids (padding rows INT32_MAX); ovl: int32
    overlap length (padding 0); n_edges, n_candidates, n_verified: ints;
    overflow: candidates exceeded the capacity (only possible with an
    explicit ``capacity`` to find_overlaps).
    """

    src: torch.Tensor
    dst: torch.Tensor
    ovl: torch.Tensor
    n_edges: int
    n_candidates: int
    n_verified: int
    overflow: bool


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


def build_seed_rows(
    reads2: torch.Tensor, valid2: torch.Tensor, s: int, geo: JoinGeometry
):
    """Seed rows of the join for (M, L) reads.

    Returns (keys (M, R) int64, live (M, R) bool, payload (M, R, Wt + 2)
    int32). Row t of read m has id m * R + t. Payload row = [aw_0 ..
    aw_{Wt-1}, xw, len]: aw_t the word of bases [pos + 16 (trim + t),
    +16); xw is, for ENTRY rows, the read's first word (the B side of
    the prefix check), for QUERY rows the word ending at pos (base
    pos - 1 in its low 2 bits; the A side); len the read length (the
    reference's _row_payload, :562). Rows of invalid reads are not live.
    """
    M, L = reads2.shape
    g, n_pos, R = geo.g, geo.n_pos, geo.R
    positions = list(range(g)) + [g * (j + 1) for j in range(n_pos)]
    words0 = bitpack.pack_read_words(reads2)
    first = words0[:, 0]
    length = torch.full_like(first, L)
    keys, rows = [], []
    for i, pos in enumerate(positions):
        if pos + s > L:
            raise ValueError(f"seed position {pos} + seed length {s} "
                             f"exceeds read length {L}")
        keys.append(seed_keys(words0, s, pos))
        aw = [bitpack.word_at(words0, pos + 16 * (geo.trim + t))
              for t in range(geo.Wt)]
        if i < g:
            xw = first
        elif pos < 16:
            xw = first >> (2 * (16 - pos))
        else:
            xw = bitpack.word_at(words0, pos - 16)
        rows.append(_as_int32(torch.stack(aw + [xw, length], dim=1)))
    live = valid2[:, None].expand(M, R)
    return torch.stack(keys, dim=1), live, torch.stack(rows, dim=1)


def sorted_seed_rows(keys, live, geo: JoinGeometry):
    """The live seed rows in the reference's sort order: (s_keys int64,
    s_rows int32 row ids).

    The reference sorted (hi, lo, packed) with packed = tag | row id, so
    within a key entries (tag 0) precede queries, each by row id. Here
    the live rows are laid out in that order (entries, then queries,
    each by id) and sorted stably by key alone.
    """
    M, R = keys.shape
    g = geo.g
    ids = torch.arange(M * R, dtype=torch.int32,
                       device=keys.device).reshape(M, R)
    base = torch.cat([ids[:, :g][live[:, :g]], ids[:, g:][live[:, g:]]])
    s_keys, perm = torch.sort(keys.reshape(-1)[base], stable=True)
    return s_keys, base[perm]


def fused_join_core(keys, live, payload, geo: JoinGeometry,
                    min_overlap: int):
    """Sort the live seed rows and join them (kernel K3). Returns (ok,
    cand_a, cand_b, ovl, total), one entry per candidate."""
    s_keys, s_rows = sorted_seed_rows(keys, live, geo)
    return kernels.overlap_join(
        s_keys, s_rows, payload.reshape(-1, geo.Wt + 2), geo.R, geo.g,
        geo.trim, min_overlap,
    )


def _reduce_fused(ok, cand_a, cand_b, cand_ovl, read_len: int,
                  capacity: int):
    """Longest overlap per (src, dst), sorted by (src, dst), padded to
    ``capacity`` rows (INT32_MAX, INT32_MAX, 0). Returns (src, dst, ovl,
    n_edges)."""
    a = cand_a[ok].to(torch.int64)
    b = cand_b[ok].to(torch.int64)
    v = cand_ovl[ok].to(torch.int64)
    # sort by (src, dst, ovl): ovl first, then stably by (src, dst)
    o1 = torch.sort(v, stable=True).indices
    o2 = torch.sort((a[o1] << 32) | b[o1], stable=True).indices
    order = o1[o2]
    a, b, v = a[order], b[order], v[order]
    is_last = torch.ones_like(a, dtype=torch.bool)
    is_last[:-1] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    n_edges = int(is_last.sum())
    dev = cand_a.device
    src = torch.full((capacity,), I32_MAX, dtype=torch.int32, device=dev)
    dst = torch.full((capacity,), I32_MAX, dtype=torch.int32, device=dev)
    ovl = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    src[:n_edges] = a[is_last].to(torch.int32)
    dst[:n_edges] = b[is_last].to(torch.int32)
    ovl[:n_edges] = v[is_last].to(torch.int32)
    return src, dst, ovl, n_edges


def _detect(reads2, valid2, min_overlap, seed_len, stride, capacity_of):
    M, L = reads2.shape
    s = min(seed_len, min_overlap, 32)
    geo = join_geometry(L, min_overlap, s, stride)
    if M * geo.R >= (1 << 31) - 1:
        raise ValueError(f"seed rows {M * geo.R} overflow 31-bit row ids")
    keys, live, payload = build_seed_rows(reads2, valid2, s, geo)
    ok, cand_a, cand_b, ovl, total = fused_join_core(
        keys, live, payload, geo, min_overlap)
    C = capacity_of(total)
    if total > C:
        # the reference keeps only the first C candidate slots
        ok, cand_a, cand_b, ovl = ok[:C], cand_a[:C], cand_b[:C], ovl[:C]
    src, dst, e_ovl, n_edges = _reduce_fused(ok, cand_a, cand_b, ovl, L, C)
    return OverlapResult(src, dst, e_ovl, n_edges, total,
                         int(ok.sum()), total > C)


def find_overlaps(
    reads2: torch.Tensor,
    valid2: torch.Tensor,
    min_overlap: int,
    seed_len: int = 32,
    capacity: int = 1 << 20,
    stride: Optional[int] = None,
    lengths: Optional[torch.Tensor] = None,
) -> OverlapResult:
    """All maximal proper exact suffix-prefix overlaps >= min_overlap of
    the valid rows of (M, L) int32 ``reads2``, with a fixed candidate
    ``capacity`` (``overflow`` set when exceeded)."""
    if lengths is not None:
        raise NotImplementedError(_RAGGED)
    return _detect(reads2, valid2, min_overlap, seed_len, stride,
                   lambda total: capacity)


def find_overlaps_auto(
    reads2: torch.Tensor,
    valid2: torch.Tensor,
    min_overlap: int,
    seed_len: int = 32,
    min_capacity: int = 1 << 14,
    stride: Optional[int] = None,
    lengths: Optional[torch.Tensor] = None,
) -> OverlapResult:
    """find_overlaps with the reference's self-sizing capacity: start at
    16 candidates per read on a 64k grain and, when the candidates
    exceed it, take the exact count plus 5% (rounded to the grain).

    The capacity sets the length of the padded edge arrays, as in the
    reference. K3's count pass knows the exact candidate count before
    anything is written, so the retry costs no second join here.
    """
    if lengths is not None:
        raise NotImplementedError(_RAGGED)
    grain = 1 << 16

    def round_up(n):
        return max(min_capacity, -(-int(n) // grain) * grain)

    def capacity_of(total: int) -> int:
        cap = round_up(16 * reads2.shape[0])
        while total > cap:
            cap = max(round_up(total * 1.05), cap + grain)
        return cap

    return _detect(reads2, valid2, min_overlap, seed_len, stride,
                   capacity_of)
