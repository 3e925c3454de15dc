"""Plain PyTorch versions of the CUDA kernels.

Each function has the signature of its kernel's wrapper in
``sage2_tpu_torch.kernels`` and returns bit-identical results. The
wrappers run these for tensors on the CPU (the tests, and
``device="cpu"``); on the card, ``chip_smoke.py`` holds each kernel
against its plain version. They repeat the kernel's arithmetic with
whole-tensor ops and are no yardstick of speed.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from sage2_tpu_torch.ops.sort import I32_MAX, unique_sorted_pairs, words_less
from sage2_tpu_torch.utils.metrics import mark_part

_U32 = 0xFFFFFFFF
I64_MAX = (1 << 63) - 1


def _forward_keys(reads: torch.Tensor, k: int) -> torch.Tensor:
    """Forward keys of every window, int64, top bit flipped when k == 32.

    The value is accumulated as a high part (first k - n_lo bases) and a
    low part (last n_lo <= 16 bases), each below 2**32, so no int64
    arithmetic overflows: for k <= 31 the key is hi * 4**n_lo + lo; for
    k == 32 it is (hi - 2**31) * 2**32 + lo, the value with its top bit
    flipped.
    """
    L = reads.shape[-1]
    P = L - k + 1
    r = reads.to(torch.int64)
    n_lo = min(k, 16)

    def value(first: int, n: int) -> torch.Tensor:
        acc = torch.zeros(r.shape[:-1] + (P,), dtype=torch.int64,
                          device=r.device)
        for j in range(first, first + n):
            acc = acc * 4 + r[..., j : j + P]
        return acc

    hi = value(0, k - n_lo)
    lo = value(k - n_lo, n_lo)
    if k == 32:
        return (hi - (1 << 31)) * (1 << 32) + lo
    return hi * (1 << (2 * n_lo)) + lo


def kmer_keys(
    reads: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(fwd, rc, canonical) int64 keys of every length-k window.

    Window p's reverse complement is window P-1-p of the reverse-
    complemented read, so the RC keys are that read's forward keys with
    the window axis reversed (sage2_tpu/ops/bitpack.py:144).
    """
    fwd = _forward_keys(reads, k)
    rc = _forward_keys((3 - reads).flip(-1), k).flip(-1)
    return fwd, rc, torch.minimum(fwd, rc)


def lookup_counts(
    table: torch.Tensor, counts: torch.Tensor, queries: torch.Tensor
) -> torch.Tensor:
    """counts[i] where table[i] == query, else 0; any query shape.

    A whole-array lower-bound binary search with a fixed step count.
    """
    T = table.shape[0]
    q = queries.reshape(-1)
    if T == 0:
        return torch.zeros(queries.shape, dtype=torch.int32,
                           device=queries.device)
    lo = torch.zeros_like(q)
    hi = torch.full_like(q, T)
    for _ in range(math.ceil(math.log2(T + 1)) + 1):
        active = lo < hi
        mid = (lo + hi) >> 1
        right = table[mid.clamp(max=T - 1)] < q
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    at = lo.clamp(max=T - 1)
    found = (lo < T) & (table[at] == q)
    out = torch.where(found, counts[at], torch.zeros_like(counts[at]))
    return out.to(torch.int32).reshape(queries.shape)


def slots_to_write(total: int, slot_limit) -> int:
    """How many of ``total`` candidate slots K3 writes: all without a
    limit, else at most ``slot_limit``, or ``slot_limit(total)`` when it
    is a function of the count (called once)."""
    if slot_limit is None:
        return total
    limit = slot_limit(total) if callable(slot_limit) else slot_limit
    return max(0, min(total, limit))


def overlap_join(
    s_keys: torch.Tensor,
    s_rows: torch.Tensor,
    payload: torch.Tensor,
    R: int,
    g: int,
    trim: int,
    min_overlap: int,
    contained: Optional[torch.Tensor] = None,
    slot_limit: Union[int, Callable[[int], int], None] = None,
    entry_payload: Optional[torch.Tensor] = None,
    entry_base: int = 0,
    query_base: int = 0,
    payload_perm: Optional[torch.Tensor] = None,
    block: int = 1 << 22,
):
    """(ok, cand_a, cand_b, ovl, total) of the sorted seed rows.

    ``s_keys``/``s_rows``: live seed rows sorted by key, entries before
    queries within a key; ``payload``: (rows, Wt + 2) int32 indexed by
    row id. One candidate per (query, entry of its run), in sorted
    query order and entry order within a query; the first
    ``slots_to_write(total, slot_limit)`` of them are returned.
    ``contained`` (uint8, updated in place): read b of each verified
    pair among those with len_b <= ovl, the reference's ok_contained
    scattered (detect.py:836-843). With ``entry_payload`` (the streamed
    join) the entry row t of read b is its row (b - entry_base) * g + t
    and ``payload`` holds the query rows, the query row t of read a at
    (a - query_base) * (R - g) + t - g. With ``payload_perm`` (the
    meshed join, whose owner holds rows of any read) the payload row of
    sorted row i is ``payload[payload_perm[i]]``. The slots are computed
    ``block`` at a time.
    """
    dev = s_keys.device
    n = s_keys.shape[0]
    idx = torch.arange(n, device=dev)
    is_head = torch.ones(n, dtype=torch.bool, device=dev)
    is_head[1:] = s_keys[1:] != s_keys[:-1]
    is_entry = (s_rows % R) < g
    run = torch.cumsum(is_head.to(torch.int64), 0) - 1
    run_start = idx[is_head]
    n_entries = torch.zeros(run_start.shape[0], dtype=torch.int64,
                            device=dev).index_add_(
        0, run, is_entry.to(torch.int64))
    counts = torch.where(is_entry, 0, n_entries[run])
    offsets = torch.cumsum(counts, 0)
    total = int(offsets[-1]) if n else 0
    n_out = slots_to_write(total, slot_limit)
    i32 = torch.int32
    ok = torch.empty(n_out, dtype=torch.bool, device=dev)
    cand = [torch.empty(n_out, dtype=i32, device=dev) for _ in range(3)]
    Wt = payload.shape[1] - 2
    # the candidate slots in blocks, to bound the per-slot temporaries
    for j0 in range(0, n_out, block):
        j = torch.arange(j0, min(j0 + block, n_out), device=dev)
        qi = torch.searchsorted(offsets, j, right=True)
        rank = j - (offsets[qi] - counts[qi])
        ei = run_start[run[qi]] + rank
        qid = s_rows[qi].to(torch.int64)
        eid = s_rows[ei].to(torch.int64)
        if payload_perm is not None:
            pa = payload[payload_perm[qi]].to(torch.int64) & _U32
            pb = payload[payload_perm[ei]].to(torch.int64) & _U32
        elif entry_payload is None:
            pa = payload[qid].to(torch.int64) & _U32
            pb = payload[eid].to(torch.int64) & _U32
        else:
            pa = payload[(qid // R - query_base) * (R - g) + qid % R - g]
            pb = entry_payload[(eid // R - entry_base) * g + eid % R]
            pa, pb = pa.to(torch.int64) & _U32, pb.to(torch.int64) & _U32

        cand_a = qid // R
        p = (qid % R - g + 1) * g
        cand_b = eid // R
        o = eid % R
        len_a = pa[:, Wt + 1]
        len_b = pb[:, Wt + 1]
        ovl = len_a - (p - o)
        match = cand_a != cand_b
        lc2 = 2 * torch.minimum(len_a - p, len_b - o)
        for t in range(Wt):
            vb = (lc2 - (t + trim) * 32).clamp(0, 32)
            diff = (pa[:, t] ^ pb[:, t]) >> (32 - vb).clamp(max=31)
            match &= (vb == 0) | (diff == 0)
        lhs = pa[:, Wt] & (torch.bitwise_left_shift(torch.ones_like(o), 2 * o)
                           - 1)
        rhs = torch.where(o == 0, 0, pb[:, Wt] >> (32 - 2 * o).clamp(0, 31))
        match &= lhs == rhs
        if contained is not None:
            contained[cand_b[match & (len_b <= ovl)]] = 1
        sl = slice(j0, j0 + j.shape[0])
        ok[sl] = match & (ovl < len_b) & (ovl >= min_overlap)
        for out, x in zip(cand, (cand_a, cand_b, ovl)):
            out[sl] = x.to(i32)
    return (ok, *cand, total)


def overlap_join_stacked(
    s_keys: torch.Tensor, s_rows: torch.Tensor, payload: torch.Tensor,
    n_live: torch.Tensor, R: int, g: int, trim: int, min_overlap: int,
    capacity: int,
):
    """(ok, cand_a, cand_b, ovl, total) of ``overlap_join`` over the first
    ``n_live`` rows (0-d int64) of a fixed row buffer
    (``seed_rows_stacked``), with exactly ``capacity`` slots: the first
    min(total, capacity) candidates, then not-ok slots with a, b and ovl
    0; ``total`` a 0-d int64 tensor (detect.py:1108, the arrays of
    find_overlaps at a fixed capacity)."""
    n = int(n_live)
    ok, a, b, ovl, total = overlap_join(s_keys[:n], s_rows[:n], payload, R,
                                        g, trim, min_overlap, None, capacity)
    dev = s_keys.device
    out = [torch.zeros(capacity, dtype=torch.bool, device=dev)] + [
        torch.zeros(capacity, dtype=torch.int32, device=dev)
        for _ in range(3)]
    for o, x in zip(out, (ok, a, b, ovl)):
        o[:x.shape[0]] = x
    return (*out, torch.tensor(total, dtype=torch.int64, device=dev))


def pointer_jump(
    p: torch.Tensor, val: Optional[torch.Tensor] = None, op: str = "none",
    steps: int = 1,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``steps`` doubling steps, each (p[p], op(val, val[p])) of the
    previous step's arrays, with op in "none" | "min" | "add" (int32,
    wrapping)."""
    if op not in ("none", "min", "add"):
        raise ValueError(f"unknown pointer_jump op {op!r}")
    for _ in range(steps):
        pl = p.to(torch.int64)
        if op == "min":
            val = torch.minimum(val, val[pl])
        elif op == "add":
            val = val + val[pl]
        p = p[pl]
    return p, val


def _count_of(table: torch.Tensor, counts: torch.Tensor,
              queries: torch.Tensor) -> torch.Tensor:
    """counts[i] where table[i] == query, else 0, in one
    torch.searchsorted: vote_windows' 4k lookups a round would take
    ~24 whole-array steps each through lookup_counts' search."""
    T = table.shape[0]
    if T == 0:
        return torch.zeros(queries.shape, dtype=torch.int32,
                           device=queries.device)
    at = torch.searchsorted(table, queries).clamp(max=T - 1)
    return torch.where(table[at] == queries, counts[at], 0).to(torch.int32)


def vote_windows(
    reads: torch.Tensor, table: torch.Tensor, counts: torch.Tensor,
    k: int, threshold: int, lengths: Optional[torch.Tensor] = None,
    rows_per_chunk: int = 1 << 16,
) -> torch.Tensor:
    """One round of the voting rule, as sage2_tpu/kmer/correct.py
    voting_round computes it: for each window position j and base b the
    canonical key of every window with base b at j, its solid verdict
    added to votes[b, :, w + j]; then the unique-max replace rule.
    ``lengths``: windows past a read's end do not vote and bases past
    it are not replaced. Processed in chunks of reads to bound the
    (4, N, L) temporaries."""
    N, L = reads.shape
    P = L - k + 1
    out = []
    for r0 in range(0, N, rows_per_chunk):
        r = reads[r0 : r0 + rows_per_chunk]
        wvalid = None
        if lengths is not None:
            ln = lengths[r0 : r0 + rows_per_chunk].to(torch.int64)[:, None]
            wvalid = torch.arange(P, device=r.device)[None, :] < ln - (k - 1)
        fwd, rc, _ = kmer_keys(r, k)
        votes = torch.zeros((4,) + tuple(r.shape), dtype=torch.int32,
                            device=r.device)
        for j in range(k):
            cur = r[:, j : j + P].to(torch.int64)
            wf = 1 << (2 * (k - 1 - j))        # set_base at position j
            wr = 1 << (2 * j)                  # and k-1-j of the RC key
            for b in range(4):
                vf = fwd + (b - cur) * wf
                vr = rc + ((3 - b) - (3 - cur)) * wr
                cnt = _count_of(table, counts, torch.minimum(vf, vr))
                solid = cnt >= threshold
                if wvalid is not None:
                    solid &= wvalid
                votes[b, :, j : j + P] += solid.to(torch.int32)
        votes = votes.permute(1, 2, 0)                      # (n, L, 4)
        vcur = votes.gather(2, r.to(torch.int64)[..., None])[..., 0]
        m = votes.max(dim=2).values
        n_at_max = (votes == m[..., None]).sum(dim=2)
        best = votes.argmax(dim=2).to(r.dtype)
        replace = (m > vcur) & (n_at_max == 1)
        if lengths is not None:
            replace &= torch.arange(L, device=r.device)[None, :] < ln
        out.append(torch.where(replace, best, r))
    return torch.cat(out) if out else reads.clone()


def _window_valid(lengths: Optional[torch.Tensor], N: int, P: int, k: int,
                  dev) -> Optional[torch.Tensor]:
    """(N, P) bool: window w lies inside its read (w < len - (k - 1)),
    or None for fixed-length reads."""
    if lengths is None:
        return None
    return torch.arange(P, device=dev)[None, :] < (
        lengths.to(torch.int64)[:, None] - (k - 1))


def vote_add(votes: torch.Tensor, counts: torch.Tensor, j: int, k: int,
             threshold: int, lengths: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """The votes of window position j of a voting round from counts the
    k-mer owners sent back (sage2_tpu/kmer/correct.py:171-173 under the
    meshed lookup, sage2_tpu/parallel/sharded.py:306-320): votes[n, w +
    j, b] += (counts[n, w, b] >= threshold) for each valid window w.
    ``votes`` (N, L, 4) uint8, updated in place and returned; ``counts``
    (N, P, 4) int32, the counts of ``window_variants(reads, k, j)``;
    ``lengths``: windows past a read's end do not vote."""
    N, P = counts.shape[:2]
    solid = counts >= threshold
    wvalid = _window_valid(lengths, N, P, k, counts.device)
    if wvalid is not None:
        solid &= wvalid[..., None]
    votes[:, j:j + P] += solid.to(votes.dtype)
    return votes


def vote_apply(reads: torch.Tensor, votes: torch.Tensor) -> torch.Tensor:
    """(N, L) int32 reads after the voting rule (sage2_tpu/kmer/
    correct.py:174-187): a base becomes the base with the most votes
    where that maximum beats its own base's votes and no other base
    ties it. The reference also masks bases at or past a read's end;
    no valid window covers them, so ``vote_add`` left their votes 0,
    and a maximum of 0 never beats the base's own: no mask is needed."""
    v = votes.to(torch.int32)
    vcur = v.gather(2, reads.to(torch.int64)[..., None])[..., 0]
    m = v.max(dim=2).values
    n_at_max = (v == m[..., None]).sum(dim=2)
    best = v.argmax(dim=2).to(reads.dtype)
    replace = (m > vcur) & (n_at_max == 1)
    return torch.where(replace, best, reads)


def _src_len(read_len, v: torch.Tensor):
    """The read length of vertices ``v``: the scalar, or the (V,)
    per-vertex lengths gathered."""
    if isinstance(read_len, torch.Tensor):
        return read_len[v].to(torch.int64)
    return read_len


def reduce_counts(
    keys: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
    ovl: torch.Tensor, n_vertices: int, read_len,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(start, maxsl, startd, counts) by torch.searchsorted over the
    composite keys, as sage2_tpu/graph/reduce.py _reduce_prep_host
    computes them; ``read_len`` an int or (V,) per-vertex lengths."""
    V = n_vertices
    dev = keys.device
    i32 = torch.int32
    vk = torch.arange(V + 1, dtype=torch.int64, device=dev) << 32
    bounds = torch.searchsorted(keys, vk)
    start, end = bounds[:V], bounds[1:]
    if keys.numel():
        maxsl = torch.where(end > start,
                            keys[(end - 1).clamp(min=0)] & _U32, -1)
    else:
        maxsl = torch.full_like(start, -1)
    startd = torch.searchsorted(
        src, torch.arange(V + 1, dtype=i32, device=dev))
    is_edge = src != 2**31 - 1
    v = src.to(torch.int64).clamp(max=max(V - 1, 0))
    sl = _src_len(read_len, v) - ovl.to(torch.int64)
    bound = torch.where(is_edge, maxsl[v] - sl, -1)
    w = torch.where(is_edge, dst, 0).to(torch.int64)
    upto = torch.searchsorted(keys, (w << 32) | bound.clamp(min=0),
                              right=True)
    counts = torch.where(is_edge & (bound >= 0), upto - start[w], 0)
    return start.to(i32), maxsl.to(i32), startd.to(i32), counts.to(i32)


def reduce_marks(
    removed: torch.Tensor, offsets: torch.Tensor, src: torch.Tensor,
    dst: torch.Tensor, ovl: torch.Tensor, ss_sl: torch.Tensor,
    ss_dst: torch.Tensor, start: torch.Tensor, startd: torch.Tensor,
    read_len, j0: int, j1: int,
) -> torch.Tensor:
    """Marks of the slots [j0, j1) as the in-core reference computes
    them (sage2_tpu/graph/reduce.py:93-116): slot to edge by a search
    of the prefix sum, membership by a search of (v, x) in the whole
    (src, dst) order, both offsets in len(v) (``read_len`` an int or
    (V,) per-vertex lengths). ``removed`` is updated in place and
    returned; ``startd`` is not needed here."""
    dev = src.device
    j = torch.arange(j0, j1, dtype=torch.int64, device=dev)
    e1 = torch.searchsorted(offsets, j, right=True)
    counts = torch.diff(offsets, prepend=offsets.new_zeros(1))
    rank = j - (offsets[e1] - counts[e1])
    e2 = start[dst[e1].to(torch.int64)].to(torch.int64) + rank
    v = src[e1].to(torch.int64)
    x = ss_dst[e2].to(torch.int64)
    len_v = _src_len(read_len, v)
    sls = (len_v - ovl[e1]) + ss_sl[e2]
    pair = (src.to(torch.int64) << 32) | dst.to(torch.int64)
    q = (v << 32) | x
    pos = torch.searchsorted(pair, q)
    pos_c = pos.clamp(max=src.shape[0] - 1)
    hit = ((x != v) & (pos < src.shape[0]) & (pair[pos_c] == q)
           & (len_v - ovl[pos_c] == sls))
    removed[pos_c[hit]] = 1
    return removed


def canonical_reads(
    reads: torch.Tensor, lengths: Optional[torch.Tensor] = None,
    rc_only: bool = False, words_only: bool = False,
    out: Optional[torch.Tensor] = None,
):
    """(rc, fwd_w, rc_w, take_rc): the reverse complement of each
    read's real bases re-padded with 0 (ops.bitpack.revcomp_ragged;
    (3 - r).flip without lengths), the packed words of the read (codes
    past its length taken as 0) and of its reverse complement, and
    whether the reverse complement's words are the smaller. With
    ``rc_only`` the last three are None, with ``words_only`` ``rc``;
    ``out`` receives ``rc``."""
    from sage2_tpu_torch.ops import bitpack

    N, L = reads.shape
    fwd = reads
    if lengths is None:
        rc = bitpack.revcomp_codes(reads)
    else:
        lengths = lengths.clamp(0, L)
        rc = bitpack.revcomp_ragged(reads, lengths)
        real = torch.arange(L, device=reads.device)[None, :] < lengths[:, None]
        fwd = torch.where(real, reads, 0)
    if out is not None:
        rc = out.copy_(rc)
    if rc_only:
        return rc, None, None, None
    fwd_w = bitpack.pack_read_words(fwd)
    rc_w = bitpack.pack_read_words(rc)
    return (None if words_only else rc), fwd_w, rc_w, words_less(rc_w,
                                                                 fwd_w)


def seed_table(
    words0: torch.Tensor, valid: torch.Tensor, L: int, s: int, g: int,
    bucket_bits: int, base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table, slab) as sage2_tpu/stream.py:193-226 builds them: the
    seed words at offsets 0..g-1 (detect.seed_keys_from_words0),
    detect.build_seed_table over global entry ids from base * g (one sort
    by (word, packed invalid-bit | id), detect.table_from_sorted), and
    each sorted slot's [entry, words0 of its read] as int32 bit
    patterns."""
    from sage2_tpu_torch.overlap import detect

    hi, _ = detect.seed_keys_from_words0(words0, s, list(range(g)), L)
    st = detect.build_seed_table(hi.reshape(-1), valid.repeat_interleave(g),
                                 bucket_bits, base * g)
    words = words0[st.entry // g - base]
    slab = torch.cat([st.entry[:, None], words], dim=1)
    return st.packed, detect._as_int32(slab)


def probe_join(
    words0: torch.Tensor, valid: torch.Tensor, table: torch.Tensor,
    slab: torch.Tensor, L: int, s: int, g: int, pa: int, base: int = 0,
    capacity: Optional[int] = None, block: int = 1 << 22,
):
    """(ok, cand_a, cand_b, ovl, total) as sage2_tpu/stream.py:240-270
    computes them: probe seeds at g (j + 1) (seed_keys_from_words0),
    detect.probe_seed_table, ops.sort.expand_with_payload over the
    exact candidate count, the slab gather and decode, and
    detect.verify_candidates_words0. Empty arrays when ``total`` exceeds
    ``capacity``. The slots are decoded and verified ``block`` at a
    time."""
    from sage2_tpu_torch.ops.sort import expand_with_payload
    from sage2_tpu_torch.overlap import detect

    n_pos = -(-pa // g)
    B = table.shape[0].bit_length() - 1
    dev = words0.device
    a_hi, _ = detect.seed_keys_from_words0(
        words0, s, [g * (j + 1) for j in range(n_pos)], L)
    lo_idx, counts = detect.probe_seed_table(
        detect.SeedTable(slab[:, 0], table, B), a_hi, valid)
    counts = counts.reshape(-1)
    total = int(counts.sum())
    n_out = 0 if capacity is not None and total > capacity else total
    i32 = torch.int32
    ok = torch.empty(n_out, dtype=torch.bool, device=dev)
    cand = [torch.empty(n_out, dtype=i32, device=dev) for _ in range(3)]
    if n_out == 0:
        return (ok, *cand, total)
    q, rank, lo_of, cand_valid = expand_with_payload(
        counts, lo_idx.reshape(-1), n_out)
    T = slab.shape[0]
    for j0 in range(0, n_out, block):
        sl = slice(j0, min(j0 + block, n_out))
        cand_a = base + q[sl] // n_pos
        cand_p = (q[sl] % n_pos + 1) * g
        row = slab[(lo_of[sl].to(torch.int64) + rank[sl]).clamp(max=T - 1)]
        row = row.to(torch.int64) & _U32
        e_b = row[:, 0]
        cand_b = e_b // g
        cand_p0 = cand_p - (e_b - cand_b * g)
        v = cand_valid[sl] & (cand_a != cand_b) & (cand_p0 <= pa)
        cand_p0 = cand_p0.clamp(1, pa)
        ok[sl] = detect.verify_candidates_words0(
            words0, cand_a - base, cand_p0, row[:, 1:], L, max_p=pa) & v
        for out, x in zip(cand, (cand_a, cand_b, L - cand_p0)):
            out[sl] = x.to(i32)
    return (ok, *cand, total)


def merge_runs(
    keys: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unique keys, summed weights) of sorted keys: the head flags of
    ops.sort.unique_sorted_pairs and an index_add_ of the weights (1
    each without weights) by group, as sage2_tpu/kmer/count.py:72-90 and
    sage2_tpu/stream.py:30-49 compute them."""
    is_head, group = unique_sorted_pairs(
        keys, torch.ones_like(keys, dtype=torch.bool))
    w = (torch.ones_like(keys, dtype=torch.int32) if weights is None
         else weights)
    sums = torch.zeros(int(is_head.sum()), dtype=torch.int32,
                       device=keys.device)
    sums.index_add_(0, group.to(torch.int64), w)
    return keys[is_head], sums


def gather_along(tbl: torch.Tensor, idx: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """take_along_axis by advanced indexing: tbl[idx, j] on axis 0,
    tbl[i, idx] on axis 1."""
    N, W = tbl.shape
    i = idx.to(torch.int64)
    if axis == 0:
        return tbl[i, torch.arange(W, device=tbl.device)[None, :]]
    return tbl[torch.arange(N, device=tbl.device)[:, None], i]


def _u32_pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 of the 64 bits hi:lo (each an int64 holding a uint32) with
    the top bit flipped, so signed order is the unsigned order."""
    return (hi - (1 << 31)) * (1 << 32) + lo


def dedup_keys(fwd_w: torch.Tensor, rc_w: torch.Tensor,
               take_rc: torch.Tensor, lengths: Optional[torch.Tensor],
               L: int) -> list:
    """The sort keys of the dedup, most significant first: the bit string
    of each read's canonical words (``rc_w`` where ``take_rc``, else
    ``fwd_w``), led for ragged reads by its length (clamped to [0, L]) in
    lb = bit_length(L) bits, cut into 64-bit keys with the top bit
    flipped. The string ends after its 2 L + lb significant bits (the
    words are zero past each read), so it takes ceil((2 L + lb) / 64)
    keys: the order of the keys is the (length, words...) order."""
    canon = torch.where(take_rc[:, None], rc_w, fwd_w)
    N, W = canon.shape
    lb = 0 if lengths is None else L.bit_length()
    if lb:
        # 32-bit words of the string: the length's lb bits, then the words
        ext = torch.cat([lengths.clamp(0, L).to(torch.int64)[:, None], canon,
                         canon.new_zeros((N, 1))], dim=1)
        canon = (((ext[:, :-1] << (32 - lb)) & _U32)
                 | (ext[:, 1:] >> lb))[:, : -(-(2 * L + lb) // 32)]
    if canon.shape[1] % 2:
        canon = torch.cat([canon, canon.new_zeros((N, 1))], dim=1)
    return [_u32_pair_key(canon[:, 2 * c], canon[:, 2 * c + 1])
            for c in range(canon.shape[1] // 2)]


def dedup_reads(
    reads: torch.Tensor, lengths: Optional[torch.Tensor],
    rc: Optional[torch.Tensor], fwd_w: torch.Tensor, rc_w: torch.Tensor,
    take_rc: torch.Tensor, out: Optional[torch.Tensor] = None, *,
    split=None,
):
    """(uniq, mult, vertex_of_read, n_unique, lens_u) of the dedup
    (sage2_tpu/overlap/prepare.py:97-133) over K8's outputs: reads in
    the stable order of their canonical (length, words) keys
    (``dedup_keys``, chained stable sorts from the last key to the
    first), grouped by equal keys. Group g's first read in that order
    is its representative: ``uniq`` row g holds it in canonical
    orientation (``rc`` where ``take_rc``; without ``rc``, the
    representatives' own reverse complements) with codes past its
    length zero, ``mult`` the group's size, ``lens_u`` its length (None
    without lengths); rows from n_unique on are zero. Read i's vertex
    is its group, plus N where it was flipped. ``out`` receives
    ``uniq``."""
    N, L = reads.shape
    dev = reads.device
    keys = dedup_keys(fwd_w, rc_w, take_rc, lengths, L)
    order = torch.arange(N, device=dev)
    for key in reversed(keys):
        order = order[torch.sort(key[order], stable=True).indices]
    mark_part(split, "sort")
    neq = torch.arange(N, device=dev) == 0
    for key in keys:
        s_key = key[order]
        neq[1:] |= s_key[1:] != s_key[:-1]
    group_id = torch.cumsum(neq.to(torch.int64), 0) - 1
    n_unique = int(group_id[-1]) + 1 if N else 0
    heads = torch.nonzero(neq).reshape(-1)
    rep = order[heads]
    mult = torch.zeros(N, dtype=torch.int32, device=dev)
    mult[:n_unique] = torch.diff(heads, append=heads.new_tensor([N])).to(
        torch.int32)
    if rc is None:
        rc_rep = canonical_reads(reads[rep], None if lengths is None
                                 else lengths[rep], True)[0]
    else:
        rc_rep = rc[rep]
    row = torch.where(take_rc[rep][:, None], rc_rep, reads[rep])
    lens_u = None
    if lengths is not None:
        real = torch.arange(L, device=dev)[None, :] < lengths[rep].clamp(
            0, L)[:, None]
        row = torch.where(real, row, 0)
        lens_u = torch.zeros_like(lengths)
        lens_u[:n_unique] = lengths[rep]
    uniq = torch.zeros_like(reads) if out is None else out.zero_()
    uniq[:n_unique] = row
    gid = torch.empty(N, dtype=torch.int64, device=dev)
    gid[order] = group_id
    vertex_of_read = (gid + take_rc.to(torch.int64) * N).to(torch.int32)
    mark_part(split, "group")
    return uniq, mult, vertex_of_read, n_unique, lens_u


def seed_positions(g: int, n_pos: int) -> list:
    """The seed positions of a read's R = g + n_pos rows: entries at
    offsets 0 .. g - 1, queries at g, 2g, ..., n_pos g."""
    return list(range(g)) + [g * (j + 1) for j in range(n_pos)]


# which rows of each read seed_rows builds
SEED_ROW_KINDS = ("all", "entries", "queries")


def seed_row_span(rows: str, g: int, n_pos: int) -> Tuple[int, int]:
    """(t0, Rw): seed_rows builds rows t0 .. t0 + Rw - 1 of each read."""
    return {"all": (0, g + n_pos), "entries": (0, g),
            "queries": (g, n_pos)}[rows]


def seed_rows(
    reads2: torch.Tensor, valid2: torch.Tensor,
    lengths: Optional[torch.Tensor], s: int, g: int, n_pos: int, trim: int,
    id_base: int = 0, rows: str = "all",
    prior_keys: Optional[torch.Tensor] = None,
    prior_ids: Optional[torch.Tensor] = None, *, split=None,
):
    """(s_keys, s_rows, payload) of the overlap join's seed rows
    (sage2_tpu/overlap/detect.py:642 build_seed_rows with :562
    _row_payload), for (M, L) int32 reads.

    Row t of read m has the global id (id_base + m) * R + t (R = g +
    n_pos) and the seed at ``seed_positions(g, n_pos)[t]``. ``rows``
    picks the rows built: "all", "entries" (t < g) or "queries" (t >=
    g), Rw of them a read (seed_row_span). ``payload`` (M, Rw, Wt + 2)
    int32:
    [aw_0 .. aw_{Wt-1}, xw, len], aw_t the word of bases [pos + 16 (trim
    + t), +16) (Wt = ceil((L - g) / 16) - trim), xw for ENTRY rows (t <
    g) the read's first word (the B side of the prefix check), for QUERY
    rows the word ending at pos (base pos - 1 in its low 2 bits; the A
    side), len the read's length (L without lengths). A row is live when
    its read is valid and, for ragged reads, its seed lies inside the
    read (pos + s <= len). The live rows, laid out as the reference's
    (key, tag | id) sort orders them (entries by id, then queries by
    id), are sorted stably by their exact seed key (int64, the
    left-aligned (hi, lo) pair with its top bit flipped): ``s_keys`` and
    the int32 row ids ``s_rows``. With "entries" the live rows come back
    in that order unsorted (an entry slab of the streamed join); with
    "queries", ``prior_keys``/``prior_ids`` (a slab) go before them into
    the sort (the reference's stream.py:865-876)."""
    from sage2_tpu_torch.ops import bitpack
    from sage2_tpu_torch.overlap import detect

    M, L = reads2.shape
    R = g + n_pos
    Wt = -(-(L - g) // 16) - trim
    t0, Rw = seed_row_span(rows, g, n_pos)
    positions = seed_positions(g, n_pos)[t0 : t0 + Rw]
    words0 = bitpack.pack_read_words(reads2)
    first = words0[:, 0]
    if lengths is None:
        length = torch.full_like(first, L)
    else:
        length = lengths.to(torch.int64)
    keys, prows = [], []
    for i, pos in enumerate(positions):
        keys.append(detect.seed_keys(words0, s, pos))
        aw = [bitpack.word_at(words0, pos + 16 * (trim + t))
              for t in range(Wt)]
        if t0 + i < g:
            xw = first
        elif pos < 16:
            xw = first >> (2 * (16 - pos))
        else:
            xw = bitpack.word_at(words0, pos - 16)
        prows.append(detect._as_int32(torch.stack(aw + [xw, length],
                                                  dim=1)))
    dev = reads2.device
    live = valid2[:, None].expand(M, Rw)
    if lengths is not None:
        pos = torch.tensor(positions, device=dev)
        live = live & (pos[None, :] + s <= length[:, None])
    keys = torch.stack(keys, dim=1)
    payload = (torch.stack(prows, dim=1) if prows else
               torch.empty((M, 0, Wt + 2), dtype=torch.int32, device=dev))
    mark_part(split, "seed_rows")
    local = torch.arange(M * Rw, dtype=torch.int64,
                         device=dev).reshape(M, Rw)
    ne = max(0, min(Rw, g - t0))      # the built entry rows of a read
    order = torch.cat([local[:, :ne][live[:, :ne]],
                       local[:, ne:][live[:, ne:]]])
    ids = ((id_base + order // Rw) * R + t0 + order % Rw).to(torch.int32)
    c_keys = keys.reshape(-1)[order]
    if prior_keys is not None:
        c_keys = torch.cat([prior_keys, c_keys])
        ids = torch.cat([prior_ids, ids])
    if rows == "entries":
        mark_part(split, "row_sort")
        return c_keys, ids, payload
    s_keys, perm = torch.sort(c_keys, stable=True)
    mark_part(split, "row_sort")
    return s_keys, ids[perm], payload


def seed_rows_stacked(reads2: torch.Tensor, valid2: torch.Tensor, s: int,
                      g: int, n_pos: int, trim: int):
    """(s_keys, s_rows, payload, n_live): every row of each read in a
    buffer of M * R rows, ``seed_rows``' live rows in the join's order
    first and dead rows (key INT64_MAX, id -1) behind them, sorted
    stably as one buffer (a live all-T seed's key is INT64_MAX too, and
    it stays before the dead rows); ``n_live`` a 0-d int64 tensor."""
    s_keys, s_rows, payload = seed_rows(reads2, valid2, None, s, g, n_pos,
                                        trim)
    n = reads2.shape[0] * (g + n_pos)
    n_live = s_keys.shape[0]
    keys = torch.full((n,), I64_MAX, dtype=torch.int64, device=s_keys.device)
    rows = torch.full((n,), -1, dtype=torch.int32, device=s_keys.device)
    keys[:n_live] = s_keys
    rows[:n_live] = s_rows
    return keys, rows, payload, torch.tensor(n_live, dtype=torch.int64,
                                             device=s_keys.device)


def edge_key_bits(n_vertices: int, read_len: int) -> Tuple[int, int]:
    """(db, ob): the bits of a vertex id below ``n_vertices`` and of an
    overlap length up to ``read_len``; K14 packs (src, dst, ovl) into one
    int64 key where 2 db + ob <= 63."""
    return max(n_vertices - 1, 0).bit_length(), int(read_len).bit_length()


def _sorted_edges(ok, cand_a, cand_b, cand_ovl, n_vertices, read_len):
    """(pair, src, dst, ovl) of the candidates sorted by (src, dst, ovl),
    the rows that are not ok first with pair -1 (see longest_edges)."""
    db, ob = edge_key_bits(n_vertices, read_len)
    a, b, v = (x.to(torch.int64) for x in (cand_a, cand_b, cand_ovl))
    neg = torch.full_like(a, -1)
    if 2 * db + ob <= 63:
        s_key = torch.sort(torch.where(
            ok, (a << (db + ob)) | (b << ob) | v, neg)).values
        pair = s_key >> ob
        s_src, s_dst = s_key >> (db + ob), pair & ((1 << db) - 1)
        s_ovl = s_key & ((1 << ob) - 1)
    else:
        o1 = torch.sort(torch.where(ok, v, neg), stable=True).indices
        pair, o2 = torch.sort(torch.where(
            ok[o1], (a[o1] << 32) | b[o1], neg[o1]), stable=True)
        s_src, s_dst = pair >> 32, pair & _U32
        s_ovl = v[o1[o2]]
    return pair, s_src, s_dst, s_ovl


def _padded_edges(cols, rows, capacity: int, out):
    """The ``rows`` of the three sorted columns, padded to ``capacity``
    with (INT32_MAX, INT32_MAX, 0), in ``out`` where given."""
    n = int(rows.sum())
    res = []
    for i, (x, fill) in enumerate(zip(cols, (I32_MAX, I32_MAX, 0))):
        col = torch.full((capacity,), fill, dtype=torch.int32,
                         device=x.device)
        col[:n] = x[rows].to(torch.int32)
        if out is not None:
            col = out[i].copy_(col)
        res.append(col)
    return res


def longest_edges(
    ok: torch.Tensor, cand_a: torch.Tensor, cand_b: torch.Tensor,
    cand_ovl: torch.Tensor, n_vertices: int, read_len: int, capacity: int,
):
    """(src, dst, ovl, n_edges): the longest overlap of each (src, dst)
    pair among the ``ok`` candidates (sage2_tpu/overlap/detect.py:1015
    _reduce_fused), sorted by (src, dst) and padded to ``capacity`` rows
    with (INT32_MAX, INT32_MAX, 0).

    With (db, ob) = ``edge_key_bits(n_vertices, read_len)`` and 2 db +
    ob <= 63 one sort orders the key src << (db + ob) | dst << ob | ovl;
    otherwise two stable sorts, by ovl and then by src << 32 | dst.
    Rows that are not ok take the key -1 and sort first. The last row of
    each (src, dst) run holds its longest overlap; ``n_edges`` an int."""
    pair, *cols = _sorted_edges(ok, cand_a, cand_b, cand_ovl, n_vertices,
                                read_len)
    is_last = pair >= 0
    is_last[:-1] &= pair[1:] != pair[:-1]
    n_edges = int(is_last.sum())
    return (*_padded_edges(cols, is_last, capacity, None), n_edges)


def longest_edges_deferred(
    ok: torch.Tensor, cand_a: torch.Tensor, cand_b: torch.Tensor,
    cand_ovl: torch.Tensor, n_vertices: int, read_len: int, capacity: int,
    out=None,
):
    """(src, dst, ovl, n_edges, n_dups): every ok candidate sorted by
    (src, dst, ovl) and padded to ``capacity`` with (INT32_MAX,
    INT32_MAX, 0), the reference's defer_dup_compact rows
    (detect.py:1050-1054): a pair's last row is its longest. n_edges
    (the pairs) and n_dups (the other ok rows) are 0-d int32 tensors."""
    pair, *cols = _sorted_edges(ok, cand_a, cand_b, cand_ovl, n_vertices,
                                read_len)
    valid = pair >= 0
    is_last = valid.clone()
    is_last[:-1] &= pair[1:] != pair[:-1]
    res = _padded_edges(cols, valid, capacity, out)
    n_edges = is_last.sum()
    return (*res, n_edges.to(torch.int32),
            (valid.sum() - n_edges).to(torch.int32))


def prune_table(keys: torch.Tensor, counts: torch.Tensor,
                threshold: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The entries of a sorted count table with count >= threshold, in
    table order (sage2_tpu/kmer/correct.py:246 _prune_impl)."""
    keep = counts >= threshold
    return keys[keep], counts[keep]


def weak_windows(
    reads: torch.Tensor, lengths: Optional[torch.Tensor],
    table: torch.Tensor, counts: torch.Tensor, directory, k: int,
    threshold: int, rows_per_block: int = 1 << 18,
) -> torch.Tensor:
    """Flat indices r * P + w, ascending, of the windows whose canonical
    key counts below ``threshold`` in the table, with ``lengths`` only
    windows inside their read, p < len - k + 1
    (sage2_tpu/kmer/correct.py:270 _phase1_kernel). ``directory`` is the
    kernel's and is not needed here. ``rows_per_block`` reads at a time."""
    N, L = reads.shape
    P = L - k + 1
    parts = []
    for r0 in range(0, N, rows_per_block):
        r = reads[r0 : r0 + rows_per_block]
        weak = lookup_counts(table, counts, kmer_keys(r, k)[2]) < threshold
        if lengths is not None:
            ln = lengths[r0 : r0 + rows_per_block].to(torch.int64)
            weak &= (torch.arange(P, device=reads.device)[None, :]
                     < ln[:, None] - (k - 1))
        parts.append(torch.nonzero(weak.reshape(-1)).reshape(-1) + r0 * P)
    if not parts:
        return torch.empty(0, dtype=torch.int64, device=reads.device)
    return torch.cat(parts)


def fix_windows(
    reads: torch.Tensor, widx: torch.Tensor, table: torch.Tensor,
    counts: torch.Tensor, directory, k: int, threshold: int, which: str,
    block: int = 1 << 21,
) -> torch.Tensor:
    """A copy of ``reads`` with the single_window rule applied at the
    weak windows ``widx`` (sage2_tpu/kmer/correct.py:293 _phase2_kernel):
    the forward and RC keys of each window, its four variant canonical
    keys with base off set to 0-3 (off = k - 1 for "last", 0 for
    "first"), their counts, and the edit where the current base counts
    below the threshold and one variant alone reaches the maximum, which
    is at least the threshold. ``block`` windows at a time (their edit
    targets are distinct, so the blocks are independent)."""
    N, L = reads.shape
    P = L - k + 1
    off = k - 1 if which == "last" else 0
    dev = reads.device
    flat = reads.reshape(-1)
    out = reads.clone()
    # base off of the window: forward position off, RC position k-1-off
    # with the complemented code (ops/bitpack.set_base)
    wf = 1 << (2 * (k - 1 - off))
    wr = 1 << (2 * off)
    for b0 in range(0, widx.shape[0], block):
        w = widx[b0 : b0 + block]
        start = (w // P) * L + w % P
        codes = flat[start[:, None] + torch.arange(k, device=dev)[None, :]]
        fwd = torch.zeros_like(start)
        rc = torch.zeros_like(start)
        for j in range(k):
            c = codes[:, j].to(torch.int64)
            fwd = fwd * 4 + c
            rc = rc + ((3 - c) << (2 * j))
        cur = codes[:, off].to(torch.int64)
        variants = [torch.minimum(fwd + (b - cur) * wf, rc + (cur - b) * wr)
                    for b in range(4)]
        cnt4 = lookup_counts(table, counts, torch.stack(variants, dim=1))
        m = cnt4.max(dim=1).values
        n_at_max = (cnt4 == m[:, None]).sum(dim=1)
        cur_cnt = cnt4.gather(1, cur[:, None]).reshape(-1)
        best = cnt4.argmax(dim=1).to(reads.dtype)
        replace = (cur_cnt < threshold) & (m >= threshold) & (n_at_max == 1)
        out.reshape(-1)[(start + off)[replace]] = best[replace]
    return out


def chain_links(src: torch.Tensor, dst: torch.Tensor, ovl: torch.Tensor,
                n_vertices: int):
    """(outdeg, indeg, nxt, ovl_next, p) of unitig labeling
    (sage2_tpu/graph/traverse.py:40-77): the degrees, the chain edge out
    of each vertex (its successor and overlap, or -1 and 0) and the
    initial parent (the predecessor over a chain edge, else the vertex).
    The neighbour scatters keep an arbitrary writer where a degree
    exceeds 1; the masks read them only where it is 1."""
    V = n_vertices
    dev = src.device
    i32 = torch.int32
    is_edge = src != I32_MAX
    e_src = src[is_edge].to(torch.int64)
    e_dst = dst[is_edge].to(torch.int64)
    outdeg = torch.bincount(e_src, minlength=V).to(i32)
    indeg = torch.bincount(e_dst, minlength=V).to(i32)
    succ = torch.full((V,), -1, dtype=i32, device=dev)
    succ[e_src] = e_dst.to(i32)
    succ_ovl = torch.zeros((V,), dtype=i32, device=dev)
    succ_ovl[e_src] = ovl[is_edge]
    pred = torch.full((V,), -1, dtype=i32, device=dev)
    pred[e_dst] = e_src.to(i32)
    succ_c = succ.clamp(min=0).to(torch.int64)
    chain_out = (outdeg == 1) & (succ >= 0) & (indeg[succ_c] == 1)
    nxt = torch.where(chain_out, succ, -1).to(i32)
    ovl_next = torch.where(chain_out, succ_ovl, 0).to(i32)
    pred_c = pred.clamp(min=0)
    chain_in = (indeg == 1) & (pred >= 0) & (
        outdeg[pred_c.to(torch.int64)] == 1)
    p = torch.where(chain_in, pred_c,
                    torch.arange(V, dtype=i32, device=dev))
    return outdeg, indeg, nxt, ovl_next, p


def chain_cut(p: torch.Tensor, pf: torch.Tensor, m: torch.Tensor,
              nxt: torch.Tensor, ovl_next: torch.Tensor):
    """(p', d0) of the cycle cut (sage2_tpu/graph/traverse.py:96-107):
    breakers (p[pf] != pf and m == id, each cycle's least vertex) become
    their own parents, and the chain edge into each (out of its
    predecessor p[breaker]) is dissolved in ``nxt``/``ovl_next`` (in
    place); d0 = (p' != id)."""
    ids = torch.arange(p.shape[0], dtype=p.dtype, device=p.device)
    pf64 = pf.to(torch.int64)
    breaker = (p[pf64] != pf) & (m == ids)
    bpred = p[breaker].to(torch.int64)
    nxt[bpred] = -1
    ovl_next[bpred] = 0
    p_out = torch.where(breaker, ids, p)
    return p_out, (p_out != ids).to(p.dtype)


# --- the device mesh (parallel/sharded.py): K19-K22 -------------------------

_MIX_A, _MIX_B, _MIX_C = 0x9E3779B1, 0x85EBCA77, 0x7FEB352D


def owner_hash(keys: torch.Tensor, n: int, flip: bool = False
               ) -> torch.Tensor:
    """int64 owner in [0, n) of each int64 key: the uint32 mix of its
    (hi, lo) words (sage2_tpu/parallel/sharded.py:49 ``_owner``, the same
    function as overlap/detect.py:551 ``_mix32``) modulo n. ``flip``: the
    key is a 32-base seed key stored with its top bit flipped
    (ops/bitpack.py), unflipped before it is split."""
    hi = (keys >> 32) & _U32
    if flip:
        hi = hi ^ 0x80000000
    lo = keys & _U32
    h = (hi * _MIX_A + lo * _MIX_B) & _U32
    h = h ^ (h >> 16)
    h = (h * _MIX_C) & _U32
    h = h ^ (h >> 15)
    return h % n


class Route(NamedTuple):
    """One shard's side of a routed exchange (K19 ``route_rows``).

    send: (A, K) int32, the accepted rows, destination-major and by rank
    within a destination (what each destination receives from this
    shard); dest, rank: (Q,) int32 each input's destination and stable
    rank among the inputs bound there (the reference's ``_Routed.dest``
    and ``.rank``: an invalid input has dest n - 1 and a rank past that
    destination's valid ones); sent_ok: (Q,) bool, the input is in
    ``send``; counts: the accepted rows per destination (host ints);
    overflow: some destination was given more than ``cap`` valid rows
    (host bool); offsets: (n,) int64, each destination's first row in
    ``send``."""

    send: torch.Tensor
    dest: torch.Tensor
    rank: torch.Tensor
    sent_ok: torch.Tensor
    counts: Tuple[int, ...]
    overflow: bool
    offsets: torch.Tensor


def route_rows(rows: torch.Tensor, n: int, cap: int,
               owner: Optional[torch.Tensor] = None,
               keys: Optional[torch.Tensor] = None, flip: bool = False,
               valid: Optional[torch.Tensor] = None,
               answers: bool = True) -> Route:
    """Route the (Q, K) int32 ``rows`` to their owners among n shards
    (sage2_tpu/parallel/sharded.py:73 ``_route``, :128 ``_route_rows``):
    the owner is ``owner`` (Q,) int32, or ``owner_hash(keys, n, flip)``;
    invalid rows (``valid`` False) go nowhere. The rows are ranked
    stably within their owner in input order (the reference's stable
    sort by owner), and those of rank >= cap are dropped and flagged.
    Only the accepted rows are written (``Route.send``). ``answers``
    False (a one-way route, ``_route_rows``): dest, rank and sent_ok are
    None."""
    dev = rows.device
    Q = rows.shape[0]
    if owner is None:
        own = owner_hash(keys.reshape(-1), n, flip)
    else:
        own = owner.to(torch.int64)
    if valid is not None:
        own = torch.where(valid, own, n)
    s_own, s_idx = torch.sort(own, stable=True)
    start = torch.searchsorted(s_own, torch.arange(n, device=dev))
    rank_sorted = torch.arange(Q, device=dev) - start[s_own.clamp(max=n - 1)]
    ok_sorted = (s_own < n) & (rank_sorted < cap)
    dest = rank = sent_ok = None
    if answers:
        dest = torch.empty(Q, dtype=torch.int32, device=dev)
        rank = torch.empty(Q, dtype=torch.int32, device=dev)
        sent_ok = torch.empty(Q, dtype=torch.bool, device=dev)
        dest[s_idx] = s_own.clamp(max=n - 1).to(torch.int32)
        rank[s_idx] = rank_sorted.to(torch.int32)
        sent_ok[s_idx] = ok_sorted
    per = torch.bincount(own, minlength=n + 1)[:n]
    accepted = per.clamp(max=cap)
    offsets = torch.cumsum(accepted, 0) - accepted
    return Route(rows[s_idx[ok_sorted]], dest, rank, sent_ok,
                 tuple(int(c) for c in accepted), bool((per > cap).any()),
                 offsets)


def route_back(back: torch.Tensor, dest: torch.Tensor, rank: torch.Tensor,
               sent_ok: torch.Tensor, offsets: torch.Tensor,
               pos: Optional[torch.Tensor] = None,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q', K) int32: the owners' answers ``back`` (A, K) int32, laid out
    as the asker's send buffer, returned to the asker's inputs
    (sharded.py:120 ``_route_back``, :564 ``_route_back_rows``), 0 where
    an input was not sent; ``dest``, ``rank``, ``sent_ok`` and
    ``offsets`` are the asker's ``Route``'s. With ``pos`` (Q',) int32 the
    answer of entry i is input pos[i]'s (the request dedup's
    ``pos_of_orig``); with ``valid`` entries where it is False get 0."""
    dest = dest.to(torch.int64)
    slot = offsets[dest] + rank.to(torch.int64)
    K = back.shape[1]
    if back.shape[0] == 0:
        ans = torch.zeros((dest.shape[0], K), dtype=torch.int32,
                          device=back.device)
    else:
        ans = back[slot.clamp(0, back.shape[0] - 1)]
        ans = torch.where(sent_ok[:, None], ans, 0).to(torch.int32)
    if pos is not None:
        ans = ans[pos.to(torch.int64)]
    if valid is not None:
        ans = torch.where(valid[:, None], ans, 0).to(torch.int32)
    return ans


def dedup_heads(s_key: torch.Tensor, s_ord: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uniq, pos_of_orig) int32 of the request dedup of
    sharded.py:575 ``_dedup_routed_gather`` over ``s_key`` (Q,) int32,
    the requests sorted (invalid ones INT32_MAX, at the end), and
    ``s_ord`` (Q,) int64 their input positions: uniq[j] the key at the
    head of each run (INT32_MAX elsewhere), pos_of_orig[s_ord[j]] the
    head of j's run (the cummax of head positions)."""
    Q = s_key.shape[0]
    dev = s_key.device
    prev = torch.cat([torch.full((1,), -1, dtype=s_key.dtype, device=dev),
                      s_key[:-1]])
    is_head = (s_key != prev) & (s_key != I32_MAX)
    uniq = torch.where(is_head, s_key, I32_MAX).to(torch.int32)
    iota = torch.arange(Q, dtype=torch.int64, device=dev)
    head_pos = torch.cummax(torch.where(is_head, iota, 0), 0).values
    pos_of_orig = torch.empty(Q, dtype=torch.int32, device=dev)
    pos_of_orig[s_ord] = head_pos.to(torch.int32)
    return uniq, pos_of_orig


def gather_rows(idx: torch.Tensor, n: int, *tables: torch.Tensor
                ) -> torch.Tensor:
    """(R, len(tables)) int32: row j holds t[clip(idx[j] // n, 0, v_d -
    1)] of each cyclically partitioned (v_d,) int32 table (the owner's
    side of ``_dedup_routed_gather``, sharded.py:607-611)."""
    v_d = tables[0].shape[0]
    slot = torch.div(idx.to(torch.int64), n, rounding_mode="floor")
    slot = slot.clamp(0, max(v_d - 1, 0))
    if v_d == 0:
        return torch.zeros((idx.shape[0], len(tables)), dtype=torch.int32,
                           device=idx.device)
    return torch.stack([t[slot] for t in tables], dim=1).to(torch.int32)


def reduce_rows(ss_key: torch.Tensor, vbase: int, v_d: int) -> torch.Tensor:
    """(v_d + 1,) int64 vertex row table of a shard's adjacency ``ss_key``
    (E,) int64, sorted src << 32 | sl (or any composite key sorted by src
    first): row[i] is the first index whose src >= vbase + i, so vertex
    vbase + i's rows are [row[i], row[i + 1]). The (src, sl) and the
    (src, dst) orders of the same edges share it."""
    starts = torch.arange(int(v_d) + 1, dtype=torch.int64,
                          device=ss_key.device) + int(vbase)
    return torch.searchsorted(ss_key, starts << 32)


def _runs(v: torch.Tensor, row: torch.Tensor,
          vbase: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[lo, hi) of each vertex v's rows from the row table of [vbase,
    vbase + v_d); empty (0, 0) for a vertex outside it, which has no rows
    in its shard (the shard holds its own vertices' edges only)."""
    i = v.to(torch.int64) - vbase
    inr = (i >= 0) & (i < row.shape[0] - 1)
    return (torch.where(inr, row[torch.where(inr, i, 0)], 0),
            torch.where(inr, row[torch.where(inr, i + 1, 0)], 0))


def reduce_requests(ss_key: torch.Tensor, ss_dst: torch.Tensor,
                    req: torch.Tensor, cand_cap: int, row: torch.Tensor,
                    vbase: int):
    """(cand (C, 3) int32, ok (C,) bool, total) of phase 2 of
    sharded.py:394 ``sharded_transitive_reduction`` (:493-508) at w's
    owner: ``ss_key`` (E,) int64 the local adjacency sorted by src << 32
    | sl (padding INT32_MAX, INT32_MAX), ``ss_dst`` (E,) int32 beside
    it, ``req`` (R, 4) int32 the received requests [v, w, sl_vw,
    bound], ``row`` the shard's vertex row table of [vbase, vbase + v_d)
    (``reduce_rows``). Each request's adjacency range (w's run,
    sl <= bound), the total of their sizes, and the first C = min(total,
    cand_cap) candidates [v, x, sl_vw + sl_wx] in request order, rank
    order within a request (``expand_by_counts``); ok where x != v."""
    dev = req.device
    R = req.shape[0]
    rv, rw, rsl, rbound = (req[:, c].to(torch.int64) for c in range(4))
    start, run_end = _runs(rw, row, vbase)
    upto = torch.searchsorted(ss_key, (rw << 32) | rbound, right=True)
    counts = torch.minimum(torch.maximum(upto, start), run_end) - start
    total = int(counts.sum()) if R else 0
    C = min(total, cand_cap)
    group = torch.repeat_interleave(torch.arange(R, device=dev), counts)[:C]
    firsts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(C, device=dev) - firsts[group]
    e2 = start[group] + rank
    cv = rv[group]
    cx = ss_dst[e2].to(torch.int64)
    csl = rsl[group] + (ss_key[e2] & _U32)
    cand = torch.stack([cv, cx, csl], dim=1).to(torch.int32)
    return cand, cx != cv, total


def reduce_probe(src: torch.Tensor, dst: torch.Tensor, ovl: torch.Tensor,
                 cand: torch.Tensor, read_len, vbase: int,
                 row: torch.Tensor) -> torch.Tensor:
    """(E,) bool removal marks of phase 4 of
    ``sharded_transitive_reduction`` (:518-537) at v's owner: each
    received candidate (C, 3) int32 [v, x, sl] is looked up in v's run of
    the local (src, dst)-sorted edges (padding INT32_MAX; ``row`` the
    shard's vertex row table of [vbase, vbase + v_d)); an edge
    v -> x of offset len(v) - ovl == sl is marked. ``read_len``: an int,
    or the shard's (v_d,) int32 lengths of its vertex range [vbase,
    vbase + v_d), len(v) = lens[clip(v - vbase, 0, v_d - 1)]
    (:524-527)."""
    E = src.shape[0]
    removed = torch.zeros(E, dtype=torch.bool, device=src.device)
    if E == 0 or cand.shape[0] == 0:
        return removed
    key = (src.to(torch.int64) << 32) | dst.to(torch.int64)
    q = (cand[:, 0].to(torch.int64) << 32) | cand[:, 1].to(torch.int64)
    lo, hi = _runs(cand[:, 0], row, vbase)
    pos = torch.minimum(torch.maximum(torch.searchsorted(key, q), lo), hi)
    if isinstance(read_len, torch.Tensor):
        v_d = read_len.shape[0]
        local = (cand[:, 0].to(torch.int64) - vbase).clamp(0, max(v_d - 1, 0))
        plen = read_len[local].to(torch.int64)
    else:
        plen = read_len
    at = pos.clamp(max=E - 1)
    hit = (pos < hi) & (key[at] == q) & (plen - ovl[at] == cand[:, 2])
    removed[at[hit]] = True
    return removed


WHICH = ("last", "first")


def variant_position(k: int, which) -> int:
    """The window position j of ``which``: an int in [0, k), or "last"
    (k - 1) or "first" (0)."""
    if which == "last":
        return k - 1
    if which == "first":
        return 0
    if isinstance(which, bool) or not isinstance(which, int) or not (
            0 <= which < k):
        raise ValueError(f"which must be 'last', 'first' or a position in "
                         f"[0, {k}), not {which!r}")
    return which


def window_variants(reads: torch.Tensor, k: int, which) -> torch.Tensor:
    """(N, P, 4) int64 canonical keys of the 4 variants of base j of every
    window (``which``: the position j, or "last" / "first"): the forward
    key with base j set to b and the RC key with position k - 1 - j set
    to 3 - b, their minimum (sage2_tpu/kmer/correct.py:161-170
    ``set_base`` + ``canonicalize_pair``; :36 ``variant_keys_last``, :58
    ``variant_keys_first``; the reference stacks the variants first,
    (4, N, P))."""
    j = variant_position(k, which)
    fwd, rc, _ = kmer_keys(reads, k)
    P = fwd.shape[-1]
    cur = reads[:, j:j + P].to(torch.int64)[..., None]
    b = torch.arange(4, dtype=torch.int64, device=reads.device)
    vf = fwd[..., None] + (b - cur) * (1 << (2 * (k - 1 - j)))
    vr = rc[..., None] + (cur - b) * (1 << (2 * j))
    return torch.minimum(vf, vr)


def apply_verdicts(reads: torch.Tensor, counts: torch.Tensor, k: int,
                   which: str, threshold: int,
                   lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, L) int32 reads after the replacement rule of
    sage2_tpu/kmer/correct.py:86 ``apply_verdicts`` at each window's
    last or first base, from ``counts`` (N, P, 4) int32, the counts of
    ``window_variants``' keys: the base becomes the unique best variant
    when its own count is below threshold and the best reaches it.
    ``lengths``: a window past its read's end (w >= len - (k - 1)) edits
    nothing (``window_valid``, :99-100)."""
    N, P = counts.shape[:2]
    off = k - 1 if which == "last" else 0
    cur = reads[:, off:off + P].to(torch.int64)
    m = counts.max(dim=-1).values
    n_at_max = (counts == m[..., None]).sum(dim=-1)
    cur_cnt = counts.gather(-1, cur[..., None])[..., 0]
    best = torch.argmax(counts, dim=-1)
    replace = (cur_cnt < threshold) & (m >= threshold) & (n_at_max == 1)
    wvalid = _window_valid(lengths, N, P, k, reads.device)
    if wvalid is not None:
        replace &= wvalid
    out = reads.clone()
    out[:, off:off + P] = torch.where(replace, best, cur).to(reads.dtype)
    return out
