"""Transitive reduction of the string graph (port of
sage2_tpu/graph/reduce.py: the in-core transitive_reduction :44, the
chunked transitive_reduction_chunked :220, the native backend :364, its
spilled form transitive_reduction_spill :414 and the dispatcher
transitive_reduction_auto :470).

Myers (2005) string-graph reduction: edge v->x (offset sl = len(v) -
overlap) is removed when some w has v->w and w->x with sl_vx = sl_vw +
sl_wx. Implication is defined on the original edge set, so one pass
suffices. ``read_len`` is the read length, or a (V,) array of
per-vertex lengths for ragged reads (offsets stay additive along paths,
each in its source read's coordinates).

Two backends:

  native  the host C++ of csrc/reduce_host.cpp, for numpy edge arrays;
  device  torch tensors, on the card through two kernels: the edges are
          sorted stably by the composite key src << 32 | sl
          (ops.sort.sort_by_pair), K6 (``kernels.reduce_counts``) gives
          each vertex's run bounds and each edge's expansion count, and
          K7 (``kernels.reduce_marks``) probes the length-2 paths slot by
          slot, in launches of at most 2^24 slots, marking implied
          edges. The kept rows are compacted with torch ops.

The in-core form probes only the slots below its ``capacity`` and
reports ``overflow``, as the reference does (the slot order is edge
order, then rank in w's (src, sl) run, which is why the sort is
stable). The chunked form probes every slot.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sage2_tpu_torch import kernels
from sage2_tpu_torch.graph import reduce_native
from sage2_tpu_torch.ops.sort import I32_MAX, sort_by_pair
from sage2_tpu_torch.utils.device import resolve_device

# the most expansion slots one K7 launch probes (the reference's chunk_cap)
LAUNCH_SLOTS = 1 << 24


class ReducedGraph(NamedTuple):
    """Reduced edge list, sorted by (src, dst), padded to the input
    length with (INT32_MAX, INT32_MAX, 0). The arrays are numpy from
    the native backend and torch tensors on the input's device from the
    device backend.

    n_expansions: the exact length-2 path count; overflow: the in-core
    form's expansion exceeded its capacity (its result then covers only
    the first ``capacity`` expansion slots). Always False from the
    native and chunked forms.
    """

    src: object
    dst: object
    ovl: object
    n_edges: int
    n_expansions: int
    overflow: bool


def transitive_reduction_native(
    src, dst, ovl, n_vertices: int, read_len,
    n_threads: Optional[int] = None,
) -> ReducedGraph:
    src_np = np.ascontiguousarray(np.asarray(src), np.int32)
    dst_np = np.ascontiguousarray(np.asarray(dst), np.int32)
    ovl_np = np.ascontiguousarray(np.asarray(ovl), np.int32)
    removed, total = reduce_native.reduce_marks(
        src_np, dst_np, ovl_np, n_vertices, read_len, n_threads=n_threads)
    E = src_np.shape[0]
    keep = (src_np != I32_MAX) & ~removed
    n_edges = int(keep.sum())
    # kept rows are already (src, dst)-sorted; padding goes to the tail
    pad = E - n_edges
    return ReducedGraph(
        np.concatenate([src_np[keep], np.full(pad, I32_MAX, np.int32)]),
        np.concatenate([dst_np[keep], np.full(pad, I32_MAX, np.int32)]),
        np.concatenate([ovl_np[keep], np.zeros(pad, np.int32)]),
        n_edges, int(total), False,
    )


def transitive_reduction_spill(
    store, src, dst, ovl, n_vertices: int, read_len,
    n_threads: Optional[int] = None, window: int = 1 << 22,
) -> ReducedGraph:
    """The native reduction with O(window) host RAM: the marks land in
    the store's ``reduce_marks`` memmap and the kept edges are compacted
    window by window into its ``reduced_src``/``reduced_dst``/
    ``reduced_ovl`` files, padded to a 2^14 grain above n_edges (not to
    the input length) with (INT32_MAX, INT32_MAX, 0). The edges are
    transitive_reduction_native's."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    ovl = np.ascontiguousarray(ovl, np.int32)
    E = src.shape[0]
    marks = store.empty("reduce_marks", np.uint8, (E,))
    _, total = reduce_native.reduce_marks(
        src, dst, ovl, n_vertices, read_len, n_threads=n_threads,
        removed_out=marks)
    writers = [store.writer(n, np.int32)
               for n in ("reduced_src", "reduced_dst", "reduced_ovl")]
    n_edges = 0
    for w0 in range(0, E, window):
        s = src[w0 : w0 + window]
        keep = (s != I32_MAX) & (marks[w0 : w0 + window] == 0)
        n_edges += int(keep.sum())
        writers[0].append(s[keep])
        writers[1].append(dst[w0 : w0 + window][keep])
        writers[2].append(ovl[w0 : w0 + window][keep])
    pad_to = max(1, -(-n_edges // (1 << 14)) * (1 << 14))
    return ReducedGraph(
        writers[0].close(pad_to=pad_to, fill=I32_MAX),
        writers[1].close(pad_to=pad_to, fill=I32_MAX),
        writers[2].close(pad_to=pad_to, fill=0),
        n_edges, int(total), False,
    )


def _device_reduce(src, dst, ovl, n_vertices: int, read_len,
                   slot_end: Optional[int],
                   launch_slots: int = LAUNCH_SLOTS) -> ReducedGraph:
    """The device backend: prep (sort + K6), marks over the slots
    [0, min(total, slot_end)) in K7 launches of ``launch_slots``, and
    compaction. ``slot_end`` None means every slot."""
    if not all(isinstance(t, torch.Tensor) for t in (src, dst, ovl)):
        raise TypeError("the device reduction takes torch tensors; "
                        "transitive_reduction_auto places numpy arrays")
    src, dst, ovl = (t.to(torch.int32).contiguous() for t in (src, dst, ovl))
    E = src.shape[0]
    is_edge = src != I32_MAX
    if isinstance(read_len, (int, np.integer)):
        L = src_len = int(read_len)
    else:
        # per-vertex lengths: K6 and K7 read len(v) from the tensor
        L = torch.as_tensor(read_len).to(device=src.device,
                                         dtype=torch.int32).contiguous()
        src_len = L[src.clamp(0, max(n_vertices - 1, 0)).long()]
    sl = torch.where(is_edge, src_len - ovl, I32_MAX)
    keys, order = sort_by_pair(src, sl)
    ss_dst = dst[order]
    ss_sl = (keys & 0xFFFFFFFF).to(torch.int32)
    start, _, startd, counts = kernels.reduce_counts(
        keys, src, dst, ovl, n_vertices, L)
    del keys, order, sl
    offsets = torch.cumsum(counts, 0, dtype=torch.int64)
    total = int(offsets[-1]) if E else 0
    end = total if slot_end is None else min(total, slot_end)
    removed = torch.zeros(E, dtype=torch.uint8, device=src.device)
    for j0 in range(0, end, launch_slots):
        kernels.reduce_marks(removed, offsets, src, dst, ovl, ss_sl, ss_dst,
                             start, startd, L, j0,
                             min(j0 + launch_slots, end))
    keep = is_edge & (removed == 0)
    n_edges = int(keep.sum())
    pad = E - n_edges

    def compact(a, fill):
        return torch.cat([a[keep], a.new_full((pad,), fill)])

    return ReducedGraph(compact(src, I32_MAX), compact(dst, I32_MAX),
                        compact(ovl, 0), n_edges, total,
                        slot_end is not None and total > slot_end)


def transitive_reduction(
    src: torch.Tensor, dst: torch.Tensor, ovl: torch.Tensor,
    n_vertices: int, read_len, capacity: int = 1 << 20,
) -> ReducedGraph:
    """In-core reduction of the (src, dst)-sorted int32 edge tensors
    with the reference's fixed expansion ``capacity``: only the first
    ``capacity`` expansion slots are probed, and ``overflow`` is set
    when there are more. Runs on the tensors' device (the plain
    versions on the CPU)."""
    return _device_reduce(src, dst, ovl, n_vertices, read_len, capacity)


def transitive_reduction_chunked(
    src: torch.Tensor, dst: torch.Tensor, ovl: torch.Tensor,
    n_vertices: int, read_len, chunk_cap: int = LAUNCH_SLOTS,
) -> ReducedGraph:
    """Exact reduction of the edge tensors: every expansion slot is
    probed, in K7 launches of at most ``min(chunk_cap, 2^24)`` slots;
    ``overflow`` is False.

    The reference also splits its edge list into slices whose
    expansion must fit ``chunk_cap`` and raises ValueError("cannot
    balance expansion ...") when one edge alone exceeds it after six
    doublings. Slot ranges need no such balance, so that error does not
    exist here."""
    if chunk_cap < 1:
        raise ValueError(f"chunk_cap must be positive, got {chunk_cap}")
    return _device_reduce(src, dst, ovl, n_vertices, read_len, None,
                          min(chunk_cap, LAUNCH_SLOTS))


def transitive_reduction_auto(
    src, dst, ovl, n_vertices: int, read_len, backend: str = "auto",
    n_threads: Optional[int] = None, device="cuda",
) -> ReducedGraph:
    """Backend dispatcher, the reference's rule: "auto" reduces numpy
    (host) arrays with the native backend and tensors with the device
    backend; "native" and "device" force one. ``device`` places numpy
    arrays for the device backend ("cuda" by default)."""
    if backend not in ("auto", "native", "device"):
        raise ValueError(f"unknown reduce backend: {backend!r}")
    host_resident = isinstance(src, np.ndarray)
    if backend == "native" or (backend == "auto" and host_resident):
        if not host_resident:
            src, dst, ovl = (t.cpu().numpy() for t in (src, dst, ovl))
        if isinstance(read_len, torch.Tensor):
            read_len = read_len.cpu().numpy()
        return transitive_reduction_native(src, dst, ovl, n_vertices,
                                           read_len, n_threads=n_threads)
    if host_resident:
        dev = resolve_device(device)
        src, dst, ovl = (torch.from_numpy(np.require(a, np.int32, "CW"))
                         .to(dev) for a in (src, dst, ovl))
    return transitive_reduction_chunked(src, dst, ovl, n_vertices, read_len)
