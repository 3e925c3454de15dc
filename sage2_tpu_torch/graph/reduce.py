"""Transitive reduction, host-native backend only (port of the native
branch of sage2_tpu/graph/reduce.py: transitive_reduction_native :364
and transitive_reduction_auto :470).

Myers (2005) string-graph reduction: edge v->x is removed when some w
has v->w and w->x with matching offsets. After the overlap stage the
edge list is on the host, and csrc/reduce_host.cpp reduces it there.
The device backends are still to be ported (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from sage2_tpu_torch.graph import reduce_native

_I32_MAX = 2**31 - 1


class ReducedGraph(NamedTuple):
    """Reduced edge list (host arrays), sorted by (src, dst), padded to
    the input length with (INT32_MAX, INT32_MAX, 0)."""

    src: np.ndarray
    dst: np.ndarray
    ovl: np.ndarray
    n_edges: int
    n_expansions: int


def transitive_reduction_native(
    src, dst, ovl, n_vertices: int, read_len: int,
    n_threads: Optional[int] = None,
) -> ReducedGraph:
    src_np = np.ascontiguousarray(np.asarray(src), np.int32)
    dst_np = np.ascontiguousarray(np.asarray(dst), np.int32)
    ovl_np = np.ascontiguousarray(np.asarray(ovl), np.int32)
    removed, total = reduce_native.reduce_marks(
        src_np, dst_np, ovl_np, n_vertices, read_len, n_threads=n_threads)
    E = src_np.shape[0]
    keep = (src_np != _I32_MAX) & ~removed
    n_edges = int(keep.sum())
    # kept rows are already (src, dst)-sorted; padding goes to the tail
    pad = E - n_edges
    return ReducedGraph(
        np.concatenate([src_np[keep], np.full(pad, _I32_MAX, np.int32)]),
        np.concatenate([dst_np[keep], np.full(pad, _I32_MAX, np.int32)]),
        np.concatenate([ovl_np[keep], np.zeros(pad, np.int32)]),
        n_edges, int(total),
    )


def transitive_reduction_auto(
    src, dst, ovl, n_vertices: int, read_len, backend: str = "auto",
    n_threads: Optional[int] = None,
) -> ReducedGraph:
    """Backend dispatcher: "auto" and "native" reduce host arrays with
    the native backend; "device" is not ported yet."""
    if backend not in ("auto", "native", "device"):
        raise ValueError(f"unknown reduce backend: {backend!r}")
    if backend == "device":
        raise NotImplementedError(
            "the device reduction is not ported yet (ROADMAP Queue 1 "
            "item 9)")
    if not isinstance(read_len, (int, np.integer)):
        raise NotImplementedError(
            "ragged reads are not ported yet (ROADMAP Queue 1 item 10)")
    return transitive_reduction_native(src, dst, ovl, n_vertices,
                                       int(read_len), n_threads=n_threads)
