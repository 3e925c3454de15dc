"""ctypes binding of the native transitive-reduction backend
(csrc/reduce_host.cpp, built from its place in the repo; port of
sage2_tpu/graph/reduce_native.py).

The library is built with g++ into the port's build folder, keyed by a
hash of source and flags and without -march=native
(utils/native_build.py). A failed build raises; where the reference
falls back to its device kernels, the port asks for
reduce_backend="device" explicitly.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from sage2_tpu_torch.utils import native_build

SOURCE = os.path.join(native_build.REPO_ROOT, "csrc", "reduce_host.cpp")
COMMAND = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        (path,) = native_build.build_all(
            [native_build.LibSpec("sage2reduce", COMMAND, [SOURCE])])
        lib = ctypes.CDLL(path)
        lib.sage2_transitive_reduce.restype = ctypes.c_int64
        lib.sage2_transitive_reduce.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # src
            ctypes.POINTER(ctypes.c_int32),  # dst
            ctypes.POINTER(ctypes.c_int32),  # ovl
            ctypes.c_int64,                  # n_total
            ctypes.c_int32,                  # n_vertices
            ctypes.c_int32,                  # fixed_len (<0 = ragged)
            ctypes.POINTER(ctypes.c_int32),  # lens (or NULL)
            ctypes.c_int32,                  # n_threads
            ctypes.POINTER(ctypes.c_uint8),  # removed_out
        ]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def reduce_marks(
    src: np.ndarray,
    dst: np.ndarray,
    ovl: np.ndarray,
    n_vertices: int,
    read_len,
    n_threads: Optional[int] = None,
    removed_out: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, int]:
    """Removal mask + exact expansion total of the (src, dst)-sorted
    int32 edge arrays (padding src == INT32_MAX at the tail);
    ``read_len`` is the read length, or a (V,) array of per-vertex
    lengths for ragged reads. Memmap inputs pass straight to the C++
    side. ``removed_out``: an (E,) uint8 destination (a spill memmap)
    for the marks, returned as they are (no bool copy)."""
    lib = _load()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    ovl = np.ascontiguousarray(ovl, np.int32)
    E = src.shape[0]
    if removed_out is not None:
        if removed_out.shape != (E,) or removed_out.dtype != np.uint8:
            raise ValueError(f"removed_out must be ({E},) uint8")
        removed = removed_out
        removed[:] = 0
    else:
        removed = np.zeros(E, np.uint8)
    if isinstance(read_len, (int, np.integer)):
        fixed, lens_ptr = int(read_len), None
    else:
        fixed = -1
        lens = np.ascontiguousarray(read_len, np.int32)
        if lens.shape[0] < n_vertices:
            # the C++ side reads lens[v] for every v < n_vertices
            raise ValueError(f"reduce_marks: lens has {lens.shape[0]} "
                             f"entries but n_vertices={n_vertices}")
        lens_ptr = _ptr(lens)
    nt = n_threads or os.cpu_count() or 1
    total = lib.sage2_transitive_reduce(
        _ptr(src), _ptr(dst), _ptr(ovl), ctypes.c_int64(E),
        ctypes.c_int32(int(n_vertices)), ctypes.c_int32(fixed),
        lens_ptr, ctypes.c_int32(int(nt)),
        removed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if total < 0:
        raise ValueError(
            "sage2_transitive_reduce: malformed edge list (src/dst out of "
            "range or not (src, dst)-sorted)"
        )
    if removed_out is not None:
        return removed, int(total)
    return removed.astype(bool), int(total)
