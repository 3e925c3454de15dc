"""ctypes binding of the native transitive-reduction backend
(csrc/reduce_host.cpp, built from its place in the repo; port of
sage2_tpu/graph/reduce_native.py).

The library is built with g++ into the port's build folder, keyed by a
hash of source and flags and without -march=native
(utils/native_build.py). A failed build raises: the port has no device
reduction to fall back to yet (ROADMAP Queue 1 item 9).
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
    read_len: int,
    n_threads: Optional[int] = None,
) -> tuple[np.ndarray, int]:
    """Removal mask + exact expansion total of the (src, dst)-sorted
    int32 edge arrays (padding src == INT32_MAX at the tail), for
    fixed-length reads of ``read_len``."""
    lib = _load()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    ovl = np.ascontiguousarray(ovl, np.int32)
    E = src.shape[0]
    removed = np.zeros(E, np.uint8)
    nt = n_threads or os.cpu_count() or 1
    total = lib.sage2_transitive_reduce(
        _ptr(src), _ptr(dst), _ptr(ovl), ctypes.c_int64(E),
        ctypes.c_int32(int(n_vertices)), ctypes.c_int32(int(read_len)),
        None, ctypes.c_int32(int(nt)),
        removed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if total < 0:
        raise ValueError(
            "sage2_transitive_reduce: malformed edge list (src/dst out of "
            "range or not (src, dst)-sorted)"
        )
    return removed.astype(bool), int(total)
