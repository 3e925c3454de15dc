"""ctypes binding of the native circulation solver (csrc/flow_host.cpp,
built from its place in the repo; port of sage2_tpu/graph/flow_native.py).

The C++ solver replays the exact arc order, comparisons and cycle walks
of flowpaths.Circulation.solve, so flows are bit-identical to the Python
loops, which remain the fallback when the library cannot be built. The
build goes to the port's build folder, keyed by a hash of source and
flags, without -march=native (utils/native_build.py).
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading
from typing import Optional

import numpy as np

from sage2_tpu_torch.utils import native_build

SOURCE = os.path.join(native_build.REPO_ROOT, "csrc", "flow_host.cpp")
COMMAND = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            (path,) = native_build.build_all(
                [native_build.LibSpec("sage2flow", COMMAND, [SOURCE])])
            lib = ctypes.CDLL(path)
        except (OSError, native_build.BuildError) as e:
            print(f"[sage2.flow_native] unavailable: {e}", file=sys.stderr)
            _build_failed = True
            return None
        lib.sage2_solve_circulation.restype = ctypes.c_int64
        lib.sage2_solve_circulation.argtypes = [
            ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def solve_circulation(
    n: int,
    to: np.ndarray,
    cap: np.ndarray,
    cost: np.ndarray,
    max_iters: int,
) -> Optional[np.ndarray]:
    """Solve; returns the (m,) int64 flow array, or None if the native
    backend is unavailable or max_iters ran out (the caller then runs
    the Python loops)."""
    lib = _load()
    if lib is None:
        return None
    to = np.ascontiguousarray(to, np.int32)
    cap = np.ascontiguousarray(cap, np.int64)
    cost = np.ascontiguousarray(cost, np.int64)
    flow = np.zeros(to.shape[0], np.int64)
    rc = lib.sage2_solve_circulation(
        np.int32(n), np.int64(to.shape[0]),
        to.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cap.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        flow.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        np.int64(max_iters),
    )
    if rc < 0:
        return None
    return flow
