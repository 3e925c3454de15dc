"""ctypes binding of the native C++ ingest (csrc/sage2io.cpp) and the
single-threaded C++ overlap baseline (csrc/baseline_cpu.cpp); port of
sage2_tpu/io/native.py.

Both are built with g++ from their place in the repo into the port's
build folder, keyed by a hash of source and flags and without
-march=native (utils/native_build.py); nothing is read from or written
to ``csrc/build``. A failed build raises with the compiler's output:
where the reference falls back to the Python reader, the port's readers
fall back only when no compiler is installed (``available``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional

import numpy as np

from sage2_tpu_torch.utils import native_build

SOURCE = os.path.join(native_build.REPO_ROOT, "csrc", "sage2io.cpp")
BASELINE_SOURCE = os.path.join(native_build.REPO_ROOT, "csrc",
                               "baseline_cpu.cpp")
COMMAND = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]
BASELINE_COMMAND = ["g++", "-O3", "-std=c++17"]
LINK = ["-lz"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_POLICY = {"strict": 0, "trim": 1, "filter": 2}


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        (path,) = native_build.build_all(
            [native_build.LibSpec("sage2io", COMMAND, [SOURCE], link=LINK)])
        lib = ctypes.CDLL(path)
        lib.sage2_parse.restype = ctypes.POINTER(ctypes.c_int8)
        lib.sage2_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sage2_free.argtypes = [ctypes.POINTER(ctypes.c_int8)]
        lib.sage2_last_error.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native parser can be had: built already, or a C++
    compiler to build it. A compiler that fails raises in the parsers."""
    return _lib is not None or shutil.which("g++") is not None


def _parse(path: str, is_fasta: bool, length_policy: str) -> np.ndarray:
    lib = _load()
    n = ctypes.c_int64()
    l = ctypes.c_int64()
    buf = lib.sage2_parse(
        path.encode(), int(is_fasta), _POLICY[length_policy],
        ctypes.byref(n), ctypes.byref(l),
    )
    if not buf:
        raise ValueError(lib.sage2_last_error().decode())
    try:
        if n.value == 0:
            return np.zeros((0, 0), np.int8)
        arr = np.ctypeslib.as_array(buf, shape=(n.value, l.value)).copy()
    finally:
        lib.sage2_free(buf)
    return arr.astype(np.int8, copy=False)


def parse_fastq(path: str, length_policy: str = "strict") -> np.ndarray:
    """FASTQ(.gz) -> (N, L) int8 codes ('N' and unknown bases -> A)."""
    return _parse(path, False, length_policy)


def parse_fasta(path: str, length_policy: str = "strict") -> np.ndarray:
    """FASTA(.gz) -> (N, L) int8 codes. Unlike the Python reader, which
    ``fastq.read_fasta`` uses, it keeps spaces around sequence lines and
    drops sequence text before the first header."""
    return _parse(path, True, length_policy)


def baseline_binary() -> str:
    """Path of the single-threaded C++ baseline, built if needed:
    ``<path> overlap <reads.bin> <N> <L> <min_overlap>`` prints the
    verified overlap count and its seconds (csrc/baseline_cpu.cpp:12-14).
    Raises native_build.BuildError when g++ fails."""
    with _lock:
        (path,) = native_build.build_all([native_build.LibSpec(
            "baseline_cpu", BASELINE_COMMAND, [BASELINE_SOURCE],
            executable=True)])
    return path
