"""The port's hand-written CUDA kernels and their wrappers.

Four kernels carry the main path (sources in ``kernels/csrc``):

  K1 ``kmer_keys``      forward, RC and canonical k-mer keys
  K2 ``lookup_counts``  binary search of query keys in a count table
  K3 ``overlap_join``   run accounting, expansion and verify of the
                        sorted overlap seed rows (two launches)
  K4 ``pointer_jump``   one pointer-doubling step of unitig labeling

Each wrapper takes its plain version (``kernels.plain``) only for a
tensor on the CPU. For a CUDA tensor it launches its kernel, on the
current stream, or raises: nothing falls back. Every wrapper adds one
to ``LAUNCHES[name]`` for each kernel it launches (``overlap_join``
launches two per call).

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use, one
``.so`` per source, all compiled at once (``load_all``), and bound with
ctypes through a plain C interface.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Dict, Optional, Tuple

import torch

from sage2_tpu_torch.kernels import plain
from sage2_tpu_torch.utils import native_build

KERNELS = ("kmer_keys", "lookup_counts", "overlap_join", "pointer_jump")

# launches per kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    "kmer_keys": {
        "sage2_kmer_keys": [_P, _I64, _I, _I, _P, _P, _P, _P],
    },
    "lookup_counts": {
        "sage2_lookup_counts": [_P, _P, _I64, _P, _I64, _P, _P],
    },
    "overlap_join": {
        "sage2_join_count": [_P, _P, _I64, _I, _I, _P, _P, _P],
        "sage2_join_write": [_P, _P, _I, _I64, _P, _P, _P, _I, _I, _I,
                             _I, _P, _P, _P, _P, _P],
    },
    "pointer_jump": {
        "sage2_pointer_jump": [_P, _P, _P, _P, _I64, _I, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def nvcc_command() -> list:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _specs():
    cmd = nvcc_command()
    common = os.path.join(_CSRC, "common.cuh")
    return [
        native_build.LibSpec(name, cmd, [os.path.join(_CSRC, name + ".cu")],
                             [common])
        for name in KERNELS
    ]


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build (concurrently) and load every kernel library; raises
    native_build.BuildError when nvcc fails."""
    with _lock:
        if len(_libs) == len(KERNELS):
            return _libs
        paths = native_build.build_all(_specs())
        for name, path in zip(KERNELS, paths):
            lib = ctypes.CDLL(path)
            for fn, argtypes in _ARGTYPES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.sage2_error_string.argtypes = [ctypes.c_int]
            lib.sage2_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs


def _launch(name: str, fn: str, *args) -> None:
    lib = load_all()[name]
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.sage2_error_string(rc).decode()
        raise RuntimeError(f"{name}: {fn} launch failed: CUDA error {rc} "
                           f"({msg})")


def _on_cpu(*tensors) -> bool:
    """True for CPU tensors; checks CUDA tensors are contiguous."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types != {"cuda"}:
        raise ValueError(f"tensors on mixed or unsupported devices: {types}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return False


def _dtype(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def kmer_keys(
    reads: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(fwd, rc, canonical) int64 keys, each (N, L - k + 1), of the
    (N, L) int32 codes (0-3); 1 < k <= 32 (see kernels/csrc/kmer_keys.cu
    for the key layout)."""
    if not 1 < k <= 32:
        raise ValueError(f"k must be in (1, 32], got {k}")
    N, L = reads.shape
    P = L - k + 1
    if P < 1:
        raise ValueError(f"k ({k}) exceeds read length ({L})")
    if _on_cpu(reads):
        return plain.kmer_keys(reads, k)
    _dtype(reads, torch.int32, "reads")
    out = [torch.empty((N, P), dtype=torch.int64, device=reads.device)
           for _ in range(3)]
    if N * P:
        _launch("kmer_keys", "sage2_kmer_keys", _ptr(reads), N, L, k,
                *map(_ptr, out), _stream())
        LAUNCHES["kmer_keys"] += 1
    return tuple(out)


def lookup_counts(
    table: torch.Tensor, counts: torch.Tensor, queries: torch.Tensor
) -> torch.Tensor:
    """int32 count of each int64 query key in the sorted unique int64
    ``table`` (``counts`` int32 beside it), 0 where absent."""
    if _on_cpu(table, counts, queries):
        return plain.lookup_counts(table, counts, queries)
    _dtype(table, torch.int64, "table")
    _dtype(counts, torch.int32, "counts")
    _dtype(queries, torch.int64, "queries")
    out = torch.empty(queries.shape, dtype=torch.int32,
                      device=queries.device)
    if queries.numel():
        _launch("lookup_counts", "sage2_lookup_counts", _ptr(table),
                _ptr(counts), table.shape[0], _ptr(queries),
                queries.numel(), _ptr(out), _stream())
        LAUNCHES["lookup_counts"] += 1
    return out


def overlap_join(
    s_keys: torch.Tensor,
    s_rows: torch.Tensor,
    payload: torch.Tensor,
    R: int,
    g: int,
    trim: int,
    min_overlap: int,
):
    """(ok bool, cand_a, cand_b, ovl int32, total) over the sorted live
    seed rows: ``s_keys`` int64 and ``s_rows`` int32 row ids, sorted by
    key with entries before queries inside a key; ``payload`` (rows,
    Wt + 2) int32 indexed by row id. Output arrays hold exactly
    ``total`` candidates (one host sync reads it between the passes)."""
    if _on_cpu(s_keys, s_rows, payload):
        return plain.overlap_join(s_keys, s_rows, payload, R, g, trim,
                                  min_overlap)
    _dtype(s_keys, torch.int64, "s_keys")
    _dtype(s_rows, torch.int32, "s_rows")
    _dtype(payload, torch.int32, "payload")
    dev = s_keys.device
    n = s_keys.shape[0]

    def empty(size, dtype):
        return torch.empty(size, dtype=dtype, device=dev)

    if n == 0:
        z = empty(0, torch.int32)
        return empty(0, torch.bool), z, z.clone(), z.clone(), 0
    counts = empty(n, torch.int32)
    ebase = empty(n, torch.int32)
    _launch("overlap_join", "sage2_join_count", _ptr(s_keys), _ptr(s_rows),
            n, R, g, _ptr(counts), _ptr(ebase), _stream())
    LAUNCHES["overlap_join"] += 1
    offsets = torch.cumsum(counts, 0, dtype=torch.int64)
    total = int(offsets[-1])
    starts = offsets - counts
    ok = empty(total, torch.bool)
    cand = [empty(total, torch.int32) for _ in range(3)]
    _launch("overlap_join", "sage2_join_write", _ptr(s_rows), _ptr(payload),
            payload.shape[1], n, _ptr(counts), _ptr(ebase), _ptr(starts),
            R, g, trim, min_overlap, _ptr(ok), *map(_ptr, cand), _stream())
    LAUNCHES["overlap_join"] += 1
    return (ok, *cand, total)


_JUMP_OPS = {"none": 0, "min": 1, "add": 2}


def pointer_jump(
    p: torch.Tensor, val: Optional[torch.Tensor] = None, op: str = "none"
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One doubling step (p[p], op(val, val[p])) over int32 (V,) arrays,
    op in "none" | "min" | "add"."""
    if op not in _JUMP_OPS:
        raise ValueError(f"unknown pointer_jump op {op!r}")
    if (op == "none") != (val is None):
        raise ValueError("val must be given exactly when op != 'none'")
    tensors = (p,) if val is None else (p, val)
    if _on_cpu(*tensors):
        return plain.pointer_jump(p, val, op)
    for t in tensors:
        _dtype(t, torch.int32, "pointer_jump input")
    p_out = torch.empty_like(p)
    v_out = None if val is None else torch.empty_like(val)
    if p.numel():
        _launch("pointer_jump", "sage2_pointer_jump", _ptr(p), _ptr(p_out),
                _ptr(val), _ptr(v_out), p.numel(), _JUMP_OPS[op],
                _stream())
        LAUNCHES["pointer_jump"] += 1
    return p_out, v_out
