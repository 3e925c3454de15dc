"""The port's hand-written CUDA kernels and their wrappers.

Twenty-three kernels (sources in ``kernels/csrc``):

  K1 ``kmer_keys``      forward, RC and canonical k-mer keys
  K2 ``lookup_counts``  count of each query key in a count table: bucket
                        directory and bucketed search (two launches)
  K3 ``overlap_join``   run accounting, expansion and verify of the
                        sorted overlap seed rows (two launches: the runs
                        and their first slots by a look-back, then slot
                        tiles with the payload rows staged;
                        ``overlap_join_stacked`` the fixed-capacity mode)
  K4 ``pointer_jump``   a whole pointer-doubling loop of unitig labeling
                        (one cooperative launch)
  K5 ``vote_windows``   one round of the covering-window voting corrector:
                        bucket directory and vote (two launches);
                        the routed mode of the mesh, where the counts
                        come from the k-mer owners: ``vote_add`` (one
                        window position's votes) and ``vote_apply`` (the
                        rule)
  K6 ``reduce_counts``  run bounds and expansion counts of the device
                        transitive reduction (two launches: the vertex
                        row table with each vertex's largest sl, K21's
                        loop, and an 8-bit copy of the sl; then each
                        edge's count from its dst's run alone)
  K7 ``reduce_marks``   expansion, membership probe and removal marks of
                        the device transitive reduction, one slot range
  K8 ``canonical_reads`` reverse complement, packed words and canonical
                        choice of each read (the dedup stage; a block a
                        tile of reads; the words alone, or the rows alone
                        into a view of reads2)
  K9 ``seed_table``     sort keys of the streamed join's entry seeds, and
                        over the sorted keys its bucket table and slab
                        (two launches around one torch.sort)
  K10 ``probe_join``    probe, expansion, slab decode and verify of one
                        query chunk of the streamed join (two launches)
  K11 ``merge_runs``    unique keys and summed weights of the runs of a
                        sorted key array (k-mer counting, table merges;
                        one pass)
  K12 ``dedup_reads``   sort keys, grouping, multiplicities, vertices and
                        unique rows of the dedup (key launches around
                        chained torch.sort calls, then four grouping
                        launches)
  K13 ``seed_rows``     seed keys, live flags and payload rows of the
                        overlap join, and the live rows in the join's
                        sort order (the rows with their buckets counted,
                        then the bucketed sort of bucket_sort.cuh: scan,
                        coarse and fine scatter, sort; an entry slab:
                        the rows and a compaction; ``seed_rows_stacked``
                        the fixed-capacity mode)
  K14 ``longest_edges`` longest overlap per (src, dst) of the join's
                        candidates, compacted and padded (a histogram,
                        then the bucketed sort, whose blocks keep the
                        last row of each pair; ``longest_edges_deferred``
                        keeps every ok row)
  K15 ``prune_table``   the solid entries of a sorted count table, in
                        table order (one launch: tiles in ticket order,
                        their first slots by a look-back)
  K16 ``weak_windows``  flat indices of the weak windows of a correction
                        sub-pass, keys rolled from the reads and looked up
                        in a membership table of the solid keys (mask
                        with a look-back, write; the table built once a
                        round by ``table_directory``: ``solid_table``,
                        three launches)
  K17 ``fix_windows``   the variant lookups, replacement rule and edits
                        at the weak windows (each tile's range of them,
                        then a tile of reads a block: two launches)
  K18 ``chain_links``   degrees, single neighbours, chain links and the
                        initial parents of unitig labeling (two passes
                        over the rows, none without rows, and two over
                        the vertices); ``chain_cut`` the cycle cut after
                        K4's first two loops (one launch)
  K19 ``route_rows``   the owner shard of each row, its stable rank
                        among the rows bound there, and the accepted rows
                        written destination-major (histogram, then a
                        single-pass scatter with decoupled look-back; a
                        one-way mode writes no per-row answers; the send
                        side of every exchange of the mesh)
  K20 ``routed_gather`` the request dedup around one torch.sort
                        (``dedup_heads``), the owner's row gather
                        (``gather_rows``) and the answers' way back to the
                        asker (``route_back``)
  K21 ``reduce_requests`` the meshed reduction's vertex row table
                        (``reduce_rows``, once a pass), adjacency ranges
                        and candidate expansion (ranges, a merge-path
                        expand around a torch.cumsum) and membership
                        probe (``reduce_probe``, with the shard's lengths
                        for ragged reads)
  K22 ``window_variants`` the canonical keys of the 4 variants of base j
                        of every window (j any position, or the last or
                        first base), and the single_window verdicts from
                        their routed counts (``apply_verdicts``, with
                        lengths for ragged reads)
  P1 ``gather_along``   gather along one axis of an (N, W) table (the
                        Pallas probe's kernel; on no path of the package)

Each wrapper takes its plain version (``kernels.plain``) only for a
tensor on the CPU. For a CUDA tensor it launches its kernel, on the
current stream, or raises: nothing falls back. Every wrapper adds one
to ``LAUNCHES[name]`` for each kernel it launches (``lookup_counts``,
``overlap_join``, ``vote_windows``, ``reduce_counts``, ``seed_table`` and
``probe_join`` and ``weak_windows`` launch two per call,
``chain_links`` four (two without edge rows), K12-K14 more
(K13 and K14 six, K13's entry slab two); ``lookup_directory``,
K2's first launch, builds the directory that K16 and K17 share,
``solid_table`` (three launches under K16's name) K16's membership
table beside it, and
``chain_cut`` counts as a ``chain_links`` launch; the fixed-capacity and
deferred modes of K3, K13 and K14, find_overlaps_stacked's, count as
their kernel's launches and read nothing to the host; K19 launches two
a call with rows (none without), K21's ``reduce_requests`` two (one
when no candidate comes out), and the other wrappers of K20, K21 and
K22 (``route_back``, ``dedup_heads``, ``gather_rows``, ``reduce_rows``,
``reduce_probe``, ``apply_verdicts``) and K5's routed mode
(``vote_add``, ``vote_apply``) one each under their kernel's name). K12
and K13 take a ``split`` (utils.metrics.DeviceSplit) that marks the end
of their sort and of their grouping or row build.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use, one
``.so`` per source, all compiled at once (``load_all``), and bound with
ctypes through a plain C interface. A source's headers (``common.cuh``,
and ``bucket_search.cuh``, ``scan.cuh``, ``lookback.cuh``,
``bucket_sort.cuh`` or ``vertex_rows.cuh`` for those that include them,
``HEADERS``) are hashed with it, so an edit to a header rebuilds its
libraries.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import threading
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils.weak import WeakIdKeyDictionary

from sage2_tpu_torch.kernels import bucket_plan, plain
from sage2_tpu_torch.utils import native_build
from sage2_tpu_torch.utils.metrics import mark_part

KERNELS = ("kmer_keys", "lookup_counts", "overlap_join", "pointer_jump",
           "vote_windows", "reduce_counts", "reduce_marks", "canonical_reads",
           "seed_table", "probe_join", "merge_runs", "gather_along",
           "dedup_reads", "seed_rows", "longest_edges", "prune_table",
           "weak_windows", "fix_windows", "chain_links", "route_rows",
           "routed_gather", "reduce_requests", "window_variants")

# launches per kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    "kmer_keys": {
        "sage2_kmer_keys": [_P, _I64, _I, _I, _P, _P, _P, _P],
    },
    "lookup_counts": {
        "sage2_lookup_directory": [_P, _P, _I64, _I, _P, _P],
        "sage2_lookup_counts": [_P, _P, _I64, _P, _P, _I64, _P, _P],
    },
    "overlap_join": {
        "sage2_join_runs": [_P, _P, _I64, _P, _I, _I, _P, _P, _P, _P],
        "sage2_join_slots": [_P, _P, _I64, _I, _P, _I64, _I, _I, _I, _P, _P,
                             _P, _P, _I, _I, _I, _I, _I64, _P, _P, _P, _P,
                             _P, _P],
    },
    "pointer_jump": {
        "sage2_pointer_jump": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _P],
    },
    "vote_windows": {
        "sage2_vote_directory": [_P, _P, _I64, _I, _P, _P],
        "sage2_vote_windows": [_P, _P, _I64, _I, _I, _P, _P, _I64, _P, _I,
                               _P, _P],
        "sage2_vote_add": [_P, _P, _P, _I64, _I, _I, _I, _I, _P],
        "sage2_vote_apply": [_P, _P, _I64, _I, _P, _P],
    },
    "reduce_counts": {
        "sage2_reduce_table": [_P, _I64, _I64, _P, _P, _P, _P],
        "sage2_reduce_counts": [_P, _P, _P, _P, _P, _I64, _I64, _I, _P, _P,
                                _P, _P, _P],
    },
    "reduce_marks": {
        "sage2_reduce_marks": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                               _I64, _I64, _P],
    },
    "canonical_reads": {
        "sage2_canonical_reads": [_P, _P, _I64, _I, _P, _P, _P, _P, _P],
    },
    "seed_table": {
        "sage2_seed_keys": [_P, _P, _I64, _I, _I, _I, _I64, _P, _P],
        "sage2_seed_table": [_P, _I64, _P, _I, _I, _I64, _I, _P, _P, _P],
    },
    "probe_join": {
        "sage2_probe_count": [_P, _P, _I64, _I, _I, _I, _I, _I, _P, _P, _P,
                              _P],
        "sage2_probe_write": [_P, _I64, _I, _I, _I, _I, _I, _I64, _P, _P,
                              _P, _P, _I64, _P, _P, _P, _P, _P],
    },
    "merge_runs": {
        "sage2_merge_runs": [_P, _P, _I64, _P, _P, _P, _P],
    },
    "gather_along": {
        "sage2_gather_along": [_P, _P, _I64, _I64, _I, _P, _P, _P],
    },
    "dedup_reads": {
        "sage2_dedup_range": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I,
                              _I, _P, _P, _I, _P, _P],
        "sage2_dedup_hist": [_P, _I64, _I, _P, _P, _I, _P],
        "sage2_dedup_scan": [_P, _I, _P],
        "sage2_dedup_scatter": [_P, _I64, _I, _P, _P, _I, _P, _P],
        "sage2_dedup_split": [_P, _P, _I, _I, _P, _P, _P],
        "sage2_dedup_big": [_P, _P, _P, _I, _I64, _I, _P],
        "sage2_dedup_sort": [_P, _P, _P, _I, _I64, _I, _P, _I64, _P, _P, _P,
                             _P, _P, _P],
        "sage2_dedup_rows": [_P, _P, _I, _P, _P, _P, _I64, _I, _I, _I, _P,
                             _P, _P, _P],
    },
    "seed_rows": {
        "sage2_seed_rows": [_P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I,
                            _P, _P, _P, _P, _I64, _P, _I, _P],
        "sage2_seed_scan": [_P, _I, _P],
        "sage2_seed_scatter": [_P, _P, _I64, _I, _I, _I, _I, _I64, _P, _P,
                               _I64, _P, _I, _P, _P],
        "sage2_seed_split": [_P, _P, _P, _I, _P],
        "sage2_seed_big": [_P, _P, _P, _I, _I64, _P, _P, _P],
        "sage2_seed_sort": [_P, _P, _I, _I64, _P, _P, _P],
        "sage2_seed_compact": [_P, _P, _I64, _I, _I, _I, _I, _I64, _P, _P,
                               _P, _P],
    },
    "longest_edges": {
        "sage2_edge_hist": [_P, _P, _I64, _I64, _I64, _P, _I, _P],
        "sage2_edge_scan": [_P, _I, _P],
        "sage2_edge_scatter": [_P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I,
                               _P, _I, _P, _P],
        "sage2_edge_split": [_P, _P, _P, _I, _I64, _I64, _I, _I, _I, _P],
        "sage2_edge_big": [_P, _P, _P, _I, _I64, _I, _I, _I, _I, _P, _P, _P,
                           _P],
        "sage2_edge_sort": [_P, _P, _P, _I, _I64, _I, _I, _I, _I64, _I, _P,
                            _P, _P, _P],
    },
    "prune_table": {
        "sage2_prune_tile": [_P],
        "sage2_prune_table": [_P, _P, _I64, _I, _P, _P, _P, _P],
    },
    "weak_windows": {
        "sage2_solid_table": [_P, _P, _I64, _I, _I, _I, _P, _P, _P],
        "sage2_weak_mask": [_P, _P, _I64, _I, _I, _P, _P, _I64, _P, _P, _I,
                            _P, _P, _P],
        "sage2_weak_write": [_P, _I64, _I, _P, _P, _P],
    },
    "fix_windows": {
        "sage2_fix_tiles": [_I64, _I, _P],
        "sage2_fix_starts": [_P, _I64, _I64, _I, _I, _P, _P],
        "sage2_fix_windows": [_P, _I64, _I, _I, _P, _P, _I64, _P, _P, _I,
                              _I, _P, _P, _P, _P],
    },
    "chain_links": {
        "sage2_chain_links": [_P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P,
                              _P, _P, _P, _P],
        "sage2_chain_cut": [_P, _P, _P, _I64, _P, _P, _P, _P, _P],
    },
    "route_rows": {
        "sage2_route_hist": [_P, _P, _I, _P, _I64, _I, _P, _P],
        "sage2_route_scatter": [_P, _P, _I, _P, _I64, _I, _I, _P, _I, _I,
                                _P, _P, _P, _P, _P, _P, _P],
    },
    "routed_gather": {
        "sage2_heads_tile": [_P],
        "sage2_dedup_heads": [_P, _P, _I64, _P, _P, _P],
        "sage2_gather_rows": [_P, _P, _I64, _P, _I64, _I, _P, _P],
        "sage2_route_back": [_P, _I, _P, _P, _P, _P, _P, _P, _I64, _P, _P],
    },
    "reduce_requests": {
        "sage2_reduce_rows": [_P, _I64, _I64, _I64, _P, _P],
        "sage2_reduce_ranges": [_P, _P, _I64, _I64, _P, _I64, _P, _P, _P],
        "sage2_reduce_expand": [_P, _P, _P, _I64, _P, _P, _I64, _P, _P, _P],
        "sage2_reduce_probe": [_P, _P, _P, _I64, _I64, _P, _I64, _I, _P,
                               _I64, _P, _P],
    },
    "window_variants": {
        "sage2_window_variants": [_P, _I64, _I, _I, _I, _P, _P],
        "sage2_apply_verdicts": [_P, _P, _P, _I64, _I, _I, _I, _I, _P,
                                 _P],
    },
}

# dynamic shared memory a block may use on the card (sm_90)
_MAX_SMEM = 232_448
# keys a tile of K11 (kTile in kernels/csrc/merge_runs.cu)
MERGE_TILE = 3072

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


# the headers each source includes besides common.cuh
HEADERS = {"lookup_counts": ("bucket_search.cuh",),
           "reduce_counts": ("vertex_rows.cuh",),
           "reduce_requests": ("vertex_rows.cuh",),
           "overlap_join": ("lookback.cuh", "scan.cuh"),
           "vote_windows": ("bucket_search.cuh",),
           "dedup_reads": ("scan.cuh", "lookback.cuh", "bucket_sort.cuh"),
           "seed_rows": ("scan.cuh", "lookback.cuh", "bucket_sort.cuh"),
           "longest_edges": ("scan.cuh", "lookback.cuh", "bucket_sort.cuh"),
           "prune_table": ("lookback.cuh", "scan.cuh"),
           "routed_gather": ("scan.cuh",),
           "weak_windows": ("bucket_search.cuh", "lookback.cuh",
                            "solid_table.cuh"),
           "fix_windows": ("bucket_search.cuh", "solid_table.cuh")}


def _specs():
    cmd = nvcc_command()
    return [
        native_build.LibSpec(
            name, cmd, [os.path.join(_CSRC, name + ".cu")],
            [os.path.join(_CSRC, h)
             for h in ("common.cuh",) + HEADERS.get(name, ())])
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
    lib = _libs.get(name) or load_all()[name]
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.sage2_error_string(rc).decode()
        raise RuntimeError(f"{name}: {fn} launch failed: CUDA error {rc} "
                           f"({msg})")


def _on_cpu(*tensors) -> bool:
    """True for CPU tensors; checks CUDA tensors are contiguous and on
    one card."""
    devices = {t.device for t in tensors}
    types = {d.type for d in devices}
    if types == {"cpu"}:
        return True
    if types != {"cuda"}:
        raise ValueError(f"tensors on mixed or unsupported devices: {types}")
    if len(devices) > 1:
        raise ValueError(f"kernel inputs on several cards: "
                         f"{sorted(str(d) for d in devices)}")
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


def _first_tensor(args) -> Optional[torch.Tensor]:
    for a in args:
        if isinstance(a, (list, tuple)):
            a = _first_tensor(a)
        if isinstance(a, torch.Tensor):
            return a
    return None


def _on_device(fn):
    """Runs a wrapper with the current CUDA device set to its tensors'
    card, so that its launches, its ``_stream()`` and the CUDA runtime
    calls of its kernels go to the card that holds its data (a mesh puts
    its shards on several cards); on the current card or the CPU it
    calls ``fn`` as it is."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t = _first_tensor((*args, *kwargs.values()))
        if (t is None or not t.is_cuda
                or t.device.index == torch.cuda.current_device()):
            return fn(*args, **kwargs)
        with torch.cuda.device(t.device):
            return fn(*args, **kwargs)
    return run


@_on_device
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


def lookup_bits(T: int) -> int:
    """log2 of K2's bucket count over a table of T keys:
    clamp(ceil(log2 T) - 2, 0, 22), about 4 keys a bucket (see
    kernels/csrc/bucket_search.cuh)."""
    return max(0, min(22, (T - 1).bit_length() - 2)) if T > 1 else 0


# the launch function of the bucket directory in each kernel that builds one
_DIRECTORY = {"lookup_counts": "sage2_lookup_directory",
              "vote_windows": "sage2_vote_directory"}


def directory_words(T: int) -> int:
    """int64 words of K2's bucket directory over a table of T keys."""
    return 4 + T + (1 << lookup_bits(T)) // 2 + 1


@_on_device
def lookup_directory(table: torch.Tensor, counts: torch.Tensor,
                     kernel: str = "lookup_counts",
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The first launch of K2 (or of K5, ``kernel="vote_windows"``, whose
    launch count it adds to) over the sorted unique int64 CUDA ``table``
    and its int32 ``counts``: int64 scratch holding a 4-word header
    (lowest key, span, bucket shift, packed or not), the packed (offset
    below the bucket, count) entries where the bucket width allows, and
    the bucket directory; in the first ``directory_words(T)`` words of
    ``out`` where given. The table's span is read on the card, so nothing
    waits for it."""
    T = table.shape[0]
    if T >= 1 << 31:
        raise ValueError(f"a table of {T} keys overflows the int32 bucket "
                         f"directory")
    bits = lookup_bits(T)
    scratch = (torch.empty(directory_words(T), dtype=torch.int64,
                           device=table.device)
               if out is None else out[:directory_words(T)])
    _launch(kernel, _DIRECTORY[kernel], _ptr(table), _ptr(counts), T, bits,
            _ptr(scratch), _stream())
    LAUNCHES[kernel] += 1
    return scratch


@_on_device
def lookup_counts(
    table: torch.Tensor, counts: torch.Tensor, queries: torch.Tensor
) -> torch.Tensor:
    """int32 count of each int64 query key in the sorted unique int64
    ``table`` (``counts`` int32 beside it), 0 where absent. Kernel K2,
    two launches: the bucket directory, then the lookups (see
    kernels/csrc/lookup_counts.cu)."""
    if _on_cpu(table, counts, queries):
        return plain.lookup_counts(table, counts, queries)
    _dtype(table, torch.int64, "table")
    _dtype(counts, torch.int32, "counts")
    _dtype(queries, torch.int64, "queries")
    out = torch.empty(queries.shape, dtype=torch.int32,
                      device=queries.device)
    if queries.numel():
        scratch = lookup_directory(table, counts)
        _launch("lookup_counts", "sage2_lookup_counts", _ptr(table),
                _ptr(counts), table.shape[0], _ptr(scratch), _ptr(queries),
                queries.numel(), _ptr(out), _stream())
        LAUNCHES["lookup_counts"] += 1
    return out


@_on_device
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
):
    """(ok bool, cand_a, cand_b, ovl int32, total) over the sorted live
    seed rows: ``s_keys`` int64 and ``s_rows`` int32 row ids, sorted by
    key with entries before queries inside a key; ``payload`` (rows,
    Wt + 2) int32 indexed by row id, its last column the read length.
    ``total`` counts every candidate (one host sync reads it between the
    passes); the output arrays hold the first ``min(total, limit)`` of
    them, ``limit`` being ``slot_limit`` or, for a function,
    ``slot_limit(total)`` (all without a limit).

    ``contained``: None (fixed-length reads), or a (reads,) uint8
    tensor in which the slots launch sets ``contained[b] = 1`` for each
    verified pair of those slots that holds read b whole (ragged
    reads).

    The streamed join's rows (global ids read * R + t) find their
    payload in two arrays: ``entry_payload`` (an entry slab's rows, the
    entry row t of read b at (b - entry_base) * g + t) and ``payload``
    (one query chunk's rows, the query row t of read a at (a -
    query_base) * (R - g) + t - g). Without ``entry_payload``
    ``payload`` holds every row at its row id. ``payload_perm`` (the
    meshed join, an owner's rows from every shard): (n,) int64, the
    payload row of each sorted row (``payload`` in received order)."""
    if payload_perm is not None and entry_payload is not None:
        raise ValueError("payload_perm and entry_payload exclude each other")
    tensors = (s_keys, s_rows, payload) + (
        () if contained is None else (contained,)) + (
        () if entry_payload is None else (entry_payload,)) + (
        () if payload_perm is None else (payload_perm,))
    if _on_cpu(*tensors):
        return plain.overlap_join(s_keys, s_rows, payload, R, g, trim,
                                  min_overlap, contained, slot_limit,
                                  entry_payload, entry_base, query_base,
                                  payload_perm)
    _dtype(s_keys, torch.int64, "s_keys")
    _dtype(s_rows, torch.int32, "s_rows")
    _dtype(payload, torch.int32, "payload")
    if contained is not None:
        _dtype(contained, torch.uint8, "contained")
    if payload_perm is not None:
        _dtype(payload_perm, torch.int64, "payload_perm")
    if entry_payload is None:       # one payload at the row ids
        segments = (payload, 0, R, payload, 0, R, 0)
    else:
        _dtype(entry_payload, torch.int32, "entry_payload")
        if entry_payload.shape[1] != payload.shape[1]:
            raise ValueError("entry and query payload rows differ in width")
        segments = (entry_payload, entry_base, g, payload, query_base, R - g,
                    g)
    dev = s_keys.device
    n = s_keys.shape[0]

    def empty(size, dtype):
        return torch.empty(size, dtype=dtype, device=dev)

    if n == 0:
        plain.slots_to_write(0, slot_limit)
        z = empty(0, torch.int32)
        return empty(0, torch.bool), z, z.clone(), z.clone(), 0
    ctl, base, run = _join_runs(s_keys, s_rows, None, R, g)
    total = int(ctl[0])
    n_out = plain.slots_to_write(total, slot_limit)
    ok = empty(n_out, torch.bool)
    cand = [empty(n_out, torch.int32) for _ in range(3)]
    _join_slots(s_rows, segments, payload.shape[1], payload_perm, ctl, base,
                run, R, g, trim, min_overlap, n_out, ok, cand, contained)
    return (ok, *cand, total)


# rows a tile of K3's runs launch (kCountTile in
# kernels/csrc/overlap_join.cu), and slots a tile of its slots launch
# (kSlotTile)
JOIN_COUNT_TILE = 2048
JOIN_SLOT_TILE = 128


def _join_runs(s_keys, s_rows, n_live, R: int, g: int):
    """K3's first launch: (ctl, base, run), the total and the run count
    (ctl[0], ctl[1]) and the records of the runs with candidates (each
    run's first slot, and its first row and entries), in device
    memory."""
    n = s_keys.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"{n} seed rows overflow 31-bit positions")
    dev = s_keys.device
    tiles = max(1, -(-n // JOIN_COUNT_TILE))
    runs = n // 2           # a run with candidates holds two rows at least
    ctl = torch.empty(3 + 2 * tiles, dtype=torch.int64, device=dev)
    base = torch.empty(runs + 1, dtype=torch.int64, device=dev)
    run = torch.empty((max(runs, 1), 2), dtype=torch.int32, device=dev)
    _launch("overlap_join", "sage2_join_runs", _ptr(s_keys), _ptr(s_rows), n,
            _ptr(n_live), R, g, _ptr(ctl), _ptr(base), _ptr(run), _stream())
    LAUNCHES["overlap_join"] += 1
    return ctl, base, run


def _join_slots(s_rows, segments, W2: int, perm, ctl, base, run, R: int,
                g: int, trim: int, min_overlap: int, n_out: int, ok, cand,
                contained) -> None:
    """K3's second launch: the first ``n_out`` candidate slots (those
    past the total, in the fixed-capacity mode, not ok with a, b and ovl
    0)."""
    ent, e_base, e_stride, qry, q_base, q_stride, q_off = segments
    _launch("overlap_join", "sage2_join_slots", _ptr(s_rows), _ptr(ent),
            e_base, e_stride, _ptr(qry), q_base, q_stride, q_off, W2,
            _ptr(perm), _ptr(ctl), _ptr(base), _ptr(run), R, g, trim,
            min_overlap, n_out, _ptr(ok),
            *map(_ptr, cand), _ptr(contained), _stream())
    LAUNCHES["overlap_join"] += 1


@_on_device
def overlap_join_stacked(
    s_keys: torch.Tensor, s_rows: torch.Tensor, payload: torch.Tensor,
    n_live: torch.Tensor, R: int, g: int, trim: int, min_overlap: int,
    capacity: int,
):
    """(ok bool, cand_a, cand_b, ovl int32, each (capacity,), total 0-d
    int64): the fixed-capacity mode of ``overlap_join`` over
    ``seed_rows_stacked``'s buffer, whose first ``n_live`` (a 0-d int64
    tensor) rows are live. The count stays on the card: the first
    min(total, capacity) slots are the candidates, the rest not ok with
    a, b and ovl 0 (see plain.overlap_join_stacked). Kernel K3, two
    launches; nothing waits on the host."""
    if _on_cpu(s_keys, s_rows, payload, n_live):
        return plain.overlap_join_stacked(s_keys, s_rows, payload, n_live, R,
                                          g, trim, min_overlap, capacity)
    _dtype(s_keys, torch.int64, "s_keys")
    _dtype(s_rows, torch.int32, "s_rows")
    _dtype(payload, torch.int32, "payload")
    _dtype(n_live, torch.int64, "n_live")
    dev = s_keys.device
    n = s_keys.shape[0]
    ok = torch.empty(capacity, dtype=torch.bool, device=dev)
    cand = [torch.empty(capacity, dtype=torch.int32, device=dev)
            for _ in range(3)]
    if n == 0:
        ok.zero_()
        for c in cand:
            c.zero_()
        return (ok, *cand, torch.zeros((), dtype=torch.int64, device=dev))
    ctl, base, run = _join_runs(s_keys, s_rows, n_live, R, g)
    _join_slots(s_rows, (payload, 0, R, payload, 0, R, 0), payload.shape[1],
                None, ctl, base, run, R, g, trim, min_overlap, capacity, ok,
                cand, None)
    return (ok, *cand, ctl[0])


_JUMP_OPS = {"none": 0, "min": 1, "add": 2}


@_on_device
def pointer_jump(
    p: torch.Tensor, val: Optional[torch.Tensor] = None, op: str = "none",
    steps: int = 1,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(p, val) after ``steps`` doubling steps, each (p[p], op(val,
    val[p])) of the previous step's int32 (V,) arrays, op in "none" |
    "min" | "add". Kernel K4, one cooperative launch (see
    kernels/csrc/pointer_jump.cu)."""
    if op not in _JUMP_OPS:
        raise ValueError(f"unknown pointer_jump op {op!r}")
    if (op == "none") != (val is None):
        raise ValueError("val must be given exactly when op != 'none'")
    if val is not None and val.shape != p.shape:
        raise ValueError(f"val {tuple(val.shape)} and p {tuple(p.shape)} "
                         f"differ in shape")
    if steps < 1:
        raise ValueError(f"steps must be at least 1, got {steps}")
    tensors = (p,) if val is None else (p, val)
    if _on_cpu(*tensors):
        return plain.pointer_jump(p, val, op, steps)
    for t in tensors:
        _dtype(t, torch.int32, "pointer_jump input")
    V = p.numel()
    p_out = torch.empty_like(p)
    v_out = None if val is None else torch.empty_like(val)
    # the ping-pong halves between the first and the last step: p, or
    # (p, val) pairs
    width = 1 if val is None else 2
    halves = [torch.empty((V, width), dtype=torch.int32, device=p.device)
              for _ in range(min(steps - 1, 2))] + [None, None]
    if V:
        _launch("pointer_jump", "sage2_pointer_jump", _ptr(p), _ptr(val),
                _ptr(halves[0]), _ptr(halves[1]), _ptr(p_out), _ptr(v_out),
                V, _JUMP_OPS[op], steps, _stream())
        LAUNCHES["pointer_jump"] += 1
    return p_out, v_out


def _vote_smem(L: int, k: int) -> int:
    """Shared memory of one read (one warp) of K5, bytes (see
    vote_windows.cu)."""
    P = L - k + 1
    return -(-(16 * P + 4 * (P + 1) + 4 * (L + 1) + 4 * L + L) // 8) * 8


@_on_device
def vote_windows(
    reads: torch.Tensor, table: torch.Tensor, counts: torch.Tensor,
    k: int, threshold: int, lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One voting round: the (N, L) int32 reads with every base whose
    covering windows vote for one other base by a unique maximum
    replaced (sage2_tpu/kmer/correct.py voting_round). ``table``: sorted
    unique int64 canonical keys with int32 ``counts``; 1 < k <= 31.
    ``lengths``: (N,) int32 per-read lengths of ragged reads (windows
    past a read's end do not vote, bases past it are not replaced), or
    None. Kernel K5, two launches: the bucket directory over the table,
    then the vote (see kernels/csrc/vote_windows.cu)."""
    if not 1 < k <= 31:
        raise ValueError(f"k must be in (1, 31], got {k}")
    N, L = reads.shape
    if L < k:
        raise ValueError(f"k ({k}) exceeds read length ({L})")
    tensors = (reads, table, counts) + (
        () if lengths is None else (lengths,))
    if _on_cpu(*tensors):
        return plain.vote_windows(reads, table, counts, k, threshold,
                                  lengths)
    _dtype(reads, torch.int32, "reads")
    if lengths is not None:
        _dtype(lengths, torch.int32, "lengths")
    _dtype(table, torch.int64, "table")
    _dtype(counts, torch.int32, "counts")
    if _vote_smem(L, k) > _MAX_SMEM:
        raise ValueError(f"reads of length {L} need more shared memory "
                         f"than a block has")
    out = torch.empty_like(reads)
    if N:
        scratch = lookup_directory(table, counts, "vote_windows")
        _launch("vote_windows", "sage2_vote_windows", _ptr(reads),
                _ptr(lengths), N, L, k, _ptr(table), _ptr(counts),
                table.shape[0], _ptr(scratch), threshold, _ptr(out),
                _stream())
        LAUNCHES["vote_windows"] += 1
    return out


def _check_lengths(lengths: Optional[torch.Tensor], N: int) -> None:
    if lengths is not None and lengths.shape != (N,):
        raise ValueError("lengths must be (N,) beside the reads")


@_on_device
def vote_add(votes: torch.Tensor, counts: torch.Tensor, j: int, k: int,
             threshold: int, lengths: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """The votes of window position j of a voting round from counts the
    k-mer owners sent back: votes[n, w + j, b] += (counts[n, w, b] >=
    threshold) for each window w inside its read (see plain.vote_add).
    ``votes`` (N, L, 4) uint8, updated in place and returned; ``counts``
    (N, P, 4) int32, the counts of ``window_variants(reads, k, j)``;
    ``lengths`` (N,) int32 or None. Kernel K5's routed ``vote_add``
    launch (kernels/csrc/vote_windows.cu)."""
    if not 1 < k <= 31 or not 0 <= j < k:
        raise ValueError(f"need 1 < k <= 31 and 0 <= j < k, got k={k}, "
                         f"j={j}")
    N, L = votes.shape[:2]
    P = L - k + 1
    if votes.shape != (N, L, 4) or counts.shape != (N, P, 4):
        raise ValueError("votes must be (N, L, 4) and counts (N, L - k + "
                         "1, 4)")
    _check_lengths(lengths, N)
    tensors = (votes, counts) + (() if lengths is None else (lengths,))
    if _on_cpu(*tensors):
        return plain.vote_add(votes, counts, j, k, threshold, lengths)
    _dtype(votes, torch.uint8, "votes")
    _dtype(counts, torch.int32, "counts")
    if lengths is not None:
        _dtype(lengths, torch.int32, "lengths")
    if votes.data_ptr() % 4 or counts.data_ptr() % 16:
        raise ValueError("votes must be 4-byte and counts 16-byte aligned")
    if N:
        _launch("vote_windows", "sage2_vote_add", _ptr(votes), _ptr(counts),
                _ptr(lengths), N, L, k, j, threshold, _stream())
        LAUNCHES["vote_windows"] += 1
    return votes


@_on_device
def vote_apply(reads: torch.Tensor, votes: torch.Tensor) -> torch.Tensor:
    """(N, L) int32 reads after the voting rule on the (N, L, 4) uint8
    ``votes`` of a round's k positions (see plain.vote_apply): a base
    becomes the unique most-voted base where it beats its own. Bases
    past a ragged read's end need no mask: ``vote_add`` left their votes
    0. Kernel K5's routed ``vote_apply`` launch."""
    N, L = reads.shape
    if votes.shape != (N, L, 4):
        raise ValueError("votes must be (N, L, 4) beside the reads")
    if _on_cpu(reads, votes):
        return plain.vote_apply(reads, votes)
    _dtype(reads, torch.int32, "reads")
    _dtype(votes, torch.uint8, "votes")
    if votes.data_ptr() % 4:
        raise ValueError("votes must be 4-byte aligned")
    out = torch.empty_like(reads)
    if N:
        _launch("vote_windows", "sage2_vote_apply", _ptr(reads), _ptr(votes),
                N, L, _ptr(out), _stream())
        LAUNCHES["vote_windows"] += 1
    return out


def _lens(read_len):
    """(scalar length, per-vertex lengths tensor or None) of a
    ``read_len`` that is an int or a (V,) int32 tensor."""
    if isinstance(read_len, torch.Tensor):
        return 0, read_len
    return int(read_len), None


@_on_device
def reduce_counts(
    keys: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
    ovl: torch.Tensor, n_vertices: int, read_len,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(start, maxsl, startd, counts) of the device reduction's prep.

    ``keys``: the (E,) sorted int64 adjacency keys src << 32 | sl;
    ``src``, ``dst``, ``ovl``: the (E,) int32 edge list in (src, dst)
    order, padding rows (INT32_MAX, INT32_MAX, 0) at the tail. Returns
    int32 ``start`` (V,) (first adjacency key of each vertex), ``maxsl``
    (V,) (its largest sl, -1 without edges), ``startd`` (V + 1,) (each
    vertex's first row in the (src, dst) order) and ``counts`` (E,)
    (each edge's expansion count); see kernels/csrc/reduce_counts.cu.
    ``read_len``: the read length, or a (V,) int32 tensor of per-vertex
    lengths (ragged reads); an edge's sl is len(src) - ovl. Kernel K6, two
    launches: the vertex row table (with maxsl and each real key's sl in
    8 bits, saturated), then the counts, each from its dst's run alone;
    on the card ``start`` is a view of ``startd``'s first V entries,
    since both orders sort by src first."""
    L, lens = _lens(read_len)
    tensors = (keys, src, dst, ovl) + (() if lens is None else (lens,))
    if _on_cpu(*tensors):
        return plain.reduce_counts(keys, src, dst, ovl, n_vertices,
                                   read_len)
    _dtype(keys, torch.int64, "keys")
    for t in tensors[1:]:
        _dtype(t, torch.int32, "edge arrays and lengths")
    E, V = src.shape[0], n_vertices

    def empty(n):
        return torch.empty(n, dtype=torch.int32, device=src.device)

    # one vertex row table serves both orders: start is its first V rows
    startd, maxsl, counts = empty(V + 1), empty(V), empty(E)
    start = startd[:V]
    # each real key's sl in 8 bits, saturated (read in 16-byte chunks)
    sl8 = torch.empty(-(-E // 16) * 16, dtype=torch.uint8,
                      device=src.device)
    _launch("reduce_counts", "sage2_reduce_table", _ptr(keys), E, V,
            _ptr(startd), _ptr(maxsl), _ptr(sl8), _stream())
    LAUNCHES["reduce_counts"] += 1
    if E:
        _launch("reduce_counts", "sage2_reduce_counts", _ptr(keys),
                _ptr(sl8), _ptr(src), _ptr(dst), _ptr(ovl), E, V, L,
                _ptr(lens), _ptr(startd), _ptr(maxsl), _ptr(counts),
                _stream())
        LAUNCHES["reduce_counts"] += 1
    return start, maxsl, startd, counts


# the slot total (last entry) of each offsets tensor K7 was given, with the
# tensor's version counter: read from the card once, not at every launch
_SLOT_TOTALS = WeakIdKeyDictionary()


def _slot_total(offsets: torch.Tensor) -> int:
    seen = _SLOT_TOTALS.get(offsets)
    if seen is None or seen[0] != offsets._version:
        seen = _SLOT_TOTALS[offsets] = (
            offsets._version, int(offsets[-1]) if offsets.numel() else 0)
    return seen[1]


@_on_device
def reduce_marks(
    removed: torch.Tensor, offsets: torch.Tensor, src: torch.Tensor,
    dst: torch.Tensor, ovl: torch.Tensor, ss_sl: torch.Tensor,
    ss_dst: torch.Tensor, start: torch.Tensor, startd: torch.Tensor,
    read_len, j0: int, j1: int,
) -> torch.Tensor:
    """Probe the expansion slots [j0, j1) and set ``removed[pos] = 1``
    (uint8, in place) for each edge a length-2 path implies; returns
    ``removed``. ``offsets``: (E,) int64 inclusive prefix sum of K6's
    counts; ``ss_sl``, ``ss_dst``: sl and dst in the (src, sl) order;
    ``read_len``: an int, or a (V,) int32 tensor of per-vertex lengths
    (the kernel needs neither: the length cancels in its test; see
    kernels/csrc/reduce_marks.cu). The range is checked against
    ``offsets[-1]``, which is read once for an ``offsets`` tensor (until
    it changes in place), not at every launch."""
    E = src.shape[0]
    total = _slot_total(offsets) if E else 0
    if not 0 <= j0 <= j1 <= total:
        raise ValueError(f"slot range [{j0}, {j1}) outside [0, {total})")
    tensors = (removed, offsets, src, dst, ovl, ss_sl, ss_dst, start,
               startd)
    _, lens = _lens(read_len)
    if _on_cpu(*tensors, *(() if lens is None else (lens,))):
        return plain.reduce_marks(*tensors, read_len, j0, j1)
    _dtype(removed, torch.uint8, "removed")
    _dtype(offsets, torch.int64, "offsets")
    for t in tensors[2:] + (() if lens is None else (lens,)):
        _dtype(t, torch.int32, "edge, run and length arrays")
    if j1 > j0:
        _launch("reduce_marks", "sage2_reduce_marks",
                *map(_ptr, tensors), E, j0, j1, _stream())
        LAUNCHES["reduce_marks"] += 1
    return removed


# the longest read K8 takes (a read's codes as a 2-bit stream in a
# block's shared memory)
CANONICAL_MAX_LEN = 1 << 19


@_on_device
def canonical_reads(
    reads: torch.Tensor, lengths: Optional[torch.Tensor] = None,
    rc_only: bool = False, words_only: bool = False,
    out: Optional[torch.Tensor] = None,
):
    """(rc, fwd_w, rc_w, take_rc) of (N, L) int32 reads: ``rc`` (N, L)
    int32 the reverse complement of each read's first ``lengths[i]``
    bases (all L without lengths), zero past them; ``fwd_w`` and
    ``rc_w`` (N, ceil(L / 16)) int64 the packed words of the read and
    of ``rc`` (ops.bitpack.pack_read_words, codes past the length taken
    as 0); ``take_rc`` (N,) bool: ``rc_w`` is the lexicographically
    smaller. With ``rc_only`` the last three are None; with
    ``words_only`` ``rc`` is None (no rows written). ``out``: an (N, L)
    int32 tensor (a view, e.g. the second half of reads2) that receives
    ``rc``. Kernel K8, one launch: a block a tile of consecutive reads
    (see kernels/csrc/canonical_reads.cu)."""
    if rc_only and words_only:
        raise ValueError("rc_only and words_only exclude each other")
    if out is not None and (words_only or out.shape != reads.shape):
        raise ValueError("out takes the (N, L) rc rows")
    tensors = (reads,) + tuple(t for t in (lengths, out) if t is not None)
    if _on_cpu(*tensors):
        return plain.canonical_reads(reads, lengths, rc_only, words_only,
                                     out)
    _dtype(reads, torch.int32, "reads")
    if lengths is not None:
        _dtype(lengths, torch.int32, "lengths")
    if out is not None:
        _dtype(out, torch.int32, "out")
    N, L = reads.shape
    if L > CANONICAL_MAX_LEN:
        raise ValueError(f"reads of {L} bases exceed K8's "
                         f"{CANONICAL_MAX_LEN}")
    W = -(-L // 16)
    dev = reads.device
    rc = fwd_w = rc_w = take_rc = None
    if not words_only:
        rc = torch.empty_like(reads) if out is None else out
    if not rc_only:
        fwd_w = torch.empty((N, W), dtype=torch.int64, device=dev)
        rc_w = torch.empty((N, W), dtype=torch.int64, device=dev)
        take_rc = torch.empty(N, dtype=torch.bool, device=dev)
    if N:
        _launch("canonical_reads", "sage2_canonical_reads", _ptr(reads),
                _ptr(lengths), N, L, _ptr(rc), _ptr(fwd_w), _ptr(rc_w),
                _ptr(take_rc), _stream())
        LAUNCHES["canonical_reads"] += 1
    return rc, fwd_w, rc_w, take_rc


def _entry_geometry(words0: torch.Tensor, L: int, s: int, g: int,
                    positions) -> None:
    """Checks shared by K9 and K10: the words cover L bases and every
    seed of ``positions`` lies inside the read."""
    if words0.dim() != 2 or words0.shape[1] != -(-L // 16):
        raise ValueError(f"words0 must be (m, ceil(L / 16)) for L = {L}, got "
                         f"{tuple(words0.shape)}")
    if not 1 <= s <= 32 or not 1 <= g <= 16:
        raise ValueError(f"need 1 <= s <= 32 and 1 <= g <= 16, got {s}, {g}")
    for p in positions:
        if p + s > L:
            raise ValueError(f"seed position {p} + seed length {s} exceeds "
                             f"read length {L}")


@_on_device
def seed_table(
    words0: torch.Tensor, valid: torch.Tensor, L: int, s: int, g: int,
    bucket_bits: int, base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table, slab) of the streamed join's entry side for the reads of
    one block: ``words0`` (m, ceil(L / 16)) int64 their unshifted packed
    words, ``valid`` (m,) bool, ``base`` the global id of the block's
    first read. The entries are (read, offset o < g) with global id
    (base + read) * g + o, keyed by the 16-base word at o (masked to
    ``s`` bases below 16; all-ones for an invalid read) and sorted by
    (word, invalid bit, id). ``table`` (2^bucket_bits, 2) int32: each
    bucket's [first sorted slot, count] among the valid entries, an
    empty bucket [first slot of a higher bucket, 0]; ``slab`` (m * g,
    W + 1) int32: each sorted slot's [entry id, words of its read] (uint32
    bit patterns). Kernel K9, two launches around one torch.sort (see
    kernels/csrc/seed_table.cu)."""
    m = words0.shape[0]
    _entry_geometry(words0, L, s, g, range(g))
    if not 1 <= bucket_bits <= min(26, 2 * s):
        raise ValueError(f"bucket_bits {bucket_bits} outside [1, "
                         f"{min(26, 2 * s)}]")
    if (base + m) * g >= 1 << 31:
        raise ValueError(f"entry ids up to {(base + m) * g} overflow 31 bits")
    if _on_cpu(words0, valid):
        return plain.seed_table(words0, valid, L, s, g, bucket_bits, base)
    _dtype(words0, torch.int64, "words0")
    _dtype(valid, torch.bool, "valid")
    W = words0.shape[1]
    dev = words0.device
    n = m * g
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        _launch("seed_table", "sage2_seed_keys", _ptr(words0), _ptr(valid),
                m, W, s, g, base, _ptr(keys), _stream())
        LAUNCHES["seed_table"] += 1
    keys = torch.sort(keys).values
    table = torch.empty((1 << bucket_bits, 2), dtype=torch.int32, device=dev)
    slab = torch.empty((n, W + 1), dtype=torch.int32, device=dev)
    _launch("seed_table", "sage2_seed_table", _ptr(keys), n, _ptr(words0), W,
            g, base, bucket_bits, _ptr(table), _ptr(slab), _stream())
    LAUNCHES["seed_table"] += 1
    return table, slab


@_on_device
def probe_join(
    words0: torch.Tensor, valid: torch.Tensor, table: torch.Tensor,
    slab: torch.Tensor, L: int, s: int, g: int, pa: int, base: int = 0,
    capacity: Optional[int] = None,
):
    """(ok bool, cand_a, cand_b, ovl int32, total) of one query chunk
    against a seed table from ``seed_table``: ``words0`` (m, ceil(L /
    16)) int64 the chunk's unshifted words, ``valid`` (m,) bool, ``base``
    the global id of its first read, ``pa`` = L - min_overlap. Each read
    probes the table at positions g, 2g, ... (ceil(pa / g) of them); a
    probe's candidates are its bucket's entries, in slot order (probes
    row-major, then rank in the bucket). A candidate (a, b, p0 = probe
    position - entry offset) is ok when a != b, p0 <= pa and a[p0:] ==
    b[:L - p0]; ovl = L - clip(p0, 1, pa). ``total`` is the candidate
    count; when it exceeds ``capacity`` nothing is expanded and the four
    arrays are empty (the reference's fail-fast overflow). Kernel K10,
    two launches (see kernels/csrc/probe_join.cu)."""
    n_pos = -(-pa // g)
    _entry_geometry(words0, L, s, g, [g * (j + 1) for j in range(n_pos)])
    B = table.shape[0].bit_length() - 1
    if table.shape != (1 << B, 2) or slab.dim() != 2 or (
            slab.shape[1] != words0.shape[1] + 1):
        raise ValueError(f"table {tuple(table.shape)} and slab "
                         f"{tuple(slab.shape)} do not fit the words")
    if _on_cpu(words0, valid, table, slab):
        return plain.probe_join(words0, valid, table, slab, L, s, g, pa,
                                base, capacity)
    _dtype(words0, torch.int64, "words0")
    _dtype(valid, torch.bool, "valid")
    _dtype(table, torch.int32, "table")
    _dtype(slab, torch.int32, "slab")
    m, W = words0.shape
    dev = words0.device
    Q = m * n_pos

    def empty(size, dtype):
        return torch.empty(size, dtype=dtype, device=dev)

    lo_idx, counts = empty(Q, torch.int32), empty(Q, torch.int32)
    if Q:
        _launch("probe_join", "sage2_probe_count", _ptr(words0), _ptr(valid),
                m, W, s, g, n_pos, B, _ptr(table), _ptr(lo_idx),
                _ptr(counts), _stream())
        LAUNCHES["probe_join"] += 1
    offsets = torch.cumsum(counts, 0, dtype=torch.int64)
    total = int(offsets[-1]) if Q else 0
    n_out = 0 if capacity is not None and total > capacity else total
    ok = empty(n_out, torch.bool)
    cand = [empty(n_out, torch.int32) for _ in range(3)]
    if n_out:
        _launch("probe_join", "sage2_probe_write", _ptr(words0), m, W, g,
                n_pos, pa, L, base, _ptr(slab), _ptr(lo_idx), _ptr(counts),
                _ptr(offsets), n_out, _ptr(ok), *map(_ptr, cand), _stream())
        LAUNCHES["probe_join"] += 1
    return (ok, *cand, total)


@_on_device
def merge_runs(
    keys: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unique keys int64, summed weight int32 of each) of the sorted
    int64 ``keys``; ``weights`` (same length) int32, or None for 1
    each. Kernel K11, one pass (see kernels/csrc/merge_runs.cu); the
    outputs are the first n_unique entries of buffers of len(keys), as
    torch.unique_consecutive's are."""
    tensors = (keys,) + (() if weights is None else (weights,))
    if _on_cpu(*tensors):
        return plain.merge_runs(keys, weights)
    _dtype(keys, torch.int64, "keys")
    if weights is not None:
        _dtype(weights, torch.int32, "weights")
    if keys.dim() != 1 or (weights is not None
                           and weights.shape != keys.shape):
        raise ValueError("keys must be 1-D and weights of their shape")
    n = keys.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"{n} keys overflow the int32 slots")
    dev = keys.device
    if n == 0:
        return keys.clone(), torch.empty(0, dtype=torch.int32, device=dev)
    tiles = -(-n // MERGE_TILE)
    # a status word a tile, the tile counter and the unique count
    scratch = torch.empty(tiles + 2, dtype=torch.int64, device=dev)
    out_keys = torch.empty(n, dtype=torch.int64, device=dev)
    out_sums = torch.empty(n, dtype=torch.int32, device=dev)
    _launch("merge_runs", "sage2_merge_runs", _ptr(keys), _ptr(weights), n,
            _ptr(scratch), _ptr(out_keys), _ptr(out_sums), _stream())
    LAUNCHES["merge_runs"] += 1
    n_unique = int(scratch[tiles + 1])
    return out_keys[:n_unique], out_sums[:n_unique]


@_on_device
def gather_along(tbl: torch.Tensor, idx: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """take_along_axis of an (N, W) int32 table with an (N, W) int32
    index: out[i, j] = tbl[idx[i, j], j] (axis 0) or tbl[i, idx[i, j]]
    (axis 1). Raises IndexError for an index outside [0, extent of the
    axis); on the card the kernel finds it, and the wrapper reads one
    flag after the launch."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if tbl.dim() != 2 or idx.shape != tbl.shape:
        raise ValueError(f"need (N, W) table and index of one shape, got "
                         f"{tuple(tbl.shape)} and {tuple(idx.shape)}")
    if _on_cpu(tbl, idx):
        return plain.gather_along(tbl, idx, axis)
    _dtype(tbl, torch.int32, "tbl")
    _dtype(idx, torch.int32, "idx")
    out = torch.empty_like(tbl)
    if idx.numel():
        flag = _range_flag()
        gather_along_launch(tbl, idx, axis, out, flag)
        if int(flag):
            flag.zero_()
            raise IndexError(f"gather_along: index out of range [0, "
                             f"{tbl.shape[axis]}) for axis {axis}")
    return out


# P1's out-of-range flag of each (device, stream): zero between calls,
# so a call needs no fill before its launch
_FLAGS: Dict[Tuple[int, int], torch.Tensor] = {}


def _range_flag() -> torch.Tensor:
    stream = torch.cuda.current_stream()
    key = (stream.device.index, stream.cuda_stream)
    flag = _FLAGS.get(key)
    if flag is None:
        flag = _FLAGS[key] = torch.zeros(1, dtype=torch.int32,
                                         device=stream.device)
    return flag


@_on_device
def gather_along_launch(tbl: torch.Tensor, idx: torch.Tensor, axis: int,
                        out: torch.Tensor, flag: torch.Tensor) -> None:
    """P1's bare launch on checked, non-empty CUDA tensors: ``out``
    (N, W) int32 gets the gather, and the int32 ``flag`` (zero before)
    turns nonzero where an index was out of range; nothing waits."""
    N, W = tbl.shape
    _launch("gather_along", "sage2_gather_along", _ptr(tbl), _ptr(idx), N, W,
            axis, _ptr(out), _ptr(flag), _stream())
    LAUNCHES["gather_along"] += 1


# rows a tile of K13's entry-slab compaction (kCompactTile in
# kernels/csrc/seed_rows.cu)
SEED_COMPACT_TILE = 2048


def dedup_reads_rc(L: int, ragged: bool) -> bool:
    """Whether K12 reads K8's reverse-complement rows for reads of L
    bases: only where it sorts their key strings in passes
    (bucket_plan.dedup_passes); in one pass it unpacks the unique rows
    from the sorted strings."""
    lb = L.bit_length() if ragged else 0
    return len(bucket_plan.dedup_passes(L, lb)) > 1


@_on_device
def dedup_reads(
    reads: torch.Tensor, lengths: Optional[torch.Tensor],
    rc: Optional[torch.Tensor], fwd_w: torch.Tensor, rc_w: torch.Tensor,
    take_rc: torch.Tensor, out: Optional[torch.Tensor] = None, *,
    split=None,
):
    """(uniq, mult, vertex_of_read, n_unique, lens_u) of the dedup over
    K8's outputs for the (N, L) int32 ``reads`` (see plain.dedup_reads):
    ``uniq`` (N, L) int32 the representative of each group of equal
    canonical reads in canonical orientation, zero past its length and
    on rows from n_unique on; ``mult`` (N,) int32 the group sizes;
    ``vertex_of_read`` (N,) int32; ``lens_u`` (N,) int32 or None.
    ``rc`` may be None exactly where K12 sorts in one pass
    (``dedup_reads_rc``); elsewhere None raises ValueError. ``out``: an
    (N, L) int32 tensor (a view, e.g. the first half of reads2) that
    receives ``uniq``.
    Kernel K12: each read's whole key string (its length, then its
    canonical words) with its index sorted once by the bucketed sort of
    bucket_sort.cuh (range, histogram, scan, coarse scatter, fine split,
    big buckets, sort; seven launches a pass), whose sort launch also
    groups equal strings and writes every output but the unique rows,
    which one more launch unpacks from the sorted strings (reads of codes
    0-3); a string longer than the widest element goes in passes
    (bucket_plan.dedup_passes; see kernels/csrc/dedup_reads.cu), and its
    rows are gathered from ``reads`` and ``rc``. One host read a call
    (n_unique)."""
    N, L = reads.shape
    W = -(-L // 16)
    if (rc is not None and rc.shape != reads.shape) or (
            fwd_w.shape != (N, W) or rc_w.shape != (N, W)
            or take_rc.shape != (N,)):
        raise ValueError("rc, fwd_w, rc_w and take_rc must be K8's outputs "
                         "for these reads")
    if rc is None and dedup_reads_rc(L, lengths is not None):
        raise ValueError(f"K12 sorts reads of {L} bases in passes and "
                         f"gathers their rows from K8's rc rows: rc must "
                         f"not be None")
    if out is not None and out.shape != reads.shape:
        raise ValueError("out takes the (N, L) unique rows")
    tensors = (reads, fwd_w, rc_w, take_rc) + tuple(
        t for t in (lengths, rc, out) if t is not None)
    if _on_cpu(*tensors):
        return plain.dedup_reads(reads, lengths, rc, fwd_w, rc_w, take_rc,
                                 out, split=split)
    _dtype(reads, torch.int32, "reads")
    if rc is not None:
        _dtype(rc, torch.int32, "rc")
    if out is not None:
        _dtype(out, torch.int32, "out")
    _dtype(fwd_w, torch.int64, "fwd_w")
    _dtype(rc_w, torch.int64, "rc_w")
    _dtype(take_rc, torch.bool, "take_rc")
    if lengths is not None:
        _dtype(lengths, torch.int32, "lengths")
    if N >= 1 << 31:
        raise ValueError(f"{N} reads overflow K12's 31-bit indices")
    dev = reads.device
    lens_u = None if lengths is None else torch.empty_like(lengths)
    uniq = torch.empty_like(reads) if out is None else out
    mult = torch.empty(N, dtype=torch.int32, device=dev)
    vertex_of_read = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        mark_part(split, "sort")
        mark_part(split, "group")
        return uniq, mult, vertex_of_read, 0, lens_u
    lb = 0 if lengths is None else L.bit_length()
    passes = bucket_plan.dedup_passes(L, lb)
    d = bucket_plan.dedup_bucket_bits(N, lengths is not None)
    scratch = torch.empty(bucket_plan.scratch_words(d, N), dtype=torch.int64,
                          device=dev)
    ctl = torch.empty(2, dtype=torch.int64, device=dev)
    prev = None
    for i, (s0, ns, NW) in enumerate(passes):
        gid = None if i + 1 == len(passes) else torch.empty(
            N, dtype=torch.int32, device=dev)
        elems = torch.empty((N, NW), dtype=torch.int64, device=dev)
        tmp = torch.empty_like(elems)
        # the elements built in read order into tmp, then bucketed
        _launch("dedup_reads", "sage2_dedup_range", _ptr(fwd_w), _ptr(rc_w),
                _ptr(take_rc), _ptr(lengths), _ptr(prev), N, W, L, lb, s0,
                ns, NW, _ptr(ctl), _ptr(scratch), d, _ptr(tmp), _stream())
        _launch("dedup_reads", "sage2_dedup_hist", _ptr(tmp), N, NW,
                _ptr(ctl), _ptr(scratch), d, _stream())
        _launch("dedup_reads", "sage2_dedup_scan", _ptr(scratch), d,
                _stream())
        _launch("dedup_reads", "sage2_dedup_scatter", _ptr(tmp), N, NW,
                _ptr(ctl), _ptr(scratch), d, _ptr(elems), _stream())
        _launch("dedup_reads", "sage2_dedup_split", _ptr(ctl), _ptr(scratch),
                d, NW, _ptr(elems), _ptr(tmp), _stream())
        _launch("dedup_reads", "sage2_dedup_big", _ptr(elems), _ptr(tmp),
                _ptr(scratch), d, N, NW, _stream())
        if gid is None:
            mark_part(split, "sort")
            reps = torch.empty((N, NW), dtype=torch.int64, device=dev)
        _launch("dedup_reads", "sage2_dedup_sort", _ptr(elems), _ptr(tmp),
                _ptr(scratch), d, N, NW, _ptr(lengths), N, _ptr(mult),
                _ptr(vertex_of_read), _ptr(lens_u),
                _ptr(reps if gid is None else None), _ptr(gid), _stream())
        # range, histogram, scan, coarse scatter, fine split, big, sort
        LAUNCHES["dedup_reads"] += 7
        prev = gid
    del elems, tmp
    _launch("dedup_reads", "sage2_dedup_rows", _ptr(reps), _ptr(scratch), NW,
            _ptr(reads), _ptr(rc), _ptr(lengths), N, L, lb, len(passes) == 1,
            _ptr(uniq), _ptr(mult), _ptr(lens_u), _stream())
    LAUNCHES["dedup_reads"] += 1
    mark_part(split, "group")
    return uniq, mult, vertex_of_read, int(scratch[1]), lens_u


def _check_seed_rows(L: int, s: int, g: int, n_pos: int, n_ids: int):
    """K13's checks of the geometry, on either device."""
    for pos in plain.seed_positions(g, n_pos):
        if pos + s > L:
            raise ValueError(f"seed position {pos} + seed length {s} "
                             f"exceeds read length {L}")
    if n_ids >= (1 << 31) - 1:
        raise ValueError(f"seed rows {n_ids} overflow 31-bit row ids")


def _seed_rows_build(reads2, valid2, lengths, s, g, n_pos, trim, t0, Rw,
                     prior_keys=None, scratch=None, d=0, split=None):
    """K13's row build, shared by ``seed_rows`` and ``seed_rows_stacked``:
    (keys int64 (M Rw,), live uint8 (M Rw,), payload (M, Rw, Wt + 2)
    int32) from one launch, which with a bucket sort's ``scratch`` (2^d
    buckets) also counts the buckets of the live rows and of
    ``prior_keys``."""
    M, L = reads2.shape
    _dtype(reads2, torch.int32, "reads2")
    _dtype(valid2, torch.bool, "valid2")
    if not 1 <= s <= 32:
        raise ValueError(f"seed length {s} outside [1, 32]")
    W = -(-L // 16)
    if 8 * W * 4 > 48 * 1024:
        raise ValueError(f"reads of length {L} need more shared memory "
                         f"than K13 takes")
    dev = reads2.device
    Wt = -(-(L - g) // 16) - trim
    n = M * Rw
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    live = torch.empty(n, dtype=torch.uint8, device=dev)
    payload = torch.empty((M, Rw, Wt + 2), dtype=torch.int32, device=dev)
    n_prior = 0 if prior_keys is None else prior_keys.shape[0]
    _launch("seed_rows", "sage2_seed_rows", _ptr(reads2), _ptr(valid2),
            _ptr(lengths), M, L, s, g, n_pos, trim, t0, Rw, _ptr(keys),
            _ptr(live), _ptr(payload), _ptr(prior_keys), n_prior,
            _ptr(scratch), d, _stream())
    LAUNCHES["seed_rows"] += 1
    mark_part(split, "seed_rows")
    return keys, live, payload


def _seed_rows_sort(keys, live, M, g, n_pos, t0, Rw, id_base, prior_keys,
                    prior_ids, scratch, d, n_cap, fill_to):
    """K13's bucketed sort of the live rows (and a slab's prior rows)
    after the row build: the scan, one host read of the live count
    (none with ``fill_to`` not None, the fixed-capacity buffer's size,
    filled with dead rows past the live ones), the two scatter passes
    and the sort (``scratch`` sized for ``n_cap`` rows). Returns (s_keys
    int64, s_rows int32)."""
    dev = keys.device
    _launch("seed_rows", "sage2_seed_scan", _ptr(scratch), d, _stream())
    n_rows = int(scratch[0]) if fill_to is None else fill_to
    elems = torch.empty((n_rows, 2), dtype=torch.int64, device=dev)
    tmp = torch.empty_like(elems)
    _launch("seed_rows", "sage2_seed_scatter", _ptr(keys), _ptr(live), M, g,
            n_pos, t0, Rw, id_base, _ptr(prior_keys), _ptr(prior_ids),
            0 if prior_keys is None else prior_keys.shape[0], _ptr(scratch),
            d, _ptr(elems), _stream())
    _launch("seed_rows", "sage2_seed_split", _ptr(elems), _ptr(tmp),
            _ptr(scratch), d, _stream())
    s_keys = torch.empty(n_rows, dtype=torch.int64, device=dev)
    s_rows = torch.empty(n_rows, dtype=torch.int32, device=dev)
    _launch("seed_rows", "sage2_seed_big", _ptr(elems), _ptr(tmp),
            _ptr(scratch), d, n_cap, _ptr(s_keys), _ptr(s_rows), _stream())
    _launch("seed_rows", "sage2_seed_sort", _ptr(tmp), _ptr(scratch), d,
            fill_to or 0, _ptr(s_keys), _ptr(s_rows), _stream())
    LAUNCHES["seed_rows"] += 5    # scan, two scatter passes, big, sort
    return s_keys, s_rows


@_on_device
def seed_rows(
    reads2: torch.Tensor, valid2: torch.Tensor,
    lengths: Optional[torch.Tensor], s: int, g: int, n_pos: int, trim: int,
    id_base: int = 0, rows: str = "all",
    prior_keys: Optional[torch.Tensor] = None,
    prior_ids: Optional[torch.Tensor] = None, *, split=None,
):
    """(s_keys int64, s_rows int32, payload (M, Rw, Wt + 2) int32): the
    overlap join's seed rows of the (M, L) int32 ``reads2`` in its sort
    order, and the built rows' payload (see plain.seed_rows). Kernel
    K13: the keys, live flags and payload rows in one launch (one warp a
    read, its words packed in shared memory) that also counts the live
    rows' buckets, then the bucketed sort of the unique (key, tag | id)
    pairs (bucket_sort.cuh: scan, coarse and fine scatter, the buckets
    past a block by the whole grid, the others a block each; six
    launches), which gives the stable order of the join's rows without a
    permutation (see kernels/csrc/seed_rows.cu). One host read a call
    (the live rows).

    ``rows``: "all" (Rw = R = g + n_pos rows a read), "entries" (Rw = g)
    or "queries" (Rw = n_pos); ids are global, (id_base + m) * R + t.
    With "entries" the live rows come back compacted in id order and
    unsorted (two launches: the rows and a look-back compaction; the
    streamed join's entry slab); with "queries", ``prior_keys``/
    ``prior_ids`` (a slab's) go before the chunk's live rows into the
    sort."""
    M, L = reads2.shape
    if rows not in plain.SEED_ROW_KINDS:
        raise ValueError(f"unknown seed rows {rows!r}")
    if (prior_keys is None) != (prior_ids is None) or (
            prior_keys is not None and rows != "queries"):
        raise ValueError("prior_keys and prior_ids go together, with "
                         "rows='queries'")
    _check_seed_rows(L, s, g, n_pos, (id_base + M) * (g + n_pos))
    tensors = (reads2, valid2) + (() if lengths is None else (lengths,)) + (
        () if prior_keys is None else (prior_keys, prior_ids))
    if _on_cpu(*tensors):
        return plain.seed_rows(reads2, valid2, lengths, s, g, n_pos, trim,
                               id_base, rows, prior_keys, prior_ids,
                               split=split)
    if lengths is not None:
        _dtype(lengths, torch.int32, "lengths")
    if prior_keys is not None:
        _dtype(prior_keys, torch.int64, "prior_keys")
        _dtype(prior_ids, torch.int32, "prior_ids")
    t0, Rw = plain.seed_row_span(rows, g, n_pos)
    dev = reads2.device
    n = M * Rw
    if rows == "entries":
        keys, live, payload = _seed_rows_build(
            reads2, valid2, lengths, s, g, n_pos, trim, t0, Rw, split=split)
        tiles = max(1, -(-n // SEED_COMPACT_TILE))
        state = torch.empty(2 + tiles, dtype=torch.int64, device=dev)
        base = torch.empty(n, dtype=torch.int32, device=dev)
        ckeys = torch.empty(n, dtype=torch.int64, device=dev)
        _launch("seed_rows", "sage2_seed_compact", _ptr(live), _ptr(keys), M,
                g, n_pos, t0, Rw, id_base, _ptr(state), _ptr(base),
                _ptr(ckeys), _stream())
        LAUNCHES["seed_rows"] += 1
        n_live = int(state[0])
        mark_part(split, "row_sort")
        return ckeys[:n_live], base[:n_live], payload
    n_prior = 0 if prior_keys is None else prior_keys.shape[0]
    if n + n_prior >= 1 << 31:
        raise ValueError(f"{n + n_prior} seed rows overflow K13's tags")
    d = bucket_plan.bucket_bits(n + n_prior)
    scratch = torch.empty(bucket_plan.scratch_words(d, n + n_prior),
                          dtype=torch.int64, device=dev)
    keys, live, payload = _seed_rows_build(
        reads2, valid2, lengths, s, g, n_pos, trim, t0, Rw, prior_keys,
        scratch, d, split)
    s_keys, s_rows = _seed_rows_sort(keys, live, M, g, n_pos, t0, Rw,
                                     id_base, prior_keys, prior_ids,
                                     scratch, d, n + n_prior, None)
    mark_part(split, "row_sort")
    return s_keys, s_rows, payload


@_on_device
def seed_rows_stacked(
    reads2: torch.Tensor, valid2: torch.Tensor, s: int, g: int, n_pos: int,
    trim: int,
):
    """(s_keys int64 (M R,), s_rows int32 (M R,), payload (M, R, Wt + 2)
    int32, n_live 0-d int64): the fixed-capacity mode of ``seed_rows``
    (every row of each read, ids m * R + t) for find_overlaps_stacked.
    The live rows in the join's order come first, dead rows (key
    INT64_MAX, id -1) fill the buffer behind them, so the first
    ``n_live`` rows are ``seed_rows``' and nothing waits on the host (see
    plain.seed_rows_stacked). Kernel K13, six launches: the rows with
    their buckets counted, the scan, the two scatter passes, the big
    buckets' sort, and the sort, whose blocks also write the dead rows
    from the live count on."""
    M, L = reads2.shape
    R = g + n_pos
    _check_seed_rows(L, s, g, n_pos, M * R)
    if _on_cpu(reads2, valid2):
        return plain.seed_rows_stacked(reads2, valid2, s, g, n_pos, trim)
    n = M * R
    d = bucket_plan.bucket_bits(n)
    scratch = torch.empty(bucket_plan.scratch_words(d, n), dtype=torch.int64,
                          device=reads2.device)
    keys, live, payload = _seed_rows_build(reads2, valid2, None, s, g, n_pos,
                                           trim, 0, R, None, scratch, d)
    s_keys, s_rows = _seed_rows_sort(keys, live, M, g, n_pos, 0, R, 0, None,
                                     None, scratch, d, n, n)
    return s_keys, s_rows, payload, scratch[0]


@_on_device
def _longest_edges(ok, cand_a, cand_b, cand_ovl, n_vertices: int,
                   read_len: int, capacity: int, deferred: bool, out,
                   sources=None):
    """K14's launches (see ``longest_edges``): (src, dst, ovl, written,
    keepers), ``written`` the 0-d int64 count of the rows written (the
    keepers, or in the deferred mode the ok rows), ``keepers`` the
    deferred mode's keeper count (None otherwise)."""
    n = ok.shape[0]
    _dtype(ok, torch.bool, "ok")
    for t in (cand_a, cand_b, cand_ovl):
        _dtype(t, torch.int32, "candidate arrays")
    if n >= 1 << 32:
        raise ValueError(f"{n} candidates overflow K14's bucket counts")
    db, ob = plain.edge_key_bits(n_vertices, read_len)
    wide = 2 * db + ob > 63
    dev = ok.device
    lo, hi = _source_range(sources, n_vertices)
    span = hi - lo
    d = bucket_plan.edge_bucket_bits(n, span)
    scratch = torch.empty(bucket_plan.scratch_words(d, n), dtype=torch.int64,
                          device=dev)
    _launch("longest_edges", "sage2_edge_hist", _ptr(ok), _ptr(cand_a), n,
            lo, span, _ptr(scratch), d, _stream())
    _launch("longest_edges", "sage2_edge_scan", _ptr(scratch), d, _stream())
    elems = torch.empty((n, 2 if wide else 1), dtype=torch.int64, device=dev)
    tmp = torch.empty_like(elems)
    _launch("longest_edges", "sage2_edge_scatter", _ptr(ok), _ptr(cand_a),
            _ptr(cand_b), _ptr(cand_ovl), n, lo, span, db, ob, int(wide),
            _ptr(scratch), d, _ptr(elems), _stream())
    _launch("longest_edges", "sage2_edge_split", _ptr(elems), _ptr(tmp),
            _ptr(scratch), d, lo, span, db, ob, int(wide), _stream())
    src, dst, ovl = out if out is not None else (
        torch.empty(capacity, dtype=torch.int32, device=dev)
        for _ in range(3))
    _launch("longest_edges", "sage2_edge_big", _ptr(elems), _ptr(tmp),
            _ptr(scratch), d, n, db, ob, int(wide), int(deferred), _ptr(src),
            _ptr(dst), _ptr(ovl), _stream())
    _launch("longest_edges", "sage2_edge_sort", _ptr(elems), _ptr(tmp),
            _ptr(scratch), d, n, db, ob, int(wide), capacity, int(deferred),
            _ptr(src), _ptr(dst), _ptr(ovl), _stream())
    LAUNCHES["longest_edges"] += 6      # two scatter passes, big, sort
    if deferred:
        return src, dst, ovl, scratch[0], scratch[1]
    return src, dst, ovl, scratch[1], None


def _source_range(sources, n_vertices: int) -> Tuple[int, int]:
    """K14's range of source ids, [lo, hi): ``sources`` or all ids."""
    lo, hi = sources if sources is not None else (0, max(n_vertices, 1))
    if not 0 <= lo < hi:
        raise ValueError(f"sources [{lo}, {hi}) is not a range of ids")
    return lo, hi


def _edge_args(ok, cand_a, cand_b, cand_ovl, capacity, out):
    n = ok.shape[0]
    if not (cand_a.shape == cand_b.shape == cand_ovl.shape == (n,)):
        raise ValueError("ok and the candidate arrays must be (n,) alike")
    if capacity < n:
        raise ValueError(f"capacity {capacity} below the {n} candidates")
    if out is not None:
        for t in out:
            _dtype(t, torch.int32, "out")
            if t.shape != (capacity,) or t.device != ok.device or (
                    not t.is_contiguous()):
                raise ValueError("out must be three contiguous (capacity,) "
                                 "tensors on the candidates' device")


def longest_edges(
    ok: torch.Tensor, cand_a: torch.Tensor, cand_b: torch.Tensor,
    cand_ovl: torch.Tensor, n_vertices: int, read_len: int, capacity: int,
    sources: Optional[Tuple[int, int]] = None,
):
    """(src, dst, ovl int32 (capacity,), n_edges int): the longest overlap
    of each (src, dst) among the ``ok`` candidates, sorted by (src, dst)
    and padded with (INT32_MAX, INT32_MAX, 0) (see plain.longest_edges;
    vertex ids below ``n_vertices``, overlaps up to ``read_len``).
    Kernel K14, six launches: the ok candidates' buckets counted (by
    src), scanned, the candidates scattered to their coarse and then
    fine buckets as one key (src, dst, ovl), or two words where 2 db +
    ob > 63, the buckets past a block sorted by the whole grid, and a
    block a bucket sorts it, keeps the last row of each (src, dst) run
    at the slot a look-back in bucket order gives, and fills the padding
    (see kernels/csrc/longest_edges.cu, bucket_sort.cuh). One host read
    a call (n_edges).

    ``sources``: (lo, hi), the ids the ok candidates' sources lie in
    where that is narrower than [0, n_vertices) (a mesh shard's own
    range): the buckets split it in place of all the ids. It moves no
    row: a source outside it is sorted all the same."""
    _edge_args(ok, cand_a, cand_b, cand_ovl, capacity, None)
    _source_range(sources, n_vertices)
    if _on_cpu(ok, cand_a, cand_b, cand_ovl):
        return plain.longest_edges(ok, cand_a, cand_b, cand_ovl, n_vertices,
                                   read_len, capacity)
    src, dst, ovl, total, _ = _longest_edges(
        ok, cand_a, cand_b, cand_ovl, n_vertices, read_len, capacity, False,
        None, sources)
    return src, dst, ovl, int(total)


def _longest_edges_unread(ok, cand_a, cand_b, cand_ovl, n_vertices: int,
                          read_len: int, capacity: int, out):
    """``longest_edges`` written into ``out`` (three (capacity,) int32
    tensors, or None), its n_edges a 0-d int32 tensor that nothing waits
    for: the fallback of the deferred reduction (overlap/detect.py
    _reduce_fused), which must not read the count to the host."""
    _edge_args(ok, cand_a, cand_b, cand_ovl, capacity, out)
    if _on_cpu(ok, cand_a, cand_b, cand_ovl):
        *res, n = plain.longest_edges(ok, cand_a, cand_b, cand_ovl,
                                      n_vertices, read_len, capacity)
        if out is not None:
            res = [o.copy_(x) for o, x in zip(out, res)]
        return (*res, torch.tensor(n, dtype=torch.int32))
    src, dst, ovl, total, _ = _longest_edges(
        ok, cand_a, cand_b, cand_ovl, n_vertices, read_len, capacity, False,
        out)
    return src, dst, ovl, total.to(torch.int32)


def longest_edges_deferred(
    ok: torch.Tensor, cand_a: torch.Tensor, cand_b: torch.Tensor,
    cand_ovl: torch.Tensor, n_vertices: int, read_len: int, capacity: int,
    out=None,
):
    """(src, dst, ovl int32 (capacity,), n_edges, n_dups 0-d int32): the
    deferred mode of ``longest_edges`` (find_overlaps_stacked's, the
    reference's defer_dup_compact): every ok candidate in (src, dst, ovl)
    order, padded with (INT32_MAX, INT32_MAX, 0); a pair verified at
    several lengths keeps all of its rows, its longest last. n_edges
    counts the pairs (the keepers), n_dups the other rows (see
    plain.longest_edges_deferred). Kernel K14 with the same launches,
    each bucket's rows written at its own slots; the counts stay on the
    card, so nothing waits on the host."""
    _edge_args(ok, cand_a, cand_b, cand_ovl, capacity, out)
    if _on_cpu(ok, cand_a, cand_b, cand_ovl):
        return plain.longest_edges_deferred(ok, cand_a, cand_b, cand_ovl,
                                            n_vertices, read_len, capacity,
                                            out)
    src, dst, ovl, valid, keepers = _longest_edges(
        ok, cand_a, cand_b, cand_ovl, n_vertices, read_len, capacity, True,
        out)
    return (src, dst, ovl, keepers.to(torch.int32),
            (valid - keepers).to(torch.int32))


def _host_int64(name: str, fn: str) -> int:
    value = ctypes.c_int64()
    _launch(name, fn, ctypes.addressof(value))
    return value.value


@functools.lru_cache(maxsize=None)
def prune_tile() -> int:
    """Entries a tile of K15, read from its library (kTile in
    kernels/csrc/prune_table.cu); builds it where it is not built."""
    return _host_int64("prune_table", "sage2_prune_tile")


@functools.lru_cache(maxsize=None)
def heads_tile() -> int:
    """Sorted requests a tile of K20's heads, read from its library
    (kHeadTile in kernels/csrc/routed_gather.cu)."""
    return _host_int64("routed_gather", "sage2_heads_tile")


def prune_buffers(T: int, device) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """K15's outputs and scratch over a table of T >= 1 entries, in one
    allocation: (keys (T,) int64, counts (T,) int32 16-byte aligned, as a
    fresh tensor is, words), words the ticket, the kept count and a
    look-back status word a tile (``prune_tile``)."""
    k_end = T + T % 2
    c_end = k_end + -(-T // 2)
    buf = torch.empty(c_end + 2 + -(-T // prune_tile()), dtype=torch.int64,
                      device=device)
    return buf[:T], buf[k_end:c_end].view(torch.int32)[:T], buf[c_end:]


@_on_device
def prune_table_launch(keys: torch.Tensor, counts: torch.Tensor,
                       threshold: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K15's bare launch on checked, non-empty CUDA tensors: (keys,
    counts, n), the outputs of ``prune_buffers`` whose first n entries are
    the kept ones, and n the (1,) int64 kept count on the card; nothing
    waits."""
    out_keys, out_counts, words = prune_buffers(keys.shape[0], keys.device)
    _launch("prune_table", "sage2_prune_table", _ptr(keys), _ptr(counts),
            keys.shape[0], threshold, _ptr(out_keys), _ptr(out_counts),
            _ptr(words), _stream())
    LAUNCHES["prune_table"] += 1
    return out_keys, out_counts, words[1:2]


@_on_device
def prune_table(keys: torch.Tensor, counts: torch.Tensor,
                threshold: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys, counts) of the entries of the sorted int64 ``keys`` whose
    int32 ``counts`` reach ``threshold``, in table order. On the card they
    are views of the first n entries of one buffer of the table's size
    (``prune_buffers``), which stays allocated while either view lives: a
    caller done with the count table drops it, so that the two do not
    live together. Kernel K15: one launch (see
    kernels/csrc/prune_table.cu); one host read a call, after it (the kept
    count)."""
    if keys.shape != counts.shape or keys.dim() != 1:
        raise ValueError("keys and counts must be 1-D of one length")
    if _on_cpu(keys, counts):
        return plain.prune_table(keys, counts, threshold)
    _dtype(keys, torch.int64, "keys")
    _dtype(counts, torch.int32, "counts")
    if keys.shape[0] == 0:
        return keys.clone(), counts.clone()
    out_keys, out_counts, n = prune_table_launch(keys, counts, threshold)
    n = int(n)
    return out_keys[:n], out_counts[:n]


# K16's membership table of the solid keys (kernels/csrc/weak_windows.cu):
# keys an average bucket holds at most, and the int64 words before the
# buckets (built, k, threshold, bits)
SOLID_LOAD = 6
SOLID_HEADER = 4


def solid_bits(T: int, k: int) -> Optional[int]:
    """log2 of the bucket count of K16's membership table over a table of
    T keys of k-mers: the fewest buckets that hold SOLID_LOAD keys or
    fewer on average (3-6), at most 2^(2k); None where no table is built
    (an empty table, or buckets that would keep more than 31 bits of
    their keys: 2k - bits > 31)."""
    if T == 0:
        return None
    bits = min(2 * k, (-(-T // SOLID_LOAD) - 1).bit_length())
    return bits if 2 * k - bits <= 31 else None


def solid_offset(T: int) -> int:
    """The int64 word of a round's directory (``table_directory``) where
    K16's membership table starts: after K2's directory, on a 32-byte
    boundary."""
    return -(-directory_words(T) // 4) * 4


def solid_words(T: int, bits: int) -> int:
    """int64 words of K16's membership table: the header, 2^bits buckets
    of eight uint32 keys, the overflow lists (at most T + 2 uint32)."""
    return SOLID_HEADER + (4 << bits) + (T + 2) // 2


@_on_device
def solid_table(table: torch.Tensor, counts: torch.Tensor, k: int,
                threshold: int, directory: torch.Tensor) -> None:
    """K16's membership table of the keys of the sorted int64 ``table``
    whose int32 ``counts`` reach ``threshold``, written into
    ``directory`` from ``solid_offset(T)`` on (``table_directory`` sizes
    it; ``solid_bits`` must not be None). Three launches under K16's
    name: bucket counts, overflow lists, placement."""
    T = table.shape[0]
    bits = solid_bits(T, k)
    work = torch.empty(3 * (1 << bits) + 1, dtype=torch.int32,
                       device=table.device)
    _launch("weak_windows", "sage2_solid_table", _ptr(table), _ptr(counts), T,
            k, threshold, bits, _ptr(directory[solid_offset(T):]), _ptr(work),
            _stream())
    LAUNCHES["weak_windows"] += 3


def table_directory(table: torch.Tensor, counts: torch.Tensor,
                    k: Optional[int] = None,
                    threshold: Optional[int] = None) -> Optional[torch.Tensor]:
    """The round's lookup structures over a count table, in one int64
    tensor, for K16 and K17 to share: K2's bucket directory
    (``lookup_directory``), and with ``k`` and ``threshold`` K16's
    membership table of the solid keys behind it (``solid_table``) where
    ``threshold`` is at least 1 (below it no key is weak, and a key absent
    from the table is solid) and ``solid_bits`` allows one; K16 without it
    looks up through K2's directory. None for CPU tensors, whose plain
    versions search the table itself."""
    if _on_cpu(table, counts):
        return None
    _dtype(table, torch.int64, "table")
    _dtype(counts, torch.int32, "counts")
    T = table.shape[0]
    bits = None if k is None or threshold is None or threshold < 1 \
        else solid_bits(T, k)
    if bits is None:
        return lookup_directory(table, counts)
    directory = torch.empty(solid_offset(T) + solid_words(T, bits),
                            dtype=torch.int64, device=table.device)
    lookup_directory(table, counts, "lookup_counts", directory)
    solid_table(table, counts, k, threshold, directory)
    return directory


def _window_checks(reads: torch.Tensor, k: int) -> Tuple[int, int, int]:
    """(N, L, P) of (N, L) reads with windows of 1 < k <= 31 bases; raises
    when N * P passes 31 bits."""
    if not 1 < k <= 31:
        raise ValueError(f"k must be in (1, 31], got {k}")
    N, L = reads.shape
    P = L - k + 1
    if P < 1:
        raise ValueError(f"k ({k}) exceeds read length ({L})")
    if N * P > (1 << 31) - 1:
        raise ValueError(f"{N * P} windows overflow 31 bits")
    return N, L, P


def _directory_checked(directory: Optional[torch.Tensor]) -> torch.Tensor:
    """The table's bucket directory, which a launch on the card needs
    (``table_directory`` builds it once for all its callers)."""
    if directory is None:
        raise ValueError("a CUDA call needs the table's bucket directory "
                         "(kernels.table_directory)")
    _dtype(directory, torch.int64, "directory")
    return directory


@_on_device
def weak_windows(
    reads: torch.Tensor, lengths: Optional[torch.Tensor],
    table: torch.Tensor, counts: torch.Tensor,
    directory: Optional[torch.Tensor], k: int, threshold: int,
) -> torch.Tensor:
    """int64 flat indices r * P + w (P = L - k + 1), ascending, of the
    weak windows of the (N, L) int32 ``reads``: windows whose canonical
    key counts below ``threshold`` in the sorted int64 ``table`` (int32
    ``counts``; 0 where absent), with (N,) int32 ``lengths`` only those
    inside their read. ``directory``: the round's ``table_directory``
    (None for CPU tensors); its membership table of the solid keys is
    used where it was built for this ``k`` and ``threshold``, else K2's
    directory. Kernel K16: mask (with a look-back for the tiles' first
    slots) and write launches (see kernels/csrc/weak_windows.cu); one
    host read a call (the weak count, to size the output)."""
    N, L, P = _window_checks(reads, k)
    tensors = (reads, table, counts) + (
        () if lengths is None else (lengths,))
    if _on_cpu(*tensors):
        return plain.weak_windows(reads, lengths, table, counts, directory,
                                  k, threshold)
    _dtype(reads, torch.int32, "reads")
    _dtype(table, torch.int64, "table")
    _dtype(counts, torch.int32, "counts")
    if lengths is not None:
        _dtype(lengths, torch.int32, "lengths")
    W = -(-L // 16)
    if 8 * (8 * W + 4 * -(-L // 4)) > 48 * 1024:
        raise ValueError(f"reads of length {L} need more shared memory "
                         f"than K16 takes")
    dev = reads.device
    if N == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    directory = _directory_checked(directory)
    T = table.shape[0]
    off = solid_offset(T)
    solid = directory[off:] if directory.numel() > off else None
    mask = torch.empty((N, -(-P // 32)), dtype=torch.int32, device=dev)
    tiles = -(-N // WEAK_TILE_READS)
    # each tile's first slot, the total, the ticket and the status words
    scan = torch.empty(2 * tiles + 2, dtype=torch.int64, device=dev)
    _launch("weak_windows", "sage2_weak_mask", _ptr(reads), _ptr(lengths), N,
            L, k, _ptr(table), _ptr(counts), T, _ptr(directory), _ptr(solid),
            threshold, _ptr(mask), _ptr(scan), _stream())
    LAUNCHES["weak_windows"] += 1
    out = torch.empty(int(scan[tiles]), dtype=torch.int64, device=dev)
    _launch("weak_windows", "sage2_weak_write", _ptr(mask), N, P, _ptr(scan),
            _ptr(out), _stream())
    LAUNCHES["weak_windows"] += 1
    return out


# reads a tile of K16 (kTileReads in kernels/csrc/weak_windows.cu)
WEAK_TILE_READS = 128


@_on_device
def fix_windows(
    reads: torch.Tensor, widx: torch.Tensor, table: torch.Tensor,
    counts: torch.Tensor, directory: Optional[torch.Tensor], k: int,
    threshold: int, which: str,
) -> torch.Tensor:
    """A copy of the (N, L) int32 ``reads`` with the single_window rule
    applied at the weak windows ``widx`` (int64 flat indices from
    ``weak_windows``): window w's base w + off (off = k - 1 for ``which``
    "last", 0 for "first") becomes the one variant whose canonical key
    counts at least ``threshold`` in the table when the current base's
    does not and no other variant ties it (sage2_tpu/kmer/correct.py
    _phase2_kernel). ``directory`` as for weak_windows: its membership
    table of the solid keys decides where it was built for this ``k``
    and ``threshold``, K2's directory only where two or more variants
    are solid, or for every variant where there is no membership table.
    On the card ``widx`` must be ascending and distinct, as
    ``weak_windows`` gives it (and the reference's _phase1_kernel, a
    sort), and a read at most about 51,600 bases long on an H100 (a tile
    holds one read's codes and packed words in a block's shared memory;
    longer reads raise ValueError); the plain version takes any order and
    length. Kernel K17, two launches: each tile's range of ``widx``, then
    a tile of reads a block, which writes the copy itself (see
    kernels/csrc/fix_windows.cu); no launch without weak windows."""
    if which not in ("last", "first"):
        raise ValueError(f"which must be 'last' or 'first', got {which!r}")
    N, L, P = _window_checks(reads, k)
    if widx.dim() != 1:
        raise ValueError("widx must be 1-D")
    if _on_cpu(reads, widx, table, counts):
        return plain.fix_windows(reads, widx, table, counts, directory, k,
                                 threshold, which)
    _dtype(reads, torch.int32, "reads")
    _dtype(widx, torch.int64, "widx")
    _dtype(table, torch.int64, "table")
    _dtype(counts, torch.int32, "counts")
    tiles = ctypes.c_int64()
    _launch("fix_windows", "sage2_fix_tiles", N, L, ctypes.addressof(tiles))
    if tiles.value < 0:
        raise ValueError(f"fix_windows on the card: a read of {L} bases "
                         f"does not fit a block's shared memory")
    n = widx.shape[0]
    if n == 0:
        return reads.clone()
    directory = _directory_checked(directory)
    T = table.shape[0]
    off = solid_offset(T)
    solid = directory[off:] if directory.numel() > off else None
    out = torch.empty_like(reads)
    starts = torch.empty(tiles.value + 1, dtype=torch.int64,
                         device=reads.device)
    _launch("fix_windows", "sage2_fix_starts", _ptr(widx), n, N, L, k,
            _ptr(starts), _stream())
    _launch("fix_windows", "sage2_fix_windows", _ptr(reads), N, L, k,
            _ptr(table), _ptr(counts), T, _ptr(directory), _ptr(solid),
            threshold, k - 1 if which == "last" else 0, _ptr(widx),
            _ptr(starts), _ptr(out), _stream())
    LAUNCHES["fix_windows"] += 2
    return out


@_on_device
def chain_links(src: torch.Tensor, dst: torch.Tensor, ovl: torch.Tensor,
                n_vertices: int):
    """(outdeg, indeg, nxt, ovl_next, p), int32 (V,), of int32 edge rows
    in any order (``src == INT32_MAX`` is padding; real ids below
    ``n_vertices``): the degrees, the chain edge out of each vertex
    (outdeg(v) == 1 and indeg(succ) == 1: its successor and overlap,
    else -1 and 0) and the initial parent of unitig labeling (the
    predecessor over the chain edge into v, else v;
    sage2_tpu/graph/traverse.py:40-77). Kernel K18's links: the counters
    zeroed, two passes over the rows (none without rows: the in-edges'
    64-bit counters, the out-edges'), then two over the vertices (the
    degree-one bit maps, the links; see kernels/csrc/chain_links.cu)."""
    if not (src.shape == dst.shape == ovl.shape) or src.dim() != 1:
        raise ValueError("src, dst and ovl must be 1-D of one length")
    if _on_cpu(src, dst, ovl):
        return plain.chain_links(src, dst, ovl, n_vertices)
    for t in (src, dst, ovl):
        _dtype(t, torch.int32, "edge arrays")
    V, E = n_vertices, src.shape[0]
    dev = src.device
    outdeg, indeg, nxt, ovl_next, p = (
        torch.empty(V, dtype=torch.int32, device=dev) for _ in range(5))
    # scratch: the in-edges' counters, the successors, the two bit maps
    in_word, succ = (torch.empty(V, dtype=torch.int64, device=dev)
                     for _ in range(2))
    bits = torch.empty(2 * -(-V // 32), dtype=torch.int32, device=dev)
    if V:
        _launch("chain_links", "sage2_chain_links", _ptr(src), _ptr(dst),
                _ptr(ovl), E, V, _ptr(outdeg), _ptr(indeg), _ptr(in_word),
                _ptr(succ), _ptr(bits), _ptr(nxt), _ptr(ovl_next), _ptr(p),
                _stream())
        LAUNCHES["chain_links"] += 4 if E else 2
    return outdeg, indeg, nxt, ovl_next, p


@_on_device
def chain_cut(p: torch.Tensor, pf: torch.Tensor, m: torch.Tensor,
              nxt: torch.Tensor, ovl_next: torch.Tensor):
    """(p', d0), int32 (V,): the cycle cut of unitig labeling
    (sage2_tpu/graph/traverse.py:96-107) over chain_links' parents ``p``,
    their roots ``pf`` (K4 "none") and the least id over each vertex's
    backward closure ``m`` (K4 "min"): each cycle's least vertex becomes
    its own parent and the chain edge into it goes (``nxt`` and
    ``ovl_next`` of its predecessor set to -1 and 0, in place); d0 = (p'
    != v), where K4's "add" loop starts. K18's second launch, counted as
    a ``chain_links`` launch."""
    if not (p.shape == pf.shape == m.shape == nxt.shape == ovl_next.shape):
        raise ValueError("p, pf, m, nxt and ovl_next must be (V,) alike")
    if _on_cpu(p, pf, m, nxt, ovl_next):
        return plain.chain_cut(p, pf, m, nxt, ovl_next)
    for t in (p, pf, m, nxt, ovl_next):
        _dtype(t, torch.int32, "chain arrays")
    V = p.shape[0]
    p_out, d0 = torch.empty_like(p), torch.empty_like(p)
    if V:
        _launch("chain_links", "sage2_chain_cut", _ptr(p), _ptr(pf), _ptr(m),
                V, _ptr(nxt), _ptr(ovl_next), _ptr(p_out), _ptr(d0),
                _stream())
        LAUNCHES["chain_links"] += 1
    return p_out, d0


Route = plain.Route
# most shards a K19 route takes (two packed words of 5 bins a tile)
MAX_ROUTE_SHARDS = 8
# rows a tile of K19's scatter (kTile in kernels/csrc/route_rows.cu)
ROUTE_TILE = 2048


@_on_device
def route_rows(rows: torch.Tensor, n: int, cap: int,
               owner: Optional[torch.Tensor] = None,
               keys: Optional[torch.Tensor] = None, flip: bool = False,
               valid: Optional[torch.Tensor] = None, answers: bool = True,
               *, split=None) -> Route:
    """Route the (Q, K) int32 ``rows`` to their owners among n shards
    (see plain.route_rows): the owner is ``owner`` (Q,) int32, or the
    hash of the int64 ``keys`` (Q,) (``flip``: 32-base seed keys);
    ``valid`` (Q,) bool or None. Returns a ``Route``: the accepted rows
    destination-major (rank < cap), each input's dest, rank and sent_ok
    (None where ``answers`` is False: no answer comes back), the
    accepted rows per destination and the overflow flag (host values)
    and the destinations' first rows in ``send``. Kernel K19: histogram,
    one host read of the n owner totals, scatter (see
    kernels/csrc/route_rows.cu); ``split`` (utils.metrics.DeviceSplit)
    marks the end of each."""
    if (owner is None) == (keys is None):
        raise ValueError("route_rows takes one of owner and keys")
    if rows.dim() != 2:
        raise ValueError("rows must be (Q, K)")
    Q, K = rows.shape
    src = owner if owner is not None else keys
    if src.shape != (Q,) or (valid is not None and valid.shape != (Q,)):
        raise ValueError("owner/keys and valid must be (Q,) beside rows")
    if _on_cpu(*(t for t in (rows, src, valid) if t is not None)):
        return plain.route_rows(rows, n, cap, owner, keys, flip, valid,
                                answers)
    if not 1 <= n <= MAX_ROUTE_SHARDS:
        raise ValueError(f"K19 routes to 1..{MAX_ROUTE_SHARDS} shards, "
                         f"not {n}")
    _dtype(rows, torch.int32, "rows")
    if owner is not None:
        _dtype(owner, torch.int32, "owner")
    else:
        _dtype(keys, torch.int64, "keys")
    if valid is not None:
        _dtype(valid, torch.bool, "valid")
    if Q >= 1 << 31:
        raise ValueError(f"{Q} rows overflow K19's int32 ranks")
    dev = rows.device
    # every rank is below Q, so a cap past Q drops and flags nothing (and
    # the launch's int32 cap cannot wrap)
    cap = min(int(cap), Q)
    dest = rank = sent_ok = None
    if answers:
        dest = torch.empty(Q, dtype=torch.int32, device=dev)
        rank = torch.empty(Q, dtype=torch.int32, device=dev)
        sent_ok = torch.empty(Q, dtype=torch.bool, device=dev)
    if Q == 0:
        return Route(rows.new_empty((0, K)), dest, rank, sent_ok, (0,) * n,
                     False, torch.zeros(n, dtype=torch.int64, device=dev))
    # the n + 1 bin totals, (n + 1) x tiles uint32 status words of the
    # look-back
    tiles = -(-Q // ROUTE_TILE)
    scratch = torch.empty(n + 1 + -(-(n + 1) * tiles // 2),
                          dtype=torch.int64, device=dev)
    args = (_ptr(owner), _ptr(keys), int(flip), _ptr(valid), Q, n)
    _launch("route_rows", "sage2_route_hist", *args, _ptr(scratch),
            _stream())
    LAUNCHES["route_rows"] += 1
    mark_part(split, "histogram")
    per = scratch[:n].tolist()
    mark_part(split, "host_read")
    counts = tuple(min(c, cap) for c in per)
    send = torch.empty((sum(counts), K), dtype=torch.int32, device=dev)
    offsets = torch.empty(n, dtype=torch.int64, device=dev)
    # a key route whose rows are the keys: the scatter hashes them from
    # the rows it holds
    key_rows = int(keys is not None and K == 2
                   and rows.data_ptr() == keys.data_ptr())
    _launch("route_rows", "sage2_route_scatter", *args, cap, _ptr(rows), K,
            key_rows, _ptr(scratch), _ptr(dest), _ptr(rank), _ptr(sent_ok),
            _ptr(send), _ptr(offsets), _stream())
    LAUNCHES["route_rows"] += 1
    mark_part(split, "scatter")
    return Route(send, dest, rank, sent_ok, counts,
                 any(c > cap for c in per), offsets)


@_on_device
def route_back(back: torch.Tensor, dest: torch.Tensor, rank: torch.Tensor,
               sent_ok: torch.Tensor, offsets: torch.Tensor,
               pos: Optional[torch.Tensor] = None,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q', K) int32: the owners' answers ``back`` (A, K) int32, laid out
    as the asker's send buffer was, at the asker's inputs, 0 where an
    input was not sent (see plain.route_back); ``dest``, ``rank``,
    ``sent_ok`` and ``offsets`` are the asker's ``Route``'s, ``pos``
    (Q',) int32 picks the input of each entry, ``valid`` (Q',) bool
    zeroes entries. Kernel K20's ``back`` launch
    (kernels/csrc/routed_gather.cu)."""
    tensors = (back, dest, rank, sent_ok, offsets) + (
        () if pos is None else (pos,)) + (() if valid is None else (valid,))
    if back.dim() != 2 or not (dest.shape == rank.shape == sent_ok.shape):
        raise ValueError("back must be (A, K); dest, rank and sent_ok (Q,)")
    if _on_cpu(*tensors):
        return plain.route_back(back, dest, rank, sent_ok, offsets, pos,
                                valid)
    _dtype(back, torch.int32, "back")
    if pos is not None:
        _dtype(pos, torch.int32, "pos")
    if valid is not None:
        _dtype(valid, torch.bool, "valid")
    _dtype(dest, torch.int32, "dest")
    _dtype(rank, torch.int32, "rank")
    _dtype(sent_ok, torch.bool, "sent_ok")
    _dtype(offsets, torch.int64, "offsets")
    Q = dest.shape[0] if pos is None else pos.shape[0]
    K = back.shape[1]
    out = torch.empty((Q, K), dtype=torch.int32, device=back.device)
    if Q:
        _launch("routed_gather", "sage2_route_back", _ptr(back), K,
                _ptr(dest), _ptr(rank), _ptr(sent_ok), _ptr(offsets),
                _ptr(pos), _ptr(valid), Q, _ptr(out), _stream())
        LAUNCHES["routed_gather"] += 1
    return out


@_on_device
def dedup_heads(s_key: torch.Tensor, s_ord: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uniq, pos_of_orig) (Q,) int32 of the request dedup over the
    sorted int32 requests ``s_key`` and their int64 input positions
    ``s_ord`` (see plain.dedup_heads). Kernel K20's ``heads`` launch."""
    if s_key.shape != s_ord.shape or s_key.dim() != 1:
        raise ValueError("s_key and s_ord must be (Q,) alike")
    if _on_cpu(s_key, s_ord):
        return plain.dedup_heads(s_key, s_ord)
    _dtype(s_key, torch.int32, "s_key")
    _dtype(s_ord, torch.int64, "s_ord")
    Q = s_key.shape[0]
    uniq = torch.empty_like(s_key)
    pos_of_orig = torch.empty_like(s_key)
    if Q:
        _launch("routed_gather", "sage2_dedup_heads", _ptr(s_key),
                _ptr(s_ord), Q, _ptr(uniq), _ptr(pos_of_orig), _stream())
        LAUNCHES["routed_gather"] += 1
    return uniq, pos_of_orig


@_on_device
def gather_rows(idx: torch.Tensor, n: int, *tables: torch.Tensor
                ) -> torch.Tensor:
    """(R, len(tables)) int32 rows t[idx // n] (clipped) of one or two
    (v_d,) int32 cyclically partitioned tables at the int32 vertex ids
    ``idx`` (see plain.gather_rows). Kernel K20's ``gather`` launch."""
    if not 1 <= len(tables) <= 2:
        raise ValueError("gather_rows takes one or two tables")
    if _on_cpu(*tables, idx):
        return plain.gather_rows(idx, n, *tables)
    for t in tables:
        _dtype(t, torch.int32, "tables")
    _dtype(idx, torch.int32, "idx")
    R = idx.shape[0]
    out = torch.empty((R, len(tables)), dtype=torch.int32, device=idx.device)
    if R:
        t1 = tables[1] if len(tables) > 1 else None
        _launch("routed_gather", "sage2_gather_rows", _ptr(tables[0]),
                _ptr(t1), tables[0].shape[0], _ptr(idx), R, n, _ptr(out),
                _stream())
        LAUNCHES["routed_gather"] += 1
    return out


@_on_device
def reduce_rows(ss_key: torch.Tensor, vbase: int, v_d: int) -> torch.Tensor:
    """(v_d + 1,) int64 vertex row table of a shard's adjacency for the
    meshed reduction (see plain.reduce_rows): row[i] is the first index
    of ``ss_key`` (E,) int64, sorted src << 32 | sl, whose src >= vbase +
    i. Kernel K21's ``rows`` launch, once a reduction pass; it serves the
    (src, dst) order of the same edges as well."""
    if ss_key.dim() != 1:
        raise ValueError("ss_key must be (E,)")
    if _on_cpu(ss_key):
        return plain.reduce_rows(ss_key, vbase, v_d)
    _dtype(ss_key, torch.int64, "ss_key")
    row = torch.empty(int(v_d) + 1, dtype=torch.int64, device=ss_key.device)
    _launch("reduce_requests", "sage2_reduce_rows", _ptr(ss_key),
            ss_key.shape[0], int(vbase), int(v_d), _ptr(row), _stream())
    LAUNCHES["reduce_requests"] += 1
    return row


def _table(row: torch.Tensor) -> int:
    """The vertices of a row table."""
    _dtype(row, torch.int64, "row")
    if row.dim() != 1 or row.shape[0] < 1:
        raise ValueError("a row table must be (v_d + 1,)")
    return row.shape[0] - 1


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` where it starts on 16 bytes, else a copy that does (a
    kernel reads its rows as int4)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@_on_device
def reduce_requests(ss_key: torch.Tensor, ss_dst: torch.Tensor,
                    req: torch.Tensor, cand_cap: int, row: torch.Tensor,
                    vbase: int, *, split=None):
    """(cand (C, 3) int32, ok (C,) bool, total) of the meshed
    reduction's phase 2 at w's owner (see plain.reduce_requests):
    ``ss_key`` (E,) int64 the local adjacency sorted by src << 32 | sl,
    ``ss_dst`` (E,) int32, ``req`` (R, 4) int32 received requests, ``row``
    the shard's vertex row table of [vbase, vbase + v_d) (reduce_rows);
    C =
    min(total, cand_cap). Kernel K21: ranges, a torch.cumsum and one
    host read of the total, expand (kernels/csrc/reduce_requests.cu);
    ``split`` marks the end of each."""
    if req.dim() != 2 or req.shape[1] != 4:
        raise ValueError("req must be (R, 4)")
    if _on_cpu(ss_key, ss_dst, req, row):
        return plain.reduce_requests(ss_key, ss_dst, req, cand_cap, row,
                                     vbase)
    _dtype(ss_key, torch.int64, "ss_key")
    _dtype(ss_dst, torch.int32, "ss_dst")
    _dtype(req, torch.int32, "req")
    v_d = _table(row)
    dev = req.device
    R, E = req.shape[0], ss_key.shape[0]
    if R == 0:
        return (torch.empty((0, 3), dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.bool, device=dev), 0)
    req = _aligned16(req)
    start = torch.empty(R, dtype=torch.int64, device=dev)
    counts = torch.empty(R, dtype=torch.int64, device=dev)
    _launch("reduce_requests", "sage2_reduce_ranges", _ptr(ss_key),
            _ptr(row), int(vbase), v_d, _ptr(req), R, _ptr(start),
            _ptr(counts), _stream())
    LAUNCHES["reduce_requests"] += 1
    mark_part(split, "ranges")
    ends = torch.cumsum(counts, 0)
    mark_part(split, "cumsum")
    total = int(ends[-1])
    mark_part(split, "host_read")
    C = min(total, cand_cap)
    cand = torch.empty((C, 3), dtype=torch.int32, device=dev)
    ok = torch.empty(C, dtype=torch.bool, device=dev)
    if C:
        _launch("reduce_requests", "sage2_reduce_expand", _ptr(ss_key),
                _ptr(ss_dst), _ptr(req), R, _ptr(start), _ptr(ends), C,
                _ptr(cand), _ptr(ok), _stream())
        LAUNCHES["reduce_requests"] += 1
    mark_part(split, "expand")
    return cand, ok, total


@_on_device
def reduce_probe(src: torch.Tensor, dst: torch.Tensor, ovl: torch.Tensor,
                 cand: torch.Tensor, read_len, vbase: int,
                 row: torch.Tensor) -> torch.Tensor:
    """(E,) bool removal marks of the meshed reduction's phase 4 at v's
    owner (see plain.reduce_probe): the received candidates (C, 3) int32
    against the local (src, dst)-sorted int32 edges; ``read_len`` an int,
    or the shard's (v_d,) int32 lengths of the vertices [vbase, vbase +
    v_d) (ragged reads); ``row`` the shard's vertex row table (the same
    edges' src runs). Kernel K21's ``probe`` launch."""
    if cand.dim() != 2 or cand.shape[1] != 3:
        raise ValueError("cand must be (C, 3)")
    scalar, lens = _lens(read_len)
    if lens is not None and lens.shape[0] == 0:
        raise ValueError("a shard's lengths must hold its vertex range")
    tensors = (src, dst, ovl, cand) + (() if lens is None else (lens,))
    if _on_cpu(*tensors, row):
        return plain.reduce_probe(src, dst, ovl, cand, read_len, vbase, row)
    for t in tensors:
        _dtype(t, torch.int32, "edges, candidates and lengths")
    v_d = _table(row)
    E, C = src.shape[0], cand.shape[0]
    removed = torch.zeros(E, dtype=torch.uint8, device=src.device)
    if E and C:
        _launch("reduce_requests", "sage2_reduce_probe", _ptr(dst),
                _ptr(ovl), _ptr(row), int(vbase), v_d,
                _ptr(cand), C, scalar, _ptr(lens),
                0 if lens is None else lens.shape[0], _ptr(removed),
                _stream())
        LAUNCHES["reduce_requests"] += 1
    return removed.bool()


def _variant_checks(reads: torch.Tensor, k: int, which) -> Tuple[int, int]:
    """(P, j): the windows of a read, and the position of ``which``."""
    if not 1 < k <= 31:
        raise ValueError(f"k must be in (1, 31], got {k}")
    j = plain.variant_position(k, which)
    P = reads.shape[1] - k + 1
    if P < 1:
        raise ValueError(f"k ({k}) exceeds read length ({reads.shape[1]})")
    return P, j


@_on_device
def window_variants(reads: torch.Tensor, k: int, which) -> torch.Tensor:
    """(N, P, 4) int64 canonical keys of the 4 variants of base j of
    every window of the (N, L) int32 ``reads``; ``which`` the position j
    in [0, k), or "last" (k - 1) or "first" (0) (see
    plain.window_variants). Kernel K22's ``variants`` launch
    (kernels/csrc/window_variants.cu)."""
    P, j = _variant_checks(reads, k, which)
    if _on_cpu(reads):
        return plain.window_variants(reads, k, which)
    _dtype(reads, torch.int32, "reads")
    N, L = reads.shape
    keys = torch.empty((N, P, 4), dtype=torch.int64, device=reads.device)
    if N:
        _launch("window_variants", "sage2_window_variants", _ptr(reads), N,
                L, k, j, _ptr(keys), _stream())
        LAUNCHES["window_variants"] += 1
    return keys


@_on_device
def apply_verdicts(reads: torch.Tensor, counts: torch.Tensor, k: int,
                   which: str, threshold: int,
                   lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, L) int32 reads after the single_window rule at each window's
    last or first base, from the (N, P, 4) int32 ``counts`` of
    ``window_variants``' keys (see plain.apply_verdicts); ``lengths``
    (N,) int32 for ragged reads (a window past its read's end edits
    nothing). Kernel K22's ``verdicts`` launch."""
    if which not in plain.WHICH:
        raise ValueError(f"which must be one of {plain.WHICH}, not {which!r}")
    P, off = _variant_checks(reads, k, which)
    if counts.shape != (reads.shape[0], P, 4):
        raise ValueError("counts must be (N, P, 4) for these reads")
    _check_lengths(lengths, reads.shape[0])
    tensors = (reads, counts) + (() if lengths is None else (lengths,))
    if _on_cpu(*tensors):
        return plain.apply_verdicts(reads, counts, k, which, threshold,
                                    lengths)
    _dtype(reads, torch.int32, "reads")
    _dtype(counts, torch.int32, "counts")
    if lengths is not None:
        _dtype(lengths, torch.int32, "lengths")
    N, L = reads.shape
    out = torch.empty_like(reads)
    if N:
        _launch("window_variants", "sage2_apply_verdicts", _ptr(reads),
                _ptr(counts), _ptr(lengths), N, L, k, off, threshold,
                _ptr(out), _stream())
        LAUNCHES["window_variants"] += 1
    return out
