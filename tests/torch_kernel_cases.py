"""Inputs shared by the CPU and the CUDA tests of kernel K2
(``kernels.lookup_counts``), made with numpy from a seed, and the
geometry of its bucket directory (kernels/csrc/bucket_search.cuh).

Imports neither JAX nor sage2_tpu, so the CUDA tests can use it on a
machine without JAX."""

import numpy as np

from sage2_tpu_torch.kernels import lookup_bits

INT64_MIN, INT64_MAX = -(1 << 63), (1 << 63) - 1

# tables whose keys are >= 0, which the reference's (hi, lo) uint32 split
# carries; the rest hold negative keys or the int64 extremes
UNSIGNED_CASES = ("skew", "single", "outside", "bits50")
SIGNED_CASES = ("pair", "negative", "extremes")


def _table(case: str, rng) -> np.ndarray:
    if case == "skew":          # every key but one in bucket 0
        return np.append(np.arange(999, dtype=np.int64), (1 << 62) - 12345)
    if case == "single":        # T = 1
        return np.array([123_456_789], np.int64)
    if case == "outside":       # queried just outside both ends
        return np.arange(1000, 5000, 3, dtype=np.int64)
    if case == "bits50":        # keys spread over all 50 bits
        return np.unique(np.append(rng.integers(0, 1 << 50, 5000),
                                   [0, (1 << 50) - 1]))
    if case == "pair":          # T = 2
        return np.array([-7, 1 << 40], np.int64)
    if case == "negative":
        return np.unique(rng.integers(-(1 << 45), 1 << 20, 3000))
    if case == "extremes":      # the span is all of int64
        return np.unique(np.concatenate([
            [INT64_MIN, INT64_MIN + 1, INT64_MAX - 1, INT64_MAX],
            rng.integers(INT64_MIN, INT64_MAX, 2000)]))
    raise ValueError(case)


def bucket_geometry(keys: np.ndarray):
    """(bits, lo, shift) of K2's directory over the sorted ``keys``."""
    T = len(keys)
    bits = lookup_bits(T)
    if T == 0:
        return bits, 0, 0
    lo, span = int(keys[0]), int(keys[-1]) - int(keys[0])
    return bits, lo, max(0, span.bit_length() - bits)


def lookup_case(case: str, seed: int = 0):
    """(keys int64 sorted unique, counts int32, queries int64): every key,
    each key +- 1, the keys just outside the table's span, every bucket's
    lowest key +- 1 (lo + (j << shift)), and random keys over the span."""
    rng = np.random.default_rng(seed)
    keys = _table(case, rng)
    counts = rng.integers(1, 1 << 20, len(keys)).astype(np.int32)
    bits, lo, shift = bucket_geometry(keys)
    hi = int(keys[-1])
    q = [int(k) + d for k in keys for d in (-1, 0, 1)]
    q += [lo - 2, lo - 1, hi + 1, hi + 2]
    q += [lo + (j << shift) + d for j in range(1 << bits) for d in (-1, 0, 1)]
    q += [int(v) for v in rng.integers(lo, hi, 2000, endpoint=True)]
    q = [v for v in q if INT64_MIN <= v <= INT64_MAX]
    if case in UNSIGNED_CASES:
        q = [v for v in q if v >= 0]
    return keys, counts, np.array(q, np.int64)


def oracle_lookup(keys: np.ndarray, counts: np.ndarray,
                  queries: np.ndarray) -> np.ndarray:
    """counts of each query key, 0 where absent, by a dictionary."""
    d = dict(zip(keys.tolist(), counts.tolist()))
    return np.array([d.get(v, 0) for v in queries.reshape(-1).tolist()],
                    np.int32).reshape(queries.shape)
