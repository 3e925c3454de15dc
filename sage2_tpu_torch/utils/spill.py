"""Host-side spill store: memmap-backed stage arrays for inputs beyond
host RAM (port of sage2_tpu/utils/spill.py, the same file layout).

The streamed pipeline's large host arrays (corrected reads, the
deduplicated read store, the pre-reduction edge list) live as flat
binary files under a spill directory instead of process RAM, so
per-stage host memory stays O(chunk + dedup sort + reduced graph)
instead of O(N*L + E). The OS page cache does the caching; numpy
memmaps give the same array API, so every consumer (chunked stages, the
native C++ reduction via ctypes, the host finish) reads windows
transparently.

Files are raw little-endian binaries plus one ``spill.json`` manifest
recording dtype/shape, the same layout as sage2_tpu's, so each package
reads a spill directory the other wrote. They double as stage artifacts
for ``resume_from`` (the npz artifact then carries only the small
arrays).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

_MANIFEST = "spill.json"


class SpillStore:
    """A directory of named memmap-backed arrays with a dtype/shape
    manifest. Not safe for concurrent writers (one pipeline process)."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._manifest_path = os.path.join(directory, _MANIFEST)
        self._entries = {}
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self._entries = json.load(f)

    # -- manifest ------------------------------------------------------
    def _flush(self) -> None:
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._entries, f, indent=1)
        os.replace(tmp, self._manifest_path)

    def _register(self, name: str, dtype, shape: Tuple[int, ...]) -> None:
        self._entries[name] = {
            "dtype": np.dtype(dtype).str,
            "shape": list(int(s) for s in shape),
        }
        self._flush()

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name + ".bin")

    # -- run metadata (a resume must not trust a stale spill dir) -----
    def set_meta(self, key: str, value) -> None:
        self._entries.setdefault("_meta", {})[key] = value
        self._flush()

    def get_meta(self, key: str, default=None):
        return self._entries.get("_meta", {}).get(key, default)

    def exists(self, name: str) -> bool:
        return name in self._entries and os.path.exists(self.path(name))

    # -- arrays --------------------------------------------------------
    def empty(self, name: str, dtype, shape: Tuple[int, ...]) -> np.memmap:
        """Create (or recreate) a named array of the given final shape;
        contents start zeroed (sparse file)."""
        mm = np.memmap(self.path(name), dtype=dtype, mode="w+", shape=shape)
        self._register(name, dtype, shape)
        return mm

    def load(self, name: str, mode: str = "r") -> np.ndarray:
        e = self._entries[name]
        shape = tuple(e["shape"])
        if int(np.prod(shape, dtype=np.int64)) == 0:
            # zero-length files cannot be mmap'd ("cannot mmap an empty
            # file"); a legitimate zero-edge run registers shape (0,)
            return np.zeros(shape, dtype=np.dtype(e["dtype"]))
        return np.memmap(self.path(name), dtype=np.dtype(e["dtype"]),
                         mode=mode, shape=shape)

    def writer(self, name: str, dtype) -> "SpillAppender":
        """Open a named 1-D array for append-style construction (total
        length unknown until close)."""
        return SpillAppender(self, name, np.dtype(dtype))

    def remove(self, name: str) -> None:
        """Drop a named array (file + manifest entry); no-op if absent.
        Used for transient fragments (block-nested join merge)."""
        self._entries.pop(name, None)
        try:
            os.remove(self.path(name))
        except OSError:
            pass
        self._flush()


class SpillAppender:
    """Appends 1-D chunks to a spill file; close() optionally pads the
    tail with a fill value and returns the finalized memmap."""

    def __init__(self, store: SpillStore, name: str, dtype: np.dtype):
        self.store, self.name, self.dtype = store, name, dtype
        self.n = 0
        self._f = open(store.path(name), "wb")

    def append(self, arr: np.ndarray) -> None:
        a = np.ascontiguousarray(arr, self.dtype)
        a.tofile(self._f)
        self.n += a.shape[0]

    def close(self, pad_to: Optional[int] = None,
              fill=0) -> np.ndarray:
        if pad_to is not None and pad_to > self.n:
            pad = np.full(pad_to - self.n, fill, self.dtype)
            pad.tofile(self._f)
            total = pad_to
        else:
            total = self.n
        self._f.close()
        self.store._register(self.name, self.dtype, (total,))
        # total==0 (e.g. a zero-edge run, or writers closed right after a
        # first-chunk overflow): the file is empty and cannot be mmap'd —
        # store.load handles it by returning a plain zero-length array
        return self.store.load(self.name, mode="r+")

    def abort(self) -> None:
        """Close and delete the partial file without registering it —
        for fail-fast paths (e.g. capacity overflow mid-construction)."""
        self._f.close()
        try:
            os.remove(self.store.path(self.name))
        except OSError:
            pass
