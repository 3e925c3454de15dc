"""The collectives of the device mesh, and their volume ledger (port of
sage2_tpu/parallel/comm.py).

A collective takes one tensor per shard (lists indexed by shard) and
returns one per shard. Within one device an exchange is a gather of the
pieces; across devices a piece is copied to the receiver's device with
``Tensor.to(dev, non_blocking=True)``. ``all_to_all_rows`` moves only
the rows a shard sent (K19 writes the accepted rows, destination-major),
not the reference's padded (n, cap) buffers.

The ledger: ``label(name)`` marks one dispatch of a sharded stage, and
every collective inside it adds the bytes of its operands, per op. The
reference records operand shapes once, at trace time, and reports that
first dispatch's volume for every dispatch; the port records the bytes
each dispatch moved (counts known at run time), so ``summary``'s
``total_bytes`` is their sum and ``bytes_per_dispatch`` its mean.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

# the active labels, innermost last
_STACK: List[str] = []

# label -> {"dispatches": int, "bytes": {op: total bytes}}
LEDGER: Dict[str, Dict[str, Any]] = {}


class label:
    """Context manager marking one dispatch of a labeled sharded stage;
    collective volumes attach to the innermost active label."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _STACK.append(self.name)
        e = LEDGER.setdefault(self.name, {"dispatches": 0, "bytes": {}})
        e["dispatches"] += 1
        return self

    def __exit__(self, *exc):
        _STACK.pop()
        return False


def _rec(op: str, nbytes: int) -> None:
    if not _STACK:
        return
    b = LEDGER[_STACK[-1]]["bytes"]
    b[op] = b.get(op, 0) + int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_to_all_rows(sends: Sequence[torch.Tensor],
                    counts: Sequence[Sequence[int]],
                    devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Shard s sends rows [off_s[d], off_s[d] + counts[s][d]) of
    ``sends[s]`` to shard d (off_s the prefix sums of counts[s]); shard d
    receives the pieces by source, concatenated, on ``devices[d]``."""
    n = len(sends)
    pieces = [[] for _ in range(n)]
    for s, (buf, cnt) in enumerate(zip(sends, counts)):
        off = 0
        for d in range(n):
            pieces[d].append(buf[off:off + cnt[d]])
            off += cnt[d]
    out = []
    for d in range(n):
        moved = [p.to(devices[d], non_blocking=True) for p in pieces[d]]
        _rec("all_to_all", sum(_nbytes(p) for p in moved))
        out.append(torch.cat(moved) if len(moved) > 1 else moved[0])
    return out


def psum(xs: Sequence) -> Any:
    """Sum over the shards of a scalar or tensor each (a host value for
    host scalars, else a tensor on the first shard's device)."""
    _rec("psum", sum(_nbytes(x) if isinstance(x, torch.Tensor) else 8
                     for x in xs))
    if all(not isinstance(x, torch.Tensor) for x in xs):
        return sum(xs)
    dev = next(x.device for x in xs if isinstance(x, torch.Tensor))
    return sum(torch.as_tensor(x).to(dev) for x in xs)


def all_gather(xs: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Every shard gets the shards' tensors concatenated along dim 0."""
    out = []
    for dev in devices:
        moved = [x.to(dev, non_blocking=True) for x in xs]
        _rec("all_gather", sum(_nbytes(x) for x in moved))
        out.append(torch.cat(moved))
    return out


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[tuple],
             devices: Sequence[torch.device]) -> List:
    """Shard d gets xs[s] for each (s, d) of ``perm`` (None elsewhere)."""
    out: List = [None] * len(xs)
    for s, d in perm:
        out[d] = xs[s].to(devices[d], non_blocking=True)
        _rec("ppermute", _nbytes(xs[s]))
    return out


def summary() -> Dict[str, Any]:
    """Per label: dispatches, and the bytes of each op's operands summed
    over the dispatches (``total_bytes``) and their mean
    (``bytes_per_dispatch``)."""
    out = {}
    for name, e in LEDGER.items():
        n = max(1, e["dispatches"])
        out[name] = {
            "dispatches": e["dispatches"],
            "bytes_per_dispatch": {op: b // n for op, b in e["bytes"].items()},
            "total_bytes": dict(e["bytes"]),
        }
    return out


def reset() -> None:
    LEDGER.clear()
