"""Structured metrics/logging (SURVEY.md §5 "Metrics / logging").

Per-stage metrics (reads/s, k-mers/s, candidate pairs/s, edges
kept/removed, N50) are appended as JSONL; the benchmark harness reads the
same stream.
"""

from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class MetricsLog:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self.records: List[Dict[str, Any]] = []

    def log(self, stage: str, **fields: Any) -> None:
        from sage2_tpu_torch.utils import watchdog

        watchdog.touch(f"metrics:{stage}")
        rec = {"ts": time.time(), "stage": stage, **fields}
        self.records.append(rec)
        line = json.dumps(rec, default=float)
        if self.path:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(f"[sage2] {stage}: " + json.dumps(fields, default=float),
                  file=sys.stderr)

    @contextmanager
    def timed(self, stage: str, **fields: Any):
        t0 = time.perf_counter()
        yield
        self.log(stage, seconds=time.perf_counter() - t0,
                 peak_rss_mb=_peak_rss_mb(), **fields)


class DeviceSplit:
    """The device time of the consecutive parts of a stage: an event on
    the current stream at the start and at the end of each part
    (``mark``), read by ``ms`` after the stage's closing
    synchronisation, so the split itself waits for nothing. On the CPU
    the work is synchronous and the marks read the host clock."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self.marks = [("start", self._now())]

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        import torch

        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def mark(self, part: str) -> None:
        self.marks.append((part, self._now()))

    def ms(self) -> Dict[str, float]:
        """Milliseconds of each part, as ``<part>_ms``."""
        return {part + "_ms": a.elapsed_time(b) if self.cuda
                else (b - a) * 1e3
                for (_, a), (part, b) in zip(self.marks, self.marks[1:])}


def mark_part(split: Optional[DeviceSplit], part: str) -> None:
    """The end of ``part`` of a stage whose device time is being split;
    nothing without a split."""
    if split is not None:
        split.mark(part)


def _peak_rss_mb() -> Optional[int]:
    """Process high-water RSS in MB (monotone: the stage whose record
    first shows a jump is the one that grew it)."""
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
    except Exception:
        return None
