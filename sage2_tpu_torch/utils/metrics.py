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


def _peak_rss_mb() -> Optional[int]:
    """Process high-water RSS in MB (monotone: the stage whose record
    first shows a jump is the one that grew it)."""
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
    except Exception:
        return None
