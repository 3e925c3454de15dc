"""Overlap layer: read dedup + all-pairs exact suffix-prefix detection."""

from sage2_tpu_torch.overlap.detect import (
    OverlapResult,
    find_overlaps,
    find_overlaps_auto,
)
from sage2_tpu_torch.overlap.prepare import ReadSet, prepare_reads

__all__ = ["ReadSet", "prepare_reads", "OverlapResult", "find_overlaps",
           "find_overlaps_auto"]
