"""Segment utilities over sorted keys (port of sage2_tpu/ops/sort.py).

The reference's multi-operand ``lax.sort`` becomes ``torch.sort`` on one
composite int64 key (see ops/bitpack.py for the key layout); what is
left here is the run accounting around the sorts.
"""

from __future__ import annotations

from typing import Tuple

import torch

I32_MAX = 2**31 - 1


def unique_sorted_pairs(
    keys: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group boundaries of a sorted key sequence (the reference's (hi,
    lo) pair is one int64 key here).

    Returns ``(is_head, group_id)``: ``is_head[i]`` marks the first
    element of each run of equal keys among valid entries (invalid
    entries, sorted to the end, get group_id INT32_MAX).
    """
    is_head = torch.ones_like(keys, dtype=torch.bool)
    is_head[1:] = keys[1:] != keys[:-1]
    is_head &= valid
    group_id = torch.cumsum(is_head.to(torch.int32), 0, dtype=torch.int32) - 1
    group_id = torch.where(valid, group_id, I32_MAX)
    return is_head, group_id


def expand_by_counts(
    counts: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten variable-size groups into a fixed-capacity index space.

    For each output slot j in [0, capacity): the group it belongs to, its
    rank within the group, and whether it is valid (slots past
    sum(counts) are not). Same outputs as the reference, including the
    invalid tail.
    """
    G = counts.shape[0]
    dev = counts.device
    offsets = torch.cumsum(counts.to(torch.int64), 0)
    total = int(offsets[-1]) if G else 0
    starts = offsets - counts
    nonempty = (counts > 0) & (starts < capacity)
    init = torch.full((capacity + 1,), -1, dtype=torch.int64, device=dev)
    init[starts[nonempty]] = torch.arange(G, device=dev)[nonempty]
    group = torch.cummax(init[:capacity], 0).values
    group_c = group.clamp(0, max(G - 1, 0))
    j = torch.arange(capacity, device=dev)
    rank = j - starts[group_c] if G else j
    valid = (j < total) & (group >= 0)
    return group_c, rank, valid


def words_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over the last (word) axis; any leading shape."""
    less = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones_like(less)
    for j in range(a.shape[-1]):
        less |= eq & (a[..., j] < b[..., j])
        eq &= a[..., j] == b[..., j]
    return less
