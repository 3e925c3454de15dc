"""Sorts and segment utilities over sorted keys (port of
sage2_tpu/ops/sort.py).

The reference's multi-operand ``lax.sort`` becomes ``torch.sort`` on one
composite int64 key (see ops/bitpack.py for the key layout); what is
left here is the key composition and the run accounting around the
sorts.
"""

from __future__ import annotations

from typing import Tuple

import torch

I32_MAX = 2**31 - 1


def sort_by_pair(
    major: torch.Tensor, minor: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort by (major, minor), the two-key form of the
    reference's ``sort_by_keys`` (which is stable).

    Both keys are non-negative int32 values (INT32_MAX allowed, as in
    padding rows). Returns ``(keys, order)``: the sorted composite int64
    keys ``major << 32 | minor`` and the int64 permutation, so that
    ``x[order]`` carries any payload along. Ties keep their input order.
    """
    keys = (major.to(torch.int64) << 32) | minor.to(torch.int64)
    keys, order = torch.sort(keys, stable=True)
    return keys, order


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


def words_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over the last (word) axis; any leading shape."""
    less = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones_like(less)
    for j in range(a.shape[-1]):
        less |= eq & (a[..., j] < b[..., j])
        eq &= a[..., j] == b[..., j]
    return less


def expand_with_payload(
    counts: torch.Tensor, payload: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten variable-size groups into ``capacity`` slots, carrying a
    per-group payload (sage2_tpu/ops/sort.py:143).

    For each slot j: the group holding it (the last non-empty group
    starting at or before j), its rank in the group, the group's payload
    and whether j is below the total count. Slots past the total keep
    the reference's values (the last non-empty group, its rank counted
    on). int64 group and rank.
    """
    dev = counts.device
    G = counts.shape[0]
    counts = counts.to(torch.int64)
    offsets = torch.cumsum(counts, 0)
    total = int(offsets[-1]) if G else 0
    starts = offsets - counts
    nonempty = (counts > 0) & (starts < capacity)
    scatter_idx = torch.where(nonempty, starts, capacity)
    init = torch.full((capacity + 1,), -1, dtype=torch.int64, device=dev)
    init.scatter_reduce_(0, scatter_idx,
                         torch.arange(G, dtype=torch.int64, device=dev),
                         "amax")
    group = torch.cummax(init[:capacity], 0).values
    group_c = group.clamp(0, max(G - 1, 0))
    j = torch.arange(capacity, dtype=torch.int64, device=dev)
    if G == 0:
        zero = torch.zeros(capacity, dtype=torch.int64, device=dev)
        return zero, j, payload.new_zeros(capacity), j < 0
    rank = j - starts[group_c]
    valid = (j < total) & (group >= 0)
    return group_c, rank, payload[group_c], valid
