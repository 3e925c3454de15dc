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
