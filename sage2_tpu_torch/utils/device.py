"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device`` ("cuda" or "cpu"). Raises when
    CUDA is asked for and not available: there is no silent fallback to
    the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or "
                         "'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "false; pass device='cpu' (--device cpu) to run the plain "
            "PyTorch versions on the CPU")
    return dev
