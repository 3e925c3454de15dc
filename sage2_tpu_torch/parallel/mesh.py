"""The device mesh (port of sage2_tpu/parallel/mesh.py).

The reference is single-controller: one process builds a 1-D ``Mesh`` of
its local devices and runs every sharded stage as one shard_map program.
The port keeps that shape in one process: a ``Mesh`` is ``n`` shard
slots, shard ``d`` bound to ``devices[d % len(devices)]``. Each sharded
stage (``parallel.sharded``) runs as per-shard steps on those devices,
cut at each collective (``parallel.comm``), which moves the shards'
tensors between them.

So several shards may share one device: a CPU mesh of 8 shards on the
one CPU (the tests' counterpart of the reference's 8 forced host
devices), or 4 shards on one H100, where every routing kernel does real
four-owner work but no byte crosses an interconnect. On several cards
each kernel launches on the card that holds its shard's tensors
(``kernels._on_device``), and the exchanges copy rows between cards. A
CUDA mesh has at most ``kernels.MAX_ROUTE_SHARDS`` shards, the most
kernel K19 routes to. ``init_distributed`` (several processes) is not
ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from sage2_tpu_torch.kernels import MAX_ROUTE_SHARDS

DATA_AXIS = "data"


class Mesh:
    """``size`` shard slots along one axis (``axis_names``); shard d
    runs on ``device_of(d)``."""

    def __init__(self, size: int, devices: Sequence[torch.device],
                 axis_names: Tuple[str, ...] = (DATA_AXIS,)):
        if size < 1 or not devices:
            raise ValueError("a mesh needs at least one shard and device")
        self.size = int(size)
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)

    def device_of(self, d: int) -> torch.device:
        return self.devices[d % len(self.devices)]

    def __repr__(self) -> str:
        return (f"Mesh(size={self.size}, devices="
                f"{[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names})")


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = (DATA_AXIS,),
    devices=None,
) -> Mesh:
    """1-D mesh of ``n_devices`` shards (default: one a device).

    ``devices``: a device or a list of them ("cpu" for a CPU mesh);
    default the visible CUDA devices, and a RuntimeError where there is
    none (no silent fall back to the CPU). Shard d runs on
    ``devices[d % len(devices)]``, so n_devices may exceed the device
    count: four shards on one card, eight on the CPU. A mesh on CUDA
    devices takes at most MAX_ROUTE_SHARDS shards (K19's limit), and a
    ValueError says so here, before any stage runs."""
    if len(axis_names) != 1:
        raise ValueError("make_mesh builds 1-D meshes")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass "
                "devices='cpu' for a CPU mesh")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devs = [torch.device(devices)]
    else:
        devs = [torch.device(d) for d in devices]
    n = n_devices or len(devs)
    if n > MAX_ROUTE_SHARDS and any(d.type == "cuda" for d in devs):
        raise ValueError(f"a CUDA mesh takes at most {MAX_ROUTE_SHARDS} "
                         f"shards (kernel K19's limit), not {n}")
    return Mesh(n, devs, axis_names)
