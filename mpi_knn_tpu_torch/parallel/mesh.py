"""The ring's device mesh: an ordered list of ``torch.device``s, one per
ring rank (the JAX package's 1-D ``jax.sharding.Mesh``).

The ring runs single-controller: one process holds every rank's
shards and moves each block to the next rank's device. On CUDA the mesh
takes the visible cards in order, and asking for more than are visible
raises. On the CPU ``num_devices=P`` gives P logical ranks on the one CPU
device, the counterpart of the JAX tests' virtual host mesh. A mesh may
name one card several times; its ranks then share the card and no bytes
move between them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mpi_knn_tpu_torch.device import DEFAULT_DEVICE


class RingMesh(list):
    """An ordered list of ``torch.device``s with the ring axis's name."""

    def __init__(self, devices, axis_name: str = "ring"):
        super().__init__(torch.device(d) for d in devices)
        if not self:
            raise ValueError("a ring mesh needs at least one device")
        self.axis_name = axis_name


def make_ring_mesh(num_devices: Optional[int] = None, axis_name: str = "ring",
                   devices: Optional[Sequence] = None,
                   device=DEFAULT_DEVICE) -> RingMesh:
    """A mesh over the first ``num_devices`` of ``devices`` (default: the
    visible cards when ``device`` is CUDA, one CPU rank per requested rank
    when it is the CPU)."""
    kind = torch.device(device).type
    if devices is None:
        if kind == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device(kind)] * (num_devices or 1)
    devices = list(devices)
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, only {len(devices)} visible"
            )
        devices = devices[:num_devices]
    return RingMesh(devices, axis_name)
