"""The lane mesh of the lane-sharded engine (the lane part of
``repro.launch.mesh``).

A :class:`LaneMesh` is a 1-D list of devices under one axis name, the
port's counterpart of a 1-D ``jax.sharding.Mesh``: slab ``p`` of the lane
batch runs on ``devices[p]``.  :func:`make_lane_mesh` builds one over
every CUDA device by default, or over the devices the caller names.  A
device may appear more than once: ``("cpu",) * 4`` is four slabs on the
CPU, the counterpart of the reference's forced host devices, and how the
CPU tests run several slabs.  Building a mesh touches no device state.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LaneMesh:
    """Devices of the lane slabs, in slab order, under one axis name."""

    devices: tuple
    axis: str = "data"

    @property
    def shape(self) -> dict:
        """``{axis: number of slabs}``, as a 1-D mesh's shape reads."""
        return {self.axis: len(self.devices)}


def make_lane_mesh(devices=None, *, axis: str = "data") -> LaneMesh:
    """A :class:`LaneMesh` over ``devices`` (names or ``torch.device``s;
    default: every CUDA device, and ``RuntimeError`` when there is none)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "a lane mesh defaults to every CUDA device and none is "
                "available; pass devices (e.g. devices=('cpu',) * 2) to "
                "run the slabs on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("a lane mesh needs at least one device")
    return LaneMesh(devices=devs, axis=axis)
