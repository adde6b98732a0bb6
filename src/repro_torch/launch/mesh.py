"""Meshes: the production and host ``DeviceMesh``es of the LM launchers,
and the lane mesh of the lane-sharded engine (the port of
``repro.launch.mesh``).

:func:`make_production_mesh` and :func:`make_host_mesh` are functions,
not module constants: importing this module touches no device and no
process group.  They return ``torch.distributed.device_mesh.DeviceMesh``es
with the reference's shapes and axis names, (16, 16) ``("data",
"model")`` and (2, 16, 16) ``("pod", "data", "model")``, so the spec
tables of :mod:`repro_torch.sharding` are the reference's.  Those shapes
are the TPU pods'; 16 H100s span two 8-card NVLink hosts, so a 16-wide
axis crosses the network (an H100-shaped layout is an open question in
ROADMAP).  A mesh is one rank a device: it needs a process group of
exactly its size (``torchrun --nproc-per-node N``, or a fake group in the
dry-run) and raises ``RuntimeError`` naming the ranks it needs otherwise;
a one-rank host mesh with no group starts that group itself
(:func:`ensure_process_group`).

A :class:`LaneMesh` is a 1-D list of devices under one axis name, the
port's counterpart of a 1-D ``jax.sharding.Mesh``: slab ``p`` of the lane
batch runs on ``devices[p]``.  :func:`make_lane_mesh` builds one over
every CUDA device by default, or over the devices the caller names.  A
device may appear more than once: ``("cpu",) * 4`` is four slabs on the
CPU, the counterpart of the reference's forced host devices, and how the
CPU tests run several slabs.  Building a mesh touches no device state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile

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


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def ensure_process_group(device=None):
    """Start the default process group when none is running: from
    ``torchrun``'s environment (``WORLD_SIZE``, ``MASTER_ADDR``, ...) when
    it is set, else a one-rank group over a file store in a fresh
    temporary directory (no port).  NCCL on the card, gloo for
    ``device="cpu"``; under ``torchrun`` the card is ``LOCAL_RANK``'s.
    Returns the temporary directory of a one-rank group it started, ""
    for a ``torchrun`` group, None when a group was already running."""
    import torch.distributed as dist
    if dist.is_initialized():
        return None
    if "LOCAL_RANK" in os.environ and torch.device(
            device or "cuda").type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    backend = _backend(resolve_device(device).type)
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
        return ""
    if backend == "nccl":
        # one rank on one host: NCCL's bootstrap needs the loopback only
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
    dist.init_process_group(backend,
                            init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=0, world_size=1)
    return tmp


@contextlib.contextmanager
def process_group(device=None):
    """The launchers' process group: the running one, or one started by
    :func:`ensure_process_group` and destroyed on exit.  Yields the
    device of this rank (``device`` resolved after ``torchrun``'s card is
    selected)."""
    import torch.distributed as dist
    started = ensure_process_group(device)
    try:
        yield resolve_device(device)
    finally:
        if started is not None:
            dist.destroy_process_group()
            if started:
                shutil.rmtree(started, ignore_errors=True)


def _device_mesh(shape, axes, device):
    """A ``DeviceMesh`` of ``shape`` over the running group's ranks, in
    rank order."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    need = 1
    for s in shape:
        need *= s
    if not dist.is_initialized():
        if need != 1:
            raise RuntimeError(
                f"the {tuple(shape)} mesh needs {need} ranks and no process "
                f"group is running: start one rank a device (torchrun "
                f"--nproc-per-node) or a fake group of {need} ranks")
        ensure_process_group(device)
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(f"the {tuple(shape)} mesh needs {need} ranks; "
                           f"the process group has {world}")
    if device is not None:
        dev_type = torch.device(device).type
    else:   # the group's own: gloo and the dry-run's fake group are CPU
        dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) data x model (256 ranks), or (2, 16, 16) pod x data x
    model (512 ranks) for the two-pod dry-run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device)


def make_host_mesh(n_data: int = 1, n_model: int = 1, *, device=None):
    """A (n_data, n_model) ``("data", "model")`` mesh over the running
    group (tests, one host); (1, 1) starts a one-rank group if none
    runs.  ``device``: the card by default, ``"cpu"`` for gloo."""
    return _device_mesh((n_data, n_model), ("data", "model"), device)
