"""Checkpointing: snapshots of a tree of tensors, committed atomically.

The port of ``repro.checkpoint.ckpt``, with the reference's layout:
``<dir>/step_<N>/`` (N zero-padded to 10 digits) holds the state and a
``manifest.json``; it is written as ``step_<N>.tmp`` and renamed into
place, and a ``COMMIT`` marker is written last, so a directory torn by a
failure mid-write is ignored by :func:`latest_step`.  ``msgpack`` and
``zstandard`` are not dependencies of the port: the state is a flat
``{path: tensor}`` dict written with ``torch.save`` (``state.pt``,
manifest format ``torch/v1``) and read with ``torch.load(...,
weights_only=True)``.  A key is the leaf's path as
``repro.checkpoint.ckpt._path_str`` builds it (``params/blocks/attn/wq``,
``opt/m/embed``, ``step``), so it names the same leaf in both packages.
A restore reads the file through ``mmap`` straight into the target
tensors.

:class:`AsyncCheckpointer` copies the state to host memory when
``save`` is called (a card's leaves into pinned memory, which PyTorch's
host allocator hands out again once an earlier snapshot is written) and
writes it from a daemon thread, so the step loop does not wait on the
disk; ``wait()`` drains the pending writes.

On a mesh a DTensor leaf is saved as its full tensor (every rank gathers
it; rank 0 writes), so the format stays ``torch/v1`` whatever the mesh.
``restore_checkpoint(..., shardings=tree)`` cuts each full leaf onto its
placements on each rank, with no communication: a one-device checkpoint
restores onto a mesh, and a mesh checkpoint onto one device, bitwise.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.sharding import full, place
from repro_torch.tree import leaves, leaves_with_path, map_with_path, \
    tree_map

_STATE = "state.pt"
FORMAT = "torch/v1"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def _host_copy(tree):
    """Every leaf copied to host memory: a new tensor even where the leaf
    already is there (``t.cpu()`` of a CPU tensor is ``t`` itself); a
    card's leaves into pinned memory, all copies queued, then one wait
    for the card."""
    cards = set()

    def copy(t):
        t = full(torch.as_tensor(t).detach())
        if not t.is_cuda:
            return t.clone()
        cards.add(t.device)
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)

    out = tree_map(copy, tree)
    for dev in cards:
        torch.cuda.synchronize(dev)
    return out


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a running
    process group, or the only process."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(directory: str, step: int, state: Any,
                    metadata: Optional[dict] = None) -> str:
    """Synchronous save (DTensor leaves as full tensors; in a group of
    several ranks rank 0 writes, then all wait for it).  Returns the
    checkpoint path."""
    import torch.distributed as dist
    flat = {path: full(torch.as_tensor(t).detach()).cpu().contiguous()
            for path, t in leaves_with_path(state)}
    ckpt_dir = _write(directory, step, flat, metadata) if _writer() \
        else _step_dir(directory, step)
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
    return ckpt_dir


def _write(directory: str, step: int, flat: dict,
           metadata: Optional[dict]) -> str:
    ckpt_dir = _step_dir(directory, step)
    tmp_dir = ckpt_dir + ".tmp"
    if os.path.exists(tmp_dir):  # a stale torn write
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)
    torch.save(flat, os.path.join(tmp_dir, _STATE))
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump({"step": step, "metadata": metadata or {},
                   "format": FORMAT}, f)
    with open(os.path.join(tmp_dir, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    os.replace(tmp_dir, ckpt_dir)
    return ckpt_dir


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "COMMIT")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like: Any,
                       shardings: Any = None, *, device=None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf is read by its path, cast to ``like``'s dtype and put on
    ``device`` (the CUDA card by default; raises without one).

    ``shardings``, a tree of :class:`repro_torch.sharding.NamedSharding`
    matching ``like``'s leaves, re-partitions instead: each leaf goes onto
    its mesh and placements (:func:`repro_torch.sharding.place`), whatever
    mesh wrote the checkpoint; ``device`` is then the meshes'."""
    if shardings is not None:
        n_sh, n_like = len(leaves(shardings)), len(leaves(like))
        if n_sh != n_like:
            raise ValueError(f"shardings has {n_sh} leaves and like "
                             f"{n_like}: one NamedSharding a leaf")
        sh = iter(leaves(shardings))
    else:
        dev = resolve_device(device)
    ckpt_dir = _step_dir(directory, step)
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        fmt = json.load(f).get("format")
    if fmt != FORMAT:
        raise ValueError(f"{ckpt_dir}: format {fmt!r}, this reader takes "
                         f"{FORMAT!r}")
    arrays = torch.load(os.path.join(ckpt_dir, _STATE), map_location="cpu",
                        weights_only=True, mmap=True)

    def leaf(path, like_leaf):
        if path not in arrays:
            raise KeyError(f"checkpoint missing leaf {path}")
        want = torch.as_tensor(like_leaf).dtype
        # a copy even on the CPU in the same dtype: never a view of the file
        if shardings is not None:
            return place(arrays[path].to(dtype=want, copy=True), next(sh))
        return arrays[path].to(device=dev, dtype=want, copy=True)

    return map_with_path(leaf, like)


class AsyncCheckpointer:
    """Non-blocking checkpointer: a host copy now, the disk write later.
    Keeps the newest ``keep`` checkpoints."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._errors: list = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_state, metadata = item
            try:
                if _writer():
                    _write(self.directory, step, host_state, metadata)
                    self._gc()
            except Exception as e:  # raised again by wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)

    def save(self, step: int, state: Any, metadata: Optional[dict] = None):
        """Copy ``state`` to host memory (synchronous: the caller may write
        ``state`` as soon as this returns) and queue its write."""
        flat = {path: t.contiguous()
                for path, t in leaves_with_path(_host_copy(state))}
        self._q.put((int(step), flat, metadata))

    def wait(self):
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self):
        """Drain the pending writes, stop the writer thread, and raise the
        first write error if there was one."""
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join()
