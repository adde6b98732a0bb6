"""Scratch and ticket counters of the Gram-bank passes, whose kernels fold
each lane's cross-block pick into their one launch
(``csrc/bank_pass.cuh``; the launcher there picks the blocks).

Every block of a bank pass writes its partial pick and draws a ticket from
its lane's counter; the block that draws the lane's last ticket reduces
the partials and sets the counter back to 0.  The counters of a device are
one int32 buffer of :data:`~repro_torch.kernels.checks.MAX_BANK_LANES`
entries, zeroed once on the device's first bank pass and never freed, so
a CUDA graph that captured a bank pass holds a valid address for as long
as it lives.  Pass A and pass B share it: they run one after the other on
one stream, and each launch leaves its counters at 0.  The lane-sharded
engine runs one host thread a device, each on its own buffer.

The buffer is made on the device's first bank pass, which runs eagerly:
every chunk shape of the fused loops runs once before its capture
(:func:`repro_torch.core.solver_fused._drive`).  A capture that would make
it raises instead (its memory would come from the graph's pool).
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels.checks import MAX_BANK_LANES

# Bytes of a row one block of a bank pass covers at the least (32 threads
# of one 16-byte word; kBankMinBlockBytes in csrc/bank_pass.cuh): the
# partials hold a lane's blocks at that width.
MIN_BLOCK_BYTES = 512

_TICKETS: dict = {}
_LOCK = threading.Lock()


def partials(B: int, l: int, dtype: torch.dtype, device, n_values: int):
    """The per-block partials of a bank pass over B lanes of l columns:
    ``n_values`` (B, nb_cap) value rows of ``dtype``, then one int32 index
    row, and nb_cap, the blocks a lane they hold (the launcher takes at
    most that many)."""
    cap = -(-l * torch.tensor([], dtype=dtype).element_size()
            // MIN_BLOCK_BYTES)
    vals = [torch.empty((B, cap), dtype=dtype, device=device)
            for _ in range(n_values)]
    return (*vals, torch.empty((B, cap), dtype=torch.int32, device=device),
            cap)


def tickets(device) -> torch.Tensor:
    """The device's zeroed ticket counters (int32, made on first use)."""
    device = torch.device(device)
    buf = _TICKETS.get(device.index)
    if buf is not None:
        return buf
    with _LOCK:
        if device.index not in _TICKETS:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "the bank passes' ticket counters are made on a "
                    "device's first bank pass, which must run outside a "
                    "CUDA graph capture")
            _TICKETS[device.index] = torch.zeros(
                MAX_BANK_LANES, dtype=torch.int32, device=device)
        return _TICKETS[device.index]
