"""Device and dtype defaults of the port's entry points.

The entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do).  Without a card and without that
request they raise; they never carry on on the CPU.  The data dtype
defaults to ``torch.get_default_dtype()``, PyTorch's counterpart of the
reference's x64 switch.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "meta":          # shapes only: the dry-run's specs
        return dev
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but no CUDA device "
                               f"is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_dtype(dtype=None) -> torch.dtype:
    dtype = torch.get_default_dtype() if dtype is None else dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got "
                         f"{dtype}")
    return dtype


def synchronize(device) -> None:
    """Wait for the card's queued work when ``device`` is a CUDA device
    (a timer's end); nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
