"""Argument checks shared by the CUDA kernel wrappers.

A kernel reads raw pointers, so every tensor handed to it must have the
shape, dtype and device it expects and be contiguous; the wrappers call
these before they launch and raise on anything else.
"""

from __future__ import annotations

import torch


def dtype_bits(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 32
    if dtype == torch.float64:
        return 64
    raise TypeError(f"the CUDA kernels take float32 or float64, got {dtype}")


def check_state(name: str, t, shape, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_lane_scalars(B: int, device, dtype, **tensors) -> None:
    """Per-lane (B,) vectors, passed to the kernels by pointer."""
    for name, t in tensors.items():
        check_state(name, t, (B,), dtype, device)
