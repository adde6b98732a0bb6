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
    if dtype == torch.float64:  # static-ok: f64 (a dtype test, no cast)
        return 64
    raise TypeError(f"the CUDA kernels take float32 or float64, got {dtype}")


def on_card(t, what: str) -> bool:
    """Whether a wrapper launches its kernel: False for CPU tensors (the
    plain version runs), True for CUDA ones; raises on anything else."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got "
                         f"{t.device}")
    return True


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


def act_ptr(act, G):
    """Pointer to the optional (B, n) bool active-set mask of the lane state
    ``G``, checked like the state; None (a null pointer) without one."""
    if act is None:
        return None
    check_state("act", act, tuple(G.shape), torch.bool, G.device)
    return act.data_ptr()


def dirv_ptr(dirv, mu2, G, H: int):
    """Pointers to the conjugate direction of the lane state ``G`` of ``H``
    halves, checked like the state: ``dirv`` a (B, l) row at base width
    and ``mu2`` (B,); (None, None) without them."""
    if dirv is None:
        if mu2 is not None:
            raise ValueError("mu2 needs the direction dirv")
        return None, None
    B, n = G.shape
    check_state("dirv", dirv, (B, n // H), G.dtype, G.device)
    check_lane_scalars(B, G.device, G.dtype, mu2=mu2)
    return dirv.data_ptr(), mu2.data_ptr()


# gridDim.y of the bank passes holds one lane per block row.
MAX_BANK_LANES = 65535


def bank_strides(name: str, gram, gram_idx, B: int, l: int, dtype,
                 device) -> tuple:
    """Check the rows a bank pass reads and return their (bank stride, row
    stride) in values: the (n_stack, l, l) Gram bank with its (B,) int64
    lane index, or with ``gram_idx`` None the lanes' pre-gathered (B, l)
    rows, a bank of B entries of one row."""
    if B > MAX_BANK_LANES:
        raise ValueError(f"the bank passes take at most {MAX_BANK_LANES} "
                         f"lanes, got {B}")
    if gram_idx is None:
        check_state(name, gram, (B, l), dtype, device)
        return l, 0
    if not isinstance(gram, torch.Tensor) or gram.ndim != 3:
        raise ValueError("the Gram bank must be an (n_stack, l, l) tensor")
    check_state(name, gram, (gram.shape[0], l, l), dtype, device)
    check_state("gram_idx", gram_idx, (B,), torch.int64, device)
    return l * l, l
