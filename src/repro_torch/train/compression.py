"""Gradient compression: int8 quantization with error feedback.

The port of ``repro.train.compression``:

* :func:`quantize_int8` / :func:`dequantize_int8`: per-tensor symmetric
  int8 with deterministic rounding (``torch.round`` rounds half to even,
  as ``jnp.round`` does), so a replayed step rounds the same way.
* :func:`ef_compress_grads`: error feedback; the quantization residual is
  carried to the next step, so the sequence of applied updates is
  unbiased.
* :func:`compressed_psum`: an int8-compressed all-reduce over
  ``torch.distributed``: the scales are reduced with MAX, the values
  requantized against the shared scale and their int32 codes reduced with
  SUM, as the reference's ``pmax`` and ``psum`` over its mesh axis do.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import tree_map_n


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q, scale)."""
    x32 = x.float()
    amax = torch.clamp_min(torch.max(torch.abs(x32)), 1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_grads(grads: Any, residuals: Any) -> Tuple[Any, Any]:
    """Quantize (grad + residual); carry the quantization error forward.
    Returns (dequantized float32 grads, new residuals)."""

    def one(g, r):
        g32 = g.float() + r
        q, s = quantize_int8(g32)
        deq = dequantize_int8(q, s)
        return deq, g32 - deq

    return tree_map_n(one, 2, grads, residuals)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-compressed all-reduce over ``group`` (the default group when
    None) of an initialised ``torch.distributed``.

    Quantizes locally, sums int32 codes across the ranks, then rescales by
    the largest scale.  Biased by the shared scale; pair it with error
    feedback at the call site."""
    import torch.distributed as dist
    _, s = quantize_int8(x)
    s_max = s.clone()
    dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
    # requantize against the shared scale so the integer sum is coherent
    q2 = torch.clamp(torch.round(x.float() / s_max), -127, 127).to(
        torch.int32)
    dist.all_reduce(q2, op=dist.ReduceOp.SUM, group=group)
    return q2.float() * s_max
