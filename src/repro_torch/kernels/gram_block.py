"""Gram wrapper: the tiled RBF cross-Gram kernel (``csrc/gram_block.cu``).

On CUDA tensors it launches the kernel on the current stream; on CPU
tensors it runs the plain version, :func:`repro_torch.kernels.ref.gram_cross`.
There is no fallback from one to the other.  ``gram_cross.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.checks import check_state, dtype_bits

# gridDim.y of the kernel holds ceil(l1 / 64) tiles.
MAX_ROWS = 65535 * 64


def gram_cross(X1, X2, gamma: float, *, out=None):
    """Cross Gram matrix k(X1, X2) -> (l1, l2) for (l1, d), (l2, d) inputs
    and a scalar ``gamma``.  ``out``, a contiguous (l1, l2) tensor such as
    one gamma's slice of a Gram bank, receives the result in place and is
    returned."""
    if X1.device.type == "cpu":
        return ref.gram_cross(X1, X2, gamma, out=out)
    if X1.device.type != "cuda":
        raise ValueError(f"the Gram kernel runs on cuda or cpu tensors, got "
                         f"{X1.device}")
    l1, d = X1.shape
    l2 = X2.shape[0]
    check_state("X1", X1, (l1, d), X1.dtype, X1.device)
    check_state("X2", X2, (l2, d), X1.dtype, X1.device)
    if l1 > MAX_ROWS:
        raise ValueError(f"gram_cross takes at most {MAX_ROWS} rows in X1, "
                         f"got {l1}")
    s1 = torch.sum(X1 * X1, dim=-1)
    s2 = torch.sum(X2 * X2, dim=-1)
    if out is None:
        out = torch.empty((l1, l2), dtype=X1.dtype, device=X1.device)
    check_state("out", out, (l1, l2), X1.dtype, X1.device)
    fn = build.entry("gram_block", dtype_bits(X1.dtype))
    ptrs = [t.data_ptr() for t in (X1, X2, s1, s2, out)]
    err = fn(*ptrs, float(gamma), l1, l2, d, X1.device.index,
             torch.cuda.current_stream(X1.device).cuda_stream)
    gram_cross.launches += 1
    build.check(err, "gram_block")
    return out


gram_cross.launches = 0
