"""Gram wrapper: the tiled RBF cross-Gram kernel (``csrc/gram_block.cu``).

On CUDA tensors it launches the kernel on the current stream; on CPU
tensors it runs the plain version, :func:`repro_torch.kernels.ref.gram_cross`.
There is no fallback from one to the other.  When ``X2`` is ``X1`` (see
:func:`is_symmetric`) the kernel runs in its symmetric mode: it computes
the tiles on and above the diagonal only and writes each twice, so the
result is bitwise symmetric.  ``gram_cross.launches`` counts kernel
launches and ``gram_cross.symmetric_launches`` those in symmetric mode.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref, tally
from repro_torch.kernels.checks import check_state, dtype_bits

# The kernel's output tile (rows of X1, rows of X2) by dtype bits; must
# equal GramTile in csrc/gram_block.cu (the library reports its own).
TILE = {64: (128, 64), 32: (128, 128)}
# m, n and d travel as C ints; the launch is a 1-D grid of tiles.
INT_MAX = 2**31 - 1
MAX_TILES = 2**31 - 1


def is_symmetric(X1, X2) -> bool:
    """Whether ``X2`` is ``X1``: the same storage, offset, shape and
    strides (equal values in other storage are not)."""
    return (X1.device == X2.device and X1.dtype == X2.dtype
            and X1.untyped_storage().data_ptr()
            == X2.untyped_storage().data_ptr()
            and X1.storage_offset() == X2.storage_offset()
            and X1.shape == X2.shape and X1.stride() == X2.stride())


def launch_tiles(m: int, n: int, d: int, bits: int, symmetric: bool) -> int:
    """Thread blocks (output tiles) of one launch at (m, n, d); raises
    ``ValueError`` past the kernel's limits: m, n and d up to 2^31 - 1,
    and at most 2^31 - 1 tiles (gridDim.x)."""
    for name, v in (("rows of X1", m), ("rows of X2", n), ("features", d)):
        if v > INT_MAX:
            raise ValueError(f"gram_cross takes at most {INT_MAX} {name}, "
                             f"got {v}")
    tm, tn = TILE[bits]
    cols = -(-n // tn)
    if symmetric:
        r = tm // tn
        # column tiles q hold q // r + 1 row tiles
        full, part = divmod(cols, r)
        tiles = r * full * (full + 1) // 2 + part * (full + 1)
    else:
        tiles = -(-m // tm) * cols
    if tiles > MAX_TILES:
        raise ValueError(f"gram_cross at {m} x {n} needs {tiles} tiles of "
                         f"{tm} x {tn}, more than {MAX_TILES}")
    return tiles


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
    bits = dtype_bits(X1.dtype)
    sym = is_symmetric(X1, X2)
    tiles = launch_tiles(l1, l2, d, bits, sym)
    if out is None:
        out = torch.empty((l1, l2), dtype=X1.dtype, device=X1.device)
    check_state("out", out, (l1, l2), X1.dtype, X1.device)
    if tiles == 0:
        return out
    s1 = torch.sum(X1 * X1, dim=-1)
    s2 = s1 if sym else torch.sum(X2 * X2, dim=-1)
    fn = build.entry("gram_block", bits)
    # the kernel takes equal X1 and X2 pointers for the symmetric mode
    ptrs = [t.data_ptr() for t in (X1, X1 if sym else X2, s1, s2, out)]
    err = fn(*ptrs, float(gamma), l1, l2, d, X1.device.index,
             torch.cuda.current_stream(X1.device).cuda_stream)
    tally.count(gram_cross)
    tally.count(gram_cross, int(sym), "symmetric_launches")
    build.check(err, "gram_block")
    return out


gram_cross.launches = 0
gram_cross.symmetric_launches = 0
