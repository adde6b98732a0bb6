"""The port's Gram at the CUDA kernel's edges, against the JAX package.

The kernel tiles its output in 128 x 64 (f64) and 128 x 128 (f32) blocks
and runs a symmetric mode when X2 is X1.  Here the port's plain paths
(``ops.gram(..., device="cpu")`` and ``ops.gram_bank(..., impl="torch")``)
meet the reference's ``ops.gram`` (``impl="jnp"`` and the Pallas kernel in
interpret mode) at one row, a tile, one short of it and one past it, with
d = 1 and 37; the wrapper's symmetric-mode detection and its launch
limits are checked without a card.  Tolerance: rtol 1e-12 (f64) and 1e-5
(f32), as in ``test_torch_kernels.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import gram_block, ops

RTOL = {np.float64: 1e-12, np.float32: 1e-5}
SIDES = (1, 127, 128, 129)
CROSS = [(s, 33, d) for s in SIDES for d in (1, 37)] + \
        [(33, s, d) for s in SIDES for d in (1, 37)]


def _rows(rng, n, d, dtype):
    return rng.normal(size=(n, d)).astype(dtype)


def _reference(X1, X2, gamma, impl):
    return np.asarray(jops.gram(jnp.asarray(X1), jnp.asarray(X2), gamma,
                                impl=impl, block_i=128, block_j=128))


@pytest.mark.parametrize("impl", ["jnp", "interpret"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("m,n,d", CROSS)
def test_gram_edge_matches_reference(m, n, d, dtype, impl):
    rng = np.random.default_rng(m * 1000 + n + d)
    X1, X2 = _rows(rng, m, d, dtype), _rows(rng, n, d, dtype)
    gamma = 1.0 / (2 * d)
    K = ops.gram(X1, X2, gamma, device="cpu",
                 dtype=torch.from_numpy(X1).dtype)
    assert K.shape == (m, n)
    np.testing.assert_allclose(K.numpy(), _reference(X1, X2, gamma, impl),
                               rtol=RTOL[dtype], atol=RTOL[dtype])


@pytest.mark.parametrize("impl", ["jnp", "interpret"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("l,d", [(l, d) for l in (1, 127, 129)
                                 for d in (1, 37)])
def test_gram_bank_edge_matches_reference(l, d, dtype, impl):
    """The bank's entries are the symmetric Grams of X, one per gamma."""
    rng = np.random.default_rng(l + d)
    X = _rows(rng, l, d, dtype)
    gammas = (0.5 / d, 2.0 / d)
    bank = ops.gram_bank(torch.from_numpy(X), gammas, impl="torch")
    assert bank.shape == (len(gammas), l, l)
    for g, gamma in enumerate(gammas):
        np.testing.assert_allclose(bank[g].numpy(),
                                   _reference(X, X, gamma, impl),
                                   rtol=RTOL[dtype], atol=RTOL[dtype])


def test_symmetric_mode_needs_the_same_tensor():
    X = torch.arange(40, dtype=torch.float64).reshape(10, 4)
    assert gram_block.is_symmetric(X, X)
    assert gram_block.is_symmetric(X, X.view(10, 4))
    # equal values in other storage
    assert not gram_block.is_symmetric(X, X.clone())
    # the same storage at another offset, the same shape
    assert not gram_block.is_symmetric(X[1:], X[:-1])
    # the same storage and shape, other strides
    S = torch.arange(16, dtype=torch.float64).reshape(4, 4)
    assert not gram_block.is_symmetric(S, S.T)
    assert not gram_block.is_symmetric(X, X.float())


@pytest.mark.parametrize("bits", [64, 32])
def test_launch_tiles_counts_the_tiles(bits):
    tm, tn = gram_block.TILE[bits]
    assert gram_block.launch_tiles(4096, 16384, 128, bits, False) == \
        -(-4096 // tm) * -(-16384 // tn)
    for l in (1, 63, 64, 65, 127, 128, 129, 1001, 16384):
        cols = -(-l // tn)
        # column tile q holds the row tiles i with i tm <= q tn
        want = sum(q * tn // tm + 1 for q in range(cols))
        assert gram_block.launch_tiles(l, l, 37, bits, True) == want


@pytest.mark.parametrize("m,n,d,sym", [
    (2**31, 1, 1, False),            # rows past a C int
    (1, 1, 2**31, False),            # features past a C int
    (2**31 - 1, 2**31 - 1, 1, False),  # tiles past gridDim.x
    (2**31 - 1, 2**31 - 1, 1, True),
])
@pytest.mark.parametrize("bits", [64, 32])
def test_launch_tiles_raises_past_the_limits(m, n, d, sym, bits):
    with pytest.raises(ValueError, match="gram_cross"):
        gram_block.launch_tiles(m, n, d, bits, sym)
