"""The RBF kernel's width and products, plain and blocked."""

from __future__ import annotations

import torch

BLOCK = 2048


def scale_gamma(X: torch.Tensor) -> float:
    """scikit-learn's ``gamma="scale"``: 1 / (d Var(X)), the variance over
    every entry of X."""
    X = X.to(torch.float64)
    return 1.0 / (X.shape[1] * float(X.var(unbiased=False)))


def products(X: torch.Tensor, Z: torch.Tensor, gamma: float,
             A: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """``k(Z, X) @ A.T``: (len(Z), B) for rows of coefficients A (B, l),
    with k(z, x) = exp(-gamma |z - x|^2), in float64, Z taken ``block``
    rows at a time so that no more than (block, l) kernel values live at
    once."""
    X = X.to(torch.float64)
    Z = Z.to(torch.float64)
    A = A.to(torch.float64)
    sx = (X * X).sum(dim=1)
    out = torch.empty((Z.shape[0], A.shape[0]), dtype=torch.float64,
                      device=X.device)
    for r in range(0, Z.shape[0], block):
        z = Z[r:r + block]
        d2 = (z * z).sum(dim=1)[:, None] + sx[None, :] - 2.0 * (z @ X.T)
        out[r:r + block] = torch.exp(-gamma * d2.clamp_min(0.0)) @ A.T
    return out
