"""Dual quadratic programs: the box, the exact math the fused solver
needs and the RBF oracle (the subset of ``repro.core.qp`` the ported
slices run).

The general SMO dual is ``max p^T a - 1/2 a^T Q a`` subject to
``sum(a) = const`` and ``L_i <= a_i <= U_i``, with gradient
``G = p - Q a``; equality signs are folded into the box (the signed
convention), so the SMO direction is always ``e_i - e_j``.  Instances:
classification (``p = y``, box ``[min(0, y_i C), max(0, y_i C)]``),
ε-SVR in doubled form (2l variables over the base kernel) and one-class /
nu novelty detection (``p = 0``, box ``[0, 1/(nu l)]``, ``sum(a) = 1``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# LIBSVM's guard for vanishing curvature (footnote 1 in the paper).
TAU = 1e-12


@dataclasses.dataclass(frozen=True)
class Bounds:
    """Box bounds of the signed dual problem."""

    lower: torch.Tensor  # L_i = min(0, y_i C)
    upper: torch.Tensor  # U_i = max(0, y_i C)


@dataclasses.dataclass(frozen=True)
class DualQP:
    """General SMO dual: ``max p^T a - 1/2 a^T Q a`` over ``bounds`` with
    one equality constraint ``sum(a) = const`` (signs folded into the box;
    the constant is fixed by the feasible starting point).  The operator
    ``Q`` comes from a kernel oracle, not from the container."""

    p: torch.Tensor    # (n,) linear term
    bounds: Bounds     # (n,) per-coordinate box


def make_bounds(y: torch.Tensor, C) -> Bounds:
    """Per-coordinate box ``[min(0, y_i C), max(0, y_i C)]``; ``C`` is a
    scalar or a per-sample vector (class-weighted SVC)."""
    yC = y * C
    zero = torch.zeros_like(yC)
    return Bounds(lower=torch.minimum(zero, yC), upper=torch.maximum(zero, yC))


def svr_qp(y: torch.Tensor, C, epsilon) -> DualQP:
    """The ε-SVR dual in signed doubled form (2l variables).

    With ``a = (alpha+, -alpha-)`` the ε-insensitive dual is the general
    form over the doubled operator ``Q[k, k'] = K[k mod l, k' mod l]`` with
    ``p = (y - eps, y + eps)``, box ``([0, C], [-C, 0])`` and
    ``sum(a) = 0``.  The regression coefficients are
    ``beta = a[:l] + a[l:]`` (:func:`svr_fold`).  ``C`` is a scalar or an
    (l,) per-sample budget.
    """
    C = torch.as_tensor(C, dtype=y.dtype, device=y.device).broadcast_to(
        y.shape)
    zero = torch.zeros_like(y)
    return DualQP(p=torch.cat([y - epsilon, y + epsilon]),
                  bounds=Bounds(lower=torch.cat([zero, -C]),
                                upper=torch.cat([C, zero])))


def svr_fold(alpha: torch.Tensor) -> torch.Tensor:
    """Fold a doubled SVR dual ``(..., 2l)`` to coefficients
    ``beta = a+ - a-`` ``(..., l)``."""
    n = alpha.shape[-1] // 2
    return alpha[..., :n] + alpha[..., n:]


def oneclass_qp(n: int, nu, dtype=torch.float64, device="cpu") -> DualQP:
    """The one-class (nu novelty-detection) dual: ``p = 0``, box
    ``[0, 1/(nu l)]``, equality ``sum(a) = 1``.  The zero vector is not
    feasible: start from :func:`oneclass_alpha0` with ``G0 = -K alpha0``."""
    u = 1.0 / (float(nu) * n)
    zero = torch.zeros((n,), dtype=dtype, device=device)
    return DualQP(p=zero, bounds=Bounds(lower=zero,
                                        upper=torch.full_like(zero, u)))


def oneclass_alpha0(n: int, nu: float, dtype=torch.float64,
                    device="cpu") -> torch.Tensor:
    """LIBSVM's feasible one-class start: the first ``floor(nu l)``
    coordinates at the upper bound ``1/(nu l)``, one fractional remainder
    coordinate, ``sum(a) = 1`` exactly."""
    nl = float(nu) * n
    m = int(np.floor(nl))
    a0 = np.zeros(n)
    a0[:m] = 1.0 / nl
    if m < n:
        a0[m] = (nl - m) / nl
    return torch.as_tensor(a0, dtype=dtype, device=device)


def kkt_gap(G, alpha, bounds: Bounds, active=None):
    """KKT violation gap ``max{G_i | i in I_up} - min{G_j | j in I_down}``
    over all elements; ``active`` optionally restricts the reductions."""
    up = alpha < bounds.upper
    dn = alpha > bounds.lower
    if active is not None:
        up = up & active
        dn = dn & active
    g_up = torch.where(up, G, float("-inf")).amax()
    g_dn = torch.where(dn, G, float("inf")).amin()
    return g_up - g_dn


def finite_gap(gap):
    """An empty ``I_up`` or ``I_down`` means no violating pair: gap 0."""
    return torch.where(torch.isfinite(gap), gap, torch.zeros_like(gap))


def safe_bias(g_up, g_dn):
    """Bias from the gap endpoints, falling back to the surviving endpoint
    when one is empty (non-finite), and 0 when both are."""
    fin_up = torch.isfinite(g_up)
    fin_dn = torch.isfinite(g_dn)
    gu = torch.where(fin_up, g_up, g_dn)
    gd = torch.where(fin_dn, g_dn, g_up)
    return torch.where(fin_up | fin_dn, 0.5 * (gu + gd),
                       torch.zeros_like(g_up))


def shrink_mask(G, alpha, L, U):
    """Conservative active mask over the trailing coordinate axis (leading
    axes broadcast: one (l,) lane or a (B, n) lane batch).

    A variable at its lower bound only acts as an ``i`` (up) candidate and
    leaves the set when ``G_i < min_{I_down} G``; one at its upper bound
    only acts as a ``j`` (down) candidate and leaves when
    ``G_j > max_{I_up} G``.  Neither can then be part of a violating pair.
    Interior variables always stay active.
    """
    up = alpha < U
    dn = alpha > L
    g_up = torch.where(up, G, float("-inf")).amax(dim=-1, keepdim=True)
    g_dn = torch.where(dn, G, float("inf")).amin(dim=-1, keepdim=True)
    return ~((~dn & (G < g_dn)) | (~up & (G > g_up)))


def is_feasible(alpha, bounds: Bounds, atol: float = 1e-9):
    """Box and equality-constraint feasibility (a 0-d bool tensor)."""
    box = torch.all((alpha >= bounds.lower - atol)
                    & (alpha <= bounds.upper + atol))
    eq = torch.abs(torch.sum(alpha)) <= atol * (
        1 + torch.sum(torch.abs(alpha)))
    return box & eq


@dataclasses.dataclass(frozen=True)
class RBFKernel:
    """Gaussian kernel oracle ``k(x, z) = exp(-gamma ||x - z||^2)`` over
    ``X``; its matvec gives the one-class ``G0`` without a Gram bank."""

    X: torch.Tensor          # (l, d)
    gamma: float
    sq_norms: torch.Tensor   # (l,)

    @property
    def n(self) -> int:
        return self.X.shape[0]

    def matvec(self, v: torch.Tensor, block: int = 256) -> torch.Tensor:
        """``K v`` for ``v`` (l,) without materializing K: one (block, l)
        distance, exp and product per block of rows."""
        out = torch.empty_like(v)
        for r0 in range(0, self.n, block):
            Xb = self.X[r0:r0 + block]
            d2 = (self.sq_norms[r0:r0 + block, None] + self.sq_norms[None, :]
                  - 2.0 * (Xb @ self.X.T))
            out[r0:r0 + block] = torch.exp(
                -self.gamma * torch.clamp_min(d2, 0.0)) @ v
        return out


def make_rbf(X: torch.Tensor, gamma) -> RBFKernel:
    return RBFKernel(X=X, gamma=float(gamma),
                     sq_norms=torch.sum(X * X, dim=-1))
