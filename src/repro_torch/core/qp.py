"""Dual quadratic programs: the box and the exact math the fused solver
needs (main-path subset of ``repro.core.qp``).

The general SMO dual is ``max p^T a - 1/2 a^T Q a`` subject to
``sum(a) = const`` and ``L_i <= a_i <= U_i``, with gradient
``G = p - Q a``; equality signs are folded into the box (the signed
convention), so the SMO direction is always ``e_i - e_j``.
"""

from __future__ import annotations

import dataclasses

import torch

# LIBSVM's guard for vanishing curvature (footnote 1 in the paper).
TAU = 1e-12


@dataclasses.dataclass(frozen=True)
class Bounds:
    """Box bounds of the signed dual problem."""

    lower: torch.Tensor  # L_i = min(0, y_i C)
    upper: torch.Tensor  # U_i = max(0, y_i C)


def make_bounds(y: torch.Tensor, C) -> Bounds:
    """Per-coordinate box ``[min(0, y_i C), max(0, y_i C)]``; ``C`` is a
    scalar or a per-sample vector (class-weighted SVC)."""
    yC = y * C
    zero = torch.zeros_like(yC)
    return Bounds(lower=torch.minimum(zero, yC), upper=torch.maximum(zero, yC))


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


def is_feasible(alpha, bounds: Bounds, atol: float = 1e-9):
    """Box and equality-constraint feasibility (a 0-d bool tensor)."""
    box = torch.all((alpha >= bounds.lower - atol)
                    & (alpha <= bounds.upper + atol))
    eq = torch.abs(torch.sum(alpha)) <= atol * (
        1 + torch.sum(torch.abs(alpha)))
    return box & eq
