"""SMO step algebra: truncated Newton step (eq. 2), gains (eq. 3/4), the
planning-ahead step (eq. 7/8), the Conjugate-SMO 2x2 step and the
overshoot heuristic (§7.3) — elementwise tensor math, any shape.

Notation follows the paper.  For a working set ``B = (i, j)`` and
direction ``v_B = e_i - e_j``:

    l    = v_B . grad f(a)        (directional derivative)
    Qtt  = K_ii - 2 K_ij + K_jj   (curvature)
    Lt   = max(L_i - a_i, a_j - U_j)            (lower step bound)
    Ut   = min(U_i - a_i, a_j - L_j)            (upper step bound)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.qp import TAU


class StepBounds(NamedTuple):
    lo: torch.Tensor  # \tilde L_t  (<= 0 at a feasible point)
    hi: torch.Tensor  # \tilde U_t  (>= 0 at a feasible point)


def step_bounds(ai, aj, Li, Ui, Lj, Uj) -> StepBounds:
    """Feasible interval of the step size mu along ``v_B = e_i - e_j``."""
    return StepBounds(lo=torch.maximum(Li - ai, aj - Uj),
                      hi=torch.minimum(Ui - ai, aj - Lj))


def newton_step(l, Qtt):
    """Unconstrained maximizer ``mu* = l / max(Qtt, tau)``."""
    return l / torch.clamp_min(Qtt, TAU)


def clip_step(mu, bounds: StepBounds):
    """Eq. (2): truncate the step to the feasible interval."""
    return torch.maximum(torch.minimum(mu, bounds.hi), bounds.lo)


def smo_step(l, Qtt, bounds: StepBounds):
    """The clipped Newton step.  Returns (mu, free); ``free`` is True iff
    the Newton step was not truncated (gates planning-ahead, Alg. 4)."""
    mu_star = newton_step(l, Qtt)
    mu = clip_step(mu_star, bounds)
    free = (mu_star > bounds.lo) & (mu_star < bounds.hi)
    return mu, free


def gain_newton(l, Qtt):
    """Eq. (3): second-order gain bound ``l^2 / (2 Qtt)``."""
    return 0.5 * l * l / torch.clamp_min(Qtt, TAU)


def gain_of_step(mu, l, Qtt):
    """Exact gain of a step of size mu: ``l mu - 1/2 Qtt mu^2``."""
    return l * mu - 0.5 * Qtt * mu * mu


class PlanningTerms(NamedTuple):
    """2x2 restriction of the QP onto directions v_B1 (current), v_B2."""

    w1: torch.Tensor   # v_B1 . grad f(a)
    w2: torch.Tensor   # v_B2 . grad f(a)
    Q11: torch.Tensor  # v_B1 . K v_B1
    Q22: torch.Tensor  # v_B2 . K v_B2
    Q12: torch.Tensor  # v_B1 . K v_B2


def planning_step(t: PlanningTerms):
    """Eq. (8): ``mu1 = (Q22 w1 - Q12 w2) / det(Q)``.  Returns (mu1, ok);
    ``ok`` is False on a numerically degenerate det (mu1 is then 0)."""
    det = t.Q11 * t.Q22 - t.Q12 * t.Q12
    ok = (det > TAU) & (t.Q22 > TAU)
    mu1 = (t.Q22 * t.w1 - t.Q12 * t.w2) / torch.where(ok, det, 1.0)
    return torch.where(ok, mu1, 0.0), ok


def planned_second_step(mu1, t: PlanningTerms):
    """Eq. (6): the greedy Newton step on B2 after a first step mu1 on B1."""
    return (t.w2 - t.Q12 * mu1) / torch.clamp_min(t.Q22, TAU)


def double_step_gain(mu1, t: PlanningTerms):
    """Eq. (7): total gain of (mu1 on B1) then the Newton step on B2."""
    det = t.Q11 * t.Q22 - t.Q12 * t.Q12
    q22 = torch.clamp_min(t.Q22, TAU)
    return (-0.5 * det / q22 * mu1 * mu1
            + (t.Q22 * t.w1 - t.Q12 * t.w2) / q22 * mu1
            + 0.5 * t.w2 * t.w2 / q22)


def conjugate_step(t: PlanningTerms):
    """Conjugate-SMO 2-direction step: the exact 2x2 solve on
    ``(v_B1, v_prev)``.  Returns (mu1, mu2, ok); both are 0 when not ok."""
    det = t.Q11 * t.Q22 - t.Q12 * t.Q12
    ok = (det > TAU) & (t.Q22 > TAU)
    safe = torch.where(ok, det, 1.0)
    mu1 = (t.Q22 * t.w1 - t.Q12 * t.w2) / safe
    mu2 = (t.Q11 * t.w2 - t.Q12 * t.w1) / safe
    return torch.where(ok, mu1, 0.0), torch.where(ok, mu2, 0.0), ok


def overshoot_step(l, Qtt, bounds: StepBounds, factor: float = 1.1):
    """§7.3 heuristic: clip ``factor * mu*`` instead of ``mu*``."""
    mu_star = newton_step(l, Qtt)
    mu = clip_step(factor * mu_star, bounds)
    free = (factor * mu_star > bounds.lo) & (factor * mu_star < bounds.hi)
    return mu, free
