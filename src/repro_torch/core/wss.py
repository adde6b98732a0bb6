"""Working-set selection policies (``repro.core.wss``), lane-batched.

* :func:`select_mvp`        — first-order most-violating pair.
* :func:`select_wss2`       — second-order selection of Fan et al. (eq. 3),
                              LIBSVM's default and the paper's baseline.
* :func:`select_wss2_exact` — the same ``i``, with ``j`` maximizing the
                              exact (clipped) SMO gain: Alg. 3's guard
                              branch.

Every selector reduces over the trailing axis, so it takes one (n,)
problem or a (B, n) batch of lanes, with one index a lane.  An argmax
takes the first maximal index, as ``jax.lax.argmax`` does, and a lane
with no candidate gives index 0 with value -inf.  Selection reads only
``G``, the box masks and kernel entries, so the classification, ε-SVR
and one-class duals select through the same code.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import step as step_mod
from repro_torch.core.qp import TAU, Bounds, take

NEG_INF = float("-inf")


class Selection(NamedTuple):
    i: torch.Tensor          # int32, one a lane
    j: torch.Tensor          # int32
    gain: torch.Tensor       # selection objective value of (i, j)
    violation: torch.Tensor  # first-order KKT gap psi(a) (for stopping)


def _masked_argmax(values, mask):
    v = torch.where(mask, values, NEG_INF)
    idx = torch.argmax(v, dim=-1)
    return idx.to(torch.int32), take(v, idx)


def select_i(G, up):
    """``i = argmax{G_n | n in I_up}`` (shared by all second-order rules)."""
    return _masked_argmax(G, up)


def pair_curvature(K_i, K_ii, diag):
    """``Q_(i,n),(i,n) = K_ii - 2 K_in + K_nn`` for all n, tau-guarded."""
    return torch.clamp_min(K_ii[..., None] - 2.0 * K_i + diag, TAU)


def _pair_terms(G, K_i, diag, down, i, g_i):
    """``l_(i,n)``, the curvature and the j-candidates of every n."""
    l = g_i[..., None] - G
    q = pair_curvature(K_i, take(diag, i), diag)
    n_idx = torch.arange(G.shape[-1], dtype=torch.int32, device=G.device)
    return l, q, down & (l > 0) & (n_idx != i[..., None])


def _exact_gains(l, q, alpha, bounds: Bounds, i):
    """The exact clipped SMO gain of every pair (i, n)."""
    ai, Li, Ui = (take(v, i)[..., None]
                  for v in (alpha, bounds.lower, bounds.upper))
    sb = step_mod.step_bounds(ai, alpha, Li, Ui, bounds.lower, bounds.upper)
    return step_mod.gain_of_step(step_mod.clip_step(l / q, sb), l, q)


def _select(G, gains, cand, down, i, g_i) -> Selection:
    j, gain = _masked_argmax(gains, cand)
    g_dn = torch.where(down, G, float("inf")).amin(dim=-1)
    return Selection(i=i.to(torch.int32), j=j, gain=gain,
                     violation=g_i - g_dn)


def select_wss2(G, K_i, diag, up, down, i: Optional[torch.Tensor] = None,
                g_i: Optional[torch.Tensor] = None) -> Selection:
    """Second-order selection (eq. 3): maximize the Newton gain bound.

    ``K_i`` is the kernel row of the selected ``i``; pass (i, g_i) to reuse
    a precomputed first index."""
    if i is None:
        i, g_i = select_i(G, up)
    l, q, cand = _pair_terms(G, K_i, diag, down, i, g_i)
    return _select(G, 0.5 * l * l / q, cand, down, i, g_i)


def select_wss2_exact(G, K_i, diag, alpha, bounds: Bounds, up, down,
                      i: Optional[torch.Tensor] = None,
                      g_i: Optional[torch.Tensor] = None) -> Selection:
    """Alg. 3's exact-gain branch: ``j`` maximizes the clipped SMO gain,
    which needs the box state of ``i`` and of every candidate."""
    if i is None:
        i, g_i = select_i(G, up)
    l, q, cand = _pair_terms(G, K_i, diag, down, i, g_i)
    return _select(G, _exact_gains(l, q, alpha, bounds, i), cand, down, i,
                   g_i)


def select_wss2_either(G, K_i, diag, alpha, bounds: Bounds, up, down, i,
                       g_i, use_exact) -> Selection:
    """:func:`select_wss2_exact` on the lanes where ``use_exact``,
    :func:`select_wss2` on the others.  Both gains are computed on every
    lane and selected per lane, as JAX's ``lax.cond`` under ``vmap`` does,
    over shared ``l``, curvature and candidates."""
    l, q, cand = _pair_terms(G, K_i, diag, down, i, g_i)
    gains = torch.where(use_exact[..., None],
                        _exact_gains(l, q, alpha, bounds, i),
                        0.5 * l * l / q)
    return _select(G, gains, cand, down, i, g_i)


def select_mvp(G, up, down) -> Selection:
    """First-order most-violating pair (for ablations)."""
    i, g_i = _masked_argmax(G, up)
    j, neg_g_j = _masked_argmax(-G, down)
    return Selection(i=i, j=j, gain=g_i + neg_g_j, violation=g_i + neg_g_j)


# ---------------------------------------------------------------------------
# Candidate working sets (Alg. 3's B^(t-2) candidate, §7.4's N candidates)
# ---------------------------------------------------------------------------


def _candidate_ok(B_i, B_j, up, down, l):
    return take(up, B_i) & take(down, B_j) & (l > 0) & (B_i != B_j)


def candidate_newton_gain(B_i, B_j, G, Kii, Kij, Kjj, up, down):
    """Newton gain bound of explicit candidates (B_i, B_j), one or (..., k)
    a lane; -inf where infeasible.  Needs only the 2x2 minor."""
    l = take(G, B_i) - take(G, B_j)
    q = torch.clamp_min(Kii - 2.0 * Kij + Kjj, TAU)
    return torch.where(_candidate_ok(B_i, B_j, up, down, l),
                       0.5 * l * l / q, NEG_INF)


def candidate_exact_gain(B_i, B_j, G, Kii, Kij, Kjj, alpha, bounds: Bounds,
                         up, down):
    """Exact clipped gain of explicit candidates; -inf where infeasible."""
    l = take(G, B_i) - take(G, B_j)
    q = torch.clamp_min(Kii - 2.0 * Kij + Kjj, TAU)
    sb = step_mod.step_bounds(
        take(alpha, B_i), take(alpha, B_j),
        take(bounds.lower, B_i), take(bounds.upper, B_i),
        take(bounds.lower, B_j), take(bounds.upper, B_j))
    g = step_mod.gain_of_step(step_mod.clip_step(l / q, sb), l, q)
    return torch.where(_candidate_ok(B_i, B_j, up, down, l), g, NEG_INF)
