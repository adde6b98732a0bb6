"""Dual quadratic programs: problem containers, exact math and the kernel
oracles (``repro.core.qp``), lane-batched.

The general SMO dual is ``max p^T a - 1/2 a^T Q a`` subject to
``sum(a) = const`` and ``L_i <= a_i <= U_i``, with gradient
``G = p - Q a``; equality signs are folded into the box (the signed
convention), so the SMO direction is always ``e_i - e_j``.  Instances:
classification (``p = y``, box ``[min(0, y_i C), max(0, y_i C)]``),
ε-SVR in doubled form (2l variables over the base kernel) and one-class /
nu novelty detection (``p = 0``, box ``[0, 1/(nu l)]``, ``sum(a) = 1``).

Reductions run over the trailing (coordinate) axis, so every function
takes one (n,) problem or a (B, n) batch of lanes.  The kernel oracles
give the classic solver (:mod:`repro_torch.core.solver`) rows, the
diagonal and entries of Q: ``row(i)`` maps an int index tensor of any
shape ``S`` (one index per lane: ``(B,)``, or ``(B, k)`` for k indices a
lane) to ``S + (n,)`` rows, ``entry(i, j)`` to ``S`` values; ``diag()`` is
(n,) for an oracle that every lane shares and (B, n) for a
:class:`StackedKernel` over B bank indices.
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


def take(M: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane gather over the trailing axis: ``M`` (..., n) at ``idx``
    (...) -> (...), or at ``idx`` (..., k) -> (..., k) (int32 indices
    become int64 here only)."""
    if idx.ndim == M.ndim - 1:
        return M.gather(-1, idx.long().unsqueeze(-1)).squeeze(-1)
    return M.gather(-1, idx.long())


def make_bounds(y: torch.Tensor, C) -> Bounds:
    """Per-coordinate box ``[min(0, y_i C), max(0, y_i C)]``; ``C`` is a
    scalar or a per-sample vector (class-weighted SVC)."""
    yC = y * C
    zero = torch.zeros_like(yC)
    return Bounds(lower=torch.minimum(zero, yC), upper=torch.maximum(zero, yC))


def classification_qp(y: torch.Tensor, C) -> DualQP:
    """The signed classification dual (eq. 1): ``p = y``, box from the
    labels; ``C`` is a scalar or a per-sample budget."""
    return DualQP(p=y, bounds=make_bounds(y, C))


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


def dual_objective(alpha, p, K):
    """``f(a) = p^T a - 1/2 a^T Q a`` for a dense symmetric ``K``."""
    return torch.sum(p * alpha, dim=-1) - 0.5 * torch.sum(
        alpha * (alpha @ K.T), dim=-1)


def gradient(alpha, p, K):
    """``grad f(a) = p - Q a`` for a dense symmetric ``K``."""
    return p - alpha @ K.T


def up_mask(alpha, bounds: Bounds, tol: float = 0.0):
    """Indicator of ``I_up(a) = {i | a_i < U_i}``."""
    return alpha < bounds.upper - tol


def down_mask(alpha, bounds: Bounds, tol: float = 0.0):
    """Indicator of ``I_down(a) = {i | a_i > L_i}``."""
    return alpha > bounds.lower + tol


def kkt_gap(G, alpha, bounds: Bounds, active=None):
    """KKT violation gap ``max{G_i | i in I_up} - min{G_j | j in I_down}``
    over the trailing axis; ``active`` optionally restricts the
    reductions."""
    up = alpha < bounds.upper
    dn = alpha > bounds.lower
    if active is not None:
        up = up & active
        dn = dn & active
    g_up = torch.where(up, G, float("-inf")).amax(dim=-1)
    g_dn = torch.where(dn, G, float("inf")).amin(dim=-1)
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


# ---------------------------------------------------------------------------
# Kernel oracles
# ---------------------------------------------------------------------------
#
# The classic loop never needs the whole of Q: it needs rows, the diagonal
# and 2x2 minors.  An oracle serves them from a precomputed Gram matrix, a
# shared Gram bank, or rows recomputed from X.


@dataclasses.dataclass(frozen=True)
class PrecomputedKernel:
    """Oracle over a dense precomputed Gram matrix, shared by all lanes."""

    K: torch.Tensor  # (l, l) symmetric PSD

    @property
    def n(self) -> int:
        return self.K.shape[0]

    def row(self, i):
        return self.K[i.long()]

    def diag(self):
        return torch.diagonal(self.K)

    def entry(self, i, j):
        return self.K[i.long(), j.long()]

    def matvec(self, v):
        return v @ self.K.T


@dataclasses.dataclass(frozen=True)
class StackedKernel:
    """Oracle over the entries ``g`` of a stacked (n_stack, l, l) bank.

    Lanes that share a Gram matrix (the one-vs-rest heads of a (C, gamma)
    grid: k lanes a gamma) index one bank entry each, so every access is a
    gather into the shared bank and no per-lane (l, l) copy exists.  ``g``
    is a (B,) int tensor, one entry a lane (a 0-d or (1,) ``g`` serves one
    problem).
    """

    Ks: torch.Tensor  # (n_stack, l, l) symmetric PSD bank
    g: torch.Tensor   # (B,) int bank index of each lane

    @property
    def n(self) -> int:
        return self.Ks.shape[-1]

    def _lane(self, i):
        """Each lane's bank index, broadcastable against ``i``."""
        g = self.g.long()
        return g.reshape(g.shape + (1,) * (i.ndim - g.ndim))

    def row(self, i):
        n = self.n
        return self.Ks.view(-1, n)[self._lane(i) * n + i.long()]

    def diag(self):
        n = self.n
        return self.Ks.view(self.Ks.shape[0], n * n)[:, ::n + 1][
            self.g.long()]

    def entry(self, i, j):
        n = self.n
        return self.Ks.view(-1)[(self._lane(i) * n + i.long()) * n
                                + j.long()]

    def matvec(self, v):
        # one lane at a time: a gather of the lanes' matrices would hold a
        # (B, l, l) copy of the bank
        if v.ndim == 1:
            return self.Ks[self.g.long().reshape(())] @ v
        return torch.stack([self.Ks[g] @ vb
                            for g, vb in zip(self.g.long(), v)])


@dataclasses.dataclass(frozen=True)
class RBFKernel:
    """Gaussian kernel oracle ``k(x, z) = exp(-gamma ||x - z||^2)`` over
    ``X``: rows recomputed on demand, ``sq_norms`` precomputed once."""

    X: torch.Tensor          # (l, d)
    gamma: float
    sq_norms: torch.Tensor   # (l,)

    @property
    def n(self) -> int:
        return self.X.shape[0]

    def row(self, i):
        i = i.long()
        d2 = (self.sq_norms[i][..., None] + self.sq_norms
              - 2.0 * (self.X[i] @ self.X.T))
        return torch.exp(-self.gamma * torch.clamp_min(d2, 0.0))

    def diag(self):
        return torch.ones_like(self.sq_norms)

    def entry(self, i, j):
        # the same expansion as row(), so both paths agree
        i, j = i.long(), j.long()
        d2 = (self.sq_norms[i] + self.sq_norms[j]
              - 2.0 * torch.sum(self.X[j] * self.X[i], dim=-1))
        return torch.exp(-self.gamma * torch.clamp_min(d2, 0.0))

    def matvec(self, v: torch.Tensor, block: int = 256) -> torch.Tensor:
        """``K v`` for ``v`` (l,) or (B, l) without materializing K: one
        (block, l) distance, exp and product per block of rows."""
        out = torch.empty_like(v)
        for r0 in range(0, self.n, block):
            Xb = self.X[r0:r0 + block]
            d2 = (self.sq_norms[r0:r0 + block, None] + self.sq_norms[None, :]
                  - 2.0 * (Xb @ self.X.T))
            out[..., r0:r0 + block] = v @ torch.exp(
                -self.gamma * torch.clamp_min(d2, 0.0)).T
        return out


@dataclasses.dataclass(frozen=True)
class LinearKernel:
    """Linear kernel oracle ``k(x, z) = x . z``."""

    X: torch.Tensor  # (l, d)

    @property
    def n(self) -> int:
        return self.X.shape[0]

    def row(self, i):
        return self.X[i.long()] @ self.X.T

    def diag(self):
        return torch.sum(self.X * self.X, dim=-1)

    def entry(self, i, j):
        return torch.sum(self.X[i.long()] * self.X[j.long()], dim=-1)

    def matvec(self, v):
        return (v @ self.X) @ self.X.T


@dataclasses.dataclass(frozen=True)
class DoubledKernel:
    """The ε-SVR doubled operator ``Q[k, k'] = K[k mod l, k' mod l]``: a
    row is the base row tiled, the diagonal the base diagonal tiled, and a
    matvec contracts the two halves first.  Nothing of size 2l x 2l
    exists; ``base`` is any oracle of this module."""

    base: object

    @property
    def n(self) -> int:
        return 2 * self.base.n

    def row(self, i):
        r = self.base.row(i % self.base.n)
        return torch.cat([r, r], dim=-1)

    def diag(self):
        d = self.base.diag()
        return torch.cat([d, d], dim=-1)

    def entry(self, i, j):
        return self.base.entry(i % self.base.n, j % self.base.n)

    def matvec(self, v):
        n = self.base.n
        m = self.base.matvec(v[..., :n] + v[..., n:])
        return torch.cat([m, m], dim=-1)


def make_rbf(X: torch.Tensor, gamma) -> RBFKernel:
    return RBFKernel(X=X, gamma=float(gamma),
                     sq_norms=torch.sum(X * X, dim=-1))


def materialize(kernel) -> torch.Tensor:
    """Dense Gram matrix of a one-problem oracle (tests, tiny problems)."""
    d = kernel.diag()
    return kernel.row(torch.arange(kernel.n, dtype=torch.int32,
                                   device=d.device))


def oracle_to(kernel, device, dtype):
    """``kernel`` with its floating tensors moved to ``device`` and
    ``dtype`` and its index tensors to ``device``."""
    def move(v):
        if torch.is_tensor(v):
            return v.to(device, dtype) if v.is_floating_point() \
                else v.to(device)
        if dataclasses.is_dataclass(v):
            return oracle_to(v, device, dtype)
        return v

    return dataclasses.replace(kernel, **{
        f.name: move(getattr(kernel, f.name))
        for f in dataclasses.fields(kernel)})
