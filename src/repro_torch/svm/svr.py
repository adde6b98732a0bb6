"""sklearn-style ``SVR`` facade: ε-insensitive regression on the port's
PA-SMO engines.

The fit is one generalized dual QP (:func:`repro_torch.core.qp.svr_qp`):
2l doubled variables sharing the base l x l kernel, run as one lane of
:func:`repro_torch.core.solver_fused.solve_fused_batched_qp` with
``doubled=True`` (on the card the H = 2 passes), or on the classic engine
through :class:`repro_torch.core.qp.DoubledKernel`; no 2l x 2l matrix
exists anywhere.  Prediction is ``f(x) = k(x, X) @ beta + b`` with
``beta = alpha[:l] + alpha[l:]`` (:func:`repro_torch.core.qp.svr_fold`).

    >>> reg = SVR(C=10.0, epsilon=0.1, gamma=0.5).fit(X, y)   # on the card
    >>> reg = SVR(C=10.0, epsilon=0.1, gamma=0.5, device="cpu").fit(X, y)
    >>> reg.predict(Xq)
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.core import qp as qp_mod
from repro_torch.core import sharded_lanes
from repro_torch.core.solver import SolveResult, solve_qp
from repro_torch.core.solver_fused import FusedResult
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.svm.base import SVMEstimatorBase
from repro_torch.telemetry import spans


class SVR(SVMEstimatorBase):
    """RBF ε-support-vector regression driven by the planning-ahead solver.

    ``C`` is the box budget, ``epsilon`` the insensitive tube's half-width,
    ``gamma`` a float or ``"scale"``; ``eps`` is the KKT stopping accuracy
    (the solver's tolerance, not the tube).  The other knobs are as in
    :class:`repro_torch.svm.svc.SVC`: ``engine`` picks the fused or the
    classic solver, ``step="conjugate"`` (with ``algorithm="smo"``) runs
    the Conjugate-SMO step, ``precompute`` (default ``True``) banks the
    Gram matrix as there, and ``diagnostics`` records the fit's spans (its
    ``fit`` span ends in an ``svr_fit`` phase event) and drains its lane
    on the fused engine.  The fit
    is one lane, so ``engine="auto"`` never shards it; ``engine="sharded"``
    (with ``mesh``/``devices`` as in :class:`~repro_torch.svm.svc.SVC`)
    runs the lane through the sharded engine all the same.
    """

    _fit_attr = "beta_"

    def __init__(self, C: float = 1.0, epsilon: float = 0.1,
                 gamma: Union[float, str] = "scale", *,
                 algorithm: str = "pasmo", step: str = "plain",
                 eps: float = 1e-3, max_iter: int = 1_000_000,
                 plan_candidates: int = 1, impl: str = "auto",
                 engine: str = "auto", precompute: bool = True, dtype=None,
                 device=None, mesh=None, devices=None, diagnostics=None):
        self.C = C
        self.epsilon = epsilon
        self.gamma = gamma
        self._init_common(algorithm=algorithm, eps=eps, max_iter=max_iter,
                          plan_candidates=plan_candidates, impl=impl,
                          engine=engine, precompute=precompute, dtype=dtype,
                          device=device, step=step, mesh=mesh,
                          devices=devices, diagnostics=diagnostics)

    def fit(self, X, y) -> "SVR":
        dev = resolve_device(self.device)
        with spans.fit_span(self.diagnostics, "svr_fit", dev) as sp:
            return self._fit(X, y, dev, sp)

    def _fit(self, X, y, dev, sp) -> "SVR":
        X = torch.as_tensor(X, dtype=self.dtype, device=dev).contiguous()
        y = torch.as_tensor(y, dtype=self.dtype, device=dev).reshape(-1)
        self.device_ = dev
        self.gamma_ = self._resolve_gamma(X)
        self.X_ = X
        self.engine_ = self._resolve_engine()
        if sp is not None:
            sp.meta.update(engine=self.engine_, rows=int(X.shape[0]))
        qp = qp_mod.svr_qp(y, float(self.C), float(self.epsilon))
        tel = self._ring_config()
        ring = None
        if self.engine_ == "batched":
            res = solve_qp(qp_mod.DoubledKernel(self._classic_kernel(X)), qp,
                           self._config(), device=dev, dtype=self.dtype)
        else:
            bank_kw = {}
            if self.precompute and ops.resolve_impl(self.impl, dev) == "torch":
                K = ops.gram(X, gamma=self.gamma_, impl=self.impl, device=dev,
                             dtype=self.dtype)
                bank_kw = dict(gram=K[None], gram_idx=torch.zeros(
                    (1,), dtype=torch.int64, device=dev))
            out = sharded_lanes.lane_solver(self._lane_mesh(dev))(
                X, qp.p[None], qp.bounds.lower[None], qp.bounds.upper[None],
                self.gamma_, self._config(), impl=self.impl, doubled=True,
                telemetry=tel, **bank_kw)
            if tel is not None:
                out, ring = out
            res = out.lane(0)
        if ring is not None:
            self.diagnostics.drain_ring(
                ring, [{"gamma": self.gamma_, "C": float(self.C),
                        "epsilon": float(self.epsilon)}], out)
        return self._fitted(res)

    def _fitted(self, res: Union[SolveResult, FusedResult]) -> "SVR":
        self.fit_result_ = res
        self.alpha_ = res.alpha                    # (2l,) doubled dual
        self.beta_ = qp_mod.svr_fold(res.alpha)    # (l,) coefficients
        self.b_ = res.b
        return self

    def predict(self, Xq) -> torch.Tensor:
        self._check_fitted()
        with spans.decide_span(self.diagnostics, self.device_):
            Kq, squeeze = self._query_gram(Xq)
            f = Kq @ self.beta_ + self.b_
        return f[0] if squeeze else f

    def score(self, Xq, yq) -> float:
        """Coefficient of determination R^2 (sklearn convention)."""
        yq = np.asarray(yq, np.float64)
        pred = self.predict(Xq).cpu().numpy().astype(np.float64)
        ss_res = float(np.sum((yq - pred) ** 2))
        ss_tot = float(np.sum((yq - yq.mean()) ** 2))
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0

    @property
    def n_support_(self) -> int:
        """Number of support vectors (nonzero folded coefficients)."""
        self._check_fitted()
        return int((self.beta_.abs() > 1e-9).sum())
