"""sklearn-style ``OneClassSVM`` facade: nu novelty detection on the port's
PA-SMO engines.

The fit is the one-class instance of the generalized dual
(:func:`repro_torch.core.qp.oneclass_qp`): ``p = 0``, box ``[0, 1/(nu l)]``,
``sum(a) = 1``, started from LIBSVM's feasible point
(:func:`repro_torch.core.qp.oneclass_alpha0`), since 0 is infeasible, with
its gradient ``G0 = -K alpha0`` paid as one matvec before the loop: the
blocked :meth:`repro_torch.core.qp.RBFKernel.matvec` on the card, the Gram
bank on the plain backend; on the classic engine the oracle's matvec.
The decision function is

    f(x) = k(x, X) @ alpha - rho,   rho = -b

and ``predict`` returns +1 for inliers, -1 for outliers.
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


class OneClassSVM(SVMEstimatorBase):
    """RBF one-class SVM driven by the planning-ahead solver.

    ``nu`` in (0, 1] upper-bounds the training-outlier fraction and
    lower-bounds the support-vector fraction.  The other knobs are as in
    :class:`repro_torch.svm.svc.SVC` (``engine`` and ``step="conjugate"``
    with ``algorithm="smo"`` included); ``diagnostics`` records the
    fit's spans (its ``fit`` span ends in a ``oneclass_fit`` phase event)
    and drains the fused engine's lane.
    """

    def __init__(self, nu: float = 0.5, gamma: Union[float, str] = "scale",
                 *, algorithm: str = "pasmo", step: str = "plain",
                 eps: float = 1e-3, max_iter: int = 1_000_000,
                 plan_candidates: int = 1, impl: str = "auto",
                 engine: str = "auto", precompute: bool = True, dtype=None,
                 device=None, mesh=None, devices=None, diagnostics=None):
        if not 0.0 < nu <= 1.0:
            raise ValueError(f"nu must be in (0, 1], got {nu!r}")
        self.nu = nu
        self.gamma = gamma
        self._init_common(algorithm=algorithm, eps=eps, max_iter=max_iter,
                          plan_candidates=plan_candidates, impl=impl,
                          engine=engine, precompute=precompute, dtype=dtype,
                          device=device, step=step, mesh=mesh,
                          devices=devices, diagnostics=diagnostics)

    def fit(self, X, y=None) -> "OneClassSVM":
        del y
        dev = resolve_device(self.device)
        with spans.fit_span(self.diagnostics, "oneclass_fit", dev) as sp:
            return self._fit(X, dev, sp)

    def _fit(self, X, dev, sp) -> "OneClassSVM":
        X = torch.as_tensor(X, dtype=self.dtype, device=dev).contiguous()
        l = X.shape[0]
        self.device_ = dev
        self.gamma_ = self._resolve_gamma(X)
        self.X_ = X
        self.engine_ = self._resolve_engine()
        if sp is not None:
            sp.meta.update(engine=self.engine_, rows=int(X.shape[0]))
        qp = qp_mod.oneclass_qp(l, self.nu, self.dtype, dev)
        a0 = qp_mod.oneclass_alpha0(l, self.nu, self.dtype, dev)
        tel = self._ring_config()
        ring = None
        if self.engine_ == "batched":
            res = solve_qp(self._classic_kernel(X), qp, self._config(),
                           alpha0=a0, device=dev, dtype=self.dtype)
        else:
            bank_kw = {}
            if self.precompute and ops.resolve_impl(self.impl, dev) == "torch":
                K = ops.gram(X, gamma=self.gamma_, impl=self.impl, device=dev,
                             dtype=self.dtype)
                G0 = -(K @ a0)
                bank_kw = dict(gram=K[None], gram_idx=torch.zeros(
                    (1,), dtype=torch.int64, device=dev))
            else:
                G0 = -qp_mod.make_rbf(X, self.gamma_).matvec(a0)
            out = sharded_lanes.lane_solver(self._lane_mesh(dev))(
                X, qp.p[None], qp.bounds.lower[None], qp.bounds.upper[None],
                self.gamma_, self._config(), impl=self.impl,
                alpha0=a0[None], G0=G0[None], telemetry=tel, **bank_kw)
            if tel is not None:
                out, ring = out
            res = out.lane(0)
        if ring is not None:
            self.diagnostics.drain_ring(
                ring, [{"gamma": self.gamma_, "nu": float(self.nu)}], out)
        return self._fitted(res)

    def _fitted(self, res: Union[SolveResult, FusedResult]) -> "OneClassSVM":
        self.fit_result_ = res
        self.alpha_ = res.alpha
        self.b_ = res.b
        self.rho_ = float(-res.b)
        return self

    def decision_function(self, Xq) -> torch.Tensor:
        """Signed distance to the separating surface: >= 0 for inliers."""
        self._check_fitted()
        with spans.decide_span(self.diagnostics, self.device_):
            Kq, squeeze = self._query_gram(Xq)
            df = Kq @ self.alpha_ + self.b_
        return df[0] if squeeze else df

    def predict(self, Xq) -> np.ndarray:
        """+1 (inlier) / -1 (outlier), sklearn convention."""
        df = self.decision_function(Xq).cpu().numpy()
        return np.where(df >= 0, 1, -1).astype(np.int64)

    @property
    def n_support_(self) -> int:
        """Number of support vectors (nonzero duals)."""
        self._check_fitted()
        return int((self.alpha_ > 1e-12).sum())
