"""sklearn-style ``SVC`` facade over the port's PA-SMO engines.

Binary problems are one signed-dual QP; multiclass problems are reduced
one-vs-rest, one lane per class head, all advanced together by the fused
solver (:mod:`repro_torch.core.solver_fused`) or the classic one
(:mod:`repro_torch.core.solver`).  Prediction computes the
query cross-kernel once for all heads (:func:`repro_torch.kernels.ops.gram`).

    >>> clf = SVC(C=10.0, gamma=0.5).fit(X, y)       # on the CUDA card
    >>> clf = SVC(C=10.0, gamma=0.5, device="cpu").fit(X, y)
    >>> clf.predict(Xq)            # labels, any dtype y was given in
    >>> clf.decision_function(Xq)  # (m,) binary margin or (m, k) OVR scores
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from repro_torch.core import multiclass as mc
from repro_torch.core.solver import SolveResult
from repro_torch.core.solver_fused import FusedResult
from repro_torch.device import resolve_device
from repro_torch.svm.base import SVMEstimatorBase
from repro_torch.telemetry import spans


class SVC(SVMEstimatorBase):
    """RBF support-vector classifier driven by the planning-ahead solver.

    Parameters mirror ``repro.svm.SVC``: ``C`` (scalar, or a per-class
    vector for one-vs-rest), ``gamma`` (float or ``"scale"``),
    ``class_weight`` (``None``, ``"balanced"`` or a ``{label: weight}``
    dict; sample ``i`` of class ``c`` gets budget ``C * w_c``; needs a
    scalar ``C``), and the solver knobs ``algorithm`` (smo | pasmo |
    pasmo_simple | overshoot), ``plan_candidates``, ``step``
    (``"plain"``, or ``"conjugate"``, the Conjugate-SMO step, with
    ``algorithm="smo"``), ``eps``, ``max_iter``.  ``engine`` picks the
    solver: ``"fused"`` (smo or pasmo, one planning candidate),
    ``"batched"`` (the classic engine, every config) or ``"auto"`` (the
    fused one when it runs the config).  ``impl`` picks the kernels
    (``"cuda"``, ``"torch"`` or ``"auto"``) for the fit and the predict
    Gram.  ``device`` defaults to the CUDA card: ``fit`` raises without
    one unless ``device="cpu"`` is given.  ``dtype`` defaults to
    ``torch.get_default_dtype()``.  ``precompute`` (default ``True``):
    the fused engine builds the shared Gram matrix and reads rows from it
    on the plain backend only (the CUDA kernels recompute rows from
    ``X``, as the reference's accelerator path does); the classic engine
    builds it on either (the Gram kernel on the card) and without it
    recomputes RBF rows from ``X``.  ``diagnostics`` (a
    :class:`repro_torch.telemetry.Diagnostics`) records the fit's spans
    (its ``fit`` span ends in an ``svc_fit`` phase event) and, on the
    fused engine with a ring, drains one lane a class head (a binary
    fit's lone head is label 1).
    ``engine="sharded"`` deals the class heads over a lane mesh
    (:mod:`repro_torch.core.sharded_lanes`): the same fit, one loop a
    device slab; ``mesh``/``devices`` pin the mesh (default: every CUDA
    device, the CPU alone with ``device="cpu"``), and ``"auto"`` shards
    when they are given.
    """

    def __init__(self, C: Union[float, np.ndarray] = 1.0,
                 gamma: Union[float, str] = "scale", *,
                 class_weight: Union[dict, str, None] = None,
                 algorithm: str = "pasmo", step: str = "plain",
                 eps: float = 1e-3, max_iter: int = 1_000_000,
                 plan_candidates: int = 1, impl: str = "auto",
                 engine: str = "auto", precompute: bool = True, dtype=None,
                 device=None, mesh=None, devices=None, diagnostics=None):
        if not (class_weight is None or class_weight == "balanced"
                or isinstance(class_weight, dict)):
            raise ValueError("class_weight must be None, 'balanced' or a "
                             f"{{label: weight}} dict, got {class_weight!r}")
        self.C = C
        self.class_weight = class_weight
        self.gamma = gamma
        self._init_common(algorithm=algorithm, eps=eps, max_iter=max_iter,
                          plan_candidates=plan_candidates, impl=impl,
                          engine=engine, precompute=precompute, dtype=dtype,
                          device=device, step=step, mesh=mesh,
                          devices=devices, diagnostics=diagnostics)

    # -- fitting ------------------------------------------------------------

    def _sample_weights(self, y_idx: np.ndarray, k: int) -> np.ndarray:
        """Per-sample class weights w_{y_i} (class_weight is not None)."""
        if self.class_weight == "balanced":
            counts = np.bincount(y_idx, minlength=k)
            w = len(y_idx) / (k * np.maximum(counts, 1))
        else:
            w = np.array([float(self.class_weight.get(c, 1.0))
                          for c in self.classes_])
        return w[y_idx]

    def fit(self, X, y) -> "SVC":
        dev = resolve_device(self.device)
        with spans.fit_span(self.diagnostics, "svc_fit", dev) as sp:
            return self._fit(X, y, dev, sp)

    def _fit(self, X, y, dev, sp) -> "SVC":
        X = torch.as_tensor(X, dtype=self.dtype, device=dev).contiguous()
        y = y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y)
        self.classes_, y_idx = mc.class_index(y)
        k = len(self.classes_)
        if k < 2:
            raise ValueError("fit needs at least two classes")
        self.device_ = dev
        self.gamma_ = self._resolve_gamma(X)
        self.X_ = X
        cfg = self._config()
        self.engine_ = engine = self._resolve_engine()
        if sp is not None:
            sp.meta.update(engine=engine, n_class=k, rows=int(X.shape[0]))

        if k == 2 and np.asarray(self.C).size != 1:
            raise ValueError("per-class C requires more than two "
                             "classes (binary problems are one QP)")
        if self.class_weight is not None:
            # per-sample budgets C_i = C * w_{y_i}: a per-coordinate box of
            # the generalized dual, shared by all one-vs-rest heads
            if np.asarray(self.C).size != 1:
                raise ValueError("class_weight requires a scalar C")
            Csamp = torch.as_tensor(
                float(np.asarray(self.C).reshape(()))
                * self._sample_weights(y_idx, k), dtype=self.dtype,
                device=dev)
            C_lanes = Csamp[None, :] if k == 2 else Csamp.expand(k, -1)
        else:
            C_lanes = (float(np.asarray(self.C).reshape(())) if k == 2
                       else torch.as_tensor(np.asarray(self.C, float),
                                            dtype=self.dtype, device=dev))
        if k == 2:
            Y = torch.where(torch.as_tensor(y_idx == 1, device=dev), 1.0,
                            -1.0).to(self.dtype)[None, :]
        else:
            Y = mc.ovr_labels(y_idx, k, self.dtype, dev)

        tel = self._ring_config()
        ring = None
        if engine == "batched":
            out = mc.solve_ovr(self._classic_kernel(X), Y, C_lanes, cfg,
                               device=dev, dtype=self.dtype)
            res = (SolveResult(**{f.name: getattr(out, f.name)[0]
                                  for f in dataclasses.fields(out)})
                   if k == 2 else out)
        else:
            out = mc.solve_ovr_fused(X, Y, C_lanes, self.gamma_, cfg,
                                     impl=self.impl,
                                     precompute=self.precompute,
                                     mesh=self._lane_mesh(dev), device=dev,
                                     dtype=self.dtype, telemetry=tel)
            if tel is not None:
                out, ring = out
            res = out.lane(0) if k == 2 else out
        if ring is not None:
            # one lane a class head (a binary fit's lone head is the
            # "classes_[1] vs rest" problem, label index 1)
            Cv = np.asarray(self.C, float).reshape(-1)
            heads = [1] if k == 2 else range(k)
            meta = [{"gamma": self.gamma_, "label": int(c),
                     **({} if self.class_weight is not None else
                        {"C": float(Cv[c] if Cv.size > 1 else Cv[0])})}
                    for c in heads]
            self.diagnostics.drain_ring(ring, meta, out)
        self.fit_result_: Union[SolveResult, FusedResult] = res
        self.alpha_ = res.alpha          # (l,) binary, (k, l) one-vs-rest
        self.b_ = res.b
        return self

    # -- inference ----------------------------------------------------------

    def decision_function(self, Xq) -> torch.Tensor:
        """Binary: (m,) signed margin (positive -> ``classes_[1]``).
        Multiclass: (m, k) one-vs-rest scores."""
        self._check_fitted()
        with spans.decide_span(self.diagnostics, self.device_):
            Kq, squeeze = self._query_gram(Xq)
            if self.alpha_.ndim == 1:
                df = Kq @ self.alpha_ + self.b_
            else:
                df = mc.ovr_decision(Kq, self.alpha_, self.b_)
        return df[0] if squeeze else df

    def predict(self, Xq) -> np.ndarray:
        self._check_fitted()
        with spans.decide_span(self.diagnostics, self.device_):
            df = self.decision_function(Xq)
            if self.alpha_.ndim == 1:
                idx = (df >= 0).to(torch.int64)
            else:
                idx = torch.argmax(df, dim=-1)
        return self.classes_[idx.cpu().numpy()]

    def score(self, Xq, yq) -> float:
        """Mean accuracy on (Xq, yq)."""
        return float(np.mean(self.predict(Xq) == np.asarray(yq)))

    # -- introspection --------------------------------------------------

    @property
    def n_support_(self) -> np.ndarray:
        """Support-vector count per head ((1,) binary, (k,) one-vs-rest)."""
        self._check_fitted()
        a = np.atleast_2d(self.alpha_.cpu().numpy())
        return (np.abs(a) > 1e-9).sum(axis=1)
