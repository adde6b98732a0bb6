"""Shared plumbing for the sklearn-style facades: the solver knobs, the
``gamma="scale"`` rule, the engine choice and the query Gram.

A fit runs on the fused engine (``engine="fused"``), on the lane-sharded
fused engine over several devices (``engine="sharded"``,
:mod:`repro_torch.core.sharded_lanes`) or on the classic one
(``engine="batched"``); ``"auto"`` picks the classic engine for the
configs the fused one does not run, else the sharded engine when
``mesh``/``devices`` is given, else the fused engine.  ``diagnostics`` (a
:class:`repro_torch.telemetry.Diagnostics`) records the fit's spans (a
``fit`` span, also a ``phase`` event) and, on the fused and sharded
engines with a ring, drains their lanes; ``telemetry.recording(diag)``
around a fit or a decision records the same spans.
"""

from __future__ import annotations

import torch

from repro_torch.core import qp as qp_mod
from repro_torch.core import sharded_lanes
from repro_torch.core.solver import SolverConfig
from repro_torch.device import resolve_dtype
from repro_torch.kernels import ops
from repro_torch.telemetry import spans


class SVMEstimatorBase:
    """Mixin holding the facade knobs shared by every estimator."""

    _fit_attr = "alpha_"

    def _init_common(self, *, algorithm: str, eps: float, max_iter: int,
                     plan_candidates: int, impl: str, engine: str,
                     precompute: bool, dtype, device, step: str = "plain",
                     mesh=None, devices=None, diagnostics=None) -> None:
        if engine not in ("auto", "fused", "batched", "sharded"):
            raise ValueError(f"engine must be auto|fused|batched|sharded, "
                             f"got {engine!r}")
        if engine in ("fused", "batched") and (mesh is not None
                                               or devices is not None):
            raise ValueError("mesh/devices belong to the sharded engine: "
                             "drop them or use engine='sharded'/'auto', "
                             f"got engine={engine!r}")
        if impl not in ops.IMPLS:
            raise ValueError(f"impl must be one of {ops.IMPLS}, got {impl!r}")
        self.algorithm = algorithm
        self.step = step
        self.eps = eps
        self.max_iter = max_iter
        self.plan_candidates = plan_candidates
        self.impl = impl
        self.engine = engine
        self.precompute = precompute
        self.mesh = mesh
        self.devices = devices
        self.device = device
        self.diagnostics = diagnostics
        self.dtype = resolve_dtype(dtype)

    def _ring_config(self):
        """The ring geometry of the attached
        :class:`~repro_torch.telemetry.Diagnostics`, or ``None`` (no
        handle, or a handle that records host phases only): the fused
        engine then runs its ring-free loop.  The classic engine carries
        no ring; a handle records its fit phase only."""
        if self.diagnostics is None:
            return None
        return self.diagnostics.ring_config

    def _config(self) -> SolverConfig:
        return SolverConfig(algorithm=self.algorithm, step=self.step,
                            eps=self.eps, max_iter=self.max_iter,
                            plan_candidates=self.plan_candidates)

    def _resolve_gamma(self, X: torch.Tensor) -> float:
        """``gamma``, with ``"scale"`` worked out from a host copy of
        ``X`` (its bytes off the CPU counted as ``fit.host_copy_bytes``
        while a recorder is active)."""
        if self.gamma == "scale":
            rec = spans.active()
            if rec is not None:
                rec.count("fit.host_copy_bytes", 0 if X.device.type == "cpu"
                          else X.numel() * X.element_size())
            var = float(X.detach().cpu().numpy().var())
            return 1.0 / (X.shape[1] * var) if var > 0 else 1.0
        return float(self.gamma)

    def _resolve_engine(self) -> str:
        """The fit engine: ``engine`` when it names one (``"sharded"`` only
        for a config the fused engine runs: ``algorithm`` smo or pasmo,
        one planning candidate); for ``"auto"`` the classic ``"batched"``
        engine for any other config, else ``"sharded"`` when
        ``mesh``/``devices`` is given, else ``"fused"``.  Unlike the
        reference, ``"auto"`` does not shard because several cards are
        attached: a slab's iterations cost what the whole batch's do on
        the card (``PERF.md``), so sharding is asked for by name."""
        fusable = (self.algorithm in ("smo", "pasmo")
                   and self.plan_candidates == 1)
        if self.engine == "sharded":
            if not fusable:
                raise ValueError(
                    "engine='sharded' runs on the fused engine, which needs "
                    "algorithm in ('smo', 'pasmo') and plan_candidates == 1")
            return "sharded"
        if self.engine != "auto":
            return self.engine
        if not fusable:
            return "batched"
        if self.mesh is not None or self.devices is not None:
            return "sharded"
        return "fused"

    def _lane_mesh(self, device):
        """The lane mesh of a sharded fit on ``device`` (the facade's
        ``mesh``/``devices``, by default every CUDA device or the CPU
        alone), ``None`` on the other engines."""
        if self.engine_ != "sharded":
            return None
        return sharded_lanes.resolve_lane_mesh(self.mesh, self.devices,
                                               home=device)

    def _classic_kernel(self, X):
        """The classic engine's oracle over ``X``: with ``precompute`` the
        Gram matrix (the Gram kernel on the card), else RBF rows
        recomputed from ``X``."""
        if self.precompute:
            return qp_mod.PrecomputedKernel(ops.gram(
                X, gamma=self.gamma_, impl=self.impl, device=X.device,
                dtype=self.dtype))
        return qp_mod.make_rbf(X, self.gamma_)

    def _check_fitted(self):
        if not hasattr(self, self._fit_attr):
            raise RuntimeError(
                f"{type(self).__name__} instance is not fitted yet")

    def _query_gram(self, Xq):
        """Query cross-Gram against the training set -> (Kq, squeeze)."""
        Xq = torch.as_tensor(Xq, dtype=self.dtype, device=self.device_)
        squeeze = Xq.ndim == 1
        if squeeze:
            Xq = Xq[None, :]
        Kq = ops.gram(Xq, self.X_, gamma=self.gamma_, impl=self.impl,
                      device=self.device_, dtype=self.dtype)
        return Kq, squeeze
