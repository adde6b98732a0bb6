"""One-vs-rest multiclass layer over the classic and the fused engine.

A k-class SVM in the one-vs-rest (OVR) reduction is k binary QPs that
differ only in the sign pattern of ``y``; they share ``X`` (or one kernel
oracle) and run as the k lanes of one solve.

Conventions: ``y_idx`` integer class indices (l,) in [0, k); ``Y``
stacked signed label vectors (k, l) with rows in {-1, +1}.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import qp as qp_mod
from repro_torch.core.solver import (CHECK_EVERY, SolveResult, SolverConfig,
                                     placement, solve_qp)
from repro_torch.core.sharded_lanes import solve_fused_sharded
from repro_torch.core.solver_fused import solve_fused_batched
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def class_index(y) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted unique labels and each sample's position among them (host
    numpy: label vocabularies are data-dependent shapes)."""
    classes, y_idx = np.unique(np.asarray(y), return_inverse=True)
    return classes, y_idx.astype(np.int32)


def ovr_labels(y_idx, n_classes: int, dtype=torch.float64,
               device="cpu") -> torch.Tensor:
    """(k, l) signed labels: row ``c`` is +1 where ``y_idx == c``, else -1."""
    y_idx = torch.as_tensor(np.asarray(y_idx), device=device)
    onehot = y_idx[None, :] == torch.arange(n_classes, device=device)[:, None]
    return torch.where(onehot, 1.0, -1.0).to(dtype)


def ovr_bounds(Y: torch.Tensor, C) -> qp_mod.Bounds:
    """Per-class box bounds with (k, l) leaves; ``C`` is a scalar or a
    (k,) vector of per-class budgets."""
    C = torch.as_tensor(C, dtype=Y.dtype, device=Y.device).broadcast_to(
        (Y.shape[0],))
    return qp_mod.make_bounds(Y, C[:, None])


def solve_ovr(kernel, Y, C, cfg: SolverConfig = SolverConfig(),
              alpha0=None, G0=None, *, device=None, dtype=None,
              check_every: int = CHECK_EVERY) -> SolveResult:
    """Solve all one-vs-rest heads as the lanes of one classic loop.

    ``kernel`` is one oracle that every class shares (a precomputed Gram
    matrix is gathered, never recomputed, per class).  ``Y`` is (k, l);
    ``C`` a scalar, (k,) per-class or (k, l) per-sample budgets
    (class-weighted SVC); ``alpha0``/``G0`` optional (k, l) warm starts.
    ``device`` defaults to the CUDA card and raises without one;
    ``dtype`` defaults to ``Y``'s when it is a floating tensor.  Returns a
    :class:`~repro_torch.core.solver.SolveResult` with a leading class
    axis.
    """
    dev, dtype = placement(Y, device, dtype)
    Y = torch.as_tensor(Y, dtype=dtype, device=dev)
    C = torch.as_tensor(C, dtype=Y.dtype, device=dev)
    bounds = (qp_mod.make_bounds(Y, C) if C.ndim == 2
              else ovr_bounds(Y, C))
    return solve_qp(kernel, qp_mod.DualQP(p=Y, bounds=bounds), cfg, alpha0,
                    G0, device=dev, dtype=Y.dtype, check_every=check_every)


def solve_ovr_fused(X, Y, C, gamma, cfg: SolverConfig = SolverConfig(), *,
                    impl: str = "auto", block_l: int = 1024,
                    precompute: bool = False, mesh=None, devices=None,
                    device=None, dtype=None, telemetry=None):
    """Solve all one-vs-rest heads as the lanes of one fused solve.

    ``C`` is a scalar, (k,) per-class or (k, l) per-sample budgets;
    ``gamma`` the shared RBF width.  With ``precompute=True`` on the plain
    backend (``impl`` resolving to ``"torch"``) the one shared Gram matrix
    is built once and the lanes read their rows from it, as the reference
    does on ``"jnp"``; otherwise rows are recomputed from ``X``.
    ``device`` defaults to the CUDA card and raises without one.  Returns a
    :class:`~repro_torch.core.solver_fused.FusedResult` with a leading
    class axis.  ``telemetry`` (a
    :class:`~repro_torch.telemetry.ring.RingConfig`) turns on the fused
    loop's flight recorder: the return value is then the ``(FusedResult,
    TelemetryRing)`` pair, the ring's fields class-leading.  ``block_l``
    is accepted and ignored: the CUDA passes fix their tiles when they are
    built (:data:`repro_torch.kernels.build.BLOCK_L`).  ``mesh``/``devices``
    shard the class-head lanes over a lane mesh
    (:func:`repro_torch.core.sharded_lanes.solve_fused_sharded`, the bank
    of ``precompute`` passed along): the same results, one loop a slab.
    """
    del block_l
    dev = resolve_device(device)
    bank_kw = {}
    if precompute and ops.resolve_impl(impl, dev) == "torch":
        K = ops.gram(X, gamma=gamma, impl=impl, device=dev, dtype=dtype)
        bank_kw = dict(gram=K[None], gram_idx=torch.zeros(
            (len(Y),), dtype=torch.int64, device=dev))
    if mesh is not None or devices is not None:
        return solve_fused_sharded(X, Y, C, gamma, cfg, mesh=mesh,
                                   devices=devices, impl=impl, device=dev,
                                   dtype=dtype, telemetry=telemetry,
                                   **bank_kw)
    return solve_fused_batched(X, Y, C, gamma, cfg, impl=impl, device=dev,
                               dtype=dtype, telemetry=telemetry, **bank_kw)


def ovr_decision(Kq: torch.Tensor, alpha: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """(m, k) OVR scores for the query cross-kernel ``Kq`` (m, l)."""
    return Kq @ alpha.T + b[None, :]


def ovr_predict(Kq: torch.Tensor, alpha: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """argmax-of-scores OVR prediction -> (m,) int32 class indices."""
    return torch.argmax(ovr_decision(Kq, alpha, b), dim=-1).to(torch.int32)
