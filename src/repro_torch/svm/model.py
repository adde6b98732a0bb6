"""SVM model object (``repro.svm.model``): train a binary RBF-SVM with any
algorithm of the classic engine, predict, inspect its support vectors."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import qp as qp_mod
from repro_torch.core.solver import SolveResult, SolverConfig, solve
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class SVMModel:
    """Trained (signed-dual) SVM.  ``alpha`` carries the label sign, so
    the decision function is ``h(x) = sum_i alpha_i k(x_i, x) + b``."""

    X: torch.Tensor      # (l, d) training inputs
    alpha: torch.Tensor  # (l,) signed dual variables
    b: torch.Tensor      # () bias
    gamma: float         # RBF width

    def n_sv(self, atol: float = 1e-9) -> torch.Tensor:
        return torch.sum(self.alpha.abs() > atol)

    def n_bounded_sv(self, C, atol: float = 1e-9) -> torch.Tensor:
        return torch.sum((self.alpha.abs() - C).abs() <= atol)


def decision_function(model: SVMModel, Xq) -> torch.Tensor:
    """h(x) for a batch of query points (m, d) -> (m,): the query Gram on
    the model's device (the Gram kernel on the card)."""
    Kq = ops.gram(Xq, model.X, model.gamma, device=model.X.device,
                  dtype=model.X.dtype)
    return Kq @ model.alpha + model.b


def predict(model: SVMModel, Xq) -> torch.Tensor:
    """±1 labels; an exactly zero margin maps to +1 (the ``df >= 0``
    convention of ``SVC.predict``)."""
    h = decision_function(model, Xq)
    return torch.where(h >= 0, 1.0, -1.0).to(h.dtype)


def train_svm(X, y, C, gamma, cfg: SolverConfig = SolverConfig(),
              dtype=torch.float64, *,
              device=None) -> tuple[SVMModel, SolveResult]:
    """Train a binary RBF-SVM with the configured algorithm on the classic
    engine, rows recomputed from ``X``.  ``device`` defaults to the CUDA
    card and raises without one (``device="cpu"`` runs on the CPU)."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=dtype, device=dev).contiguous()
    y = torch.as_tensor(y, dtype=dtype, device=dev)
    res = solve(qp_mod.make_rbf(X, gamma), y, C, cfg, device=dev,
                dtype=dtype)
    return SVMModel(X=X, alpha=res.alpha, b=res.b, gamma=float(gamma)), res
