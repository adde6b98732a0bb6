"""SVM readout heads on LM features — the paper's solver on the LM stack.

The port of ``repro.svm.probes``.  Pool the final hidden states of a
model (mean over the sequence), build the RBF Gram matrix with the Gram
kernel (:func:`repro_torch.kernels.ops.gram`: kernel 3 on the card), and
train the one-vs-rest binary SVMs as the lanes of one classic batched
PA-SMO loop (:func:`repro_torch.core.solver.solve`).  The lanes share
the one Gram matrix through a
:class:`~repro_torch.core.qp.StackedKernel` whose every lane reads entry
0: the same rows as the reference's k broadcast copies, without them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import qp
from repro_torch.core.multiclass import ovr_decision
from repro_torch.core.solver import SolverConfig, solve
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import registry


def extract_features(params, cfg, batch, pool: str = "mean") -> torch.Tensor:
    """Pooled final hidden states (B, d_model), float32, of a model of any
    family, on the device of ``params``."""
    mod = registry.get_module(cfg)
    if cfg.family == "moe":
        hidden, _ = mod.apply(params, cfg, batch["tokens"],
                              return_hidden=True)
    elif cfg.family == "encdec":
        hidden = mod.apply(params, cfg, batch["tokens"], batch["frames"],
                           return_hidden=True)
    elif cfg.family == "vlm":
        hidden = mod.apply(params, cfg, batch["tokens"], batch["patches"],
                           return_hidden=True)
    else:
        hidden = mod.apply(params, cfg, batch["tokens"], return_hidden=True)
    if pool == "mean":
        return torch.mean(hidden.float(), dim=1)
    return hidden[:, -1].float()  # last-token pool


@dataclasses.dataclass
class SVMProbe:
    X: torch.Tensor           # (n, d) training features
    alphas: torch.Tensor      # (n_classes, n) signed duals
    biases: torch.Tensor      # (n_classes,)
    gamma: float
    iterations: torch.Tensor  # (n_classes,) solver iterations per head
    objective: torch.Tensor   # (n_classes,) dual objective per head
    kkt_gap: torch.Tensor     # (n_classes,) final KKT gap per head
    converged: torch.Tensor   # (n_classes,) bool


def median_gamma(feats: torch.Tensor) -> float:
    """``1 / median`` of all n^2 clamped squared distances, diagonal
    included; an even count averages the two middle values (as
    ``jnp.median``; ``torch.median`` would take the lower one)."""
    sq = torch.sum(feats * feats, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2 * feats @ feats.T
    v = torch.sort(torch.clamp_min(d2, 0.0).flatten()).values
    m = v.numel()
    med = v[m // 2] if m % 2 else (v[m // 2 - 1] + v[m // 2]) / 2
    return float(1.0 / torch.clamp_min(med, 1e-6))


def train_probe(feats, labels, n_classes: int, C: float = 10.0,
                gamma: Optional[float] = None,
                cfg: SolverConfig = SolverConfig(algorithm="pasmo",
                                                 eps=1e-3),
                *, device=None) -> SVMProbe:
    """One-vs-rest multiclass SVM trained by batched PA-SMO, in float64.

    The n_classes binary QPs (one Gram matrix, different labels) solve as
    the lanes of one classic loop.  ``device`` defaults to the CUDA card
    and raises without one."""
    dev = resolve_device(device)
    feats = torch.as_tensor(feats, device=dev).to(torch.float64)
    if gamma is None:
        gamma = median_gamma(feats)
    K = kops.gram(feats, gamma=gamma, device=dev, dtype=torch.float64)
    labels = torch.as_tensor(labels, device=dev)
    classes = torch.arange(n_classes, device=dev)
    ys = torch.where(labels[None, :] == classes[:, None], 1.0, -1.0).to(
        torch.float64)
    shared = qp.StackedKernel(
        K[None], torch.zeros((n_classes,), dtype=torch.int32, device=dev))
    res = solve(shared, ys, C, cfg, device=dev, dtype=torch.float64)
    return SVMProbe(X=feats, alphas=res.alpha, biases=res.b, gamma=gamma,
                    iterations=res.iterations, objective=res.objective,
                    kkt_gap=res.kkt_gap, converged=res.converged)


def predict_probe(probe: SVMProbe, feats) -> torch.Tensor:
    """(m, d) -> (m,) class predictions."""
    Kq = kops.gram(feats, probe.X, probe.gamma, device=probe.X.device,
                   dtype=torch.float64)
    return torch.argmax(ovr_decision(Kq, probe.alphas, probe.biases),
                        dim=-1)
