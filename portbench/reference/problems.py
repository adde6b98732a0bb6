"""Each lane's dual QP, worked out from the labels or targets and the
hyper-parameters alone.

Every QP is the general dual of the RBF SVM: maximise
``p.a - a.Q.a / 2`` subject to ``L <= a <= U`` and ``sum(a) = 0``, whose
gradient is ``G = p - Q a``.

* One-vs-rest classification (a hyper-parameter set with ``Cs`` and no
  ``epsilons``): a lane a (gamma, class, C), row-major.  Class c's signed
  labels ``y_c`` are +1 on its points and -1 elsewhere (classes in sorted
  order); ``p = y_c``, ``L = min(0, C y_c)``, ``U = max(0, C y_c)``,
  ``Q = K``; the decision is ``k(x, X) @ a + b``.
* epsilon-SVR (a set with ``epsilons``): a lane a (gamma, epsilon, C),
  row-major, over 2l doubled coordinates: ``p = (y - eps, y + eps)``,
  ``L = (0, -C)``, ``U = (C, 0)``, ``Q = [[K, K], [K, K]]``; the
  coefficients are ``beta = a[:l] + a[l:]`` and the decision is
  ``k(x, X) @ beta + b``.

The gammas are the set's ``gamma_factors`` times scikit-learn's
``gamma="scale"`` of the training inputs.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from portbench.reference import rbf


def lanes(hyper: dict, X: torch.Tensor, y: torch.Tensor) -> SimpleNamespace:
    """The lanes' ``gammas`` (B floats), ``P``, ``L``, ``U`` (B, n) in
    float64, and ``doubled`` (the epsilon-SVR layout)."""
    g0 = rbf.scale_gamma(X)
    gammas = [g0 * float(f) for f in hyper["gamma_factors"]]
    Cs = [float(c) for c in hyper["Cs"]]
    dev = X.device
    f64 = torch.float64
    P, L, U, lane_gamma = [], [], [], []
    if "epsilons" in hyper:
        y = y.to(f64)
        zero = torch.zeros_like(y)
        for g in gammas:
            for e in hyper["epsilons"]:
                for C in Cs:
                    P.append(torch.cat([y - float(e), y + float(e)]))
                    L.append(torch.cat([zero, zero - C]))
                    U.append(torch.cat([zero + C, zero]))
                    lane_gamma.append(g)
        doubled = True
    else:
        classes = torch.unique(y)
        for g in gammas:
            for c in classes:
                yc = torch.where(y == c, 1.0, -1.0).to(f64)
                for C in Cs:
                    P.append(yc)
                    L.append((C * yc).clamp_max(0.0))
                    U.append((C * yc).clamp_min(0.0))
                    lane_gamma.append(g)
        doubled = False
    return SimpleNamespace(gammas=lane_gamma, P=torch.stack(P).to(dev),
                           L=torch.stack(L).to(dev),
                           U=torch.stack(U).to(dev), doubled=doubled)
