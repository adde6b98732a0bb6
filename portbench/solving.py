"""What the solve drivers share: the solver's settings from a
configuration, scikit-learn's ``gamma="scale"`` as a user computes it
before a grid, and a result's lanes flattened onto the host."""

from __future__ import annotations

import torch

from repro_torch.core.solver import SolverConfig


def solver_config(conf: dict, max_iter=None) -> SolverConfig:
    """The configuration's solver settings; ``max_iter`` caps a warm-up or
    traced solve."""
    kw = dict(algorithm=conf["solver"]["algorithm"],
              eps=conf["solver"]["eps"])
    if max_iter is not None:
        kw["max_iter"] = max_iter
    return SolverConfig(**kw)


def scale_gamma(X: torch.Tensor) -> float:
    """scikit-learn's ``gamma="scale"``, 1 / (d Var(X))."""
    return 1.0 / (X.shape[1] * float(X.var(unbiased=False)))


def host_lanes(res, decision: torch.Tensor, n: int) -> dict:
    """A solver result's fields and the decision values, lanes flattened
    (lane order as the result's axes, row-major), on the host."""
    def flat(t, *tail):
        return t.reshape((-1,) + tail).cpu()

    return dict(alpha=flat(res.alpha, n), G=flat(res.G, n), b=flat(res.b),
                objective=flat(res.objective),
                converged=flat(res.converged),
                iterations=flat(res.iterations),
                decision=flat(decision, decision.shape[-1]))
