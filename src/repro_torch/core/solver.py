"""Solver configuration and result type (the classic engine itself is a
later slice)."""

from __future__ import annotations

import dataclasses

import torch

# Soft-shrinking cadence when a config has none of its own.
DEFAULT_SHRINK_EVERY = 64


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration, field for field as
    ``repro.core.solver.SolverConfig``."""

    algorithm: str = "pasmo"       # smo | pasmo | pasmo_simple | overshoot
    wss: str = "wss2"              # wss2 | mvp
    eps: float = 1e-3              # KKT stopping accuracy (paper default)
    eta: float = 0.9               # Alg. 3 ratio window (paper fixes 0.9)
    overshoot: float = 1.1         # §7.3 factor (only algorithm="overshoot")
    max_iter: int = 1_000_000
    plan_candidates: int = 1       # N of §7.4; 1 = plain PA-SMO
    record_trace: bool = False     # record mu/mu* of planning steps (Fig. 3)
    trace_cap: int = 16384
    shrink_every: int = 0          # 0 = off; else re-evaluate mask every k its
    record_steps: bool = False     # record (i, j, mu) per iteration (debug /
    step_cap: int = 4096           # trajectory-parity tests)
    step: str = "plain"            # plain | conjugate (Conjugate-SMO 2-dir)

    def __post_init__(self):
        assert self.algorithm in ("smo", "pasmo", "pasmo_simple", "overshoot")
        assert self.wss in ("wss2", "mvp")
        assert self.plan_candidates >= 1
        assert self.step in ("plain", "conjugate")
        # The conjugate step replaces the planning-ahead machinery (both
        # re-use the previous working set as the second direction), so it
        # only composes with the plain SMO base algorithm.
        assert self.step == "plain" or self.algorithm == "smo", \
            "step='conjugate' requires algorithm='smo'"


def resolve_shrink_cfg(cfg: SolverConfig, shrinking) -> SolverConfig:
    """Fold a ``shrinking=True|False|None`` knob into ``cfg.shrink_every``.

    ``None`` defers to the config; ``True`` enables it with
    :data:`DEFAULT_SHRINK_EVERY` when the config has no cadence of its own;
    ``False`` forces it off.
    """
    if shrinking is None:
        return cfg
    every = (cfg.shrink_every or DEFAULT_SHRINK_EVERY) if shrinking else 0
    if every == cfg.shrink_every:
        return cfg
    return dataclasses.replace(cfg, shrink_every=every)


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Solver output, field for field as ``repro.core.solver.SolveResult``.

    ``n_free``/``n_clipped``/``n_reverted`` are per-step counters; the
    fused engine does not track the step type and fills them with
    ``repro_torch.core.grid.UNTRACKED`` (-1), never with zeros.
    ``n_free_sv`` is the number of strictly interior (free) support
    vectors at the returned ``alpha``.  ``trace``/``n_trace`` and the
    ``steps_*`` recorders are placeholders on the fused engine.
    """

    alpha: torch.Tensor
    b: torch.Tensor
    G: torch.Tensor
    iterations: torch.Tensor
    objective: torch.Tensor
    kkt_gap: torch.Tensor
    converged: torch.Tensor
    n_planning: torch.Tensor
    n_free: torch.Tensor
    n_clipped: torch.Tensor
    n_reverted: torch.Tensor
    n_free_sv: torch.Tensor
    trace: torch.Tensor
    n_trace: torch.Tensor
    steps_i: torch.Tensor
    steps_j: torch.Tensor
    steps_mu: torch.Tensor
