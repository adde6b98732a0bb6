"""Lint fixture: TA003 — a widened result record (planted).

A ``FusedResult`` that grew a field outside the flight recorder.  Linted
as if it lived at ``src/repro_torch/core/__planted__.py``; never imported.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class FusedResult:
    alpha: object
    b: object
    G: object
    iterations: object
    objective: object
    kkt_gap: object
    converged: object
    n_planning: object
    n_unshrink: object
    shiny_new_counter: object
