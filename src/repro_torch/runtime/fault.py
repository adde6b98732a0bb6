"""Straggler detection over step times (``repro.runtime.fault``'s
:class:`StepMonitor`).

The chunked fused driver (:func:`repro_torch.core.solver_fused.
solve_fused_chunked_qp`) feeds it each chunk's wall time and emits a
``straggler_warning`` event when a chunk breaches the deadline.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class StepMonitor:
    """EWMA step-time tracker with a straggler deadline."""

    alpha: float = 0.1
    deadline_factor: float = 3.0
    warmup_steps: int = 3
    ewma: Optional[float] = None
    count: int = 0
    slow_steps: int = 0

    def record(self, dt: float) -> bool:
        """Record one step's duration; True when the step breached the
        straggler deadline (the caller decides what to do)."""
        self.count += 1
        if self.count <= self.warmup_steps:
            # build and warm-up steps stay out of the EWMA
            return False
        if self.ewma is None:
            self.ewma = dt
            return False
        breached = dt > self.deadline_factor * self.ewma
        if breached:
            self.slow_steps += 1
        # clamp outliers so one straggler does not poison the baseline
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * min(
            dt, 2 * self.ewma)
        return breached

    @property
    def deadline(self) -> Optional[float]:
        return None if self.ewma is None \
            else self.deadline_factor * self.ewma
