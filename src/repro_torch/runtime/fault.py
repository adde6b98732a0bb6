"""Fault tolerance runtime: straggler detection, failure injection and
the resilient step loop (checkpoint, restore, replay).

The port of ``repro.runtime.fault``.  :class:`StepMonitor` tracks step
times: the chunked fused driver (:func:`repro_torch.core.solver_fused.
solve_fused_chunked_qp`) feeds it each chunk's wall time and emits a
``straggler_warning`` event when a chunk breaches the deadline, and the
training loops feed it each step's.  :func:`run_resilient` restarts from
the last committed checkpoint on a failure and replays the data by step
index; with failures injected by :class:`FailureInjector` it must end
bitwise where an uninterrupted run ends.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.device import synchronize
from repro_torch.tree import leaves


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


class FailureInjector:
    """Deterministic failure schedule for tests: raises at given steps,
    once each."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


def run_resilient(step_fn: Callable, init_state: Any, batch_at: Callable,
                  n_steps: int, ckpt_dir: str, save_every: int = 10,
                  injector: Optional[FailureInjector] = None,
                  max_restarts: int = 10,
                  monitor: Optional[StepMonitor] = None) -> Any:
    """Checkpointed training loop with restart on failure.

    ``step_fn(state, batch) -> (state, metrics)`` must not write the state
    it is given (``train_step.make_train_step``'s step does not): an
    attempt that fails before the first checkpoint restarts from
    ``init_state`` itself.  ``batch_at(step)`` is a pure function
    (replayable).  On a ``RuntimeError``: restore the last committed
    checkpoint onto ``init_state``'s device and replay from there.  With
    a ``monitor``, each step's time is taken after the device has
    finished it.  Returns the final state.

    The replay ends bitwise where an uninterrupted run ends when each
    step is deterministic: always on the CPU; on the card under
    ``torch.use_deterministic_algorithms(True)``, since SDPA's default
    backward there adds its query gradients in no fixed order."""
    device = leaves(init_state)[0].device
    restarts = 0
    while True:
        ckpt = AsyncCheckpointer(ckpt_dir)
        try:
            start = latest_step(ckpt_dir)
            if start is None:
                state, step0 = init_state, 0
            else:
                state = restore_checkpoint(ckpt_dir, start, init_state,
                                           device=device)
                step0 = start
            for step in range(step0, n_steps):
                if injector is not None:
                    injector.maybe_fail(step)
                t0 = time.monotonic()
                state, _ = step_fn(state, batch_at(step))
                if monitor is not None:
                    synchronize(device)
                    monitor.record(time.monotonic() - t0)
                nxt = step + 1
                if nxt % save_every == 0 or nxt == n_steps:
                    ckpt.save(nxt, state)
            ckpt.close()
            return state
        except RuntimeError:
            ckpt.close()
            restarts += 1
            if restarts > max_restarts:
                raise
