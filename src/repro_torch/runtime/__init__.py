"""Runtime helpers of the port (``repro.runtime``): the step-time
straggler monitor, failure injection and the resilient training loop."""

from repro_torch.runtime.fault import (FailureInjector, StepMonitor,
                                       run_resilient)

__all__ = ["FailureInjector", "StepMonitor", "run_resilient"]
