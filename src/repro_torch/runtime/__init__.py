"""Runtime helpers of the port (``repro.runtime``): the step-time
straggler monitor."""
