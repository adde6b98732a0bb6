"""Static analysis of the port: the invariants its loops depend on, checked.

The port's loops replay CUDA graphs on the card, and a graph freezes
whatever its body read when it was captured.  So the invariants are:

* a loop body never reads the host (no ``.item()``, no ``bool()`` of a
  tensor, no Python branch on the state): a read would be frozen at
  capture, or would break the capture;
* with float32 inputs no op outputs float64, outside the host drivers that
  carry float64 state by design; working-set indices reach the kernels as
  int32;
* the kernels an iteration launches do not grow with the lanes, the rows
  or the values of (C, gamma);
* a loop captures each chunk shape once: a fit one graph per refresh
  pattern, a chunked driver one per cache entry and refresh pattern, and
  the kernels build once per source hash;
* the result records keep the reference's fields.

``python -m repro_torch.analysis`` checks them in three passes, each a
module here and each returning a list of :class:`Finding`:

* :mod:`repro_torch.analysis.dispatch_audit` — records the aten ops of
  the loop bodies under a ``TorchDispatchMode`` on the CPU path (dtypes,
  host reads, op multisets across shapes and values, census);
* :mod:`repro_torch.analysis.capture_guard` — exact CUDA-graph capture
  counts per call site (on the CPU through a stand-in graph), and one
  kernel build per source hash on the card;
* :mod:`repro_torch.analysis.lint_rules` — AST rules TA001-TA003 over
  ``src/repro_torch``.

The CLI exits non-zero when any pass finds something.  The package imports
``torch``, ``numpy`` and the port, never JAX or the reference.
"""

from repro_torch.analysis.report import Finding

__all__ = ["Finding"]
