"""Lint fixture: TA002 — a host read in a loop body (planted).

Linted as if it lived at ``src/repro_torch/core/__planted__.py``; never
imported by the test suite.
"""


def body(s, refresh):
    gap = s.gap
    if gap.max() <= 0.0:
        return s
    return s
