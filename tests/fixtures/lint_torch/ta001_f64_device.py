"""Lint fixture: TA001 — float64 in device code (planted).

Linted as if it lived at ``src/repro_torch/core/__planted__.py``; never
imported by the test suite.
"""
import torch


def widen(G, dtype=torch.float64):
    # the signature default above is API and allowed; the cast is not
    return G.to(torch.float64)
