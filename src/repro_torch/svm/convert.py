"""Carry fitted duals across from the JAX package.

An SVM has no weights beyond its fitted dual: the training inputs, the
signed dual coefficients, the biases, the RBF width and the label
vocabulary.  :func:`svc_from_numpy` takes those as numpy arrays (read off
a fitted ``repro.svm.SVC`` as ``X_``, ``alpha_``, ``b_``, ``gamma_``,
``classes_``) and builds a fitted port :class:`~repro_torch.svm.svc.SVC`
that predicts the same thing.  :func:`grid_from_numpy` does the same for
a whole (gamma, class, C) grid result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.solver import SolveResult
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.svm.svc import SVC


def svc_from_numpy(X, alpha, b, gamma, classes, *, device=None,
                   dtype=None) -> SVC:
    """A fitted port SVC from a fitted dual.

    ``X`` (l, d); ``alpha`` (l,) for a binary model or (k, l) one-vs-rest;
    ``b`` () or (k,); ``gamma`` a float; ``classes`` the sorted labels.
    ``device`` defaults to the CUDA card and raises without one.
    """
    clf = SVC(gamma=float(gamma), dtype=dtype, device=device)
    dev = resolve_device(device)
    alpha = np.asarray(alpha)
    classes = np.asarray(classes)
    if alpha.ndim == 1 and len(classes) != 2:
        raise ValueError(f"a binary dual needs two classes, got "
                         f"{len(classes)}")
    if alpha.ndim == 2 and alpha.shape[0] != len(classes):
        raise ValueError(f"{alpha.shape[0]} one-vs-rest heads for "
                         f"{len(classes)} classes")
    clf.device_ = dev
    clf.X_ = torch.tensor(np.asarray(X), dtype=clf.dtype, device=dev)
    clf.alpha_ = torch.tensor(alpha, dtype=clf.dtype, device=dev)
    clf.b_ = torch.tensor(np.asarray(b), dtype=clf.dtype, device=dev)
    clf.gamma_ = float(gamma)
    clf.classes_ = classes
    return clf


def grid_from_numpy(fields, *, device=None, dtype=None) -> SolveResult:
    """The port's :class:`~repro_torch.core.solver.SolveResult` from a grid
    result given as numpy arrays.

    ``fields`` maps every ``SolveResult`` field name to an array, e.g.
    ``{f: np.asarray(getattr(res, f)) for f in ...}`` of a
    ``repro.core.grid.solve_grid`` result; ``alpha`` is
    (n_gamma, k, n_C, l) and ``b`` (n_gamma, k, n_C).  Floating fields take
    ``dtype`` (default ``torch.get_default_dtype()``), integer fields
    int32, boolean fields stay boolean.  ``device`` defaults to the CUDA
    card and raises without one.
    """
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    names = [f.name for f in dataclasses.fields(SolveResult)]
    missing = sorted(set(names) - set(fields))
    if missing:
        raise ValueError(f"grid result lacks the fields {missing}")
    alpha, b = np.asarray(fields["alpha"]), np.asarray(fields["b"])
    if alpha.ndim != 4 or b.shape != alpha.shape[:3]:
        raise ValueError(f"alpha must be (n_gamma, k, n_C, l) and b its "
                         f"first three axes, got {alpha.shape} and "
                         f"{b.shape}")

    def convert(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            dt = torch.bool
        elif np.issubdtype(a.dtype, np.integer):
            dt = torch.int32
        else:
            dt = dtype
        return torch.tensor(a, dtype=dt, device=dev)

    return SolveResult(**{name: convert(fields[name]) for name in names})
