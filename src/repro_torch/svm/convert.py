"""Carry fitted duals across from the JAX package.

An SVM has no weights beyond its fitted dual: the training inputs, the
signed dual coefficients, the biases, the RBF width and the label
vocabulary.  :func:`svc_from_numpy` takes those as numpy arrays (read off
a fitted ``repro.svm.SVC`` as ``X_``, ``alpha_``, ``b_``, ``gamma_``,
``classes_``) and builds a fitted port :class:`~repro_torch.svm.svc.SVC`
that predicts the same thing; :func:`svr_from_numpy` and
:func:`oneclass_from_numpy` do the same for ``SVR`` (``X_``, ``alpha_`` or
``beta_``, ``b_``, ``gamma_``) and ``OneClassSVM`` (``X_``, ``alpha_``,
``b_``, ``gamma_``).  :func:`grid_from_numpy` does it for a whole
(gamma, class, C) grid result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import qp as qp_mod
from repro_torch.core.solver import SolveResult
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.svm.oneclass import OneClassSVM
from repro_torch.svm.svc import SVC
from repro_torch.svm.svr import SVR


def svc_from_numpy(X, alpha, b, gamma, classes, *, device=None,
                   dtype=None) -> SVC:
    """A fitted port SVC from a fitted dual.

    ``X`` (l, d); ``alpha`` (l,) for a binary model or (k, l) one-vs-rest;
    ``b`` () or (k,); ``gamma`` a float; ``classes`` the sorted labels.
    ``device`` defaults to the CUDA card and raises without one.
    """
    clf = SVC(gamma=float(gamma), dtype=dtype, device=device)
    alpha = np.asarray(alpha)
    classes = np.asarray(classes)
    if alpha.ndim == 1 and len(classes) != 2:
        raise ValueError(f"a binary dual needs two classes, got "
                         f"{len(classes)}")
    if alpha.ndim == 2 and alpha.shape[0] != len(classes):
        raise ValueError(f"{alpha.shape[0]} one-vs-rest heads for "
                         f"{len(classes)} classes")
    dev = _fitted(clf, X, b, gamma, device)
    clf.alpha_ = torch.tensor(alpha, dtype=clf.dtype, device=dev)
    clf.classes_ = classes
    return clf


def _fitted(est, X, b, gamma, device):
    """Set the fitted attributes every facade shares; returns the device."""
    dev = resolve_device(device)
    est.device_ = dev
    est.X_ = torch.tensor(np.asarray(X), dtype=est.dtype, device=dev)
    est.b_ = torch.tensor(np.asarray(b), dtype=est.dtype, device=dev)
    est.gamma_ = float(gamma)
    return dev


def svr_from_numpy(X, alpha, b, gamma, *, device=None, dtype=None) -> SVR:
    """A fitted port SVR from a fitted ε-SVR dual.

    ``X`` (l, d); ``alpha`` the doubled (2l,) dual or the folded (l,)
    coefficients ``beta``; ``b`` a scalar; ``gamma`` a float.  ``device``
    defaults to the CUDA card and raises without one.
    """
    reg = SVR(gamma=float(gamma), dtype=dtype, device=device)
    dev = _fitted(reg, X, b, gamma, device)
    alpha = torch.tensor(np.asarray(alpha), dtype=reg.dtype, device=dev)
    l = reg.X_.shape[0]
    if alpha.shape == (2 * l,):
        reg.alpha_ = alpha
        alpha = qp_mod.svr_fold(alpha)
    elif alpha.shape != (l,):
        raise ValueError(f"alpha must be (2l,) or (l,) for l = {l}, got "
                         f"{tuple(alpha.shape)}")
    reg.beta_ = alpha
    return reg


def oneclass_from_numpy(X, alpha, b, gamma, *, device=None,
                        dtype=None) -> OneClassSVM:
    """A fitted port OneClassSVM from a fitted one-class dual.

    ``X`` (l, d); ``alpha`` (l,); ``b`` a scalar (``rho = -b``); ``gamma``
    a float.  ``device`` defaults to the CUDA card and raises without one.
    """
    oc = OneClassSVM(gamma=float(gamma), dtype=dtype, device=device)
    dev = _fitted(oc, X, b, gamma, device)
    oc.alpha_ = torch.tensor(np.asarray(alpha), dtype=oc.dtype, device=dev)
    if oc.alpha_.shape != (oc.X_.shape[0],):
        raise ValueError(f"alpha must be (l,) for l = {oc.X_.shape[0]}, "
                         f"got {tuple(oc.alpha_.shape)}")
    oc.rho_ = float(-oc.b_)
    return oc


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
