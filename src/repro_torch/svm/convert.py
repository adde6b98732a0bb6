"""Carry a fitted SVC across from the JAX package.

An SVM has no weights beyond its fitted dual: the training inputs, the
signed dual coefficients, the biases, the RBF width and the label
vocabulary.  :func:`svc_from_numpy` takes those as numpy arrays (read off
a fitted ``repro.svm.SVC`` as ``X_``, ``alpha_``, ``b_``, ``gamma_``,
``classes_``) and builds a fitted port :class:`~repro_torch.svm.svc.SVC`
that predicts the same thing.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
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
