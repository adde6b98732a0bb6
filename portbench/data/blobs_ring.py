"""Stand-in for a k-class image set: the port's ``multiclass_blobs`` law
(``repro_torch.svm.data``), copied and moved onto the device.

k spherical Gaussians in d dimensions whose centres lie on a circle of
radius ``sep / 2`` in the first two: label ``c`` is uniform over 0..k-1,
``x = centre(c) + N(0, I_d)``.  The base set (``n_train + n_test``
points) is drawn once from the configuration's ``data_seed``, as a
dataset is fixed; ``--seed`` shuffles the training points and the
held-out points, each among themselves.  So every seed solves the same
set in another order: the same work, with the ties of the first steps
broken elsewhere.
"""

from __future__ import annotations

import math

import torch


def make(config: dict, seed: int, device, dtype) -> dict:
    """{"X", "y", "Xq", "yq"}: (l, d) training inputs, (l,) int64 labels,
    (m, d) held-out inputs, (m,) labels, on ``device`` in ``dtype``."""
    p = config["generator_params"]
    l, m = config["n_train"], config["n_test"]
    d, k = config["n_features"], config["n_classes"]
    g = torch.Generator(device=device).manual_seed(p["data_seed"])
    y = torch.randint(0, k, (l + m,), generator=g, device=device)
    X = torch.randn((l + m, d), generator=g, device=device,
                    dtype=torch.float64)
    theta = 2.0 * math.pi * y.to(torch.float64) / k
    X[:, 0] += p["sep"] / 2.0 * torch.cos(theta)
    X[:, 1] += p["sep"] / 2.0 * torch.sin(theta)
    g.manual_seed(seed)
    tr = torch.randperm(l, generator=g, device=device)
    te = l + torch.randperm(m, generator=g, device=device)
    X = X.to(dtype)
    return dict(X=X[tr].contiguous(), y=y[tr], Xq=X[te].contiguous(),
                yq=y[te])
