"""Stand-in for a tabular regression set: standard-normal features and a
smooth non-linear target of a seeded projection of them, plus noise.

``z = X W / sqrt(d)`` with W (d, 2) standard normal;
``y = sin(2 z_0) + 0.5 tanh(3 z_1) + noise * N(0, 1)``, standardised to
mean 0 and standard deviation 1 over the whole set.  The base set is
drawn once from the configuration's ``data_seed``; ``--seed`` shuffles
the training points and the held-out points, each among themselves.
"""

from __future__ import annotations

import math

import torch


def make(config: dict, seed: int, device, dtype) -> dict:
    """{"X", "y", "Xq", "yq"}: (l, d) training inputs, (l,) targets,
    (m, d) held-out inputs, (m,) targets, on ``device`` in ``dtype``."""
    p = config["generator_params"]
    l, m, d = config["n_train"], config["n_test"], config["n_features"]
    f64 = torch.float64
    g = torch.Generator(device=device).manual_seed(p["data_seed"])
    X = torch.randn((l + m, d), generator=g, device=device, dtype=f64)
    W = torch.randn((d, 2), generator=g, device=device, dtype=f64)
    z = X @ W / math.sqrt(d)
    y = (torch.sin(2.0 * z[:, 0]) + 0.5 * torch.tanh(3.0 * z[:, 1])
         + p["noise"] * torch.randn((l + m,), generator=g, device=device,
                                    dtype=f64))
    y = (y - y.mean()) / y.std()
    g.manual_seed(seed)
    tr = torch.randperm(l, generator=g, device=device)
    te = l + torch.randperm(m, generator=g, device=device)
    X, y = X.to(dtype), y.to(dtype)
    return dict(X=X[tr].contiguous(), y=y[tr], Xq=X[te].contiguous(),
                yq=y[te])
