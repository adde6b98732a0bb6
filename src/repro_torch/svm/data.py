"""Synthetic dataset generators for the paper-validation experiments.

The paper's hardest benchmark is the artificial *chess-board* problem
(Glasmachers & Igel 2005): uniform inputs on [0, s)^2, labels by the parity
of the integer cell — "quadratic programs which are very difficult to solve
for SMO-type decomposition algorithms" (§7).  Because the distribution is
known we can sample any size, exactly as the paper does (1k/10k/100k).

All generators are deterministic in (seed, n) and return float64 numpy
arrays (the reference solver precision); callers cast as needed.  This is
the port's own numpy copy of ``repro.svm.data``: the same generators give
the same arrays for the same seeds, without importing the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np


def chessboard(n: int, seed: int = 0, size: int = 4,
               noise: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Chess-board problem on [0, size)^2 with parity labels."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, float(size), size=(n, 2))
    cells = np.floor(X).astype(int)
    y = np.where((cells[:, 0] + cells[:, 1]) % 2 == 0, 1.0, -1.0)
    if noise > 0:
        flip = rng.uniform(size=n) < noise
        y = np.where(flip, -y, y)
    return X, y


def gaussian_blobs(n: int, seed: int = 0, d: int = 8,
                   sep: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """Two spherical Gaussians, moderately separated (an 'easy' problem)."""
    rng = np.random.default_rng(seed)
    y = np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0)
    mean = np.zeros((n, d))
    mean[:, 0] = y * sep / 2.0
    X = mean + rng.normal(size=(n, d))
    return X, y


def ring(n: int, seed: int = 0, r_in: float = 1.0,
         r_out: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """Inner disc vs outer annulus — needs many free SVs (RBF-hard-ish)."""
    rng = np.random.default_rng(seed)
    y = np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0)
    r = np.where(y > 0, rng.uniform(0, r_in, n),
                 rng.uniform(r_in * 1.05, r_out, n))
    theta = rng.uniform(0, 2 * np.pi, n)
    X = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
    return X, y


def xor_gaussians(n: int, seed: int = 0,
                  sep: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """Four Gaussians in XOR layout — strong second-order cross terms, the
    oscillation regime planning-ahead targets (§3)."""
    rng = np.random.default_rng(seed)
    quad = rng.integers(0, 4, size=n)
    sx = np.where(quad % 2 == 0, 1.0, -1.0)
    sy = np.where(quad // 2 == 0, 1.0, -1.0)
    y = sx * sy
    X = np.stack([sx * sep / 2, sy * sep / 2], axis=1) \
        + 0.6 * rng.normal(size=(n, 2))
    return X, y


def multiclass_blobs(n: int, seed: int = 0, k: int = 3, d: int = 2,
                     sep: float = 3.0) -> Tuple[np.ndarray, np.ndarray]:
    """k spherical Gaussians on a circle — integer labels 0..k-1 (the
    one-vs-rest / ``SVC`` multiclass toy problem)."""
    if d < 2:
        raise ValueError("multiclass_blobs needs d >= 2 (circle layout)")
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, size=n)
    theta = 2.0 * np.pi * y / k
    centers = np.zeros((n, d))
    centers[:, 0] = sep / 2.0 * np.cos(theta)
    centers[:, 1] = sep / 2.0 * np.sin(theta)
    X = centers + rng.normal(size=(n, d))
    return X, y.astype(np.int64)


# dataset registry: name -> (generator, default C, default gamma)
# C/gamma chosen in a generalizing regime, mirroring Table 1's protocol
# (grid-searched once, then fixed).
DATASETS: Dict[str, Tuple[Callable, float, float]] = {
    "chessboard": (chessboard, 1e6, 0.5),       # the paper's hard problem
    "blobs": (gaussian_blobs, 1.0, 0.05),       # easy, mostly bounded SVs
    "ring": (ring, 10.0, 1.0),                  # many free SVs
    "xor": (xor_gaussians, 100.0, 0.5),         # oscillation-prone
}


def make_dataset(name: str, n: int, seed: int = 0):
    """Returns (X, y, C, gamma) for a registered dataset."""
    gen, C, gamma = DATASETS[name]
    X, y = gen(n, seed=seed)
    return X, y, C, gamma


def permute(X: np.ndarray, y: np.ndarray, seed: int):
    """Random permutation — the paper averages over 100 permutations to
    wash out the first-iteration tie-break asymmetry (§7)."""
    perm = np.random.default_rng(seed).permutation(len(y))
    return X[perm], y[perm]
