"""The port's classic (C, gamma) grid drivers, ``solve_grid(impl=None)``
and ``solve_grid_compacted(impl=None)``, against the reference's, on the
CPU in f64.

Objectives rtol 1e-6, every lane converged with its gap <= eps, results in
the input order of ``Cs``.  On a problem without rounding ties on the
reference's side (its arithmetic is contracted into fused multiply-adds,
so elsewhere its path can leave the port's at a tie; see
``test_torch_classic.py``) every per-lane counter equals the reference's.
Within the port: each iteration is one planning, free or clipped step;
chunking changes no bit of an SMO grid (no planning history to reset) nor
of a PA-SMO grid whose chunk holds every iteration, and the scaled warm
start chains the C axis exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as jgrid
from repro.core.solver import SolverConfig as JConfig
from repro.svm.data import multiclass_blobs
from repro_torch import kernels
from repro_torch.core import grid
from repro_torch.core import qp as tqp
from repro_torch.core.solver import SolveResult, SolverConfig

EPS = 1e-3
CS = [2.0, 0.5, 8.0]                  # unsorted: results keep this order
GAMMAS = [0.2, 0.6]
COUNTERS = ("iterations", "n_planning", "n_free", "n_clipped", "n_reverted")
F64 = dict(device="cpu", dtype=torch.float64)


def _problem(sep, seed=0, n=60, k=3):
    X, y = multiclass_blobs(n, seed=seed, k=k, d=3, sep=sep)
    return X, np.where(y[None, :] == np.arange(k)[:, None], 1.0, -1.0)


def _check(rt, rj, counters):
    assert rt.alpha.shape == tuple(np.shape(rj.alpha))
    assert bool(rt.converged.all()) and float(rt.kkt_gap.max()) <= EPS
    np.testing.assert_allclose(rt.objective.numpy(), np.asarray(rj.objective),
                               rtol=1e-6)
    steps = rt.n_planning + rt.n_free + rt.n_clipped
    assert torch.equal(steps, rt.iterations)
    if counters:
        for f in COUNTERS + ("n_free_sv",):
            assert np.array_equal(getattr(rt, f).numpy(),
                                  np.asarray(getattr(rj, f))), f


def _feasible(X, Y, r):
    """Each grid point's alpha in its box with sum(alpha) = 0, and its G
    the exact gradient."""
    for g, gam in enumerate(GAMMAS):
        K = tqp.materialize(tqp.make_rbf(torch.as_tensor(X), gam))
        for c in range(Y.shape[0]):
            y = torch.as_tensor(Y[c])
            for ci, C in enumerate(CS):
                a = r.alpha[g, c, ci]
                assert bool(tqp.is_feasible(a, tqp.make_bounds(y, C)))
                np.testing.assert_allclose(r.G[g, c, ci].numpy(),
                                           (y - K @ a).numpy(), atol=1e-9)


@pytest.mark.parametrize("warm_start", [True, False])
@pytest.mark.parametrize("alg", ["pasmo", "smo"])
def test_classic_grid_matches_reference(alg, warm_start):
    X, Y = _problem(sep=6.0)
    cfg = dict(algorithm=alg, eps=EPS)
    rj = jgrid.solve_grid(jnp.asarray(X), jnp.asarray(Y), CS, GAMMAS,
                          JConfig(**cfg), warm_start=warm_start)
    rt = grid.solve_grid(X, Y, CS, GAMMAS, SolverConfig(**cfg),
                         warm_start=warm_start, **F64)
    _check(rt, rj, counters=alg == "pasmo")
    _feasible(X, Y, rt)


@pytest.mark.parametrize("alg", ["pasmo", "conjugate", "pasmo_simple"])
def test_classic_grid_objectives_match_reference(alg):
    X, Y = _problem(sep=3.0, seed=1)
    cfg = (dict(algorithm="smo", step="conjugate") if alg == "conjugate"
           else dict(algorithm=alg))
    rj = jgrid.solve_grid(jnp.asarray(X), jnp.asarray(Y), CS, GAMMAS,
                          JConfig(eps=EPS, **cfg))
    rt = grid.solve_grid(X, Y, CS, GAMMAS, SolverConfig(eps=EPS, **cfg),
                         **F64)
    _check(rt, rj, counters=False)


def test_classic_grid_shrinking_matches_reference():
    X, Y = _problem(sep=3.0)
    cfg = dict(eps=EPS, shrink_every=8)
    rj = jgrid.solve_grid(jnp.asarray(X), jnp.asarray(Y), CS, GAMMAS,
                          JConfig(**cfg), shrinking=True)
    rt = grid.solve_grid(X, Y, CS, GAMMAS, SolverConfig(**cfg),
                         shrinking=True, **F64)
    _check(rt, rj, counters=False)
    _feasible(X, Y, rt)
    off = grid.solve_grid(X, Y, CS, GAMMAS, SolverConfig(eps=EPS), **F64)
    np.testing.assert_allclose(rt.objective.numpy(), off.objective.numpy(),
                               rtol=1e-6)


def test_warm_start_chains_the_c_axis():
    """Each C of the warm grid is one solve from the scaled optimum of the
    C before it (ascending), bit for bit."""
    from repro_torch.core.solver import solve
    X, Y = _problem(sep=3.0)
    cfg = SolverConfig(eps=EPS)
    r = grid.solve_grid(X, Y[:1], CS, GAMMAS[:1], cfg, **F64)
    K = tqp.PrecomputedKernel(grid.sqdist(torch.as_tensor(X)).mul(
        -GAMMAS[0]).exp())
    y = torch.as_tensor(Y[0])
    alpha, G, C_prev = torch.zeros_like(y), y, torch.tensor(0.5,
                                                            dtype=y.dtype)
    for ci in np.argsort(CS):
        C = torch.tensor(CS[ci], dtype=y.dtype)
        rr = C / C_prev
        s = solve(K, y, CS[ci], cfg, alpha * rr, (1.0 - rr) * y + rr * G,
                  **F64)
        assert torch.equal(s.alpha, r.alpha[0, 0, ci])
        assert int(s.iterations) == int(r.iterations[0, 0, ci])
        alpha, G, C_prev = s.alpha, s.G, C


@pytest.mark.parametrize("shrinking", [False, True])
def test_classic_compacted_matches_reference(shrinking):
    X, Y = _problem(sep=3.0)
    cfg = dict(eps=EPS, shrink_every=8)
    rj = jgrid.solve_grid_compacted(jnp.asarray(X), jnp.asarray(Y), CS,
                                    GAMMAS, JConfig(**cfg), chunk=16,
                                    shrinking=shrinking)
    rt = grid.solve_grid_compacted(X, Y, CS, GAMMAS, SolverConfig(**cfg),
                                   chunk=16, shrinking=shrinking, **F64)
    _check(rt, rj, counters=False)
    _feasible(X, Y, rt)
    for f in ("trace", "steps_i"):
        assert getattr(rt, f).shape == (2, 3, 3, 1)


@pytest.mark.parametrize("alg,chunk", [("smo", 16), ("pasmo", 4096)])
def test_chunking_changes_no_bit_without_a_history_reset(alg, chunk):
    X, Y = _problem(sep=3.0)
    cfg = SolverConfig(algorithm=alg, eps=EPS)
    whole = grid.solve_grid(X, Y, CS, GAMMAS, cfg, **F64)
    chunked = grid.solve_grid_compacted(X, Y, CS, GAMMAS, cfg, chunk=chunk,
                                        **F64)
    for f in dataclasses.fields(SolveResult):
        if f.name.startswith(("trace", "n_trace", "steps")):
            continue
        assert torch.equal(getattr(chunked, f.name), getattr(whole, f.name)), \
            f.name


def test_chunks_reset_the_planning_history():
    """A PA-SMO chunk starts with no history: it cannot plan on its first
    iteration, so chunks of 1 never plan."""
    X, Y = _problem(sep=3.0)
    r = grid.solve_grid_compacted(X, Y, CS, GAMMAS[:1],
                                  SolverConfig(eps=EPS), chunk=1, **F64)
    assert int(r.n_planning.sum()) == 0
    assert bool(r.converged.all())
    whole = grid.solve_grid(X, Y, CS, GAMMAS[:1], SolverConfig(eps=EPS),
                            **F64)
    assert int(whole.n_planning.sum()) > 0
    np.testing.assert_allclose(r.objective.numpy(), whole.objective.numpy(),
                               rtol=1e-6)


def test_classic_grids_launch_no_kernel_on_the_cpu():
    before = kernels.launches()
    X, Y = _problem(sep=3.0, n=32)
    grid.solve_grid(X, Y, [1.0, 4.0], [0.5], **F64)
    grid.solve_grid_compacted(X, Y, [1.0, 4.0], [0.5], chunk=8,
                              shrinking=True, **F64)
    assert kernels.launches() == before
