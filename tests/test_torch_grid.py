"""The port's fused (C, gamma) grids against ``repro.core.grid``: the SVC
grid through both row sources, the one-class grid, ``grid_decision`` on
identical duals, and ``SVC(precompute=True)`` through the Gram bank.

Across packages (f64): objectives to rtol 1e-6, equal ``converged``, KKT
gap <= eps, the ``UNTRACKED`` sentinels and the free-SV counts; decision
values on identical duals to rtol 1e-12.  Iteration counts are not
compared across packages (the reference's own backends differ there)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as jgrid
from repro.core import multiclass as jmc
from repro.core.solver import SolverConfig as JConfig
from repro.svm import SVC as JSVC
from repro_torch.core import grid, qp as tqp
from repro_torch.core import multiclass as mc
from repro_torch.core.solver import SolveResult, SolverConfig
from repro_torch.kernels import ref, row_source
from repro_torch.svm import SVC, data, grid_from_numpy

EPS = 1e-4
CFG, JCFG = SolverConfig(eps=EPS), JConfig(eps=EPS, max_iter=200_000)
CS = np.array([16.0, 1.0])            # unsorted: results keep this order
GAMMAS = np.array([0.4, 1.2])


def _problem(n, k=3, seed=0):
    X, y = data.multiclass_blobs(n, seed=seed, k=k)
    Y = mc.ovr_labels(mc.class_index(y)[1], k, torch.float64).numpy()
    return X, Y


def _grid(X, Y, Cs, gammas, precompute, impl="torch"):
    return grid.solve_grid(X, Y, Cs, gammas, CFG, impl=impl,
                           precompute=precompute, device="cpu",
                           dtype=torch.float64)


def _check_against(r_t, r_j):
    assert r_t.alpha.shape == tuple(np.shape(r_j.alpha))
    np.testing.assert_array_equal(r_t.converged.numpy(),
                                  np.asarray(r_j.converged))
    assert bool(r_t.converged.all())
    np.testing.assert_allclose(r_t.objective.numpy(),
                               np.asarray(r_j.objective), rtol=1e-6)
    assert float(r_t.kkt_gap.max()) <= EPS
    for c in (r_t.n_free, r_t.n_clipped, r_t.n_reverted):
        assert c.dtype == torch.int32
        np.testing.assert_array_equal(c.numpy(), grid.UNTRACKED)
    np.testing.assert_array_equal(r_t.n_free_sv.numpy(),
                                  np.asarray(r_j.n_free_sv))


@pytest.mark.parametrize("precompute", [True, False])
def test_solve_grid_matches_reference(precompute):
    X, Y = _problem(64)
    r_t = _grid(X, Y, CS, GAMMAS, precompute)
    r_j = jgrid.solve_grid(jnp.asarray(X), jnp.asarray(Y), CS, GAMMAS, JCFG,
                           impl="jnp")
    _check_against(r_t, r_j)
    # carried G == p - K alpha for every lane, against the plain Gram
    Xt = torch.as_tensor(X)
    for g, gamma in enumerate(GAMMAS):
        K = torch.exp(-gamma * grid.sqdist(Xt))
        np.testing.assert_allclose(
            r_t.G[g].numpy(),
            (torch.as_tensor(Y)[:, None, :] - r_t.alpha[g] @ K).numpy(),
            rtol=0, atol=1e-9)
    # the unsorted C axis comes back in input order
    r_sorted = _grid(X, Y, CS[::-1].copy(), GAMMAS, precompute)
    for f in ("alpha", "objective", "iterations", "converged"):
        assert torch.equal(getattr(r_t, f), getattr(r_sorted, f).flip(2)), f


def test_solve_grid_matches_the_reference_bank_kernels_in_interpret_mode():
    X, Y = _problem(48)
    Cs, gammas = np.array([1.0, 8.0]), np.array([0.6])
    r_j = jgrid.solve_grid(jnp.asarray(X), jnp.asarray(Y), Cs, gammas, JCFG,
                           impl="interpret", block_l=128, precompute=True)
    r_t = _grid(X, Y, Cs, gammas, True)
    _check_against(r_t, r_j)


@pytest.mark.parametrize("precompute", [True, False])
def test_solve_grid_oneclass_matches_reference(precompute):
    X, _ = data.gaussian_blobs(80, seed=3, d=3)
    nus, gammas = np.array([0.1, 0.3]), np.array([0.3, 0.9])
    r_t = grid.solve_grid_oneclass(X, nus, gammas, CFG, impl="torch",
                                   precompute=precompute, device="cpu",
                                   dtype=torch.float64)
    r_j = jgrid.solve_grid_oneclass(jnp.asarray(X), nus, gammas, JCFG,
                                    impl="jnp", precompute=precompute)
    assert r_t.alpha.shape == (2, 2, 80)
    assert bool(r_t.converged.all())
    np.testing.assert_array_equal(r_t.converged.numpy(),
                                  np.asarray(r_j.converged))
    np.testing.assert_allclose(r_t.objective.numpy(),
                               np.asarray(r_j.objective), rtol=1e-6)
    assert float(r_t.kkt_gap.max()) <= EPS
    for g in range(2):
        for n, nu in enumerate(nus):
            q = tqp.oneclass_qp(80, nu)
            a = r_t.alpha[g, n]
            assert bool(((a >= q.bounds.lower) & (a <= q.bounds.upper))
                        .all())
            assert abs(float(a.sum()) - 1.0) < 1e-12


def test_grid_decision_on_identical_duals():
    X, Y = _problem(64)
    r_j = jgrid.solve_grid(jnp.asarray(X), jnp.asarray(Y), CS, GAMMAS, JCFG,
                           impl="jnp")
    fields = {f.name: np.asarray(getattr(r_j, f.name))
              for f in dataclasses.fields(SolveResult)}
    r_t = grid_from_numpy(fields, device="cpu", dtype=torch.float64)
    assert r_t.iterations.dtype == torch.int32
    assert r_t.converged.dtype == torch.bool
    Xq = np.random.default_rng(9).normal(size=(25, 2))
    df_t = grid.grid_decision(Xq, X, GAMMAS, r_t.alpha, r_t.b)
    df_j = jgrid.grid_decision(jnp.asarray(Xq), jnp.asarray(X), GAMMAS,
                               r_j.alpha, r_j.b)
    assert df_t.shape == (2, 3, 2, 25)
    np.testing.assert_allclose(df_t.numpy(), np.asarray(df_j), rtol=1e-12,
                               atol=1e-12)
    with pytest.raises(ValueError, match="lacks"):
        grid_from_numpy({"alpha": fields["alpha"]}, device="cpu")


@pytest.mark.parametrize("precompute", [True, False])
def test_svc_row_source_follows_precompute(precompute, monkeypatch):
    """``SVC(device="cpu")`` banks with ``precompute=True`` as the
    reference does on ``jnp``, and recomputes rows without it; both reach
    the reference's optimum."""
    X, y = data.multiclass_blobs(90, seed=5, k=3, d=2, sep=4.0)
    sources = []
    for name in ("bank_source", "rbf_source"):
        inner = getattr(row_source, name)

        def spy(*a, _inner=inner, _name=name, **kw):
            sources.append(_name)
            return _inner(*a, **kw)
        monkeypatch.setattr(row_source, name, spy)
    t = SVC(C=2.0, gamma=0.5, eps=1e-6, precompute=precompute, device="cpu",
            dtype=torch.float64).fit(X, y)
    assert sources[-1] == ("bank_source" if precompute else "rbf_source")
    j = JSVC(C=2.0, gamma=0.5, eps=1e-6, impl="jnp",
             dtype=jnp.float64).fit(X, y)
    np.testing.assert_allclose(t.fit_result_.objective.numpy(),
                               np.asarray(j.fit_result_.objective),
                               rtol=1e-6)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    Y = jmc.ovr_labels(jmc.class_index(y)[1], 3)
    K = ref.gram_cross(torch.as_tensor(X), torch.as_tensor(X), 0.5)
    np.testing.assert_allclose(t.fit_result_.G.numpy(),
                               np.asarray(Y) - (t.alpha_ @ K).numpy(),
                               rtol=0, atol=1e-9)
