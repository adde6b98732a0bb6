"""The port's fused solver (``impl="torch"``, CPU) against the reference's
``solve_fused_batched(impl="jnp")``, and the host loop's own invariants.

Across packages: objective to rtol 1e-6, KKT gap <= eps, feasibility and
``G == p - K alpha`` to 1e-7 (f64).  Iteration counts are not compared
across packages: the reference's own backends differ there.  Within the
port: a frozen lane's state is bitwise held over later iterations of the
same run, the host-check cadence does not change any bit of the result,
and ``max_iter`` is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solver import SolverConfig as JConfig
from repro.core.solver_fused import solve_fused_batched as j_solve
from repro_torch.core import qp as tqp
from repro_torch.core import solver_fused
from repro_torch.core.solver import SolverConfig
from repro_torch.kernels import ref
from repro_torch.svm.data import gaussian_blobs, ring, xor_gaussians

EPS = 1e-3
GENS = {"xor": (xor_gaussians, 100.0, 0.5), "blobs": (gaussian_blobs, 1.0,
                                                       0.05),
        "ring": (ring, 10.0, 1.0)}


def _problem(name, B, n=64, seed=1):
    """B lanes over one X: lane b relabels with a seeded flip of 10% of
    the labels and scales C and gamma, so lanes differ in all three."""
    gen, C, gamma = GENS[name]
    X, y = gen(n, seed=seed)
    rng = np.random.default_rng(seed)
    Y = np.stack([np.where(rng.uniform(size=n) < (0.1 if b else 0.0), -y, y)
                  for b in range(B)])
    Cs = C * np.array([1.0, 0.1, 3.0])[:B]
    gs = gamma * np.array([1.0, 2.0, 0.5])[:B]
    return X, Y, Cs, gs


CASES = [("xor", 1, "smo"), ("xor", 1, "pasmo"), ("xor", 3, "pasmo"),
         ("blobs", 3, "smo"), ("blobs", 1, "pasmo"), ("ring", 3, "pasmo"),
         ("ring", 1, "smo")]


@pytest.mark.parametrize("name,B,alg", CASES)
def test_fused_matches_reference(name, B, alg):
    X, Y, Cs, gs = _problem(name, B)
    r_j = j_solve(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Cs),
                  jnp.asarray(gs), JConfig(algorithm=alg, eps=EPS),
                  impl="jnp")
    r_t = solver_fused.solve_fused_batched(
        X, Y, Cs, gs, SolverConfig(algorithm=alg, eps=EPS), impl="torch",
        device="cpu", dtype=torch.float64)
    assert bool(np.all(np.asarray(r_j.converged)))
    assert bool(r_t.converged.all())
    np.testing.assert_allclose(r_t.objective.numpy(),
                               np.asarray(r_j.objective), rtol=1e-6)
    assert float(r_t.kkt_gap.max()) <= EPS
    Xt = torch.as_tensor(X)
    for b in range(B):
        y = torch.as_tensor(Y[b])
        bounds = tqp.make_bounds(y, float(Cs[b]))
        a = r_t.alpha[b]
        assert bool(tqp.is_feasible(a, bounds))
        assert float(tqp.kkt_gap(r_t.G[b], a, bounds)) <= EPS
        G_exact = y - ref.gram_cross(Xt, Xt, float(gs[b])) @ a
        np.testing.assert_allclose(r_t.G[b].numpy(), G_exact.numpy(),
                                   rtol=0, atol=1e-7)


def _record_pass_b(monkeypatch):
    """Wrap pass B to snapshot every lane's (alpha, G) after each call."""
    seen = []
    inner = solver_fused.ops.source_update_wss

    def spy(src, G, alpha_new, *args, **kw):
        out = inner(src, G, alpha_new, *args, **kw)
        seen.append((alpha_new.clone(), out[0].clone()))
        return out

    monkeypatch.setattr(solver_fused.ops, "source_update_wss", spy)
    return seen


@pytest.mark.parametrize("alg", ["smo", "pasmo"])
def test_frozen_lane_is_bitwise_held_within_one_run(alg, monkeypatch):
    X, Y, Cs, gs = _problem("xor", 3)
    Cs = np.array([0.05, 100.0, 100.0])      # lane 0 converges far first
    seen = _record_pass_b(monkeypatch)
    r = solver_fused.solve_fused_batched(
        X, Y, Cs, gs, SolverConfig(algorithm=alg, eps=EPS), impl="torch",
        device="cpu", dtype=torch.float64, check_every=1)
    m0 = int(r.iterations[0])
    assert m0 + 10 < len(seen) == int(r.iterations.max())
    a0, g0 = seen[m0 - 1][0][0], seen[m0 - 1][1][0]
    for alpha, G in seen[m0:]:
        assert torch.equal(alpha[0], a0) and torch.equal(G[0], g0)
    assert torch.equal(r.alpha[0], a0) and torch.equal(r.G[0], g0)


@pytest.mark.parametrize("alg", ["smo", "pasmo"])
def test_check_cadence_is_bitwise_invisible(alg):
    X, Y, Cs, gs = _problem("ring", 3)
    cfg = SolverConfig(algorithm=alg, eps=EPS)
    r1, r32 = (solver_fused.solve_fused_batched(
        X, Y, Cs, gs, cfg, impl="torch", device="cpu", dtype=torch.float64,
        check_every=k) for k in (1, 32))
    for f in ("alpha", "b", "G", "iterations", "objective", "kkt_gap",
              "converged", "n_planning", "n_unshrink"):
        assert torch.equal(getattr(r1, f), getattr(r32, f)), f


@pytest.mark.parametrize("max_iter", [1, 37, 64])
def test_max_iter_is_exact(max_iter, monkeypatch):
    X, Y, Cs, gs = _problem("xor", 3)
    seen = _record_pass_b(monkeypatch)
    r = solver_fused.solve_fused_batched(
        X, Y, Cs, gs, SolverConfig(algorithm="pasmo", eps=1e-9,
                                   max_iter=max_iter),
        impl="torch", device="cpu", dtype=torch.float64)
    assert len(seen) == max_iter
    assert not bool(r.converged.any())
    np.testing.assert_array_equal(r.iterations.numpy(), [max_iter] * 3)


def test_float32_lanes_converge():
    X, Y, Cs, gs = _problem("blobs", 3)
    r = solver_fused.solve_fused_batched(
        X, Y, Cs, gs, SolverConfig(algorithm="pasmo", eps=EPS),
        impl="torch", device="cpu", dtype=torch.float32)
    assert r.alpha.dtype == torch.float32 and bool(r.converged.all())
    r64 = solver_fused.solve_fused_batched(
        X, Y, Cs, gs, SolverConfig(algorithm="pasmo", eps=EPS),
        impl="torch", device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(r.objective.numpy(), r64.objective.numpy(),
                               rtol=1e-4)
