"""The port's single-lane fused solver and its two passes against the JAX
package.

Passes: the plain single-lane pass A and pass B, and the per-block forms
kernels 6 and 7 return, against ``repro.kernels.ref.rbf_row_wss`` /
``rbf_update_wss`` and against ``repro.kernels.ops`` with the Pallas
kernels in interpret mode: l not a multiple of 128, an all-masked vector
(index 0, gain -inf), an exact gain tie across blocks (the lower index
wins), ``idx == i`` excluded, and ``mu = 0`` bitwise.  Rows, gains and G
to rtol 1e-12 (f64), indices exactly.

Solver: ``solve_fused(device="cpu")`` against the reference's
``solve_fused(impl="jnp")`` (and once its interpret-mode kernels) on blobs
and xor at 64 points, smo and pasmo: objective to rtol 1e-6, KKT gap <=
eps, feasibility, G within 1e-7 of ``y - K alpha``.  Iteration counts are
not compared across packages (the reference's own backends differ).
Within the port: the relaunch flag, the host-check cadence and
``max_iter``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solver import SolverConfig as JConfig
from repro.core.solver_fused import solve_fused as j_solve
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import qp as tqp
from repro_torch.core import solver_fused
from repro_torch.core.solver import SolverConfig
from repro_torch.kernels import build, ops, rbf_row_wss, rbf_update_wss, ref
from repro_torch.svm.data import gaussian_blobs, xor_gaussians

TA, TB = 5, -3            # duplicated points: first and last block


def _single(l, d, seed, masked=False):
    """Single-lane pass A/B inputs (f64) with an exact gain tie between the
    duplicated points TA and l+TB, the best of the vector; ``masked``
    pins every alpha at L (nothing selectable in pass A, empty I_up in
    pass B's scan over alpha < U when also pinned at U)."""
    rng = np.random.default_rng(seed)
    tb = l + TB
    X = rng.normal(size=(l, d))
    X[tb] = X[TA]
    y = rng.choice([-1.0, 1.0], size=l)
    C = 2.0
    L, U = np.minimum(0.0, y * C), np.maximum(0.0, y * C)
    frac = rng.uniform(size=l)
    frac = np.where(rng.uniform(size=l) < 0.4, np.round(frac), frac)
    frac[[TA, tb]] = 0.5
    alpha = L + (U - L) * frac
    G = rng.normal(size=l)
    G[TA] = G.min() - 5.0
    for arr in (G, alpha, L, U):
        arr[tb] = arr[TA]
    i = int(rng.integers(TA + 1, tb))
    g_i = G[i] + 1.0
    if masked:
        alpha = L.copy()
    sqn = (X * X).sum(axis=1)
    j = int(rng.integers(0, l))
    G_b = G.copy()
    G_b[[TA, tb]] = G.max() + 5.0
    alpha_b = U.copy() if masked else alpha
    return dict(X=X, sqn=sqn, G=G, alpha=alpha, L=L, U=U, xq=X[i],
                a_i=alpha[i], L_i=L[i], U_i=U[i], g_i=g_i,
                i_idx=np.int32(i), gamma=0.3, G_b=G_b, alpha_b=alpha_b,
                xq_j=X[j], mu=rng.normal())


def _pass_a(s, use_exact, lib):
    args = [s[k] for k in ("X", "sqn", "G", "alpha", "L", "U", "xq", "a_i",
                           "L_i", "U_i", "g_i", "i_idx")]
    if lib is torch:
        return [torch.as_tensor(a) for a in args] + [
            torch.tensor(use_exact), torch.tensor(s["gamma"],
                                                  dtype=torch.float64)]
    return [jnp.asarray(a) for a in args] + [jnp.asarray(use_exact),
                                             jnp.asarray(s["gamma"])]


CASES_A = [(300, 16, False, False), (300, 16, True, False),
           (257, 5, False, True), (130, 3, True, False)]


@pytest.mark.parametrize("l,d,use_exact,masked", CASES_A)
def test_single_pass_a_matches_reference(l, d, use_exact, masked):
    s = _single(l, d, seed=l + d, masked=masked)
    k_t, j_t, g_t = ops.rbf_row_wss(*_pass_a(s, use_exact, torch))
    assert j_t.dtype == torch.int32 and j_t.ndim == 0
    k_r, j_r, g_r = jref.rbf_row_wss(*_pass_a(s, use_exact, jnp))
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_r), rtol=1e-12)
    for k_j, j_j, g_j in ((k_r, j_r, g_r),
                          jops.rbf_row_wss(*_pass_a(s, use_exact, jnp),
                                           impl="interpret", block_l=128)):
        np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=1e-12)
        assert int(j_t) == int(j_j)
        np.testing.assert_allclose(float(g_t), float(g_j), rtol=1e-12)
    if masked:
        assert int(j_t) == 0 and float(g_t) == -np.inf
    elif not use_exact:          # the tie across blocks: the lower index
        assert int(j_t) == TA
    # the per-block form kernel 6 returns, reduced across blocks
    args = _pass_a(s, use_exact, torch)
    xq = args[6]
    k_b, bmax, barg = ref.rbf_row_wss_blocks(
        *args[:7], torch.dot(xq, xq), *args[7:], block_l=build.BLOCK_L)
    assert bmax.shape == (-(-l // 128),) and barg.dtype == torch.int32
    np.testing.assert_array_equal(k_b.numpy(), k_t.numpy())
    j_b, g_b = ops._first_max(bmax[None], barg[None])
    assert int(j_b[0]) == int(j_t) and float(g_b[0]) == float(g_t)


def test_single_pass_a_excludes_i():
    s = _single(300, 16, seed=1)
    s["G"][:] = 0.0
    s["g_i"] = 1.0
    s["alpha"] = s["L"] + 0.5 * (s["U"] - s["L"])
    # every column's gain is 0.5 / q: i's own (q = TAU) would win
    k_t, j_t, _ = ops.rbf_row_wss(*_pass_a(s, False, torch))
    _, j_r, _ = jref.rbf_row_wss(*_pass_a(s, False, jnp))
    assert int(j_t) != int(s["i_idx"]) and int(j_t) == int(j_r)
    assert float(k_t[int(s["i_idx"])]) == 1.0


def test_relaunch_flag_keeps_or_replaces_the_row():
    """A false flag leaves the stored row as it was, bitwise; a true one
    replaces it with the new query's row (wrapper and dispatch)."""
    s = _single(300, 16, seed=2)
    args = _pass_a(s, False, torch)
    stored = torch.full((300,), 7.0, dtype=torch.float64)
    for flag in (False, True):
        run = torch.tensor(flag)
        k_w, _, _ = rbf_row_wss.rbf_row_wss(
            *args[:7], torch.dot(args[6], args[6]), *args[7:],
            k_out=stored, run=run)
        k_o, _, _ = ops.rbf_row_wss(*args, k_out=stored, run=run)
        want = (ref.rbf_row(args[0], args[1], args[6], args[-1]) if flag
                else stored)
        for k in (k_w, k_o):
            np.testing.assert_array_equal(k.numpy(), want.numpy())


@pytest.mark.parametrize("l,d,masked", [(300, 16, False), (257, 5, True),
                                        (130, 3, False)])
def test_single_pass_b_matches_reference(l, d, masked):
    s = _single(l, d, seed=l, masked=masked)
    X, sqn = torch.as_tensor(s["X"]), torch.as_tensor(s["sqn"])
    k_i = ref.rbf_row(X, sqn, torch.as_tensor(s["xq"]), s["gamma"])
    tt = [torch.as_tensor(s[k]) for k in ("G_b", "alpha_b", "L", "U",
                                          "xq_j")]
    for mu in (s["mu"], 0.0):
        mu_t = torch.tensor(mu, dtype=torch.float64)
        G_t, i_t, gi_t, gdn_t = ops.rbf_update_wss(
            X, sqn, tt[0], k_i, tt[1], tt[2], tt[3], tt[4], mu_t, s["gamma"])
        assert i_t.dtype == torch.int32 and i_t.ndim == 0
        if mu == 0.0:
            assert torch.equal(G_t, tt[0])
        jargs = [jnp.asarray(a) for a in (s["X"], s["sqn"], s["G_b"],
                                          k_i.numpy())]
        rest = [jnp.asarray(s[k]) for k in ("alpha_b", "L", "U")]
        outs = (jref.rbf_update_wss(*jargs, jnp.asarray(s["xq_j"]),
                                    jnp.asarray(mu), *rest, s["gamma"]),
                jops.rbf_update_wss(*jargs, *rest, jnp.asarray(s["xq_j"]),
                                    jnp.asarray(mu), s["gamma"],
                                    impl="interpret", block_l=128))
        for G_j, i_j, gi_j, gdn_j in outs:
            np.testing.assert_allclose(G_t.numpy(), np.asarray(G_j),
                                       rtol=1e-12, atol=1e-12)
            assert int(i_t) == int(i_j)
            np.testing.assert_allclose(float(gi_t), float(gi_j), rtol=1e-12)
            np.testing.assert_allclose(float(gdn_t), float(gdn_j),
                                       rtol=1e-12)
        if masked:                 # alpha == U everywhere: empty I_up
            assert int(i_t) == 0 and float(gi_t) == -np.inf
        else:                      # the tie across blocks
            assert int(i_t) == TA
        G_b, bmax, barg, bmin = rbf_update_wss.rbf_update_wss(
            X, sqn, tt[0], k_i, tt[1], tt[2], tt[3], tt[4],
            torch.dot(tt[4], tt[4]), mu_t,
            torch.tensor(s["gamma"], dtype=torch.float64))
        np.testing.assert_array_equal(G_b.numpy(), G_t.numpy())
        i_b, gi_b = ops._first_max(bmax[None], barg[None])
        assert int(i_b[0]) == int(i_t) and float(bmin.amin()) == float(gdn_t)


GENS = {"xor": (xor_gaussians, 100.0, 0.5), "blobs": (gaussian_blobs, 1.0,
                                                       0.05)}
EPS = 1e-3


def _fit(name, alg, **kw):
    gen, C, gamma = GENS[name]
    X, y = gen(64, seed=1)
    r = solver_fused.solve_fused(X, y, C, gamma,
                                 SolverConfig(algorithm=alg, eps=EPS),
                                 device="cpu", dtype=torch.float64, **kw)
    return X, y, C, gamma, r


@pytest.mark.parametrize("name", ["xor", "blobs"])
@pytest.mark.parametrize("alg", ["smo", "pasmo"])
def test_solve_fused_matches_reference(name, alg):
    X, y, C, gamma, r_t = _fit(name, alg)
    r_j = j_solve(jnp.asarray(X), jnp.asarray(y), C, gamma,
                  JConfig(algorithm=alg, eps=EPS), impl="jnp")
    assert bool(r_j.converged) and bool(r_t.converged)
    for f in ("b", "iterations", "objective", "kkt_gap", "converged"):
        assert getattr(r_t, f).ndim == 0, f
    np.testing.assert_allclose(float(r_t.objective), float(r_j.objective),
                               rtol=1e-6)
    assert float(r_t.kkt_gap) <= EPS
    yt = torch.as_tensor(y)
    bounds = tqp.make_bounds(yt, C)
    assert bool(tqp.is_feasible(r_t.alpha, bounds))
    assert float(tqp.kkt_gap(r_t.G, r_t.alpha, bounds)) <= EPS
    Xt = torch.as_tensor(X)
    G_exact = yt - ref.gram_cross(Xt, Xt, gamma) @ r_t.alpha
    np.testing.assert_allclose(r_t.G.numpy(), G_exact.numpy(), rtol=0,
                               atol=1e-7)
    # the batched engine's lane 0 solves the same QP
    r_b = solver_fused.solve_fused_batched(
        X, y[None], C, gamma, SolverConfig(algorithm=alg, eps=EPS),
        device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(float(r_t.objective), float(r_b.objective[0]),
                               rtol=1e-6)


def test_solve_fused_matches_the_reference_kernels_in_interpret_mode():
    X, y, C, gamma, r_t = _fit("xor", "pasmo")
    r_j = j_solve(jnp.asarray(X), jnp.asarray(y), C, gamma,
                  JConfig(algorithm="pasmo", eps=EPS), impl="interpret",
                  block_l=128)
    np.testing.assert_allclose(float(r_t.objective), float(r_j.objective),
                               rtol=1e-6)


def test_relaunches_are_counted_and_some_run():
    stats = {}
    _, _, _, _, r = _fit("xor", "pasmo", stats=stats, check_every=1)
    # one conditional pass A a planning iteration, a few of them run
    assert stats["relaunches"] == int(r.iterations)
    assert 0 < stats["relaunches_ran"] < stats["relaunches"]
    smo = {}
    _fit("xor", "smo", stats=smo)
    assert smo == {"relaunches": 0, "relaunches_ran": 0}


@pytest.mark.parametrize("alg", ["smo", "pasmo"])
def test_check_cadence_is_bitwise_invisible(alg):
    r1 = _fit("blobs", alg, check_every=1)[-1]
    r32 = _fit("blobs", alg, check_every=32)[-1]
    for f in ("alpha", "b", "G", "iterations", "objective", "kkt_gap",
              "converged", "n_planning"):
        assert torch.equal(getattr(r1, f), getattr(r32, f)), f


@pytest.mark.parametrize("max_iter", [1, 37])
def test_max_iter_is_exact(max_iter):
    X, y = xor_gaussians(64, seed=1)
    r = solver_fused.solve_fused(
        X, y, 100.0, 0.5, SolverConfig(algorithm="pasmo", eps=1e-9,
                                       max_iter=max_iter),
        device="cpu", dtype=torch.float64)
    assert int(r.iterations) == max_iter and not bool(r.converged)


def test_float32_fit_converges():
    X, y = gaussian_blobs(64, seed=1)
    r = solver_fused.solve_fused(X, y, 1.0, 0.05, SolverConfig(eps=EPS),
                                 device="cpu", dtype=torch.float32)
    assert r.alpha.dtype == torch.float32 and bool(r.converged)
    r64 = _fit("blobs", "pasmo")[-1]
    np.testing.assert_allclose(float(r.objective), float(r64.objective),
                               rtol=1e-4)


def test_graph_driver_replays_the_eager_loop_bitwise(monkeypatch):
    """On the card both solvers replay captured chunks of the loop
    (``solver_fused._drive``), one graph per shape of chunk.  With a
    stand-in graph whose replay re-runs the chunk on the
    driver's state buffers, the results, iteration, unshrink and relaunch
    counts equal the eager loop's bit for bit, also when ``max_iter`` ends
    on a partial chunk and when soft shrinking refreshes its mask at
    iterations that fall anywhere in a chunk."""
    X, y = xor_gaussians(64, seed=1)
    Y = np.stack([y, -y])

    def fake_capture(body, static, refresh, pool=None):
        def replay():
            out = static
            for r in refresh:
                out = body(out, r)
            for dst, src in zip(static, out):
                if dst is not src:
                    dst.copy_(src)
        return type("Graph", (), {"replay": staticmethod(replay),
                                  "pool": staticmethod(lambda: pool)}), {}

    def runs(cfg):
        st = {}
        return (solver_fused.solve_fused_batched(
                    X, Y, [100.0, 1.0], 0.5, cfg, device="cpu",
                    dtype=torch.float64, shrinking=cfg.shrink_every > 0,
                    check_every=5 if cfg.shrink_every else 32),
                solver_fused.solve_fused(X, y, 100.0, 0.5, cfg, device="cpu",
                                         dtype=torch.float64, stats=st), st)

    drive = solver_fused._drive
    for cfg in (SolverConfig(algorithm="pasmo"),
                SolverConfig(algorithm="smo", max_iter=75),
                SolverConfig(algorithm="pasmo", shrink_every=8)):
        eager = runs(cfg)
        with monkeypatch.context() as m:
            m.setattr(solver_fused, "_capture", fake_capture)
            m.setattr(solver_fused, "_drive",
                      lambda body, s, mx, ce, graphs, period=0: drive(
                          body, s, mx, ce, True, period))
            replayed = runs(cfg)
        for r_e, r_g in zip(eager[:2], replayed[:2]):
            for f in ("alpha", "b", "G", "iterations", "objective",
                      "kkt_gap", "converged", "n_planning", "n_unshrink"):
                assert torch.equal(getattr(r_e, f), getattr(r_g, f)), f
        assert eager[2] == replayed[2]
