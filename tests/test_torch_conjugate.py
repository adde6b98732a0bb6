"""The Conjugate-SMO step (``SolverConfig(algorithm="smo",
step="conjugate")``) in the port against the JAX package.

Pass B's conjugate variants (the plain versions and the forms the CUDA
kernels return: per-block for rbf rows, the lanes' results for bank rows;
one state half and the doubled ε-SVR operator, with and without an
``act`` mask) against
``repro.kernels.ops`` on ``impl="jnp"`` and the Pallas kernels in
interpret mode (``block_l=64``); then the fused loop: the reference's
trajectory on well-conditioned problems, fewer iterations than PA-SMO on the chess board, grid
parity, a bitwise lane freeze within one run, warm-start resume and the
compacted grid, soft shrinking, a doubled ε-SVR lane, the three facades,
the graph driver at any host-check cadence, and the dispatch to the
card's conjugate wrappers.

Tolerances: passes to rtol 1e-12 with indices equal (f64); objectives to
rtol 1e-6 and atol 1e-6 (at eps 1e-3 and 1e-4), every lane converged with
its gap at most eps.  Iteration counts are compared across packages on two
well-conditioned problems only: elsewhere the conjugate step's 2x2 solve
amplifies rounding (a near-singular minor, C = 1000), and the two
trajectories part after a few dozen iterations."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as jgrid
from repro.core import qp as jqp
from repro.core import solver as jsolver
from repro.core import solver_fused as jsf
from repro.kernels import ops as jops
from repro.svm import SVC as JSVC
from repro.svm.data import chessboard, gaussian_blobs, xor_gaussians
from repro_torch.core import grid
from repro_torch.core import solver_fused as tsf
from repro_torch.core.solver import SolverConfig
from repro_torch.kernels import ops, rbf_update_wss, ref
from repro_torch.svm import SVC, SVR, OneClassSVM

CONJ = SolverConfig(algorithm="smo", step="conjugate", eps=1e-3,
                    max_iter=200_000)
PASMO = dataclasses.replace(CONJ, algorithm="pasmo", step="plain")
JCONJ = jsolver.SolverConfig(algorithm="smo", step="conjugate", eps=1e-3,
                             max_iter=200_000)
F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-12


def _obj_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _lanes_ok(res, eps):
    assert bool(res.converged.all())
    gap = res.kkt_gap.numpy()
    assert np.all(np.isfinite(gap)) and float(gap.max()) <= eps


# ---------------------------------------------------------------------------
# pass B with the conjugate direction
# ---------------------------------------------------------------------------

L_, D_, B_ = 130, 4, 5
GIDX = np.array([0, 1, 1, 0, 1])


def _state(dup, seed):
    """Pass B inputs with the direction.  Coordinates ``lo`` < ``hi``
    carry the same state, base row and direction value, an exact tie that
    is the best of the next-i scan in every lane (across blocks; across
    halves when doubled); the mask hides ``lo`` in lane 0 and all of lane
    1; the last lane has an empty I_up.  Lane 0 takes mu = mu2 = 0, lane
    1 mu2 = 0 with mu != 0, the others both non-zero."""
    rng = np.random.default_rng(seed)
    l, d, B = L_, D_, B_
    ta, tb = 5, l - 3
    X = rng.normal(size=(l, d))
    X[tb] = X[ta]
    C = rng.choice([0.5, 1.0, 10.0], size=(B, 1))
    if dup:
        n, lo, hi = 2 * l, tb, l + ta
        z = np.zeros((B, l))
        L = np.concatenate([z, z - C], axis=1)
        U = np.concatenate([z + C, z], axis=1)
    else:
        n, lo, hi = l, ta, tb
        y = rng.choice([-1.0, 1.0], size=(B, l))
        L, U = np.minimum(0.0, y * C), np.maximum(0.0, y * C)
    frac = rng.uniform(size=(B, n))
    frac = np.where(rng.uniform(size=(B, n)) < 0.4, np.round(frac), frac)
    frac[:, lo] = 0.5
    alpha = L + (U - L) * frac
    G = rng.normal(size=(B, n))
    G[:, lo] = G.max(axis=1) + 50.0
    for arr in (G, alpha, L, U):
        arr[:, hi] = arr[:, lo]
    alpha[-1] = U[-1]
    i_idx = rng.integers(ta + 1, tb, size=B).astype(np.int32)
    if dup:
        i_idx += l
    j_idx = rng.integers(0, n, size=B).astype(np.int32)
    base = rng.normal(scale=0.5, size=(B, l))
    base[:, tb] = base[:, ta]
    dirv = np.concatenate([base, base], axis=1) if dup else base
    mu = rng.normal(size=B)
    mu2 = rng.normal(scale=0.5, size=B)
    mu[0] = mu2[0] = mu2[1] = 0.0
    act = rng.uniform(size=(B, n)) < 0.85
    act[:, [lo, hi]] = True
    act[0, lo] = False
    act[1] = False
    sqn = (X * X).sum(axis=1)
    gammas = rng.uniform(0.1, 0.5, size=B)
    d2 = np.maximum(sqn[:, None] + sqn[None, :] - 2.0 * X @ X.T, 0.0)
    bank = np.exp(-np.array([0.2, 0.45])[:, None, None] * d2)
    bank[:, :, tb] = bank[:, :, ta]
    bank[:, tb, :] = bank[:, ta, :]
    bi, bj = (i_idx % l, j_idx % l) if dup else (i_idx, j_idx)
    return dict(X=X, sqn=sqn, G=G, alpha_new=alpha, L=L, U=U, XQi=X[bi],
                sqqi=sqn[bi], XQj=X[bj], sqqj=sqn[bj], mu=mu,
                gammas=gammas, base=base, dirv=dirv, mu2=mu2, act=act,
                bank=bank,
                i_idx=i_idx, j_idx=j_idx, bi=bi, bj=bj, lo=lo, hi=hi)


PASS_B = ("X", "sqn", "G", "alpha_new", "L", "U", "XQi", "sqqi", "XQj",
          "sqqj", "mu", "gammas")
STATE = ("G", "alpha_new", "L", "U")


def _t(s, names):
    return [torch.as_tensor(s[k]) for k in names]


def _port(src, s, dup, act, conj=True):
    """The dispatched plain pass B (``impl="torch"``), the direction at
    base width."""
    kw = dict(impl="torch", dup=dup, act=act)
    if conj:
        kw.update(dirv=torch.as_tensor(s["base"]),
                  mu2=torch.as_tensor(s["mu2"]))
    if src == "rbf":
        return ops.rbf_update_wss_batched(*_t(s, PASS_B), **kw)
    return ops.update_wss_batched_bank(
        torch.as_tensor(s["bank"]), torch.as_tensor(GIDX), *_t(s, STATE),
        *_t(s, ("i_idx", "j_idx", "mu")), **kw)


def _port_blocks(src, s, dup, act):
    """The conjugate wrappers' plain versions (CPU tensors) as they return
    them: the rbf pass's per-block outputs, reduced as the dispatch
    reduces them; the bank pass's lane results (its kernel folds the
    reductions in)."""
    dirv = torch.as_tensor(s["base"])
    mu2 = torch.as_tensor(s["mu2"])
    if src == "bank":
        return rbf_update_wss.update_wss_batched_rows_conj(
            torch.as_tensor(s["bank"]), torch.as_tensor(GIDX),
            *_t(s, STATE), *_t(s, ("i_idx", "j_idx", "mu")), dirv, mu2,
            dup=dup, act=act)
    G, bmax, barg, bmin, r = rbf_update_wss.rbf_update_wss_batched_conj(
        *_t(s, PASS_B), dirv, mu2, dup=dup, act=act)
    return G, *ops._first_max(bmax, barg), bmin.amin(dim=1), r


def _reference(src, s, dup, act, impl):
    kw = dict(impl=impl, dup=dup, dirv=jnp.asarray(s["dirv"]),
              mu2=jnp.asarray(s["mu2"]))
    if act is not None:
        kw["act"] = jnp.asarray(act)
    if impl == "interpret":
        kw["block_l"] = 64
    if src == "rbf":
        return jops.rbf_update_wss_batched(
            *(jnp.asarray(s[k]) for k in PASS_B), **kw)
    rows = lambda b: jnp.asarray(s["bank"][GIDX, b])
    return jops.update_wss_batched_rows(
        rows(s["bi"]), rows(s["bj"]), *(jnp.asarray(s[k]) for k in STATE),
        jnp.asarray(s["mu"]), **kw)


@pytest.mark.parametrize("src", ["rbf", "bank"])
@pytest.mark.parametrize("dup", [False, True], ids=["h1", "dup"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "act"])
def test_conjugate_pass_b_matches_reference(src, dup, masked):
    s = _state(dup, seed=41 + 2 * dup + masked)
    act = torch.as_tensor(s["act"]) if masked else None
    got = _port(src, s, dup, act)
    assert len(got) == 5 and got[4].shape == (B_, L_)
    for k, (a, b) in enumerate(zip(_port_blocks(src, s, dup, act), got)):
        assert torch.equal(a, b), k
    # the reference carries the doubled direction tiled
    G, i_next, g_i, _, r = got
    r_full = ref.tile_rows(r) if dup else r
    for impl in ("jnp", "interpret"):
        want = _reference(src, s, dup, s["act"] if masked else None, impl)
        assert len(want) == 5
        for k, (a, b) in enumerate(zip(got[:4] + (r_full,), want)):
            if k == 1:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=RTOL, atol=1e-13)
    # r is the base row of k_i - k_j, which is tiled when doubled
    if src == "rbf":
        k_i, k_j = (ref.rbf_rows_batched(*_t(s, ("X", "sqn", q, sq,
                                                 "gammas")), dup=dup)
                    for q, sq in (("XQi", "sqqi"), ("XQj", "sqqj")))
    else:
        k_i, k_j = (ref.bank_rows(torch.as_tensor(s["bank"]),
                                  torch.as_tensor(GIDX),
                                  torch.as_tensor(s[k]), dup)
                    for k in ("i_idx", "j_idx"))
    assert torch.equal(r_full, k_i - k_j)
    # mu = mu2 = 0 keeps G bitwise; mu2 = 0 is the plain step's G bitwise;
    # mu2 != 0 moves G by -mu2 dirv
    plain = _port(src, s, dup, act, conj=False)[0]
    assert torch.equal(G[0], torch.as_tensor(s["G"][0]))
    assert torch.equal(G[1], plain[1])
    np.testing.assert_allclose(
        (G - plain)[2:].numpy(), -(s["mu2"][:, None] * s["dirv"])[2:],
        rtol=1e-12, atol=1e-13)
    # the tie across blocks (and halves) goes to the lower index, or to the
    # other one where the mask hides it; empty scans give 0 at -inf
    lo, hi = s["lo"], s["hi"]
    empty = [1, B_ - 1] if masked else [B_ - 1]
    for b in range(B_):
        if b in empty:
            assert int(i_next[b]) == 0 and g_i[b].item() == -np.inf
        else:
            assert int(i_next[b]) == (hi if masked and b == 0 else lo), b


def test_conjugate_wrappers_check_their_direction():
    s = _state(False, seed=3)
    dirv, mu2 = torch.as_tensor(s["dirv"]), torch.as_tensor(s["mu2"])
    from repro_torch.kernels import checks
    G = torch.as_tensor(s["G"])
    with pytest.raises(ValueError, match="dirv has shape"):
        checks.dirv_ptr(dirv[:, :-1], mu2, G, 1)
    with pytest.raises(ValueError, match="contiguous"):
        checks.dirv_ptr(dirv.T.contiguous().T, mu2, G, 1)
    with pytest.raises(ValueError, match="mu2 needs"):
        checks.dirv_ptr(None, mu2, G, 1)
    with pytest.raises(TypeError, match="mu2"):
        checks.dirv_ptr(dirv, None, G, 1)
    assert checks.dirv_ptr(None, None, G, 1) == (None, None)
    assert checks.dirv_ptr(dirv, mu2, G, 1) == (dirv.data_ptr(),
                                                 mu2.data_ptr())
    # the doubled state takes the base row, not the tiled one nor the
    # tiled row's base half (a strided view)
    G2 = torch.zeros((B_, 2 * L_), dtype=torch.float64)
    full = torch.cat([dirv, dirv], dim=1)
    assert checks.dirv_ptr(dirv, mu2, G2, 2)[0] == dirv.data_ptr()
    with pytest.raises(ValueError, match="dirv has shape"):
        checks.dirv_ptr(full, mu2, G2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        checks.dirv_ptr(full[:, :L_], mu2, G2, 2)


# ---------------------------------------------------------------------------
# the fused loop
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _chess(n):
    X, y = chessboard(n, seed=0)
    return np.asarray(X), np.asarray(y)


@pytest.mark.parametrize("data", ["blobs", "xor"])
def test_conjugate_trajectory_follows_reference(data):
    """On well-conditioned problems the port's conjugate loop follows the
    reference's step for step: the same iterations and accepted steps,
    alpha and G to 1e-10."""
    if data == "blobs":
        (X, y), C, gamma = gaussian_blobs(80, seed=0), 2.0, 0.2
    else:
        (X, y), C, gamma = xor_gaussians(64, seed=1), 10.0, 0.5
    X, y = np.asarray(X), np.asarray(y)
    got = tsf.solve_fused_batched(X, y[None], C, gamma, CONJ, **F64)
    want = jsf.solve_fused_batched(jnp.asarray(X), jnp.asarray(y)[None], C,
                                   gamma, JCONJ, impl="jnp")
    _lanes_ok(got, 1e-3)
    assert int(got.iterations[0]) == int(want.iterations[0])
    assert int(got.n_planning[0]) == int(want.n_planning[0]) > 20
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.G.numpy(), np.asarray(want.G), rtol=0,
                               atol=1e-10)


def test_conjugate_fewer_iterations_than_pasmo_on_chessboard():
    X, y = _chess(60)
    pa = tsf.solve_fused_batched(X, y[None], 100.0, 0.5, PASMO, **F64)
    cj = tsf.solve_fused_batched(X, y[None], 100.0, 0.5, CONJ, **F64)
    want = jsf.solve_fused_batched(jnp.asarray(X), jnp.asarray(y)[None],
                                   100.0, 0.5, JCONJ, impl="jnp")
    _lanes_ok(pa, 1e-3)
    _lanes_ok(cj, 1e-3)
    assert int(cj.iterations[0]) < int(pa.iterations[0])
    assert int(cj.n_planning[0]) > int(cj.iterations[0]) // 4
    _obj_close(cj.objective, pa.objective)
    _obj_close(cj.objective, want.objective)


@pytest.mark.parametrize("precompute", [True, False], ids=["bank", "rbf"])
@pytest.mark.parametrize("data", ["chessboard", "blobs"])
def test_conjugate_grid_objective_parity(data, precompute):
    """A small (C, gamma) grid: conjugate and PA-SMO reach the same optima,
    and the reference's conjugate grid's."""
    if data == "chessboard":
        X, y = _chess(60)
        Cs, gammas = [1.0, 10.0], [0.5, 1.0]
    else:
        X, y = (np.asarray(a) for a in gaussian_blobs(60, seed=0))
        Cs, gammas = [0.5, 2.0], [0.05, 0.2]
    cj_cfg = dataclasses.replace(CONJ, eps=1e-4)
    kw = dict(impl="auto", precompute=precompute, **F64)
    cj = grid.solve_grid(X, y, Cs, gammas, cj_cfg, **kw)
    pa = grid.solve_grid(X, y, Cs, gammas,
                         dataclasses.replace(PASMO, eps=1e-4), **kw)
    want = jgrid.solve_grid(X, y, Cs, gammas,
                            dataclasses.replace(JCONJ, eps=1e-4),
                            impl="jnp", precompute=precompute)
    _lanes_ok(cj, 1e-4)
    _obj_close(cj.objective, pa.objective)
    _obj_close(cj.objective, want.objective)
    assert int(cj.n_planning.min()) > 0


def test_conjugate_lane_freeze_is_bitwise_within_one_run(monkeypatch):
    """Once a lane converges it takes mu = mu2 = 0: in the same run, every
    later pass B hands its G back bitwise and its alpha never moves,
    while the other lane keeps iterating."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(48, 3))
    y = np.where(rng.normal(size=48) >= 0, 1.0, -1.0)
    seen = []
    update = ops.source_update_wss

    def spy(src, G, alpha, *args, **kw):
        out = update(src, G, alpha, *args, **kw)
        seen.append((G[0].clone(), out[0][0].clone(), alpha[0].clone(),
                     kw["mu2"][0].item()))
        return out

    monkeypatch.setattr(tsf.ops, "source_update_wss", spy)
    res = tsf.solve_fused_batched(X, np.stack([y, -y]), [0.1, 50.0], 0.8,
                                  dataclasses.replace(CONJ, eps=1e-4),
                                  **F64)
    _lanes_ok(res, 1e-4)
    it0, it1 = (int(t) for t in res.iterations)
    assert it0 < it1 and len(seen) >= it1 > it0 + 10
    for G_in, G_out, a, m2 in seen[it0:]:
        assert torch.equal(G_in, G_out) and m2 == 0.0
        assert torch.equal(a, res.alpha[0]) and torch.equal(G_out,
                                                            res.G[0])
    assert any(m2 != 0.0 for *_, m2 in seen[:it0])


def test_conjugate_warm_start_resume_and_compacted_grid():
    """Stopping mid-run and resuming from (alpha, G) starts a fresh
    direction and lands on the uninterrupted optimum; so does the
    compacted grid, whose chunks of 300 iterations are such resumes."""
    X, y = _chess(60)
    full = tsf.solve_fused_batched(X, y[None], 100.0, 0.5, CONJ, **F64)
    part = tsf.solve_fused_batched(X, y[None], 100.0, 0.5,
                                   dataclasses.replace(CONJ, max_iter=300),
                                   **F64)
    assert not bool(part.converged[0])
    resumed = tsf.solve_fused_batched(X, y[None], 100.0, 0.5, CONJ,
                                      alpha0=part.alpha, G0=part.G, **F64)
    _lanes_ok(full, 1e-3)
    _lanes_ok(resumed, 1e-3)
    _obj_close(resumed.objective, full.objective)
    comp = grid.solve_grid_compacted(X, y, [100.0], [0.5], CONJ, chunk=300,
                                     impl="auto", **F64)
    assert bool(comp.converged.all())
    assert int(comp.iterations[0, 0, 0]) > 300
    _obj_close(comp.objective[0, 0], full.objective)
    want = jgrid.solve_grid_compacted(X, y[None], np.array([100.0]),
                                      np.array([0.5]), JCONJ, chunk=300,
                                      impl="jnp")
    _obj_close(comp.objective, want.objective)


def test_conjugate_composes_with_shrinking():
    """Soft shrinking with the conjugate step (the direction resets on
    every refresh and unshrink): the unshrunk run's optimum and the
    reference's, with accepted conjugate steps."""
    X, y = _chess(60)
    cfg = dataclasses.replace(CONJ, shrink_every=16)
    base = tsf.solve_fused_batched(X, y[None], 100.0, 0.5, CONJ, **F64)
    shr = tsf.solve_fused_batched(X, y[None], 100.0, 0.5, cfg,
                                  shrinking=True, **F64)
    want = jsf.solve_fused_batched(
        jnp.asarray(X), jnp.asarray(y)[None], 100.0, 0.5,
        dataclasses.replace(JCONJ, shrink_every=16), impl="jnp",
        shrinking=True)
    _lanes_ok(base, 1e-3)
    _lanes_ok(shr, 1e-3)
    assert int(shr.n_planning[0]) > 0
    _obj_close(shr.objective, base.objective)
    _obj_close(shr.objective, want.objective)


@functools.lru_cache(maxsize=None)
def _svr_problem():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(60, 2))
    y = np.sin(X[:, 0]) + 0.1 * rng.normal(size=60)
    q = jqp.svr_qp(jnp.asarray(y), 2.0, 0.05)
    return X, y, tuple(np.array(a)[None] for a in (q.p, q.bounds.lower,
                                                    q.bounds.upper))


@pytest.mark.parametrize("precompute", [True, False], ids=["bank", "rbf"])
def test_conjugate_doubled_svr_lane_parity(precompute):
    X, _, (P, L, U) = _svr_problem()
    kw = {}
    if precompute:
        kw = dict(gram=ops.gram(X, X, 0.7, device="cpu",
                                dtype=torch.float64)[None], gram_idx=[0])
    args = [torch.as_tensor(a) for a in (X, P, L, U)]
    cfg = dataclasses.replace(CONJ, eps=1e-4)
    cj = tsf.solve_fused_batched_qp(*args, 0.7, cfg, doubled=True, **kw)
    pa = tsf.solve_fused_batched_qp(*args, 0.7,
                                    dataclasses.replace(PASMO, eps=1e-4),
                                    doubled=True, **kw)
    want = jsf.solve_fused_batched_qp(X, P, L, U, 0.7,
                                      dataclasses.replace(JCONJ, eps=1e-4),
                                      impl="jnp", doubled=True)
    _lanes_ok(cj, 1e-4)
    assert int(cj.n_planning[0]) > 0
    assert abs(float(cj.alpha.sum())) <= 1e-10
    _obj_close(cj.objective, pa.objective)
    _obj_close(cj.objective, want.objective)


def test_facades_thread_the_step_knob():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(50, 3))
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    clf = SVC(C=2.0, gamma=0.7, algorithm="smo", step="conjugate",
              **F64).fit(X, y)
    base = SVC(C=2.0, gamma=0.7, algorithm="smo", **F64).fit(X, y)
    want = JSVC(C=2.0, gamma=0.7, algorithm="smo", step="conjugate",
                impl="jnp", dtype=jnp.float64).fit(X, y)
    assert clf.score(X, y) == base.score(X, y)
    _obj_close(clf.fit_result_.objective, base.fit_result_.objective)
    _obj_close(clf.fit_result_.objective, want.fit_result_.objective)
    assert int(clf.fit_result_.n_planning) > 0

    yr = np.sin(X[:, 0])
    reg = SVR(C=2.0, epsilon=0.1, gamma=0.7, algorithm="smo",
              step="conjugate", **F64).fit(X, yr)
    reg_b = SVR(C=2.0, epsilon=0.1, gamma=0.7, algorithm="smo",
                **F64).fit(X, yr)
    _obj_close(reg.fit_result_.objective, reg_b.fit_result_.objective)
    np.testing.assert_allclose(reg.predict(X).numpy(),
                               reg_b.predict(X).numpy(), atol=5e-3)

    oc = OneClassSVM(nu=0.3, gamma=0.7, algorithm="smo", step="conjugate",
                     **F64).fit(X)
    oc_b = OneClassSVM(nu=0.3, gamma=0.7, algorithm="smo", **F64).fit(X)
    _obj_close(oc.fit_result_.objective, oc_b.fit_result_.objective)
    # the conjugate step composes with algorithm="smo" only
    with pytest.raises(AssertionError, match="algorithm='smo'"):
        SVC(step="conjugate", **F64).fit(X, y)


def test_conjugate_graph_driver_is_bitwise_at_any_cadence(monkeypatch):
    """Conjugate with soft shrinking (period 8) through the graph driver
    (a stand-in graph whose replay re-runs the chunk on the driver's state
    buffers): ``check_every`` 1, 5 and 32 give the same results, counts and
    carried direction bit for bit."""
    X, y = _chess(60)
    Y = np.stack([y, -y])
    cfg = dataclasses.replace(CONJ, shrink_every=8, eps=1e-4)

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

    drive = tsf._drive
    monkeypatch.setattr(tsf, "_capture", fake_capture)
    monkeypatch.setattr(tsf, "_drive",
                        lambda body, s, mx, ce, graphs, period=0: drive(
                            body, s, mx, ce, True, period))
    runs = [tsf.solve_fused_batched(X, Y, [10.0, 2.0], 0.5, cfg,
                                    shrinking=True, check_every=ce, **F64)
            for ce in (1, 5, 32)]
    for r in runs[1:]:
        for f in ("alpha", "b", "G", "iterations", "objective", "kkt_gap",
                  "converged", "n_planning", "n_unshrink"):
            assert torch.equal(getattr(r, f), getattr(runs[0], f)), f
    _lanes_ok(runs[0], 1e-4)
    assert int(runs[0].n_planning.min()) > 0


def test_single_lane_solve_fused_refuses_conjugate():
    X, y = _chess(60)
    with pytest.raises(ValueError, match="lane-batched"):
        tsf.solve_fused(X, y, 10.0, 0.5, CONJ, **F64)


@pytest.mark.parametrize("shrinking", [False, True], ids=["off", "soft"])
def test_card_dispatch_runs_only_the_conjugate_pass_b(shrinking,
                                                      monkeypatch):
    """Routed to the card's dispatch (the wrappers run their plain per-block
    versions on CPU tensors), conjugate runs through both row sources, the
    doubled ε-SVR lanes and the compacted grid call the conjugate pass B
    wrappers and never the plain ones, and give the plain backend's
    results bit for bit."""
    from repro_torch.kernels import rbf_update_wss as pb
    X, y = _chess(60)
    Y = np.stack([y, -y])
    Xs, ys, _ = _svr_problem()
    calls = {}

    def counting(name):
        fn = getattr(pb, name)

        def shim(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return shim

    def runs():
        out = []
        for pre in (True, False):
            out.append(grid.solve_grid(X, Y, [1.0, 10.0], [0.5], CONJ,
                                       impl="auto", precompute=pre,
                                       shrinking=shrinking, **F64))
            out.append(grid.solve_grid_svr(Xs, ys, [1.0], [0.1], [0.7],
                                           CONJ, precompute=pre,
                                           shrinking=shrinking, **F64))
        out.append(grid.solve_grid_compacted(
            X, Y, [1.0, 10.0], [0.5], CONJ, chunk=32, impl="auto",
            precompute=True, shrinking=shrinking, **F64))
        return out

    want = runs()
    names = [n for n in vars(pb) if n.startswith(("rbf_update_wss_batched",
                                                  "update_wss_batched_rows"))]
    with monkeypatch.context() as m:
        m.setattr(ops, "resolve_impl", lambda impl, device: "cuda")
        for n in names:
            m.setattr(pb, n, counting(n))
        got = runs()
    assert set(calls) == {"rbf_update_wss_batched_conj",
                          "update_wss_batched_rows_conj"}, calls
    for g, w in zip(got, want):
        for f in ("alpha", "G", "iterations", "n_planning", "objective"):
            assert torch.equal(getattr(g, f), getattr(w, f)), f
        assert bool(g.converged.all())
        assert int(g.n_planning.max()) > 0


# ---------------------------------------------------------------------------
# the conjugate step over lane slabs
# ---------------------------------------------------------------------------

def test_conjugate_step_over_slabs_matches_batched():
    """The conjugate carry is per lane, so each slab runs the batched
    engine's conjugate loop: over two slabs on the CPU the iterations and
    accepted steps equal the batched engine's (alpha to 1e-12), and the
    objectives hold the reference's batched conjugate lanes."""
    from repro_torch.core.sharded_lanes import solve_fused_sharded
    rng = np.random.default_rng(0)
    X = rng.normal(size=(24, 3))
    y = np.where(rng.normal(size=24) >= 0, 1.0, -1.0)
    Y = np.stack([y, -y])
    cfg = dataclasses.replace(CONJ, max_iter=2000)
    rs = solve_fused_sharded(X, Y, 2.0, 0.8, cfg, devices=("cpu", "cpu"),
                             **F64)
    rb = tsf.solve_fused_batched(X, Y, 2.0, 0.8, cfg, **F64)
    assert torch.equal(rs.iterations, rb.iterations)
    assert torch.equal(rs.n_planning, rb.n_planning)
    assert int(rs.n_planning.sum()) > 0
    np.testing.assert_allclose(rs.alpha.numpy(), rb.alpha.numpy(),
                               rtol=RTOL, atol=0)
    rj = jsf.solve_fused_batched(jnp.asarray(X), jnp.asarray(Y), 2.0, 0.8,
                                 dataclasses.replace(JCONJ, max_iter=2000),
                                 impl="jnp")
    _obj_close(rs.objective, rj.objective)
    _lanes_ok(rs, cfg.eps)
