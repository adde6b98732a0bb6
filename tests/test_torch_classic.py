"""The port's classic engine (``repro_torch.core.solver``), its selection
rules (``core/wss.py``), its kernel oracles (``core/qp.py``) and
``solve_ovr`` against the reference's, on the CPU in f64 (the facades and
``svm/model.py`` are in ``test_torch_classic_svm.py``).

Selection rules and oracles elementwise to rtol 1e-12 (indices exactly,
ties and all-masked lanes included).  Solves: objective rtol 1e-6, KKT gap
<= eps and feasibility everywhere.  On the well-conditioned blobs problems
of 60 points the four per-step counters, the first 64 working sets and the
Fig. 3 ratios (rtol 1e-9) equal the reference's.  Elsewhere XLA contracts
the reference's arithmetic into fused multiply-adds, so its path can leave
the port's where two candidates tie to rounding (checked to be such a tie,
as the reference's own trajectory tests do); against the reference's numpy
transcription (``repro.core.reference``), which rounds as the port does,
the whole path and every counter are equal.  Within the port: a frozen
lane is held bitwise and ``max_iter`` is exact per lane at any
host-check cadence."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multiclass as jmc
from repro.core import qp as jqp
from repro.core import reference as ref
from repro.core import solver as js
from repro.core import wss as jwss
from repro.svm.data import (chessboard, gaussian_blobs, multiclass_blobs,
                            ring, xor_gaussians)
from repro_torch.core import multiclass as tmc
from repro_torch.core import qp as tqp
from repro_torch.core import solver as ts
from repro_torch.core import wss as twss

EPS = 1e-3
RTOL = 1e-12
COUNTERS = ("iterations", "n_planning", "n_free", "n_clipped", "n_reverted")
F64 = dict(device="cpu", dtype=torch.float64)


def _rbf(X, gamma):
    sq = np.sum(X * X, axis=1)
    return np.exp(-gamma * np.maximum(sq[:, None] + sq[None, :]
                                      - 2 * X @ X.T, 0.0))


def _problem(name, n, seed=0):
    gen = {"chess": chessboard, "blobs": gaussian_blobs, "ring": ring,
           "xor": xor_gaussians}[name]
    X, y = gen(n, seed=seed)
    gamma = {"chess": 0.5, "blobs": 0.05, "ring": 1.0, "xor": 0.5}[name]
    C = {"chess": 1000.0, "blobs": 1.0, "ring": 10.0, "xor": 100.0}[name]
    return X, y, C, gamma


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


# ---------------------------------------------------------------------------
# Selection rules, lane by lane against the reference's (n,) functions
# ---------------------------------------------------------------------------


def _wss_state(B=6, n=40, seed=0):
    """B lanes: lane 1 has tied maxima of G (and of the gains), lane 2 an
    empty I_up, lane 3 an empty I_down, the rest random boxes with a third
    of the coordinates on a bound."""
    rng = np.random.default_rng(seed)
    y = rng.choice([-1.0, 1.0], size=(B, n))
    C = rng.choice([0.5, 1.0, 10.0], size=(B, n))
    L, U = np.minimum(0.0, y * C), np.maximum(0.0, y * C)
    frac = rng.uniform(size=(B, n))
    frac = np.where(rng.uniform(size=(B, n)) < 0.33, np.round(frac), frac)
    alpha = L + (U - L) * frac
    G = rng.normal(size=(B, n))
    G[1, [5, 17, 30]] = 3.0
    alpha[1, [5, 17, 30]] = L[1, [5, 17, 30]]
    X = rng.normal(size=(n, 3))
    K = _rbf(X, 0.7)
    K[:, 8] = K[8] = K[:, 21] = K[21] = 0.25    # tied curvature columns
    np.fill_diagonal(K, 1.0)
    K[8, 21] = K[21, 8] = 0.25
    G[1, [8, 21]] = -2.0
    alpha[2] = U[2]
    alpha[3] = L[3]
    return dict(G=G, alpha=alpha, L=L, U=U, K=K)


def _lane_j(s, b):
    return (jnp.asarray(s["G"][b]), jnp.asarray(s["alpha"][b]),
            jqp.Bounds(jnp.asarray(s["L"][b]), jnp.asarray(s["U"][b])))


def _lanes_t(s):
    return (_t(s["G"]), _t(s["alpha"]),
            tqp.Bounds(_t(s["L"]), _t(s["U"])))


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=0)


def test_masked_argmax_takes_the_first_tie_and_gives_minus_inf_when_empty():
    v = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0],
                      [9.0, 1.0, 9.0, 0.0]], dtype=torch.float64)
    mask = torch.tensor([[True] * 4, [False, True, True, True],
                         [False] * 4])
    idx, val = twss.select_i(v, mask)
    assert idx.dtype == torch.int32
    assert idx.tolist() == [1, 1, 0]
    assert val[:2].tolist() == [3.0, 5.0] and val[2] == float("-inf")
    for b in range(3):
        ji, jv = jwss.select_i(jnp.asarray(v[b].numpy()),
                               jnp.asarray(mask[b].numpy()))
        assert int(ji) == int(idx[b]) and float(jv) == float(val[b])


@pytest.mark.parametrize("rule", ["wss2", "exact", "mvp", "either"])
def test_selection_matches_reference_lane_by_lane(rule):
    s = _wss_state()
    B = s["G"].shape[0]
    G, alpha, bounds = _lanes_t(s)
    up, dn = tqp.up_mask(alpha, bounds), tqp.down_mask(alpha, bounds)
    K = _t(s["K"])
    diag = torch.diagonal(K).expand(B, -1)
    i, g_i = twss.select_i(G, up)
    K_i = K[i.long()]
    use_exact = torch.tensor([b % 2 == 0 for b in range(B)])
    if rule == "wss2":
        got = twss.select_wss2(G, K_i, diag, up, dn)
    elif rule == "exact":
        got = twss.select_wss2_exact(G, K_i, diag, alpha, bounds, up, dn)
    elif rule == "mvp":
        got = twss.select_mvp(G, up, dn)
    else:
        got = twss.select_wss2_either(G, K_i, diag, alpha, bounds, up, dn,
                                      i, g_i, use_exact)
    for b in range(B):
        Gj, aj, bj = _lane_j(s, b)
        upj, dnj = jqp.up_mask(aj, bj), jqp.down_mask(aj, bj)
        Kj = jnp.asarray(s["K"])
        dj = jnp.diagonal(Kj)
        Kij = Kj[int(i[b])]
        exact = rule == "exact" or (rule == "either" and bool(use_exact[b]))
        if rule == "mvp":
            want = jwss.select_mvp(Gj, upj, dnj)
        elif exact:
            want = jwss.select_wss2_exact(Gj, Kij, dj, aj, bj, upj, dnj)
        else:
            want = jwss.select_wss2(Gj, Kij, dj, upj, dnj)
        assert (int(got.i[b]), int(got.j[b])) == (int(want.i), int(want.j))
        for f in ("gain", "violation"):
            w, g = float(getattr(want, f)), float(getattr(got, f)[b])
            if np.isfinite(w):
                assert abs(g - w) <= RTOL * abs(w), (b, f, g, w)
            else:
                assert g == w, (b, f, g, w)
    assert got.i.dtype == got.j.dtype == torch.int32
    # the empty I_up lane selects index 0 with gain -inf (wss2 rules)
    if rule != "mvp":
        assert int(got.i[2]) == 0 and float(got.gain[2]) == float("-inf")


def test_pair_curvature_matches_reference():
    s = _wss_state()
    K = s["K"]
    K_i = K[[3, 8, 21]]
    got = twss.pair_curvature(_t(K_i), _t(np.diagonal(K)[[3, 8, 21]]),
                              _t(np.diagonal(K)))
    for r, i in enumerate((3, 8, 21)):
        want = jwss.pair_curvature(jnp.asarray(K[i]), jnp.asarray(K[i, i]),
                                   jnp.asarray(np.diagonal(K)))
        _close(got[r], want)
    assert float(got.min()) >= tqp.TAU


@pytest.mark.parametrize("exact", [False, True])
def test_candidate_gains_match_reference(exact):
    s = _wss_state()
    B, n = s["G"].shape
    rng = np.random.default_rng(3)
    ci = rng.integers(0, n, size=(B, 4)).astype(np.int32)
    cj = rng.integers(0, n, size=(B, 4)).astype(np.int32)
    cj[:, 0] = ci[:, 0]                                 # i == j: infeasible
    K = s["K"]
    G, alpha, bounds = _lanes_t(s)
    up, dn = tqp.up_mask(alpha, bounds), tqp.down_mask(alpha, bounds)
    Kii, Kjj = np.diagonal(K)[ci], np.diagonal(K)[cj]
    Kij = K[ci, cj]
    args = (_t(ci), _t(cj), G, _t(Kii), _t(Kij), _t(Kjj))
    got = (twss.candidate_exact_gain(*args, alpha, bounds, up, dn) if exact
           else twss.candidate_newton_gain(*args, up, dn))
    assert got.shape == (B, 4)
    for b in range(B):
        Gj, aj, bj = _lane_j(s, b)
        upj, dnj = jqp.up_mask(aj, bj), jqp.down_mask(aj, bj)
        for c in range(4):
            a = (jnp.int32(ci[b, c]), jnp.int32(cj[b, c]), Gj,
                 Kii[b, c], Kij[b, c], Kjj[b, c])
            want = float(jwss.candidate_exact_gain(*a, aj, bj, upj, dnj)
                         if exact else
                         jwss.candidate_newton_gain(*a, upj, dnj))
            g = float(got[b, c])
            assert (g == want if not np.isfinite(want)
                    else abs(g - want) <= RTOL * abs(want)), (b, c, g, want)
    assert bool((got[:, 0] == float("-inf")).all())


# ---------------------------------------------------------------------------
# Kernel oracles and QP helpers
# ---------------------------------------------------------------------------


def _oracles(kind, seed=0):
    """(port oracle, reference oracle per lane b) over B = 3 lanes."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(24, 5))
    Ks = np.stack([_rbf(X, g) for g in (0.2, 0.5, 1.3)])
    g = np.array([2, 0, 2], np.int32)
    base = kind.removeprefix("doubled_")
    if base == "precomputed":
        t, j = tqp.PrecomputedKernel(_t(Ks[1])), \
            (lambda b: jqp.PrecomputedKernel(jnp.asarray(Ks[1])))
    elif base == "stacked":
        t = tqp.StackedKernel(_t(Ks), _t(g))
        j = (lambda b: jqp.StackedKernel(jnp.asarray(Ks), jnp.int32(g[b])))
    elif base == "rbf":
        t, j = tqp.make_rbf(_t(X), 0.5), (lambda b: jqp.make_rbf(
            jnp.asarray(X), 0.5))
    else:
        t, j = tqp.LinearKernel(_t(X)), (lambda b: jqp.LinearKernel(
            jnp.asarray(X)))
    if kind.startswith("doubled_"):
        return tqp.DoubledKernel(t), (lambda b: jqp.DoubledKernel(j(b)))
    return t, j


KINDS = ["precomputed", "stacked", "rbf", "linear", "doubled_precomputed",
         "doubled_stacked", "doubled_rbf"]


@pytest.mark.parametrize("kind", KINDS)
def test_oracles_match_reference(kind):
    t, j = _oracles(kind)
    B, n = 3, t.n
    rng = np.random.default_rng(1)
    i = rng.integers(0, n, size=(B,)).astype(np.int32)
    ik = rng.integers(0, n, size=(B, 4)).astype(np.int32)
    jk = rng.integers(0, n, size=(B, 4)).astype(np.int32)
    v = rng.normal(size=(B, n))
    rows, rows_k = t.row(_t(i)), t.row(_t(ik))
    entries = t.entry(_t(ik), _t(jk))
    diag = t.diag()
    mv = t.matvec(_t(v))
    assert rows.shape == (B, n) and rows_k.shape == (B, 4, n)
    assert entries.shape == (B, 4) and mv.shape == (B, n)
    for b in range(B):
        jo = j(b)
        assert jo.n == n
        _close(rows[b], jo.row(jnp.int32(i[b])))
        for c in range(4):
            _close(rows_k[b, c], jo.row(jnp.int32(ik[b, c])))
            _close(entries[b, c], jo.entry(jnp.int32(ik[b, c]),
                                           jnp.int32(jk[b, c])))
        _close(diag if diag.ndim == 1 else diag[b], jo.diag())
        _close(mv[b], jo.matvec(jnp.asarray(v[b])), rtol=1e-11)
    # one problem: 1-D vectors and the dense materialization
    if "stacked" not in kind:
        _close(t.matvec(_t(v[0])), j(0).matvec(jnp.asarray(v[0])),
               rtol=1e-11)
        _close(tqp.materialize(t), jqp.materialize(j(0)))


def test_stacked_materialize_and_rbf_entry_agree_with_rows():
    t, _ = _oracles("stacked")
    for g in (torch.tensor([1], dtype=torch.int32), torch.tensor(2)):
        _close(tqp.materialize(tqp.StackedKernel(t.Ks, g)), t.Ks[int(g)])
    rbf = tqp.make_rbf(_t(np.random.default_rng(2).normal(size=(30, 4))),
                       0.8)
    idx = torch.arange(30, dtype=torch.int32)
    K = tqp.materialize(rbf)
    ii, jj = torch.meshgrid(idx, idx, indexing="ij")
    _close(rbf.entry(ii, jj), K)
    _close(torch.diagonal(K), rbf.diag())


def test_qp_helpers_match_reference():
    s = _wss_state()
    K = s["K"]
    y = np.sign(s["G"][0]) + (s["G"][0] == 0)
    a = s["alpha"][0]
    tq, jq = tqp.classification_qp(_t(y), 2.0), jqp.classification_qp(
        jnp.asarray(y), 2.0)
    for f in ("lower", "upper"):
        _close(getattr(tq.bounds, f), getattr(jq.bounds, f))
    _close(tq.p, jq.p)
    _close(tqp.dual_objective(_t(a), _t(y), _t(K)),
           jqp.dual_objective(jnp.asarray(a), jnp.asarray(y),
                              jnp.asarray(K)))
    _close(tqp.gradient(_t(a), _t(y), _t(K)),
           jqp.gradient(jnp.asarray(a), jnp.asarray(y), jnp.asarray(K)))
    tb = tqp.Bounds(_t(s["L"][0]), _t(s["U"][0]))
    jb = jqp.Bounds(jnp.asarray(s["L"][0]), jnp.asarray(s["U"][0]))
    for tol in (0.0, 0.1):
        assert np.array_equal(_np(tqp.up_mask(_t(a), tb, tol)),
                              np.asarray(jqp.up_mask(jnp.asarray(a), jb,
                                                     tol)))
        assert np.array_equal(_np(tqp.down_mask(_t(a), tb, tol)),
                              np.asarray(jqp.down_mask(jnp.asarray(a), jb,
                                                       tol)))
    # lane-batched: one row per lane
    A = _t(s["alpha"][:2])
    P = _t(np.stack([y, -y]))
    _close(tqp.dual_objective(A, P, _t(K))[1],
           jqp.dual_objective(jnp.asarray(s["alpha"][1]), jnp.asarray(-y),
                              jnp.asarray(K)))


# ---------------------------------------------------------------------------
# solve against the reference's classic engine
# ---------------------------------------------------------------------------

VARIANTS = {
    "smo": dict(algorithm="smo"),
    "pasmo": dict(algorithm="pasmo"),
    "pasmo_simple": dict(algorithm="pasmo_simple"),
    "overshoot": dict(algorithm="overshoot"),
    "plan3": dict(algorithm="pasmo", plan_candidates=3),
    "mvp": dict(wss="mvp"),
    "shrink8": dict(shrink_every=8),
    "conjugate": dict(algorithm="smo", step="conjugate"),
}


def _solve_both(X, y, C, gamma, kw, **tkw):
    K = _rbf(X, gamma)
    rj = js.solve(jqp.PrecomputedKernel(jnp.asarray(K)), jnp.asarray(y), C,
                  js.SolverConfig(eps=EPS, **kw))
    rt = ts.solve(tqp.PrecomputedKernel(_t(K)), _t(y), C,
                  ts.SolverConfig(eps=EPS, **kw), **F64, **tkw)
    return K, rj, rt


def _check_solution(K, y, C, rt, rj):
    assert bool(rt.converged) and float(rt.kkt_gap) <= EPS
    np.testing.assert_allclose(float(rt.objective), float(rj.objective),
                               rtol=1e-6)
    bounds = tqp.make_bounds(_t(y), C)
    assert bool(tqp.is_feasible(rt.alpha, bounds))
    np.testing.assert_allclose(_np(rt.G), y - K @ _np(rt.alpha), atol=1e-9)
    assert float(tqp.kkt_gap(_t(y - K @ _np(rt.alpha)), rt.alpha,
                             bounds)) <= EPS


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_solve_matches_reference_on_blobs(variant):
    X, y, C, gamma = _problem("blobs", 60)
    kw = dict(VARIANTS[variant], record_steps=True)
    K, rj, rt = _solve_both(X, y, C, gamma, kw)
    _check_solution(K, y, C, rt, rj)
    for f in COUNTERS:
        assert int(getattr(rt, f)) == int(getattr(rj, f)), f
    m = min(64, int(rj.iterations))
    for f in ("steps_i", "steps_j"):
        assert np.array_equal(_np(getattr(rt, f))[:m],
                              np.asarray(getattr(rj, f))[:m]), f
    assert rt.alpha.shape == (60,) and rt.iterations.ndim == 0
    if variant in ("pasmo", "plan3", "conjugate", "pasmo_simple"):
        assert int(rt.n_planning) > 0


def _replay(K, y, steps_i, steps_j, steps_mu, t):
    alpha, G = np.zeros(len(y)), y.astype(np.float64).copy()
    for i, j, mu in zip(steps_i[:t], steps_j[:t], steps_mu[:t]):
        alpha[i] += mu
        alpha[j] -= mu
        G -= mu * (K[i] - K[j])
    return alpha, G


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name,n", [("blobs", 96), ("xor", 60)])
def test_solve_leaves_the_reference_path_only_at_a_rounding_tie(variant,
                                                                name, n):
    X, y, C, gamma = _problem(name, n)
    kw = dict(VARIANTS[variant], record_steps=True)
    K, rj, rt = _solve_both(X, y, C, gamma, kw)
    _check_solution(K, y, C, rt, rj)
    t = min(int(rj.iterations), int(rt.iterations), 4096)
    ji, jj, jm = (np.asarray(getattr(rj, f))[:t]
                  for f in ("steps_i", "steps_j", "steps_mu"))
    ti, tj, tm = (_np(getattr(rt, f))[:t]
                  for f in ("steps_i", "steps_j", "steps_mu"))
    d = np.nonzero((ji != ti) | (jj != tj)
                   | (np.abs(jm - tm) > 1e-9 * np.maximum(1.0, np.abs(jm))))[0]
    # a step size that left first is a planning or conjugate acceptance
    # decided at its border (covered by the optimum above); the conjugate
    # step's second direction is not recorded, so its state is not replayed
    if len(d) == 0 or (ji[d[0]], jj[d[0]]) == (ti[d[0]], tj[d[0]]) \
            or variant == "conjugate":
        return
    # the port's own state at the first divergence: i is an argmax of G
    # over I_up and j (WSS2) of the Newton gain, so a flip is a tie there
    t0 = int(d[0])
    _, G = _replay(K, y, ti, tj, tm, t0)
    a, b = (int(ji[t0]), int(jj[t0])), (int(ti[t0]), int(tj[t0]))
    if a[0] != b[0]:
        scale = max(1.0, abs(G[a[0]]), abs(G[b[0]]))
        assert abs(G[a[0]] - G[b[0]]) <= 1e-8 * scale, (t0, a, b)
    elif VARIANTS[variant].get("wss") != "mvp":
        def gain(i, j):
            q = max(K[i, i] - 2 * K[i, j] + K[j, j], tqp.TAU)
            return 0.5 * (G[i] - G[j]) ** 2 / q

        g1, g2 = gain(*a), gain(*b)
        assert abs(g1 - g2) <= 1e-6 * max(abs(g1), abs(g2)), (t0, a, b)


def test_record_trace_matches_reference():
    X, y, C, gamma = _problem("blobs", 96)
    kw = dict(algorithm="pasmo", record_trace=True, trace_cap=32)
    _, rj, rt = _solve_both(X, y, C, gamma, kw)
    assert int(rt.n_trace) == int(rj.n_trace) == int(rt.n_planning)
    assert rt.trace.shape == (32,)
    np.testing.assert_allclose(_np(rt.trace), np.asarray(rj.trace),
                               rtol=1e-9)
    m = min(32, int(rt.n_trace))
    assert bool((rt.trace[:m] != 0).all())
    # capped: the last slot holds the newest ratio past the cap
    kw["trace_cap"] = 4
    _, rj, rt = _solve_both(X, y, C, gamma, kw)
    assert int(rt.n_trace) == int(rj.n_trace) > 4
    np.testing.assert_allclose(_np(rt.trace), np.asarray(rj.trace),
                               rtol=1e-9)


@pytest.mark.parametrize("name,n", [("xor", 60), ("ring", 50),
                                    ("chess", 60), ("xor", 96)])
@pytest.mark.parametrize("alg", ["smo", "pasmo"])
def test_solve_takes_the_numpy_reference_path(name, n, alg):
    X, y, C, gamma = _problem(name, n)
    K = _rbf(X, gamma)
    fn = ref.solve_smo if alg == "smo" else ref.solve_pasmo
    r = fn(K, y, C, eps=EPS, tie="first", record_steps=True)
    rt = ts.solve(tqp.PrecomputedKernel(_t(K)), _t(y), C,
                  ts.SolverConfig(algorithm=alg, eps=EPS, record_steps=True,
                                  step_cap=4096), **F64)
    t = int(rt.iterations)
    assert r.converged and bool(rt.converged) and t == r.iterations
    steps = np.array([(s[0], s[1]) for s in r.steps])
    assert np.array_equal(_np(rt.steps_i)[:t], steps[:, 0])
    assert np.array_equal(_np(rt.steps_j)[:t], steps[:, 1])
    np.testing.assert_allclose(_np(rt.steps_mu)[:t],
                               [s[2] for s in r.steps], rtol=1e-9,
                               atol=1e-12)
    assert (int(rt.n_planning), int(rt.n_free), int(rt.n_clipped)) == (
        r.n_planning, r.n_free, r.n_clipped)
    np.testing.assert_allclose(float(rt.objective), r.objective, rtol=1e-9)


def test_plan_candidates_matches_numpy_reference_optimum():
    X, y, C, gamma = _problem("xor", 50)
    K = _rbf(X, gamma)
    r = ref.solve_pasmo_multi(K, y, C, N=3, eps=EPS, tie="first")
    rt = ts.solve(tqp.PrecomputedKernel(_t(K)), _t(y), C,
                  ts.SolverConfig(plan_candidates=3, eps=EPS), **F64)
    assert r.converged and bool(rt.converged)
    np.testing.assert_allclose(float(rt.objective), r.objective, rtol=1e-6)


# ---------------------------------------------------------------------------
# lanes: solve_batched, solve_ovr, the frozen lane and max_iter
# ---------------------------------------------------------------------------


def _ovr_problem(n=72, k=3, seed=0):
    X, y = multiclass_blobs(n, seed=seed, k=k, d=3, sep=3.0)
    Y = np.where(y[None, :] == np.arange(k)[:, None], 1.0, -1.0)
    return X, Y, _rbf(X, 0.5)


def _check_lanes(rt, rj, counters=True):
    assert bool(rt.converged.all()) and float(rt.kkt_gap.max()) <= EPS
    np.testing.assert_allclose(_np(rt.objective), np.asarray(rj.objective),
                               rtol=1e-6)
    if counters:
        for f in COUNTERS:
            assert np.array_equal(_np(getattr(rt, f)),
                                  np.asarray(getattr(rj, f))), f


@pytest.mark.parametrize("C", ["scalar", "per_class", "per_sample"])
def test_solve_ovr_matches_reference(C):
    X, Y, K = _ovr_problem()
    k, l = Y.shape
    Cv = {"scalar": 2.0, "per_class": np.array([0.5, 2.0, 8.0]),
          "per_sample": np.random.default_rng(0).choice([0.5, 4.0],
                                                        size=(k, l))}[C]
    cfg = dict(eps=EPS, algorithm="pasmo")
    rj = jmc.solve_ovr(jqp.PrecomputedKernel(jnp.asarray(K)), jnp.asarray(Y),
                       jnp.asarray(Cv), js.SolverConfig(**cfg))
    rt = tmc.solve_ovr(tqp.PrecomputedKernel(_t(K)), _t(Y), Cv,
                       ts.SolverConfig(**cfg), **F64)
    assert rt.alpha.shape == (k, l) and rt.iterations.shape == (k,)
    _check_lanes(rt, rj, counters=False)
    Cb = np.broadcast_to(np.asarray(Cv, float).reshape(
        (k, -1) if np.ndim(Cv) else (1, 1)), (k, l))
    for b in range(k):
        bounds = tqp.make_bounds(_t(Y[b]), _t(Cb[b]))
        assert bool(tqp.is_feasible(rt.alpha[b], bounds))
        # each lane takes the numpy transcription's path
        r = ref.solve_pasmo(K, Y[b], Cb[b], eps=EPS, tie="first")
        assert (int(rt.iterations[b]), int(rt.n_planning[b]),
                int(rt.n_free[b]), int(rt.n_clipped[b])) == (
            r.iterations, r.n_planning, r.n_free, r.n_clipped)


def test_solve_batched_matches_reference():
    X, Y, _ = _ovr_problem()
    Ks = np.stack([_rbf(X, g) for g in (0.2, 0.5, 1.5)])
    Cs = np.array([1.0, 4.0, 0.5])
    rj = js.solve_batched(jnp.asarray(Ks), jnp.asarray(Y), jnp.asarray(Cs),
                          js.SolverConfig(eps=EPS))
    rt = ts.solve_batched(Ks, Y, Cs, ts.SolverConfig(eps=EPS), **F64)
    _check_lanes(rt, rj, counters=False)
    for b in range(len(Cs)):
        r = ref.solve_pasmo(Ks[b], Y[b], Cs[b], eps=EPS, tie="first")
        assert (int(rt.iterations[b]), int(rt.n_planning[b])) == (
            r.iterations, r.n_planning)
    rt1 = ts.solve_batched(Ks, Y, 2.0, ts.SolverConfig(eps=EPS), **F64)
    rj1 = js.solve_batched(jnp.asarray(Ks), jnp.asarray(Y), 2.0,
                           js.SolverConfig(eps=EPS))
    _check_lanes(rt1, rj1, counters=False)


@pytest.mark.parametrize("variant", ["pasmo", "conjugate", "shrink8"])
def test_frozen_lane_is_held_bitwise(variant):
    """Lane 0 alone, and beside lanes that run on after it converged (and
    at another host-check cadence): every returned bit the same."""
    X, Y, K = _ovr_problem()
    cfg = ts.SolverConfig(eps=EPS, record_steps=True, record_trace=True,
                          trace_cap=64, step_cap=64, **VARIANTS[variant])
    kern = tqp.PrecomputedKernel(_t(K))
    Cs = _t(np.array([[0.5], [50.0], [8.0]]))
    P = _t(Y)
    L, U = torch.clamp_max(P * Cs, 0.0), torch.clamp_min(P * Cs, 0.0)
    alone = ts.solve_lanes(kern, P[:1], L[:1], U[:1], cfg, check_every=1)
    both = ts.solve_lanes(kern, P, L, U, cfg, check_every=7)
    its = both.iterations
    assert int(its[0]) < int(its.max())          # lane 0 froze first
    for f in dataclasses.fields(ts.SolveResult):
        a, b = getattr(alone, f.name)[0], getattr(both, f.name)[0]
        assert torch.equal(a, b), f.name


@pytest.mark.parametrize("check_every", [1, 7])
def test_max_iter_is_exact_per_lane(check_every):
    X, Y, K = _ovr_problem()
    kern = tqp.PrecomputedKernel(_t(K))
    C = _t(np.array([[0.05], [50.0], [8.0]]))
    P = _t(Y)
    L, U = torch.clamp_max(P * C, 0.0), torch.clamp_min(P * C, 0.0)
    free = ts.solve_lanes(kern, P, L, U, ts.SolverConfig(eps=EPS))
    m = int(free.iterations[1]) - 3
    assert int(free.iterations[0]) < m < int(free.iterations.max())
    cfg = ts.SolverConfig(eps=EPS, max_iter=m)
    r = ts.solve_lanes(kern, P, L, U, cfg, check_every=check_every)
    ref_run = ts.solve_lanes(kern, P, L, U, cfg, check_every=32)
    want = torch.minimum(free.iterations, torch.tensor(m, dtype=torch.int32))
    assert torch.equal(r.iterations, want)
    assert torch.equal(r.converged, free.iterations <= m)
    for f in dataclasses.fields(ts.SolveResult):
        assert torch.equal(getattr(r, f.name), getattr(ref_run, f.name))
    assert torch.equal(r.alpha[0], free.alpha[0])


# ---------------------------------------------------------------------------
# the general dual: ε-SVR through DoubledKernel, one-class from alpha0
# ---------------------------------------------------------------------------


def _regression(n=48, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, 2))
    return X, np.sinc(X[:, 0]) + 0.05 * rng.normal(size=n)


@pytest.mark.parametrize("source", ["precomputed", "stacked", "rbf"])
def test_svr_doubled_matches_reference(source):
    X, y = _regression()
    K = _rbf(X, 0.5)
    jbase = (jqp.make_rbf(jnp.asarray(X), 0.5) if source == "rbf"
             else jqp.PrecomputedKernel(jnp.asarray(K)))
    tbase = {"precomputed": tqp.PrecomputedKernel(_t(K)),
             "stacked": tqp.StackedKernel(_t(np.stack([K, K + 1.0])),
                                          torch.tensor(0)),
             "rbf": tqp.make_rbf(_t(X), 0.5)}[source]
    cfg = dict(eps=EPS, algorithm="smo")
    rj = js.solve_qp(jqp.DoubledKernel(jbase),
                     jqp.svr_qp(jnp.asarray(y), 4.0, 0.1),
                     js.SolverConfig(**cfg))
    rt = ts.solve_qp(tqp.DoubledKernel(tbase), tqp.svr_qp(_t(y), 4.0, 0.1),
                     ts.SolverConfig(**cfg), **F64)
    assert bool(rt.converged) and float(rt.kkt_gap) <= EPS
    np.testing.assert_allclose(float(rt.objective), float(rj.objective),
                               rtol=1e-6)
    assert abs(float(rt.alpha.sum())) <= 1e-8
    a = _np(rt.alpha)
    Qa = K @ (a[:48] + a[48:])
    P = np.concatenate([y - 0.1, y + 0.1])
    np.testing.assert_allclose(_np(rt.G), P - np.concatenate([Qa, Qa]),
                               atol=1e-9)
    if source != "rbf":
        Q, p, lo, hi = ref.doubled_qp(K, y, 4.0, 0.1)
        r = ref.solve_qp_smo(Q, p, lo, hi, eps=EPS, tie="first")
        assert (int(rt.iterations), int(rt.n_free), int(rt.n_clipped)) == (
            r.iterations, r.n_free, r.n_clipped)


@pytest.mark.parametrize("source", ["precomputed", "rbf"])
def test_oneclass_from_alpha0_matches_reference(source):
    X, _ = _regression(seed=1)
    K = _rbf(X, 0.5)
    n, nu = len(X), 0.2
    jk = (jqp.PrecomputedKernel(jnp.asarray(K)) if source == "precomputed"
          else jqp.make_rbf(jnp.asarray(X), 0.5))
    tk = (tqp.PrecomputedKernel(_t(K)) if source == "precomputed"
          else tqp.make_rbf(_t(X), 0.5))
    rj = js.solve_qp(jk, jqp.oneclass_qp(n, nu), js.SolverConfig(eps=EPS),
                     alpha0=jqp.oneclass_alpha0(n, nu))
    rt = ts.solve_qp(tk, tqp.oneclass_qp(n, nu), ts.SolverConfig(eps=EPS),
                     alpha0=tqp.oneclass_alpha0(n, nu), **F64)
    assert bool(rt.converged) and float(rt.kkt_gap) <= EPS
    np.testing.assert_allclose(float(rt.objective), float(rj.objective),
                               rtol=1e-6, atol=1e-12)
    assert abs(float(rt.alpha.sum()) - 1.0) <= 1e-12
    np.testing.assert_allclose(_np(rt.G), -K @ _np(rt.alpha), atol=1e-9)
