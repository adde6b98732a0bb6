"""repro_torch step algebra and QP helpers against the JAX reference,
elementwise on seeded arrays (f64, rtol 1e-12; booleans exactly).

The inputs mix free and clipped steps, curvature below TAU (including 0
and negative values) and degenerate 2x2 minors (det <= TAU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qp as jqp
from repro.core import step as jstep
from repro_torch.core import qp as tqp
from repro_torch.core import step as tstep

RTOL = 1e-12
N = 96


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    y = rng.choice([-1.0, 1.0], size=(2, N))
    C = rng.choice([0.5, 1.0, 10.0], size=(2, N))
    lo, hi = np.minimum(0.0, y * C), np.maximum(0.0, y * C)
    frac = rng.uniform(size=(2, N))
    # a third of the coordinates sit on a bound
    frac = np.where(rng.uniform(size=(2, N)) < 0.33, np.round(frac), frac)
    a = lo + (hi - lo) * frac
    Qtt = rng.uniform(0.0, 4.0, N)
    Qtt[:8] = [0.0, -1.0, 1e-13, 5e-13, 1e-12, 2e-12, -1e-14, 1e-15]
    Q11 = rng.uniform(0.1, 4.0, N)
    Q22 = rng.uniform(0.1, 4.0, N)
    Q12 = rng.uniform(-1.0, 1.0, N) * np.sqrt(Q11 * Q22)
    # degenerate minors: parallel directions, vanishing Q22
    Q12[:10] = np.sqrt(Q11[:10] * Q22[:10])
    Q22[10:14] = [0.0, 1e-13, -1.0, 1e-12]
    return dict(ai=a[0], aj=a[1], Li=lo[0], Ui=hi[0], Lj=lo[1], Uj=hi[1],
                l=rng.normal(scale=2.0, size=N), Qtt=Qtt,
                mu=rng.normal(scale=3.0, size=N),
                w1=rng.normal(size=N), w2=rng.normal(size=N),
                Q11=Q11, Q22=Q22, Q12=Q12)


def _bounds(m, a):
    return m.step_bounds(a["ai"], a["aj"], a["Li"], a["Ui"], a["Lj"],
                         a["Uj"])


def _terms(m, a):
    return m.PlanningTerms(w1=a["w1"], w2=a["w2"], Q11=a["Q11"],
                           Q22=a["Q22"], Q12=a["Q12"])


STEP_CASES = {
    "step_bounds": lambda m, a: tuple(_bounds(m, a)),
    "newton_step": lambda m, a: (m.newton_step(a["l"], a["Qtt"]),),
    "clip_step": lambda m, a: (m.clip_step(a["mu"], _bounds(m, a)),),
    "smo_step": lambda m, a: m.smo_step(a["l"], a["Qtt"], _bounds(m, a)),
    "gain_newton": lambda m, a: (m.gain_newton(a["l"], a["Qtt"]),),
    "gain_of_step": lambda m, a: (m.gain_of_step(a["mu"], a["l"],
                                                 a["Qtt"]),),
    "planning_step": lambda m, a: m.planning_step(_terms(m, a)),
    "planned_second_step": lambda m, a: (m.planned_second_step(
        m.planning_step(_terms(m, a))[0], _terms(m, a)),),
    "double_step_gain": lambda m, a: (m.double_step_gain(a["mu"],
                                                         _terms(m, a)),),
    "conjugate_step": lambda m, a: m.conjugate_step(_terms(m, a)),
    "overshoot_step": lambda m, a: m.overshoot_step(a["l"], a["Qtt"],
                                                    _bounds(m, a)),
}


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()
        w = np.asarray(w)
        assert g.shape == w.shape
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_step_algebra_matches_reference(name):
    a = _inputs()
    want = STEP_CASES[name](jstep, {k: jnp.asarray(v) for k, v in a.items()})
    got = STEP_CASES[name](tstep, {k: torch.as_tensor(v)
                                   for k, v in a.items()})
    _assert_same(got, want)


def test_inputs_cover_clipped_free_and_degenerate_cases():
    a = {k: torch.as_tensor(v) for k, v in _inputs().items()}
    _, free = tstep.smo_step(a["l"], a["Qtt"], _bounds(tstep, a))
    assert 0 < int(free.sum()) < N
    _, ok = tstep.planning_step(_terms(tstep, a))
    assert 0 < int(ok.sum()) < N
    assert bool((a["Qtt"] <= tqp.TAU).any())


def _qp_inputs(seed=1):
    rng = np.random.default_rng(seed)
    y = rng.choice([-1.0, 1.0], size=N)
    C = rng.choice([0.5, 2.0], size=N)
    lo, hi = np.minimum(0.0, y * C), np.maximum(0.0, y * C)
    frac = rng.uniform(size=N)
    frac = np.where(rng.uniform(size=N) < 0.4, np.round(frac), frac)
    alpha = lo + (hi - lo) * frac
    alpha -= alpha.sum() / N * (hi > lo)   # near the equality constraint
    return dict(y=y, C=C, alpha=alpha, G=rng.normal(size=N),
                active=rng.uniform(size=N) < 0.7)


@pytest.mark.parametrize("C_kind", ["scalar", "vector"])
def test_make_bounds_matches_reference(C_kind):
    a = _qp_inputs()
    C = 3.0 if C_kind == "scalar" else a["C"]
    jb = jqp.make_bounds(jnp.asarray(a["y"]),
                         C if C_kind == "scalar" else jnp.asarray(C))
    tb = tqp.make_bounds(torch.as_tensor(a["y"]),
                         C if C_kind == "scalar" else torch.as_tensor(C))
    _assert_same((tb.lower, tb.upper), (jb.lower, jb.upper))


@pytest.mark.parametrize("masked", [False, True])
def test_kkt_gap_matches_reference(masked):
    a = _qp_inputs()
    jb = jqp.make_bounds(jnp.asarray(a["y"]), jnp.asarray(a["C"]))
    tb = tqp.make_bounds(torch.as_tensor(a["y"]), torch.as_tensor(a["C"]))
    want = jqp.kkt_gap(jnp.asarray(a["G"]), jnp.asarray(a["alpha"]), jb,
                       jnp.asarray(a["active"]) if masked else None)
    got = tqp.kkt_gap(torch.as_tensor(a["G"]), torch.as_tensor(a["alpha"]),
                      tb, torch.as_tensor(a["active"]) if masked else None)
    _assert_same((got,), (want,))


def test_finite_gap_and_safe_bias_match_reference():
    inf = np.inf
    g_up = np.array([1.0, -inf, 0.5, -inf, 2.0, -0.25])
    g_dn = np.array([0.5, 0.3, inf, inf, -1.0, -0.75])
    gap = np.array([0.1, -inf, inf, np.nan, 0.0, 3.0])
    _assert_same((tqp.finite_gap(torch.as_tensor(gap)),),
                 (jqp.finite_gap(jnp.asarray(gap)),))
    _assert_same((tqp.safe_bias(torch.as_tensor(g_up),
                                torch.as_tensor(g_dn)),),
                 (jqp.safe_bias(jnp.asarray(g_up), jnp.asarray(g_dn)),))


@pytest.mark.parametrize("shift", [0.0, 1e-3, 5.0])
def test_is_feasible_matches_reference(shift):
    a = _qp_inputs()
    alpha = a["alpha"].copy()
    alpha[0] += shift
    jb = jqp.make_bounds(jnp.asarray(a["y"]), jnp.asarray(a["C"]))
    tb = tqp.make_bounds(torch.as_tensor(a["y"]), torch.as_tensor(a["C"]))
    want = bool(jqp.is_feasible(jnp.asarray(alpha), jb, atol=1e-2))
    got = bool(tqp.is_feasible(torch.as_tensor(alpha), tb, atol=1e-2))
    assert got == want
