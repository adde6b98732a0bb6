"""The doubled ε-SVR operator and the SVR / one-class facades of the port
against the JAX package.

Plain passes with ``dup=True`` (the state of 2l coordinates over the base
``X``) and their per-block forms against ``repro.kernels.ops`` on
``impl="jnp"`` and the Pallas kernels in interpret mode, with a gain tie
between half 0 and half 1 that the lower doubled index must win (also
across blocks, where the per-block winners stop being monotone in the
index), an all-masked lane and a ``mu = 0`` lane; the ``RowSource``
``dup`` suppliers; ``svr_qp``/``svr_fold``; ``solve_grid_svr`` per lane;
the ``SVR``/``OneClassSVM`` facades; the convert functions.  Tolerances:
passes to rtol 1e-12 with indices equal (f64); objectives to rtol 1e-6;
predictions to 1e-8 at a stopping accuracy of 1e-10; ``sum(alpha)``
within 1e-8 of 0 (SVR)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as jgrid
from repro.core import qp as jqp
from repro.core.solver import SolverConfig as JConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import row_source as jrs
from repro.svm import SVR as JSVR
from repro.svm import OneClassSVM as JOneClassSVM
from repro_torch.core import grid
from repro_torch.core import qp as tqp
from repro_torch.core.solver import SolverConfig
from repro_torch.kernels import ops, rbf_row_wss, rbf_update_wss, ref
from repro_torch.kernels import row_source
from repro_torch.svm import (SVR, OneClassSVM, oneclass_from_numpy,
                             svr_from_numpy)

TA, TB = 5, -3            # duplicated points: first and last block


def _dup_state(l, d, B, seed):
    """Doubled pass A/B inputs (f64).  Points TA and l+TB coincide; half 1
    at TA carries the state of half 0 at l+TB, so their gains (and pass
    B's updated G) tie exactly and are the best of every lane; the lower
    doubled index l+TB must win over l+TA.  The last lane of B > 1 is
    all-masked in pass A and has an empty I_up in pass B; lane 0 takes
    mu = 0."""
    rng = np.random.default_rng(seed)
    tb = l + TB
    X = rng.normal(size=(l, d))
    X[tb] = X[TA]
    C = rng.choice([0.5, 1.0, 10.0], size=(B, 1))
    L = np.concatenate([np.zeros((B, l)), -C + np.zeros((B, l))], axis=1)
    U = np.concatenate([C + np.zeros((B, l)), np.zeros((B, l))], axis=1)
    frac = rng.uniform(size=(B, 2 * l))
    frac = np.where(rng.uniform(size=(B, 2 * l)) < 0.4, np.round(frac), frac)
    alpha = L + (U - L) * frac
    G = rng.normal(size=(B, 2 * l))
    G[:, tb] = G.min(axis=1) - 5.0
    alpha[:, tb] = 0.5 * C[:, 0]
    # half 1 at TA: the same state as half 0 at tb (and so the same gain)
    for arr in (G, alpha, L, U):
        arr[:, l + TA] = arr[:, tb]
    i_idx = rng.integers(TA + 1, tb, size=B).astype(np.int32) + l
    lanes = np.arange(B)
    # i's partner i - l shares its base row (k = 1, q = TAU): it is not
    # excluded, and its gain of order 1 / TAU would win; mask it here
    alpha[lanes, i_idx - l] = L[lanes, i_idx - l]
    g_i = G[lanes, i_idx] + 1.0
    use_exact = lanes % 2 == 1
    alpha_b = alpha.copy()
    G_b = G.copy()
    G_b[:, [tb, l + TA]] = G.max(axis=1, keepdims=True) + 5.0
    if B > 1:
        alpha[-1] = L[-1]
        alpha_b[-1] = U[-1]
    j_idx = rng.integers(0, 2 * l, size=B)
    mu = rng.normal(size=B)
    mu[0] = 0.0
    sqn = (X * X).sum(axis=1)
    base = lambda idx: idx % l
    a = dict(X=X, sqn=sqn, G=G, alpha=alpha, L=L, U=U, XQ=X[base(i_idx)],
             sqq=sqn[base(i_idx)], a_i=alpha[lanes, i_idx],
             L_i=L[lanes, i_idx], U_i=U[lanes, i_idx], g_i=g_i, i_idx=i_idx,
             use_exact=use_exact, gammas=rng.uniform(0.05, 0.5, B))
    b = dict(X=X, sqn=sqn, G=G_b, alpha_new=alpha_b, L=L, U=U,
             XQi=X[base(i_idx)], sqqi=sqn[base(i_idx)], XQj=X[base(j_idx)],
             sqqj=sqn[base(j_idx)], mu=mu, gammas=a["gammas"])
    return a, b


PASS_A = ("X", "sqn", "G", "alpha", "L", "U", "XQ", "sqq", "a_i", "L_i",
          "U_i", "g_i", "i_idx", "use_exact", "gammas")
PASS_B = ("X", "sqn", "G", "alpha_new", "L", "U", "XQi", "sqqi", "XQj",
          "sqqj", "mu", "gammas")
DUP_SHAPES = [(300, 16, 1), (257, 5, 3), (130, 4, 9)]


def _t(s, names):
    return [torch.as_tensor(s[k]) for k in names]


def _j(s, names):
    return [jnp.asarray(s[k]) for k in names]


@pytest.mark.parametrize("l,d,B", DUP_SHAPES)
def test_doubled_pass_a_matches_reference(l, d, B):
    a, _ = _dup_state(l, d, B, seed=l + B)
    j_t, gain_t = ops.rbf_row_wss_batched(*_t(a, PASS_A), dup=True)
    for impl in ("jnp", "interpret"):
        j_j, gain_j = jops.rbf_row_wss_batched(*_j(a, PASS_A), impl=impl,
                                               block_l=128, dup=True)
        np.testing.assert_array_equal(j_t.numpy(), np.asarray(j_j))
        np.testing.assert_allclose(gain_t.numpy(), np.asarray(gain_j),
                                   rtol=1e-12)
    # the cross-half tie goes to the lower doubled index in every
    # Newton-gain lane (even lanes; the last lane of B > 1 is all-masked)
    newton = list(range(0, B - (B > 1), 2))
    np.testing.assert_array_equal(j_t.numpy()[newton], l + TB)
    if B > 1:
        assert int(j_t[-1]) == 0 and gain_t[-1].item() == -np.inf
    # the per-block form, reduced across blocks, is the full-row result
    bmax, barg = rbf_row_wss.rbf_row_wss_batched_h2(*_t(a, PASS_A))
    assert bmax.shape == (B, -(-l // 128))
    j_blk, g_blk = ops._first_max(bmax, barg)
    np.testing.assert_array_equal(j_blk.numpy(), j_t.numpy())
    np.testing.assert_array_equal(g_blk.numpy(), gain_t.numpy())


def test_doubled_partner_of_i_is_not_excluded():
    """As in the reference, only ``idx == i`` is masked: i's partner
    i - l (k = 1, q = TAU) is selectable and wins with a finite gain."""
    l = 257
    a, _ = _dup_state(l, 5, 3, seed=3)
    part = a["i_idx"] - l
    lanes = np.arange(3)
    a["alpha"][lanes, part] = 0.5 * a["U"][lanes, part]
    a["G"][lanes, part] = a["g_i"] - 1.0
    j_t, gain_t = ops.rbf_row_wss_batched(*_t(a, PASS_A), dup=True)
    newton = [0, 2]                        # lane 1 takes the exact gain
    np.testing.assert_array_equal(j_t.numpy()[newton], part[newton])
    assert np.isfinite(gain_t.numpy()).all()
    for impl in ("jnp", "interpret"):
        j_j, gain_j = jops.rbf_row_wss_batched(*_j(a, PASS_A), impl=impl,
                                               block_l=128, dup=True)
        np.testing.assert_array_equal(j_t.numpy(), np.asarray(j_j))
        np.testing.assert_allclose(gain_t.numpy(), np.asarray(gain_j),
                                   rtol=1e-12)


def test_doubled_blocks_are_not_monotone_in_the_index():
    """Block 0's winner is the half-1 tie partner l+TA, the last block's
    the half-0 one l+TB < l+TA: a plain argmax over blocks would take the
    first block, the lowest-index rule takes l+TB."""
    l = 300
    a, _ = _dup_state(l, 16, 3, seed=7)
    bmax, barg = rbf_row_wss.rbf_row_wss_batched_h2(*_t(a, PASS_A))
    assert bmax[0, 0] == bmax[0, -1]
    assert int(barg[0, 0]) == l + TA and int(barg[0, -1]) == l + TB
    assert int(ops._first_max(bmax, barg)[0][0]) == l + TB


@pytest.mark.parametrize("l,d,B", DUP_SHAPES)
def test_doubled_pass_b_matches_reference(l, d, B):
    _, b = _dup_state(l, d, B, seed=l + B)
    G_t, i_t, gi_t, gdn_t = ops.rbf_update_wss_batched(*_t(b, PASS_B),
                                                       dup=True)
    np.testing.assert_array_equal(G_t[0].numpy(), b["G"][0])  # mu = 0
    for impl in ("jnp", "interpret"):
        G_j, i_j, gi_j, gdn_j = jops.rbf_update_wss_batched(
            *_j(b, PASS_B), impl=impl, block_l=128, dup=True)
        np.testing.assert_allclose(G_t.numpy(), np.asarray(G_j), rtol=1e-12,
                                   atol=1e-12 * np.abs(b["G"]).max())
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_allclose(gi_t.numpy(), np.asarray(gi_j),
                                   rtol=1e-12)
        np.testing.assert_allclose(gdn_t.numpy(), np.asarray(gdn_j),
                                   rtol=1e-12)
    if B > 1:
        assert int(i_t[-1]) == 0 and gi_t[-1].item() == -np.inf
    G_blk, bmax, barg, bmin = rbf_update_wss.rbf_update_wss_batched_h2(
        *_t(b, PASS_B))
    i_blk, gi_blk = ops._first_max(bmax, barg)
    for got, want in zip((G_blk, i_blk, gi_blk, bmin.amin(dim=1)),
                         (G_t, i_t, gi_t, gdn_t)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_doubled_pass_b_cross_half_tie_takes_the_lower_index():
    l = 300
    _, b = _dup_state(l, 16, 2, seed=7)
    G_t, i_t, _, _ = ops.rbf_update_wss_batched(*_t(b, PASS_B), dup=True)
    assert G_t[0, l + TB] == G_t[0, l + TA]     # the planted tie holds
    assert int(i_t[0]) == l + TB
    G_blk, bmax, barg, _ = rbf_update_wss.rbf_update_wss_batched_h2(
        *_t(b, PASS_B))
    assert int(barg[0, 0]) == l + TA and int(barg[0, -1]) == l + TB


@pytest.mark.parametrize("impl", ["jnp", "interpret"])
def test_doubled_bank_passes_match_reference(impl):
    a, b = _dup_state(257, 5, 3, seed=2)
    X = torch.as_tensor(a["X"])
    gram = torch.stack([ref.gram_cross(X, X, g) for g in (0.2, 0.7)])
    gidx = torch.tensor([1, 0, 1])
    keys = ("G", "alpha", "L", "U", "a_i", "L_i", "U_i", "g_i", "i_idx",
            "use_exact")
    j_t, g_t = ops.row_wss_batched_bank(gram, gidx, *_t(a, keys), dup=True)
    KR = jnp.asarray(gram.numpy())[jnp.asarray([1, 0, 1]),
                                   jnp.asarray(a["i_idx"] % 257)]
    j_j, g_j = jops.row_wss_batched_rows(KR, *_j(a, keys[:-2]),
                                         jnp.asarray(a["i_idx"]),
                                         jnp.asarray(a["use_exact"]),
                                         impl=impl, block_l=128, dup=True)
    np.testing.assert_array_equal(j_t.numpy(), np.asarray(j_j))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12)
    i_idx = torch.as_tensor(a["i_idx"])
    j_idx = torch.tensor([3, 400, 256], dtype=torch.int32)
    out_t = ops.update_wss_batched_bank(
        gram, gidx, *_t(b, ("G", "alpha_new", "L", "U")), i_idx, j_idx,
        torch.as_tensor(b["mu"]), dup=True)
    rows = jnp.asarray(gram.numpy())[jnp.asarray([1, 0, 1, 1, 0, 1]),
                                     jnp.asarray(np.concatenate(
                                         [a["i_idx"], [3, 400, 256]]) % 257)]
    out_j = jops.update_wss_batched_rows(
        rows[:3], rows[3:], *_j(b, ("G", "alpha_new", "L", "U", "mu")),
        impl=impl, block_l=128, dup=True)
    for got, want in zip(out_t, out_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-13)


def test_doubled_bank_passes_on_the_card_backend_match_plain(monkeypatch):
    """``impl="cuda"`` on CPU tensors raises; routed to the card's H = 2
    bank wrappers (which run their plain per-block versions on CPU
    tensors) the doubled bank lanes give the plain backend's picks."""
    a, b = _dup_state(40, 3, 2, seed=1)
    gram = torch.as_tensor(ref.gram_cross(torch.as_tensor(a["X"]),
                                          torch.as_tensor(a["X"]), 0.3))
    gram = torch.stack([gram, gram * 0.5])
    gidx = torch.tensor([1, 0])
    keys = ("G", "alpha", "L", "U", "a_i", "L_i", "U_i", "g_i", "i_idx",
            "use_exact")
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.row_wss_batched_bank(gram, gidx, *_t(a, keys), impl="cuda",
                                 dup=True)
    want_a = ops.row_wss_batched_bank(gram, gidx, *_t(a, keys),
                                      impl="torch", dup=True)
    args_b = (gram, gidx, *_t(b, ("G", "alpha_new", "L", "U")),
              torch.as_tensor(a["i_idx"]), torch.tensor([3, 77],
                                                        dtype=torch.int32),
              torch.as_tensor(b["mu"]))
    want_b = ops.update_wss_batched_bank(*args_b, impl="torch", dup=True)
    monkeypatch.setattr(ops, "resolve_impl", lambda impl, device: "cuda")
    got_a = ops.row_wss_batched_bank(gram, gidx, *_t(a, keys), dup=True)
    got_b = ops.update_wss_batched_bank(*args_b, dup=True)
    for got, want in zip(got_a + got_b, want_a + want_b):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def _sources(dup_bank):
    rng = np.random.default_rng(4)
    l, d, B = 50, 3, 3
    X = rng.normal(size=(l, d))
    gammas = np.array([0.3, 0.3, 1.1])
    if dup_bank:
        gram = np.stack([np.asarray(jref.gram(jnp.asarray(X), g))
                         for g in (0.3, 1.1)])
        gidx = np.array([0, 0, 1])
        t = row_source.bank_source(torch.as_tensor(gram), gidx, gammas,
                                   dup=True)
        j = jrs.bank_source(jnp.asarray(gram), jnp.asarray(gidx),
                            jnp.asarray(gammas), dup=True)
    else:
        t = row_source.rbf_source(torch.as_tensor(X), gammas, B, dup=True)
        j = jrs.rbf_source(jnp.asarray(X), jnp.asarray(gammas), B, dup=True)
    return t, j, l, B


@pytest.mark.parametrize("bank", [False, True])
def test_row_source_dup_matches_reference(bank):
    t, j, l, B = _sources(bank)
    idx = np.array([3, l + 3, 2 * l - 1, 0, l, 7], dtype=np.int32)
    q_t, q_j = t.query(torch.as_tensor(idx)), j.query(jnp.asarray(idx))
    for a_, b_ in zip((q_t,) if bank else q_t, (q_j,) if bank else q_j):
        np.testing.assert_allclose(a_.numpy(), np.asarray(b_), rtol=1e-12)
    b_idx = np.array([l + 3, 3, 9, l + 40, 1, 2 * l - 2], dtype=np.int32)
    np.testing.assert_allclose(
        t.entry_pairs(torch.as_tensor(idx), torch.as_tensor(b_idx),
                      2).numpy(),
        np.asarray(j.entry_pairs(jnp.asarray(idx), jnp.asarray(b_idx), 2)),
        rtol=1e-12)
    # a coordinate and its partner k + l share the base row: K = 1
    same = t.entry_pairs(torch.tensor([3, 3, 3]),
                         torch.tensor([l + 3, l + 3, l + 3]), 1)
    np.testing.assert_allclose(same.numpy(), 1.0, rtol=1e-14)
    v = np.random.default_rng(5).normal(size=(B, 2 * l))
    np.testing.assert_allclose(t.matvec(torch.as_tensor(v), block=16).numpy(),
                               np.asarray(j.matvec(jnp.asarray(v))),
                               rtol=1e-10, atol=1e-12)


def test_svr_qp_and_fold_match_reference():
    rng = np.random.default_rng(6)
    y = rng.normal(size=23)
    for C in (2.5, rng.uniform(0.5, 3.0, 23)):
        q_t = tqp.svr_qp(torch.as_tensor(y), C, 0.15)
        q_j = jqp.svr_qp(jnp.asarray(y), C, 0.15)
        for got, want in ((q_t.p, q_j.p), (q_t.bounds.lower, q_j.bounds.lower),
                          (q_t.bounds.upper, q_j.bounds.upper)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    a = rng.normal(size=(2, 3, 46))
    np.testing.assert_array_equal(tqp.svr_fold(torch.as_tensor(a)).numpy(),
                                  np.asarray(jqp.svr_fold(jnp.asarray(a))))


def _svr_problem(l=40, d=3, seed=0):
    """The shapes of the reference's own ε-SVR tests."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(l, d))
    y = np.sinc(X[:, 0]) + 0.1 * rng.normal(size=l)
    return X, y, 0.7, 5.0, 0.05


def _oneclass_problem(l=60, d=2, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(l, d))
    X[:5] += 4.0                       # planted outliers
    return X, 0.3, 0.5


TIGHT = 1e-10


@pytest.mark.parametrize("precompute", [True, False])
def test_svr_facade_matches_reference(precompute):
    X, y, gamma, C, epsilon = _svr_problem()
    Xq = np.random.default_rng(8).normal(size=(15, 3))
    t = SVR(C=C, epsilon=epsilon, gamma=gamma, eps=TIGHT,
            precompute=precompute, device="cpu",
            dtype=torch.float64).fit(X, y)
    j = JSVR(C=C, epsilon=epsilon, gamma=gamma, eps=TIGHT, impl="jnp",
             precompute=precompute, dtype=jnp.float64).fit(X, y)
    r = t.fit_result_
    assert bool(r.converged) and float(r.kkt_gap) <= TIGHT
    assert t.alpha_.shape == (80,) and t.beta_.shape == (40,)
    np.testing.assert_allclose(float(r.objective),
                               float(j.fit_result_.objective), rtol=1e-6)
    assert abs(float(t.alpha_.sum())) <= 1e-8
    q = tqp.svr_qp(torch.as_tensor(y), C, epsilon)
    assert bool(((t.alpha_ >= q.bounds.lower - 1e-12)
                 & (t.alpha_ <= q.bounds.upper + 1e-12)).all())
    np.testing.assert_allclose(t.predict(Xq).numpy(),
                               np.asarray(j.predict(Xq)), rtol=0, atol=1e-8)
    assert abs(t.score(X, y) - j.score(X, y)) <= 1e-8
    # the carried gradient is p - Q alpha of the doubled operator
    K = ref.gram_cross(torch.as_tensor(X), torch.as_tensor(X), gamma)
    Qa = (K @ t.beta_).repeat(2)
    np.testing.assert_allclose(r.G.numpy(), (q.p - Qa).numpy(), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("precompute", [True, False])
def test_oneclass_facade_matches_reference(precompute):
    X, nu, gamma = _oneclass_problem()
    Xq = np.random.default_rng(9).normal(size=(15, 2)) * 2.0
    t = OneClassSVM(nu=nu, gamma=gamma, eps=TIGHT, precompute=precompute,
                    device="cpu", dtype=torch.float64).fit(X)
    j = JOneClassSVM(nu=nu, gamma=gamma, eps=TIGHT, impl="jnp",
                     precompute=precompute, dtype=jnp.float64).fit(X)
    r = t.fit_result_
    assert bool(r.converged) and float(r.kkt_gap) <= TIGHT
    np.testing.assert_allclose(float(r.objective),
                               float(j.fit_result_.objective), rtol=1e-6)
    assert abs(float(t.alpha_.sum()) - 1.0) <= 1e-12
    df_t = t.decision_function(Xq).numpy()
    np.testing.assert_allclose(df_t, np.asarray(j.decision_function(Xq)),
                               rtol=0, atol=1e-8)
    clear = np.abs(df_t) > 1e-6           # away from the surface itself
    np.testing.assert_array_equal(t.predict(Xq)[clear],
                                  np.asarray(j.predict(Xq))[clear])
    assert t.rho_ == pytest.approx(j.rho_, abs=1e-8)


@pytest.mark.parametrize("precompute", [None, False])
def test_solve_grid_svr_matches_reference(precompute):
    X, y, _, _, _ = _svr_problem()
    Cs, epss, gammas = [4.0, 0.5], [0.05, 0.2], [0.3, 1.0]
    cfg = 1e-5
    r_t = grid.solve_grid_svr(X, y, Cs, epss, gammas, SolverConfig(eps=cfg),
                              precompute=precompute, device="cpu",
                              dtype=torch.float64)
    r_j = jgrid.solve_grid_svr(jnp.asarray(X), jnp.asarray(y), Cs, epss,
                               gammas, JConfig(eps=cfg, max_iter=200_000),
                               impl="jnp", precompute=precompute)
    assert r_t.alpha.shape == (2, 2, 2, 80) == np.shape(r_j.alpha)
    assert bool(r_t.converged.all())
    np.testing.assert_array_equal(r_t.converged.numpy(),
                                  np.asarray(r_j.converged))
    np.testing.assert_allclose(r_t.objective.numpy(),
                               np.asarray(r_j.objective), rtol=1e-6)
    assert float(r_t.kkt_gap.max()) <= cfg
    assert float(r_t.alpha.sum(-1).abs().max()) <= 1e-8
    # every lane is the facade's problem at its (gamma, eps, C)
    for g, e, c in ((0, 1, 0), (1, 0, 1)):
        q = tqp.svr_qp(torch.as_tensor(y), Cs[c], epss[e])
        a = r_t.alpha[g, e, c]
        assert bool(((a >= q.bounds.lower) & (a <= q.bounds.upper)).all())


def test_solve_grid_svr_bank_matches_rbf_and_interpret():
    X, y, _, _, _ = _svr_problem(l=32)
    args = ([2.0], [0.1], [0.5])
    cfg = SolverConfig(eps=1e-5)
    r_b = grid.solve_grid_svr(X, y, *args, cfg, precompute=True,
                              device="cpu", dtype=torch.float64)
    r_r = grid.solve_grid_svr(X, y, *args, cfg, precompute=False,
                              device="cpu", dtype=torch.float64)
    r_i = jgrid.solve_grid_svr(jnp.asarray(X), jnp.asarray(y), *args,
                               JConfig(eps=1e-5, max_iter=200_000),
                               impl="interpret", block_l=128,
                               precompute=False)
    for r in (r_r, r_i):
        np.testing.assert_allclose(r_b.objective.numpy(),
                                   np.asarray(r.objective), rtol=1e-6)


def test_solve_grid_svr_precompute_on_the_card_matches_plain(monkeypatch):
    """``solve_grid_svr(precompute=True)`` on the card's backend: routed
    through the CUDA dispatch (the H = 2 bank wrappers and the Gram
    wrapper, which run their plain versions on CPU tensors) it gives the
    plain backend's result."""
    X, y, _, _, _ = _svr_problem(l=16)
    kw = dict(precompute=True, device="cpu", dtype=torch.float64)
    want = grid.solve_grid_svr(X, y, [1.0], [0.1], [0.5], impl="torch", **kw)
    monkeypatch.setattr(ops, "resolve_impl", lambda impl, device: "cuda")
    got = grid.solve_grid_svr(X, y, [1.0], [0.1], [0.5], **kw)
    assert bool(got.converged.all())
    np.testing.assert_array_equal(got.alpha.numpy(), want.alpha.numpy())
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  want.iterations.numpy())


def test_convert_svr_and_oneclass_predict_like_the_reference():
    X, y, gamma, C, epsilon = _svr_problem()
    Xq = np.random.default_rng(10).normal(size=(12, 3))
    j = JSVR(C=C, epsilon=epsilon, gamma=gamma, impl="jnp",
             dtype=jnp.float64).fit(X, y)
    for coef in (j.alpha_, j.beta_):
        t = svr_from_numpy(np.asarray(j.X_), np.asarray(coef),
                           np.asarray(j.b_), j.gamma_, device="cpu",
                           dtype=torch.float64)
        np.testing.assert_allclose(t.predict(Xq).numpy(),
                                   np.asarray(j.predict(Xq)), rtol=1e-12,
                                   atol=1e-12)
    with pytest.raises(ValueError, match="alpha must be"):
        svr_from_numpy(X, np.zeros(7), 0.0, gamma, device="cpu")
    Xo, nu, gamma_o = _oneclass_problem()
    jo = JOneClassSVM(nu=nu, gamma=gamma_o, impl="jnp",
                      dtype=jnp.float64).fit(Xo)
    to = oneclass_from_numpy(np.asarray(jo.X_), np.asarray(jo.alpha_),
                             np.asarray(jo.b_), jo.gamma_, device="cpu",
                             dtype=torch.float64)
    np.testing.assert_allclose(to.decision_function(Xo).numpy(),
                               np.asarray(jo.decision_function(Xo)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(to.predict(Xo), np.asarray(jo.predict(Xo)))
    assert to.rho_ == jo.rho_
