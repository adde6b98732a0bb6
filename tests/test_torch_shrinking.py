"""Active-set shrinking in the port against the JAX package: the shrink
rule, the plain passes with an ``act`` mask (one state half and the doubled
ε-SVR operator, rbf and bank rows) against ``repro.kernels.ops`` on
``impl="jnp"`` and the Pallas kernels in interpret mode (``block_l=64``),
soft shrinking in the fused loop (the (C, gamma), ε-SVR and one-class
grids, a forced unshrink, a refresh that does not depend on the host's
check cadence) and hard compaction in the chunked driver.

Tolerances: ``shrink_mask`` exactly; passes to rtol 1e-12 with indices
equal (f64); objectives to rtol 1e-6 at eps 1e-5, every lane converged
with its full-set gap at most eps; the compacted run's G equal to
``p - Q alpha`` to 1e-9."""

import dataclasses
import functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as jgrid
from repro.core import qp as jqp
from repro.core import solver as jsolver
from repro.core import solver_fused as jsf
from repro.kernels import ops as jops
from repro.svm.data import chessboard, xor_gaussians
from repro_torch.core import grid
from repro_torch.core import qp as tqp
from repro_torch.core import solver as tsolver
from repro_torch.core import solver_fused as tsf
from repro_torch.core.solver import SolverConfig
from repro_torch.kernels import ops, rbf_row_wss, rbf_update_wss

CFG = SolverConfig(eps=1e-5, max_iter=200_000)
JCFG = jsolver.SolverConfig(eps=1e-5, max_iter=200_000)
F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-12


def _obj_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _lanes_ok(res, eps=CFG.eps):
    assert bool(res.converged.all())
    gap = res.kkt_gap.numpy()
    assert np.all(np.isfinite(gap)) and float(gap.max()) <= eps
    assert np.all(np.isfinite(res.b.numpy()))


# ---------------------------------------------------------------------------
# the shrink rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(37,), (4, 50), (2, 3, 21)])
def test_shrink_mask_matches_reference(shape):
    """Elementwise equal on seeded states with one-sided boxes (labels
    times C), a third of the variables at a bound (their G pushed away
    from the gap, so some leave the set), and a lane pinned wholly at its
    lower bound (an empty I_down)."""
    rng = np.random.default_rng(sum(shape))
    y = rng.choice([-1.0, 1.0], size=shape)
    C = rng.choice([0.5, 4.0], size=shape[:-1] + (1,))
    L, U = np.minimum(0.0, y * C), np.maximum(0.0, y * C)
    frac = rng.uniform(size=shape)
    frac = np.where(rng.uniform(size=shape) < 0.35, np.round(frac), frac)
    alpha = L + (U - L) * frac
    if len(shape) > 1:
        alpha.reshape(-1, shape[-1])[0] = L.reshape(-1, shape[-1])[0]
    # bound variables lean away from the gap, so some leave the set
    G = (rng.normal(size=shape) - 2.0 * (alpha <= L) + 2.0 * (alpha >= U))
    got = tqp.shrink_mask(*(torch.as_tensor(a) for a in (G, alpha, L, U)))
    want = jqp.shrink_mask(*(jnp.asarray(a) for a in (G, alpha, L, U)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()


def test_resolve_shrink_cfg_matches_reference():
    for every in (0, 9):
        for knob in (None, True, False):
            got = tsolver.resolve_shrink_cfg(
                dataclasses.replace(CFG, shrink_every=every), knob)
            want = jsolver.resolve_shrink_cfg(
                dataclasses.replace(JCFG, shrink_every=every), knob)
            assert got.shrink_every == want.shrink_every
    assert tsolver.resolve_shrink_cfg(CFG, None) is CFG
    assert (tsolver.resolve_shrink_cfg(CFG, True).shrink_every
            == jsolver.DEFAULT_SHRINK_EVERY == tsolver.DEFAULT_SHRINK_EVERY)


# ---------------------------------------------------------------------------
# the plain passes with an active-set mask
# ---------------------------------------------------------------------------

L_, D_, B_ = 130, 4, 5
GIDX = np.array([0, 1, 1, 0, 1])


def _state(dup, seed):
    """Pass A/B inputs with a mask.  Coordinates ``lo`` < ``hi`` carry the
    same state and base row, an exact tie that is the best of both passes
    in every lane (across blocks; across halves when doubled).  Lane 0's
    mask hides ``lo``, so ``hi`` must win there; lane 1's mask is all
    false; the last lane is all-masked by its box in pass A and has an
    empty I_up in pass B; lane 0 takes mu = 0."""
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
    G[:, lo] = G.min(axis=1) - 5.0
    for arr in (G, alpha, L, U):
        arr[:, hi] = arr[:, lo]
    lanes = np.arange(B)
    i_idx = rng.integers(ta + 1, tb, size=B).astype(np.int32)
    if dup:
        i_idx += l
        # i's partner i - l shares its base row (q = TAU): mask it
        alpha[lanes, i_idx - l] = L[lanes, i_idx - l]
    j_idx = rng.integers(0, n, size=B).astype(np.int32)
    alpha_a, alpha_b, G_b = alpha.copy(), alpha.copy(), G.copy()
    alpha_a[-1] = L[-1]
    alpha_b[-1] = U[-1]
    G_b[:, [lo, hi]] = G.max(axis=1, keepdims=True) + 5.0
    act = rng.uniform(size=(B, n)) < 0.85
    act[:, [lo, hi]] = True
    act[0, lo] = False
    act[1] = False
    mu = rng.normal(size=B)
    mu[0] = 0.0
    sqn = (X * X).sum(axis=1)
    gammas = rng.uniform(0.1, 0.5, size=B)
    d2 = np.maximum(sqn[:, None] + sqn[None, :] - 2.0 * X @ X.T, 0.0)
    bank = np.exp(-np.array([0.2, 0.45])[:, None, None] * d2)
    bank[:, :, tb] = bank[:, :, ta]
    bank[:, tb, :] = bank[:, ta, :]
    base = (lambda k: k % l) if dup else (lambda k: k)
    a = dict(X=X, sqn=sqn, G=G, alpha=alpha_a, L=L, U=U, XQ=X[base(i_idx)],
             sqq=sqn[base(i_idx)], a_i=alpha_a[lanes, i_idx],
             L_i=L[lanes, i_idx], U_i=U[lanes, i_idx],
             g_i=G[lanes, i_idx] + 1.0, i_idx=i_idx,
             use_exact=lanes % 2 == 1, gammas=gammas)
    b = dict(X=X, sqn=sqn, G=G_b, alpha_new=alpha_b, L=L, U=U,
             XQi=X[base(i_idx)], sqqi=sqn[base(i_idx)], XQj=X[base(j_idx)],
             sqqj=sqn[base(j_idx)], mu=mu, gammas=gammas)
    return a, b, act, bank, i_idx, j_idx, lo, hi


PASS_A = ("X", "sqn", "G", "alpha", "L", "U", "XQ", "sqq", "a_i", "L_i",
          "U_i", "g_i", "i_idx", "use_exact", "gammas")
PASS_B = ("X", "sqn", "G", "alpha_new", "L", "U", "XQi", "sqqi", "XQj",
          "sqqj", "mu", "gammas")
BANK_A = PASS_A[2:6] + PASS_A[8:14]
VARIANTS = [pytest.param(src, dup, id=f"{src}-{'dup' if dup else 'h1'}")
            for src in ("rbf", "bank") for dup in (False, True)]


def _t(s, names):
    return [torch.as_tensor(s[k]) for k in names]


def _j(s, names):
    return [jnp.asarray(s[k]) for k in names]


def _bank_rows(bank, idx, dup):
    """The reference's pre-gathered base rows for the lanes' indices."""
    base = idx % L_ if dup else idx
    return jnp.asarray(bank[GIDX, base])


def _port_a(src, a, act, bank, dup, impl="torch"):
    if src == "rbf":
        return ops.rbf_row_wss_batched(*_t(a, PASS_A), impl=impl, dup=dup,
                                       act=act)
    return ops.row_wss_batched_bank(torch.as_tensor(bank),
                                    torch.as_tensor(GIDX), *_t(a, BANK_A),
                                    impl=impl, dup=dup, act=act)


def _port_blocks_a(src, a, act, bank, dup):
    """The act kernels' plain versions as the wrappers return them: the
    rbf pass's per-block outputs, reduced as the dispatch reduces them;
    the bank pass's lane results (its kernel folds the pick in)."""
    if src == "rbf":
        return ops._first_max(*rbf_row_wss.rbf_row_wss_batched_act(
            *_t(a, PASS_A), act, dup=dup))
    return rbf_row_wss.row_wss_batched_rows_act(
        torch.as_tensor(bank), torch.as_tensor(GIDX), *_t(a, BANK_A), act,
        dup=dup)


def _port_b(src, b, act, bank, i_idx, j_idx, dup, impl="torch"):
    if src == "rbf":
        return ops.rbf_update_wss_batched(*_t(b, PASS_B), impl=impl,
                                          dup=dup, act=act)
    return ops.update_wss_batched_bank(
        torch.as_tensor(bank), torch.as_tensor(GIDX),
        *_t(b, ("G", "alpha_new", "L", "U")), torch.as_tensor(i_idx),
        torch.as_tensor(j_idx), torch.as_tensor(b["mu"]), impl=impl,
        dup=dup, act=act)


def _port_blocks_b(src, b, act, bank, i_idx, j_idx, dup):
    if src == "rbf":
        G, bmax, barg, bmin = rbf_update_wss.rbf_update_wss_batched_act(
            *_t(b, PASS_B), act, dup=dup)
        return (G, *ops._first_max(bmax, barg), bmin.amin(dim=1))
    return rbf_update_wss.update_wss_batched_rows_act(
        torch.as_tensor(bank), torch.as_tensor(GIDX),
        *_t(b, ("G", "alpha_new", "L", "U")), torch.as_tensor(i_idx),
        torch.as_tensor(j_idx), torch.as_tensor(b["mu"]), act, dup=dup)


def _ref_a(src, a, act, bank, dup, impl):
    kw = dict(impl=impl, dup=dup, act=jnp.asarray(act))
    if impl == "interpret":
        kw["block_l"] = 64
    if src == "rbf":
        return jops.rbf_row_wss_batched(*_j(a, PASS_A), **kw)
    return jops.row_wss_batched_rows(_bank_rows(bank, a["i_idx"], dup),
                                     *_j(a, BANK_A), **kw)


def _ref_b(src, b, act, bank, i_idx, j_idx, dup, impl):
    kw = dict(impl=impl, dup=dup, act=jnp.asarray(act))
    if impl == "interpret":
        kw["block_l"] = 64
    if src == "rbf":
        return jops.rbf_update_wss_batched(*_j(b, PASS_B), **kw)
    return jops.update_wss_batched_rows(
        _bank_rows(bank, i_idx, dup), _bank_rows(bank, j_idx, dup),
        *_j(b, ("G", "alpha_new", "L", "U", "mu")), **kw)


@pytest.mark.parametrize("src,dup", VARIANTS)
def test_masked_pass_a_matches_reference(src, dup):
    a, _, act, bank, _, _, lo, hi = _state(dup, seed=11 + dup)
    act_t = torch.as_tensor(act)
    j_t, g_t = _port_a(src, a, act_t, bank, dup)
    j_k, g_k = _port_blocks_a(src, a, act_t, bank, dup)
    np.testing.assert_array_equal(j_k.numpy(), j_t.numpy())
    np.testing.assert_array_equal(g_k.numpy(), g_t.numpy())
    for impl in ("jnp", "interpret"):
        j_j, g_j = _ref_a(src, a, act, bank, dup, impl)
        np.testing.assert_array_equal(j_t.numpy(), np.asarray(j_j))
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=RTOL)
    # the hidden argmax moves to the tie's other index; the lanes without
    # an active candidate give index 0 at -inf; the other Newton lanes keep
    # the tie's lower index
    assert int(j_t[0]) == hi and int(j_t[2]) == lo
    for k in (1, B_ - 1):
        assert int(j_t[k]) == 0 and g_t[k].item() == -np.inf
    # without the mask lane 0 picks the lower index
    assert int(_port_a(src, a, None, bank, dup)[0][0]) == lo


@pytest.mark.parametrize("src,dup", VARIANTS)
def test_masked_pass_b_matches_reference(src, dup):
    _, b, act, bank, i_idx, j_idx, lo, hi = _state(dup, seed=21 + dup)
    act_t = torch.as_tensor(act)
    out_t = _port_b(src, b, act_t, bank, i_idx, j_idx, dup)
    out_k = _port_blocks_b(src, b, act_t, bank, i_idx, j_idx, dup)
    for got, want in zip(out_k, out_t):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    for impl in ("jnp", "interpret"):
        out_j = _ref_b(src, b, act, bank, i_idx, j_idx, dup, impl)
        for k, (got, want) in enumerate(zip(out_t, out_j)):
            if k == 1:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=RTOL, atol=1e-13)
    G, i_next, g_i, _ = out_t
    # the mask restricts the scans, never the update: G is bitwise that of
    # the unmasked pass, and the mu = 0 lane's G comes back bitwise
    G_plain = _port_b(src, b, None, bank, i_idx, j_idx, dup)[0]
    assert torch.equal(G, G_plain)
    assert torch.equal(G[0], torch.as_tensor(b["G"][0]))
    assert int(i_next[0]) == hi and int(i_next[2]) == lo
    for k in (1, B_ - 1):
        assert int(i_next[k]) == 0 and g_i[k].item() == -np.inf


def test_doubled_bank_blocks_match_reference_interpret():
    """The H = 2 bank wrappers without a mask (their plain versions on CPU
    tensors, the lanes' results) against the reference's interpret
    kernels."""
    a, b, _, bank, i_idx, j_idx, lo, _ = _state(True, seed=31)
    gram, gidx = torch.as_tensor(bank), torch.as_tensor(GIDX)
    j, g = rbf_row_wss.row_wss_batched_rows_h2(gram, gidx, *_t(a, BANK_A))
    j_j, g_j = jops.row_wss_batched_rows(
        _bank_rows(bank, a["i_idx"], True), *_j(a, BANK_A),
        impl="interpret", block_l=64, dup=True)
    np.testing.assert_array_equal(j.numpy(), np.asarray(j_j))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=RTOL)
    assert int(j[0]) == lo
    got = rbf_update_wss.update_wss_batched_rows_h2(
        gram, gidx, *_t(b, ("G", "alpha_new", "L", "U")),
        torch.as_tensor(i_idx), torch.as_tensor(j_idx),
        torch.as_tensor(b["mu"]))
    out_j = jops.update_wss_batched_rows(
        _bank_rows(bank, i_idx, True), _bank_rows(bank, j_idx, True),
        *_j(b, ("G", "alpha_new", "L", "U", "mu")), impl="interpret",
        block_l=64, dup=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(out_j[1]))
    for k in (0, 2, 3):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(out_j[k]),
                                   rtol=RTOL, atol=1e-13)


# ---------------------------------------------------------------------------
# the mask refresh in the host loop
# ---------------------------------------------------------------------------


class _Probe(NamedTuple):
    done: torch.Tensor


@pytest.mark.parametrize("period,check_every", [(8, 5), (64, 32), (3, 7),
                                                (1, 4), (5, 1)])
def test_drive_refreshes_at_the_reference_iterations(period, check_every):
    """The refresh falls on the iterations ``t`` with ``t % period ==
    period - 1``, counted over the whole call, whatever the cadence of
    the host's checks and the length of the last chunk."""
    seen = []

    def body(s, refresh):
        if refresh:
            seen.append(len(calls))
        calls.append(refresh)
        return s

    calls = []
    s, t = tsf._drive(body, _Probe(torch.zeros(1, dtype=torch.bool)), 100,
                      check_every, False, period)
    assert t == len(calls) == 100
    assert seen == [k for k in range(100) if k % period == period - 1]


@pytest.mark.parametrize("period,check_every", [(1000, 32), (37, 32),
                                                (64, 32), (8, 5), (3, 7),
                                                (0, 32)])
def test_drive_captures_at_most_two_graphs(period, check_every,
                                           monkeypatch):
    """With graphs, every chunk but a first one of its shape (and a last
    one cut short by ``max_iter``) is a replay, whatever the period: a
    period coprime to the cadence still needs at most two captured graphs
    and two eager chunks, and the refreshes fall where the reference puts
    them."""
    captured, seen, replayed = [], [], []

    def body(s, refresh):
        if refresh:
            seen.append(len(calls))
        calls.append(refresh)
        return s

    def fake_capture(body_, static, refresh, pool=None):
        captured.append((refresh, pool))

        def replay():
            replayed.append(len(refresh))
            for r in refresh:
                body_(static, r)
        return type("Graph", (), {"replay": staticmethod(replay),
                                  "pool": staticmethod(lambda: "pool")}), {}

    monkeypatch.setattr(tsf, "_capture", fake_capture)
    calls, max_iter = [], 5 * max(period, check_every) + 3
    _, t = tsf._drive(body, _Probe(torch.zeros(1, dtype=torch.bool)),
                      max_iter, check_every, True, period)
    assert t == len(calls) == max_iter
    assert seen == [k for k in range(max_iter)
                    if period and k % period == period - 1]
    assert 1 <= len(captured) <= 2
    # every graph after the first draws on the first one's pool
    assert [p for _, p in captured] == [None, "pool"][:len(captured)]
    # eager: the first chunk of each shape and a short last one
    assert max_iter - sum(replayed) <= 3 * check_every


# ---------------------------------------------------------------------------
# soft shrinking in the fused loop
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _chessboard_ref():
    X, y = chessboard(40, seed=0)
    X, y = np.asarray(X), np.asarray(y)
    res = jgrid.solve_grid(X, y, [1.0, 64.0], [0.5], JCFG, impl="jnp",
                           shrinking=True)
    return X, y, np.asarray(res.objective)


@pytest.mark.parametrize("precompute", [True, False], ids=["bank", "rbf"])
def test_grid_shrinking_parity_chessboard(precompute):
    """The (C, gamma) SVC grid on the paper's chess-board data reaches the
    same objectives with shrinking on and off and as the reference with
    shrinking on."""
    X, y, want = _chessboard_ref()
    kw = dict(impl="auto", precompute=precompute, **F64)
    on = grid.solve_grid(X, y, [1.0, 64.0], [0.5], CFG, shrinking=True, **kw)
    off = grid.solve_grid(X, y, [1.0, 64.0], [0.5], CFG, **kw)
    _lanes_ok(on)
    _obj_close(on.objective, off.objective)
    _obj_close(on.objective, want)


def _svr_problem():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(32, 2))
    return X, np.sin(2.0 * X[:, 0]) + 0.25 * X[:, 1]


@functools.lru_cache(maxsize=None)
def _svr_ref():
    X, y = _svr_problem()
    res = jgrid.solve_grid_svr(X, y, [1.0, 16.0], [0.1], [1.0], JCFG,
                               impl="jnp", shrinking=True)
    return np.asarray(res.objective)


@pytest.mark.parametrize("precompute", [True, False], ids=["bank", "rbf"])
def test_svr_grid_shrinking_parity(precompute):
    """Shrinking over the doubled ε-SVR operator: the (B, 2l) mask masks
    each half on its own; objectives match the unshrunk run and the
    reference, and sum(alpha) stays 0."""
    X, y = _svr_problem()
    kw = dict(impl="auto", precompute=precompute, **F64)
    on = grid.solve_grid_svr(X, y, [1.0, 16.0], [0.1], [1.0], CFG,
                             shrinking=True, **kw)
    off = grid.solve_grid_svr(X, y, [1.0, 16.0], [0.1], [1.0], CFG, **kw)
    _lanes_ok(on)
    _obj_close(on.objective, off.objective)
    _obj_close(on.objective, _svr_ref())
    assert float(on.alpha.sum(-1).abs().max()) <= 1e-8
    assert int(on.n_unshrink.min()) >= 0


@pytest.mark.parametrize("precompute", [True, False], ids=["bank", "rbf"])
def test_oneclass_grid_shrinking_parity(precompute):
    X = np.random.default_rng(7).normal(size=(40, 2))
    args = ([0.2, 0.5], [0.5, 2.0])
    on = grid.solve_grid_oneclass(X, *args, CFG, impl="auto",
                                  precompute=precompute, shrinking=True,
                                  **F64)
    want = jgrid.solve_grid_oneclass(X, *args, JCFG, impl="jnp",
                                     precompute=precompute, shrinking=True)
    _lanes_ok(on)
    _obj_close(on.objective, want.objective)
    np.testing.assert_allclose(on.alpha.sum(-1).numpy(), 1.0, atol=1e-12)


@functools.lru_cache(maxsize=None)
def _xor_unshrink():
    X, y = xor_gaussians(72, seed=4)
    return np.asarray(X), np.asarray(y)[None]


def test_forced_unshrink_and_resume():
    """An aggressive cadence forces the unshrink cycle: a lane whose masked
    problem looks solved is reactivated (counted), resumes, and lands on
    the unshrunk optimum with its full-set gap at most eps."""
    X, Y = _xor_unshrink()
    cfg = dataclasses.replace(CFG, shrink_every=8)
    on = tsf.solve_fused_batched(X, Y, 100.0, 0.5, cfg, shrinking=True,
                                 **F64)
    off = tsf.solve_fused_batched(X, Y, 100.0, 0.5, cfg, **F64)
    want = jsf.solve_fused_batched(X, jnp.asarray(Y), 100.0, 0.5,
                                   dataclasses.replace(JCFG, shrink_every=8),
                                   impl="jnp", shrinking=True)
    _lanes_ok(on)
    assert int(on.n_unshrink[0]) >= 1 and int(off.n_unshrink[0]) == 0
    _obj_close(on.objective, off.objective)
    _obj_close(on.objective, want.objective)
    G = on.G[0].numpy()
    up = on.alpha[0].numpy() < 100.0 * np.maximum(Y[0], 0.0)
    dn = on.alpha[0].numpy() > 100.0 * np.minimum(Y[0], 0.0)
    assert G[up].max() - G[dn].min() <= CFG.eps


def test_refresh_does_not_depend_on_check_every():
    """Iterations, unshrink counts and alpha are bitwise the same for any
    cadence of the host's checks (two lanes, the bank row source)."""
    X, Y = _xor_unshrink()
    Y = np.concatenate([Y, -Y])
    cfg = dataclasses.replace(CFG, shrink_every=8)
    X_t = torch.as_tensor(X)
    bank = ops.gram_bank(X_t, [0.5, 1.5], impl="torch")
    runs = [tsf.solve_fused_batched(X, Y, [100.0, 10.0], [0.5, 1.5], cfg,
                                    gram=bank, gram_idx=[0, 1],
                                    shrinking=True, check_every=ce, **F64)
            for ce in (1, 5, 32)]
    for r in runs[1:]:
        for f in ("iterations", "n_unshrink", "alpha", "G"):
            assert torch.equal(getattr(r, f), getattr(runs[0], f)), f
    _lanes_ok(runs[0])
    assert int(runs[0].n_unshrink.sum()) >= 1


def test_zero_C_lane_with_shrinking():
    """A C = 0 lane (box collapsed to a point) converges at init with a
    zero gap and b = 0 beside a live lane."""
    X, y = xor_gaussians(48, seed=6)
    Y = np.stack([y, y])
    res = tsf.solve_fused_batched(X, Y, [0.0, 5.0], 0.5, CFG,
                                  shrinking=True, **F64)
    _lanes_ok(res)
    assert float(res.alpha[0].abs().max()) == 0.0
    assert float(res.kkt_gap[0]) == 0.0 and int(res.iterations[0]) == 0


# ---------------------------------------------------------------------------
# hard compaction in the chunked driver
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _chunked_problem(precompute):
    X, y = xor_gaussians(48, seed=5)
    X, y = np.asarray(X), np.asarray(y)
    want = jgrid.solve_grid_compacted(X, y, [2.0, 24.0], [0.4], JCFG,
                                      chunk=32, impl="jnp",
                                      precompute=precompute, shrinking=True)
    return X, y, np.asarray(want.objective)


def _spy_rounds(monkeypatch):
    """The chunk solves of a chunked run, as (lane bucket, kept rows): the
    padded coordinates are the ones with ``L = U = 0``."""
    rounds = []
    solve = tsf.solve_fused_batched_qp

    def spy(X, P, L, U, *args, **kw):
        rounds.append((P.shape[0], int(((L != 0) | (U != 0)).any(0).sum())))
        return solve(X, P, L, U, *args, **kw)

    monkeypatch.setattr(tsf, "solve_fused_batched_qp", spy)
    return rounds


@pytest.mark.parametrize("precompute", [False, True], ids=["rbf", "bank"])
def test_chunked_hard_compaction_parity(precompute, monkeypatch):
    """Lane and row compaction between chunks of 32 iterations: the
    reference's objectives, every lane converged on the full set, and the
    rebuilt G exact on every coordinate.  A profiler window sees the
    round's four phases as ranges: the spans of the recorder that is
    active around the call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.telemetry import Diagnostics, recording
    X, y, want = _chunked_problem(precompute)
    rounds = _spy_rounds(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            recording(Diagnostics(ring=None)):
        res = grid.solve_grid_compacted(X, y, [2.0, 24.0], [0.4], CFG,
                                        chunk=32, impl="auto",
                                        precompute=precompute,
                                        shrinking=True, **F64)
    _lanes_ok(res)
    _obj_close(res.objective, want)
    K = np.exp(-0.4 * np.maximum(((X[:, None] - X[None]) ** 2).sum(-1), 0.0))
    for c in range(2):
        np.testing.assert_allclose(res.G[0, 0, c].numpy(),
                                   y - K @ res.alpha[0, 0, c].numpy(),
                                   atol=1e-9)
    # the rows shrank below the 48 points
    assert min(m for _, m in rounds) < 48
    names = {e.key for e in prof.key_averages()}
    assert {f"chunked.{p}" for p in ("slice", "solve", "rebuild",
                                     "checks")} <= names


def test_chunked_lane_compaction_without_shrinking(monkeypatch):
    X, y, want = _chunked_problem(False)
    rounds = _spy_rounds(monkeypatch)
    res = grid.solve_grid_compacted(X, y, [2.0, 24.0], [0.4], CFG, chunk=32,
                                    impl="auto", precompute=False, **F64)
    _lanes_ok(res)
    _obj_close(res.objective, want)
    assert {m for _, m in rounds} == {48} and rounds[-1][0] == 1


@pytest.mark.parametrize("precompute", [False, True], ids=["rbf", "bank"])
def test_chunked_doubled_lanes_match_reference(precompute):
    """ε-SVR lanes through the chunked driver: the doubled layout
    ``[sub, pad, sub2, pad]`` with the bucketed half offset, the halves
    folded in the row shrink; the reference's objectives, the full-set gap,
    G equal to ``p - Q alpha`` and sum(alpha) = 0."""
    X, y = _svr_problem()
    l = len(y)
    Cs, eps_ = np.array([1.0, 16.0]), 0.1
    P = np.concatenate([y - eps_, y + eps_])[None].repeat(2, axis=0)
    z = np.zeros((2, l))
    L = np.concatenate([z, z - Cs[:, None]], axis=1)
    U = np.concatenate([z + Cs[:, None], z], axis=1)
    sq = (X * X).sum(-1)
    K = np.exp(-np.maximum(sq[:, None] + sq[None] - 2.0 * X @ X.T, 0.0))
    kw, jkw = {}, {}
    if precompute:
        kw = dict(gram=torch.as_tensor(K[None]), gram_idx=[0, 0])
        jkw = dict(gram=jnp.asarray(K[None]), gram_idx=np.zeros(2, np.int32))
    res = tsf.solve_fused_chunked_qp(
        torch.as_tensor(X), *(torch.as_tensor(a) for a in (P, L, U)), 1.0,
        CFG, chunk=32, shrinking=True, doubled=True, **kw)
    want = jsf.solve_fused_chunked_qp(X, P, L, U, 1.0, JCFG, impl="jnp",
                                      chunk=32, shrinking=True, doubled=True,
                                      **jkw)
    _lanes_ok(res)
    _obj_close(res.objective, want.objective)
    a = res.alpha.numpy()
    Qa = (a[:, :l] + a[:, l:]) @ K
    np.testing.assert_allclose(res.G.numpy(), P - np.concatenate([Qa, Qa], 1),
                               atol=1e-9)
    assert np.abs(a.sum(-1)).max() <= 1e-8


def test_chunked_refuses_what_the_port_lacks():
    """Lane sharding, once a later slice (step 12), is ported: a mesh that
    is not a ``LaneMesh`` and a card that is not there raise, naming no
    step, and nothing falls back; a bad chunk still raises."""
    X, y = xor_gaussians(16, seed=0)
    P = torch.as_tensor(y)[None]
    args = (torch.as_tensor(X), P, -P.abs(), P.abs(), 0.5)
    for kw, err in ((dict(mesh=object()), TypeError),
                    (dict(devices=("cuda:0",)), RuntimeError)):
        with pytest.raises(err) as got:
            tsf.solve_fused_chunked_qp(*args, **kw)
        assert "step 12" not in str(got.value)
    with pytest.raises(ValueError, match="chunk"):
        tsf.solve_fused_chunked_qp(*args, chunk=0)
