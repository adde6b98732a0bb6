"""The Gram-bank row source: the port's plain bank pass A and pass B and
their ``ops`` dispatchers against the JAX package's
``row_wss_batched_rows``/``update_wss_batched_rows`` (``impl="jnp"`` and
the Pallas kernels in interpret mode), the per-block outputs the CUDA bank
passes return, the bank supplier of ``RowSource``, and the Gram kernel's
``out=``.

State: l = 300 (not a multiple of 128), B = 5 lanes over a 2-entry bank,
``use_exact`` both ways, an all-masked lane, a duplicated point that ties
across the first and last block, and a ``mu = 0`` lane whose G must come
back bitwise unchanged.  Tolerance (f64): values rtol 1e-12, indices
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qp as jqp
from repro.kernels import ops as jops
from repro.kernels import row_source as jrs
from repro_torch.core import qp as tqp
from repro_torch.kernels import gram_block, ops, rbf_row_wss, rbf_update_wss
from repro_torch.kernels import ref, row_source

RTOL = 1e-12
TIE_A, TIE_B = 5, -3
L_, D_, B_ = 300, 6, 5
GIDX = np.array([0, 1, 1, 0, 1])
GAMMAS = np.array([0.15, 0.4])


def _bank_state(seed=0):
    """Pass A and pass B inputs over a 2-entry bank (module docstring)."""
    rng = np.random.default_rng(seed)
    l, B = L_, B_
    tb = l + TIE_B
    X = rng.normal(size=(l, D_))
    X[tb] = X[TIE_A]
    sq = (X * X).sum(axis=1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * X @ X.T, 0.0)
    bank = np.exp(-GAMMAS[:, None, None] * d2)
    # the duplicate's bank entries equal the original's bitwise (a blocked
    # matrix product need not round them alike)
    bank[:, :, tb] = bank[:, :, TIE_A]
    bank[:, tb, :] = bank[:, TIE_A, :]
    C = rng.choice([0.5, 1.0, 10.0], size=(B, 1))
    y = rng.choice([-1.0, 1.0], size=(B, l))
    L, U = np.minimum(0.0, y * C), np.maximum(0.0, y * C)
    frac = rng.uniform(size=(B, l))
    frac = np.where(rng.uniform(size=(B, l)) < 0.4, np.round(frac), frac)
    frac[:, [TIE_A, tb]] = 0.5
    alpha = L + (U - L) * frac
    G = rng.normal(size=(B, l))
    G[:, TIE_A] = G.min(axis=1) - 5.0       # the tie carries the best gain
    for arr in (G, alpha, L, U):
        arr[:, tb] = arr[:, TIE_A]
    i_idx = rng.integers(TIE_A + 1, tb, size=B).astype(np.int32)
    j_idx = rng.integers(0, l, size=B).astype(np.int32)
    lanes = np.arange(B)
    alpha_a = alpha.copy()
    alpha_a[-1] = L[-1]                     # all-masked lane: no alpha > L
    G_b = G.copy()
    G_b[:, [TIE_A, tb]] = G.max(axis=1, keepdims=True) + 5.0
    alpha_b = alpha.copy()
    alpha_b[-1] = U[-1]                     # empty I_up
    mu = rng.normal(size=B)
    mu[0] = 0.0
    a = dict(G=G, alpha=alpha_a, L=L, U=U, a_i=alpha_a[lanes, i_idx],
             L_i=L[lanes, i_idx], U_i=U[lanes, i_idx],
             g_i=G[lanes, i_idx] + 1.0, i_idx=i_idx,
             use_exact=lanes % 2 == 1)
    b = dict(G=G_b, alpha_new=alpha_b, L=L, U=U, i_idx=i_idx, j_idx=j_idx,
             mu=mu)
    return bank, a, b


PASS_A = ("G", "alpha", "L", "U", "a_i", "L_i", "U_i", "g_i", "i_idx",
          "use_exact")
PASS_B = ("G", "alpha_new", "L", "U")


def _t(s, names):
    return [torch.as_tensor(s[k]) for k in names]


def _j(s, names):
    return [jnp.asarray(s[k]) for k in names]


def _bank_t(bank):
    return torch.as_tensor(bank), torch.as_tensor(GIDX, dtype=torch.int64)


@pytest.mark.parametrize("impl", ["jnp", "interpret"])
def test_bank_pass_a_matches_reference(impl):
    bank, a, _ = _bank_state()
    gram, gidx = _bank_t(bank)
    j_t, gain_t = ops.row_wss_batched_bank(gram, gidx, *_t(a, PASS_A))
    assert j_t.dtype == torch.int32
    KR = jnp.asarray(bank[GIDX, a["i_idx"]])
    j_j, gain_j = jops.row_wss_batched_rows(KR, *_j(a, PASS_A), impl=impl,
                                            block_l=128)
    np.testing.assert_array_equal(j_t.numpy(), np.asarray(j_j))
    np.testing.assert_allclose(gain_t.numpy(), np.asarray(gain_j),
                               rtol=RTOL)
    # all-masked lane: index 0, -inf; Newton-gain lanes take the lower tie
    assert int(j_t[-1]) == 0 and gain_t[-1].item() == -np.inf
    np.testing.assert_array_equal(j_t.numpy()[[0, 2]], [TIE_A, TIE_A])


@pytest.mark.parametrize("impl", ["jnp", "interpret"])
def test_bank_pass_b_matches_reference(impl):
    bank, _, b = _bank_state()
    gram, gidx = _bank_t(bank)
    mu = torch.as_tensor(b["mu"])
    G_t, i_t, gi_t, gdn_t = ops.update_wss_batched_bank(
        gram, gidx, *_t(b, PASS_B), *_t(b, ("i_idx", "j_idx")), mu)
    np.testing.assert_array_equal(G_t[0].numpy(), b["G"][0])   # mu = 0
    KRi = jnp.asarray(bank[GIDX, b["i_idx"]])
    KRj = jnp.asarray(bank[GIDX, b["j_idx"]])
    G_j, i_j, gi_j, gdn_j = jops.update_wss_batched_rows(
        KRi, KRj, *_j(b, PASS_B), jnp.asarray(b["mu"]), impl=impl,
        block_l=128)
    scale = float(np.abs(b["G"]).max())
    np.testing.assert_allclose(G_t.numpy(), np.asarray(G_j), rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(gi_t.numpy(), np.asarray(gi_j), rtol=RTOL)
    np.testing.assert_allclose(gdn_t.numpy(), np.asarray(gdn_j), rtol=RTOL)
    assert int(i_t[-1]) == 0 and gi_t[-1].item() == -np.inf
    np.testing.assert_array_equal(i_t.numpy()[:-1], [TIE_A] * (B_ - 1))


ROWS_CASES = {"plain": {}, "dup": {"dup": True}, "act": {"act": True},
              "conj": {"conj": True}}


def _rows_case(case):
    """Pass A and pass B inputs of a rows-form case: the bank state, doubled
    to (B, 2l) halves for ``dup``, with an active set for ``act`` and a
    conjugate direction for ``conj``."""
    bank, a, b = _bank_state(seed=5)
    opt = ROWS_CASES[case]
    rng = np.random.default_rng(6)
    kw_a, kw_b = {}, {}
    if opt.get("dup"):
        for s_ in (a, b):
            for k in ("G", "alpha", "alpha_new", "L", "U"):
                if k in s_:
                    s_[k] = np.concatenate([s_[k], s_[k][:, ::-1]], axis=1)
        b["j_idx"] = (b["j_idx"] + L_).astype(np.int32)
        kw_a = kw_b = dict(dup=True)
    if opt.get("act"):
        act = rng.uniform(size=a["G"].shape) < 0.7
        kw_a = kw_b = dict(act=act)
    if opt.get("conj"):
        kw_b = dict(dirv=rng.normal(size=(B_, L_)), mu2=rng.normal(size=B_))
    return bank, a, b, kw_a, kw_b


def _kw(kw, to):
    return {k: (to(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


@pytest.mark.parametrize("case", ROWS_CASES)
def test_rows_forms_match_reference(case, monkeypatch):
    """``ops.row_wss_batched_rows``/``update_wss_batched_rows`` take the
    reference's pre-gathered rows ``KR``/``KRi, KRj`` and agree with its
    ``impl="jnp"``; with ``impl="cuda"`` they reach the bank kernels'
    wrappers (their plain versions on CPU tensors), bitwise the same."""
    bank, a, b, kw_a, kw_b = _rows_case(case)
    base_i = b["i_idx"] % L_
    KR = bank[GIDX, a["i_idx"] % L_]
    KRi, KRj = bank[GIDX, base_i], bank[GIDX, b["j_idx"] % L_]
    t_a = ops.row_wss_batched_rows(torch.as_tensor(KR), *_t(a, PASS_A),
                                   block_l=128, **_kw(kw_a, torch.as_tensor))
    j_a = jops.row_wss_batched_rows(jnp.asarray(KR), *_j(a, PASS_A),
                                    impl="jnp", **_kw(kw_a, jnp.asarray))
    np.testing.assert_array_equal(t_a[0].numpy(), np.asarray(j_a[0]))
    np.testing.assert_allclose(t_a[1].numpy(), np.asarray(j_a[1]), rtol=RTOL)
    mu = b["mu"]
    t_b = ops.update_wss_batched_rows(
        torch.as_tensor(KRi), torch.as_tensor(KRj), *_t(b, PASS_B),
        torch.as_tensor(mu), block_l=128, **_kw(kw_b, torch.as_tensor))
    jkw = _kw(kw_b, jnp.asarray)
    if "dup" in kw_b and "dirv" in jkw:
        jkw["dirv"] = jnp.tile(jkw["dirv"], (1, 2))
    j_b = jops.update_wss_batched_rows(
        jnp.asarray(KRi), jnp.asarray(KRj), *_j(b, PASS_B), jnp.asarray(mu),
        impl="jnp", **jkw)
    assert len(t_b) == len(j_b)
    scale = float(np.abs(b["G"]).max())
    for k, (got, want) in enumerate(zip(t_b, j_b)):
        if got.dtype == torch.int32:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=RTOL * scale,
                                       err_msg=str(k))
    monkeypatch.setattr(ops, "resolve_impl", lambda impl, device: "cuda")
    c_a = ops.row_wss_batched_rows(torch.as_tensor(KR), *_t(a, PASS_A),
                                   **_kw(kw_a, torch.as_tensor))
    c_b = ops.update_wss_batched_rows(
        torch.as_tensor(KRi), torch.as_tensor(KRj), *_t(b, PASS_B),
        torch.as_tensor(mu), **_kw(kw_b, torch.as_tensor))
    for got, want in zip(c_a + c_b, t_a + t_b):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_cpu_bank_wrappers_run_the_plain_blocks():
    """On CPU tensors the bank kernel wrappers return the plain per-block
    outputs, whose cross-block reduction equals the full-row versions, and
    launch nothing."""
    before = (rbf_row_wss.row_wss_batched_rows.launches,
              rbf_update_wss.update_wss_batched_rows.launches)
    bank, a, b = _bank_state(seed=4)
    gram, gidx = _bank_t(bank)
    bmax, barg = rbf_row_wss.row_wss_batched_rows(gram, gidx, *_t(a, PASS_A))
    assert bmax.shape == (B_, -(-L_ // 128)) and barg.dtype == torch.int32
    # the tie across blocks: both copies lead their blocks
    assert bmax[0, 0] == bmax[0, -1] and int(barg[0, -1]) == L_ + TIE_B
    full = ops.row_wss_batched_bank(gram, gidx, *_t(a, PASS_A), impl="torch")
    for got, want in zip(ops._first_max(bmax, barg), full):
        np.testing.assert_array_equal(got.numpy(), want.numpy())

    args = (*_t(b, PASS_B), *_t(b, ("i_idx", "j_idx")),
            torch.as_tensor(b["mu"]))
    G_blk, bmax, barg, bmin = rbf_update_wss.update_wss_batched_rows(
        gram, gidx, *args)
    full = ops.update_wss_batched_bank(gram, gidx, *args, impl="torch")
    i_blk, gi_blk = ops._first_max(bmax, barg)
    for got, want in zip((G_blk, i_blk, gi_blk, bmin.amin(dim=1)), full):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert before == (rbf_row_wss.row_wss_batched_rows.launches,
                      rbf_update_wss.update_wss_batched_rows.launches)


def test_bank_source_matches_reference():
    bank, a, b = _bank_state(seed=2)
    gram, gidx = _bank_t(bank)
    src = row_source.bank_source(gram, gidx, GAMMAS[GIDX])
    jsrc = jrs.bank_source(jnp.asarray(bank), jnp.asarray(GIDX))
    assert src.is_bank and src.base_l == jsrc.base_l == L_
    idx = np.concatenate([b["i_idx"], b["j_idx"]])
    np.testing.assert_array_equal(src.query(torch.as_tensor(idx)).numpy(),
                                  np.asarray(jsrc.query(jnp.asarray(idx))))
    e_t = src.entry_pairs(torch.as_tensor(idx),
                          torch.as_tensor(idx[::-1].copy()), 2)
    e_j = jsrc.entry_pairs(jnp.asarray(idx), jnp.asarray(idx[::-1]), 2)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    v = np.random.default_rng(3).normal(size=(B_, L_))
    np.testing.assert_allclose(src.matvec(torch.as_tensor(v)).numpy(),
                               np.asarray(jsrc.matvec(jnp.asarray(v))),
                               rtol=RTOL, atol=RTOL * L_)
    with pytest.raises(ValueError, match="index"):
        row_source.bank_source(gram, torch.tensor([0, 2]))
    with pytest.raises(ValueError, match="n_stack, l, l"):
        row_source.bank_source(gram[:, :, :10], gidx)


def test_rbf_matvec_and_oracle_match_reference():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(300, 4))
    v = rng.normal(size=(3, 300))
    gammas = np.array([0.2, 0.5, 1.1])
    src = row_source.rbf_source(torch.as_tensor(X), torch.as_tensor(gammas),
                                3)
    jsrc = jrs.rbf_source(jnp.asarray(X), jnp.asarray(gammas), 3)
    np.testing.assert_allclose(src.matvec(torch.as_tensor(v)).numpy(),
                               np.asarray(jsrc.matvec(jnp.asarray(v))),
                               rtol=RTOL, atol=RTOL * 300)
    for g, row in zip(gammas, v):
        np.testing.assert_allclose(
            tqp.make_rbf(torch.as_tensor(X), g).matvec(
                torch.as_tensor(row)).numpy(),
            np.asarray(jqp.make_rbf(jnp.asarray(X), g).matvec(
                jnp.asarray(row))), rtol=RTOL, atol=RTOL * 300)


@pytest.mark.parametrize("n,nu", [(300, 0.1), (77, 0.35), (10, 1.0)])
def test_oneclass_qp_matches_reference(n, nu):
    a_t = tqp.oneclass_alpha0(n, nu)
    np.testing.assert_array_equal(a_t.numpy(),
                                  np.asarray(jqp.oneclass_alpha0(n, nu)))
    assert abs(float(a_t.sum()) - 1.0) < 1e-12
    q_t, q_j = tqp.oneclass_qp(n, nu), jqp.oneclass_qp(n, nu)
    for got, want in ((q_t.p, q_j.p), (q_t.bounds.lower, q_j.bounds.lower),
                      (q_t.bounds.upper, q_j.bounds.upper)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(((a_t >= 0) & (a_t <= q_t.bounds.upper)).all())


def test_gram_writes_into_a_bank_slice():
    rng = np.random.default_rng(6)
    X = torch.as_tensor(rng.normal(size=(130, 5)))
    bank = ops.gram_bank(X, GAMMAS, impl="torch")
    assert bank.shape == (2, 130, 130)
    for g, gamma in enumerate(GAMMAS):
        np.testing.assert_array_equal(bank[g].numpy(),
                                      ref.gram_cross(X, X, gamma).numpy())
    out = torch.empty((3, 130, 130), dtype=torch.float64)
    got = gram_block.gram_cross(X, X, 0.3, out=out[1])
    assert got.data_ptr() == out[1].data_ptr()
    np.testing.assert_array_equal(out[1].numpy(),
                                  ref.gram_cross(X, X, 0.3).numpy())


@pytest.mark.parametrize("shrinking", [False, True], ids=["plain", "shrink"])
def test_solve_grid_svr_bank_matches_reference(shrinking):
    """The doubled ε-SVR lanes over the base bank (``precompute=True``, the
    H = 2 bank passes' plain versions) against the reference's banked
    grid: objectives to rtol 1e-6, the full-set gap, G equal to
    ``p - Q alpha`` and sum(alpha) = 0 in every lane."""
    from repro.core import grid as jgrid
    from repro.core.solver import SolverConfig as JConfig
    from repro_torch.core import grid
    from repro_torch.core.solver import SolverConfig
    rng = np.random.default_rng(12)
    X = rng.normal(size=(40, 3))
    y = np.sin(X[:, 0]) + 0.3 * X[:, 1]
    args = ([1.0, 8.0], [0.05, 0.2], [0.3, 0.9])
    got = grid.solve_grid_svr(X, y, *args, SolverConfig(eps=1e-5),
                              precompute=True, shrinking=shrinking,
                              device="cpu", dtype=torch.float64)
    want = jgrid.solve_grid_svr(jnp.asarray(X), jnp.asarray(y), *args,
                                JConfig(eps=1e-5, max_iter=200_000),
                                impl="jnp", precompute=True,
                                shrinking=shrinking)
    assert bool(got.converged.all())
    assert float(got.kkt_gap.max()) <= 1e-5
    np.testing.assert_allclose(got.objective.numpy(),
                               np.asarray(want.objective), rtol=1e-6)
    sq = (X * X).sum(-1)
    d2 = np.maximum(sq[:, None] + sq[None] - 2.0 * X @ X.T, 0.0)
    a = got.alpha.numpy()
    for g, gamma in enumerate(args[2]):
        Qa = (a[g, ..., :40] + a[g, ..., 40:]) @ np.exp(-gamma * d2)
        for e, epsilon in enumerate(args[1]):
            p = np.concatenate([y - epsilon, y + epsilon])
            np.testing.assert_allclose(
                got.G[g, e].numpy(), p - np.concatenate([Qa[e], Qa[e]], -1),
                atol=1e-10)
    assert np.abs(a.sum(-1)).max() <= 1e-8
