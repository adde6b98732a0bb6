"""The Gram-bank row source: the port's plain bank pass A and pass B and
their ``ops`` dispatchers against the JAX package's
``row_wss_batched_rows``/``update_wss_batched_rows`` (``impl="jnp"`` and
the Pallas kernels in interpret mode), the lane results the CUDA bank
passes return (their pick folded into the launch) in every variant and
both dtypes, against the reference and against the earlier per-block form
reduced by ``ops._first_max``, the bank supplier of ``RowSource``, and the
Gram kernel's ``out=``.

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


def _parent_form_a(gram, gidx, args, dup=False, act=None):
    """Pass A as the bank kernel and its dispatch gave it before the pick
    was folded into the kernel: the per-block first max of the plain
    values over 128-column blocks, reduced across blocks by
    ``ops._first_max``."""
    vals = ref._wss_vals(ref.bank_rows(gram, gidx, args[8], dup), *args,
                         act)
    return ops._first_max(*ref.block_first_max(vals, 128, 2 if dup else 1))


def _parent_form_b(gram, gidx, args, dup=False, act=None, dirv=None,
                   mu2=None):
    """Pass B in the same earlier form: per-block outputs reduced by
    ``ops._first_max`` and ``amin``."""
    G, alpha_new, L, U, i_idx, j_idx, mu = args
    out = ref._blocks_b(G, ref.bank_rows(gram, gidx, i_idx, dup),
                        ref.bank_rows(gram, gidx, j_idx, dup), mu, alpha_new,
                        L, U, 128, dup, act, dirv, mu2)
    return (out[0], *ops._first_max(out[1], out[2]),
            out[3].amin(dim=1)) + tuple(out[4:])


def test_cpu_bank_wrappers_run_the_plain_blocks():
    """On CPU tensors the bank kernel wrappers return the lanes' plain
    results, which their kernels now reduce across blocks in the launch:
    bitwise the ``ops`` dispatch on ``impl="torch"`` and the earlier
    per-block outputs reduced by ``ops._first_max``; and they launch
    nothing."""
    before = (rbf_row_wss.row_wss_batched_rows.launches,
              rbf_update_wss.update_wss_batched_rows.launches)
    bank, a, b = _bank_state(seed=4)
    gram, gidx = _bank_t(bank)
    got = rbf_row_wss.row_wss_batched_rows(gram, gidx, *_t(a, PASS_A))
    assert got[0].shape == (B_,) and got[0].dtype == torch.int32
    # the tie across blocks goes to the lower index
    assert int(got[0][0]) == TIE_A
    full = ops.row_wss_batched_bank(gram, gidx, *_t(a, PASS_A), impl="torch")
    for x, y, z in zip(got, full, _parent_form_a(gram, gidx, _t(a, PASS_A))):
        assert torch.equal(x, y) and torch.equal(x, z)

    args = (*_t(b, PASS_B), *_t(b, ("i_idx", "j_idx")),
            torch.as_tensor(b["mu"]))
    got = rbf_update_wss.update_wss_batched_rows(gram, gidx, *args)
    assert len(got) == 4 and got[1].shape == (B_,)
    full = ops.update_wss_batched_bank(gram, gidx, *args, impl="torch")
    for x, y, z in zip(got, full, _parent_form_b(gram, gidx, args)):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert before == (rbf_row_wss.row_wss_batched_rows.launches,
                      rbf_update_wss.update_wss_batched_rows.launches)


# The bank passes' lane results in every variant: one state half or two,
# with and without the mask, pass B with and without the conjugate
# direction, at an l that is not a multiple of 128 and an odd one, in both
# dtypes.  Values: rtol 1e-12 (f64) and 1e-5 (f32) against the reference,
# indices exactly; against the earlier per-block form, bitwise.
LANE_VARIANTS = {"h1": (False, False, False), "h2": (True, False, False),
                 "h1_act": (False, True, False), "h2_act": (True, True, False),
                 "h1_conj": (False, False, True),
                 "h2_conj": (True, False, True),
                 "h1_act_conj": (False, True, True),
                 "h2_act_conj": (True, True, True)}
LANE_TOL = {"f64": 1e-12, "f32": 1e-5}


def _lane_state(l, dup, dtype, seed):
    """Bank pass inputs at ``l`` over a 2-entry bank, B_ = 5 lanes, with
    the edge cases: points 5 and l-3 coincide (their bank rows and columns
    set equal), so their coordinates tie exactly across the first and last
    block, and with ``dup`` half 1 at 5 carries half 0's state at l-3, a
    tie across the halves and blocks whose lower doubled index l-3 must
    win; the tie carries the best gain (pass A) and the largest G (pass
    B); the last lane is all-masked in pass A and has an empty I_up in pass
    B; lane 0 takes mu = mu2 = 0 and must keep its G bitwise.  The mask
    hides the lower tie index in lane 0 and all of lane 1.  Returns
    (gram, gram_idx, pass A args, pass B args, act, dirv, mu2, (lo, hi))
    as tensors of ``dtype``."""
    rng = np.random.default_rng(seed)
    B, ta, tb = B_, 5, l - 3
    lo, hi = (l - 3, l + 5) if dup else (ta, tb)
    n = 2 * l if dup else l
    X = rng.normal(size=(l, D_))
    X[tb] = X[ta]
    sq = (X * X).sum(axis=1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * X @ X.T, 0.0)
    bank = np.exp(-GAMMAS[:, None, None] * d2)
    bank[:, :, tb] = bank[:, :, ta]
    bank[:, tb, :] = bank[:, ta, :]
    C = rng.choice([0.5, 1.0, 10.0], size=(B, 1))
    if dup:
        zero = np.zeros((B, l))
        L = np.concatenate([zero, zero - C], axis=1)
        U = np.concatenate([zero + C, zero], axis=1)
    else:
        y = rng.choice([-1.0, 1.0], size=(B, l))
        L, U = np.minimum(0.0, y * C), np.maximum(0.0, y * C)
    frac = rng.uniform(size=(B, n))
    frac = np.where(rng.uniform(size=(B, n)) < 0.4, np.round(frac), frac)
    frac[:, [lo, hi]] = 0.5
    alpha = L + (U - L) * frac
    G = rng.normal(size=(B, n))
    G[:, lo] = G.min(axis=1) - 5.0
    for arr in (G, alpha, L, U):
        arr[:, hi] = arr[:, lo]
    lanes = np.arange(B)
    i_idx = rng.integers(ta + 1, tb, size=B) + (l if dup else 0)
    if dup:
        alpha[lanes, i_idx - l] = L[lanes, i_idx - l]
    j_idx = rng.integers(0, n, size=B)
    alpha_a, alpha_b, G_b = alpha.copy(), alpha.copy(), G.copy()
    alpha_a[-1] = L[-1]
    alpha_b[-1] = U[-1]
    G_b[:, [lo, hi]] = G.max(axis=1, keepdims=True) + 10.0
    mu = rng.normal(size=B)
    mu[0] = 0.0
    dirv = rng.normal(scale=0.1, size=(B, l))
    dirv[:, tb] = dirv[:, ta]
    mu2 = rng.normal(scale=0.5, size=B)
    mu2[0] = 0.0
    act = rng.uniform(size=(B, n)) < 0.85
    act[:, [lo, hi]] = True
    act[0, lo] = False
    act[1] = False
    t = lambda x: torch.tensor(x, dtype=dtype)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)
    args_a = (t(G), t(alpha_a), t(L), t(U), t(alpha_a[lanes, i_idx]),
              t(L[lanes, i_idx]), t(U[lanes, i_idx]),
              t(G[lanes, i_idx] + 1.0), i32(i_idx),
              torch.tensor(lanes % 2 == 1))
    args_b = (t(G_b), t(alpha_b), t(L), t(U), i32(i_idx), i32(j_idx), t(mu))
    return (t(bank), torch.as_tensor(GIDX), args_a, args_b,
            torch.tensor(act), t(dirv), t(mu2), (lo, hi))


def _close(got, want, rtol, scale=0.0):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * scale)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("l", [300, 131])
@pytest.mark.parametrize("variant", ["h1", "h2", "h1_act", "h2_act"])
def test_bank_pass_a_lane_results(variant, l, dtype):
    """Bank pass A's wrapper (its plain version on CPU tensors) returns the
    lanes' (j, gain): bitwise the earlier per-block form reduced by
    ``ops._first_max``, and the reference's ``row_wss_batched_rows`` on
    ``impl="jnp"``; the ties, the hidden argmax and the empty lanes as the
    state fixes them."""
    dup, masked, _ = LANE_VARIANTS[variant]
    torch_dtype = torch.float64 if dtype == "f64" else torch.float32
    gram, gidx, args, _, act, _, _, (lo, hi) = _lane_state(
        l, dup, torch_dtype, seed=l + 10 * dup + masked)
    act = act if masked else None
    if masked:
        got = rbf_row_wss.row_wss_batched_rows_act(gram, gidx, *args, act,
                                                   dup=dup)
    elif dup:
        got = rbf_row_wss.row_wss_batched_rows_h2(gram, gidx, *args)
    else:
        got = rbf_row_wss.row_wss_batched_rows(gram, gidx, *args)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch_dtype
    for x, y in zip(got, _parent_form_a(gram, gidx, args, dup, act)):
        assert torch.equal(x, y)
    KR = gram.numpy()[GIDX, args[8].numpy() % l]
    want = jops.row_wss_batched_rows(
        jnp.asarray(KR), *(jnp.asarray(x.numpy()) for x in args),
        impl="jnp", dup=dup, act=None if act is None else jnp.asarray(act))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1], LANE_TOL[dtype])
    j = got[0].tolist()
    assert j[0] == (hi if masked else lo) and j[2] == lo
    for k in ([1, B_ - 1] if masked else [B_ - 1]):
        assert j[k] == 0 and got[1][k].item() == -np.inf


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("l", [300, 131])
@pytest.mark.parametrize("variant", list(LANE_VARIANTS))
def test_bank_pass_b_lane_results(variant, l, dtype):
    """Bank pass B's wrappers (plain versions on CPU tensors) return G and
    the lanes' (i_next, g_i_next, g_dn), and r with the direction: bitwise
    the earlier per-block form reduced by ``ops._first_max`` and ``amin``,
    within the tolerance of the reference's ``update_wss_batched_rows`` on
    ``impl="jnp"``; the mu = mu2 = 0 lane's G bitwise, the ties, the hidden
    argmax and the empty lanes as the state fixes them."""
    dup, masked, conj = LANE_VARIANTS[variant]
    torch_dtype = torch.float64 if dtype == "f64" else torch.float32
    gram, gidx, _, args, act, dirv, mu2, (lo, hi) = _lane_state(
        l, dup, torch_dtype, seed=l + 10 * dup + masked + 100 * conj)
    act = act if masked else None
    kw = dict(dirv=dirv, mu2=mu2) if conj else {}
    if conj:
        got = rbf_update_wss.update_wss_batched_rows_conj(
            gram, gidx, *args, dirv, mu2, dup=dup, act=act)
    elif masked:
        got = rbf_update_wss.update_wss_batched_rows_act(gram, gidx, *args,
                                                         act, dup=dup)
    elif dup:
        got = rbf_update_wss.update_wss_batched_rows_h2(gram, gidx, *args)
    else:
        got = rbf_update_wss.update_wss_batched_rows(gram, gidx, *args)
    assert len(got) == 4 + conj and got[1].dtype == torch.int32
    for x, y in zip(got, _parent_form_b(gram, gidx, args, dup, act, **kw)):
        assert torch.equal(x, y)
    assert torch.equal(got[0][0], args[0][0])          # mu = mu2 = 0
    G, alpha_new, L, U, i_idx, j_idx, mu = (x.numpy() for x in args)
    rows = gram.numpy()[np.concatenate([GIDX, GIDX]),
                        np.concatenate([i_idx, j_idx]) % l]
    jkw = {} if act is None else dict(act=jnp.asarray(act.numpy()))
    if conj:
        d = dirv.numpy()
        jkw.update(dirv=jnp.asarray(np.tile(d, (1, 2)) if dup else d),
                   mu2=jnp.asarray(mu2.numpy()))
    want = jops.update_wss_batched_rows(
        jnp.asarray(rows[:B_]), jnp.asarray(rows[B_:]), jnp.asarray(G),
        jnp.asarray(alpha_new), jnp.asarray(L), jnp.asarray(U),
        jnp.asarray(mu), impl="jnp", dup=dup, **jkw)
    assert len(want) == len(got)
    scale = float(np.abs(G).max())
    tol = LANE_TOL[dtype]
    _close(got[0], want[0], tol, scale)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[2], want[2], tol, scale)
    _close(got[3], want[3], tol, scale)
    if conj:
        r_full = ref.tile_rows(got[4]) if dup else got[4]
        _close(r_full, want[4], tol, 1.0)
    i = got[1].tolist()
    assert i[0] == (hi if masked else lo) and i[2] == lo and i[3] == lo
    for k in ([1, B_ - 1] if masked else [B_ - 1]):
        assert i[k] == 0 and got[2][k].item() == -np.inf


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
