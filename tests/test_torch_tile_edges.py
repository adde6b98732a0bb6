"""The plain per-block forms of the lane-batched rbf passes, what kernels 1
and 2 return (``ref.rbf_row_wss_batched_blocks``,
``ref.rbf_update_wss_batched_blocks``), against the JAX package's
``ops`` (``impl="jnp"`` and the Pallas kernels in interpret mode) at the
shapes where the tiled CUDA kernels have edges: one column past a block
(l = 129), one lane past a group of 16 and of 32 (B = 17, 33), one
feature (d = 1).  Every variant: one state half and two (the doubled
ε-SVR operator), with and without an ``act`` mask, pass B with and without
the conjugate direction.

The states carry an exact tie across the two blocks (and across the halves
when doubled, with i in half 1 and its partner masked), an all-masked lane
in pass A and an empty I_up in pass B, a lane whose mask is all false, a
``mu = 0`` lane (and a ``mu2 = 0`` lane) whose G must come back bitwise.  Tolerances as the port's conventions
state: gains, G and r to rtol 1e-12 (f64) and 1e-5 (f32); indices exactly,
except that in f32 two picks may differ where their values agree to 1e-5
(the products sum in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

RTOL = {np.float64: 1e-12, np.float32: 1e-5}
SHAPES = [(129, 5, 17), (129, 5, 33), (129, 1, 17)]
PASS_A = ("X", "sqn", "G", "alpha", "L", "U", "XQ", "sqq", "a_i", "L_i",
          "U_i", "g_i", "i_idx", "use_exact", "gammas")
PASS_B = ("X", "sqn", "G", "alpha_new", "L", "U", "XQi", "sqqi", "XQj",
          "sqqj", "mu", "gammas")


def _state(l, d, B, dup, seed, dtype):
    """Seeded pass A and pass B inputs with the edge cases of the module
    docstring; with d = 1 the points are the shuffled integers, so no two
    lie so close that a near-duplicate of i outweighs the planted tie."""
    rng = np.random.default_rng(seed)
    ta, tb = 5, l - 3
    if d == 1:
        X = (rng.permutation(l) - l // 2).astype(np.float64)[:, None]
    else:
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
    G[:, lo] = G.min(axis=1) - 50.0     # pass A: the tie's gain is best
    for arr in (G, alpha, L, U):
        arr[:, hi] = arr[:, lo]
    lanes = np.arange(B)
    i_idx = rng.integers(ta + 1, tb, size=B).astype(np.int32)
    if dup:
        i_idx += l
    j_idx = rng.integers(0, n, size=B)
    bi, bj = i_idx % l, j_idx % l
    alpha_a, alpha_b = alpha.copy(), alpha.copy()
    if dup:     # i's partner i - l shares its base row: q = tau, masked
        alpha_a[lanes, i_idx - l] = L[lanes, i_idx - l]
    alpha_a[-1] = L[-1]                  # all-masked lane in pass A
    alpha_b[-1] = U[-1]                  # empty I_up in pass B
    G_b = G.copy()
    G_b[:, [lo, hi]] = G.max(axis=1, keepdims=True) + 5.0
    mu = rng.normal(size=B)
    mu2 = rng.normal(scale=0.5, size=B)
    mu[0] = mu2[0] = mu2[1] = 0.0
    base = rng.normal(scale=0.1, size=(B, l))
    base[:, tb] = base[:, ta]
    act = rng.uniform(size=(B, n)) < 0.85
    act[:, [lo, hi]] = True
    act[0, lo] = False                   # hides the tie's lower index
    act[1] = False                       # all false
    sqn = (X * X).sum(axis=1)
    cast = lambda a: np.asarray(a, dtype)
    return dict(
        X=cast(X), sqn=cast(sqn), G=cast(G), alpha=cast(alpha_a), L=cast(L),
        U=cast(U), XQ=cast(X[bi]), sqq=cast(sqn[bi]),
        a_i=cast(alpha_a[lanes, i_idx]), L_i=cast(L[lanes, i_idx]),
        U_i=cast(U[lanes, i_idx]), g_i=cast(G[lanes, i_idx] + 1.0),
        i_idx=i_idx, use_exact=lanes % 2 == 1,
        gammas=cast(rng.uniform(0.05, 0.5, B) * 16.0 / d),
        G_b=cast(G_b), alpha_new=cast(alpha_b), XQi=cast(X[bi]),
        sqqi=cast(sqn[bi]), XQj=cast(X[bj]), sqqj=cast(sqn[bj]), mu=cast(mu),
        mu2=cast(mu2), base=cast(base), act=act, lo=lo, hi=hi)


def _torch(s, names, G="G"):
    return [torch.as_tensor(s[G if k == "G" else k]) for k in names]


def _jax(s, names, G="G"):
    return [jnp.asarray(s[G if k == "G" else k]) for k in names]


def _same_picks(got, want, vals, dtype):
    """Indices equal; in f32 a differing pick must be a near-tie."""
    got, want = np.asarray(got), np.asarray(want)
    for b in np.nonzero(got != want)[0]:
        assert dtype == np.float32, (b, got[b], want[b])
        np.testing.assert_allclose(vals[b, got[b]], vals[b, want[b]],
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "act"])
@pytest.mark.parametrize("dup", [False, True], ids=["h1", "h2"])
@pytest.mark.parametrize("l,d,B", SHAPES)
def test_pass_a_blocks_match_reference_at_tile_edges(l, d, B, dup, masked,
                                                     dtype):
    s = _state(l, d, B, dup, seed=l + d + B + dup, dtype=dtype)
    act = s["act"] if masked else None
    tact = None if act is None else torch.as_tensor(act)
    bmax, barg = ref.rbf_row_wss_batched_blocks(
        *_torch(s, PASS_A), block_l=128, dup=dup, act=tact)
    assert bmax.shape == (B, 2) and barg.dtype == torch.int32
    j, gain = ops._first_max(bmax, barg)
    vals = ref._wss_vals(
        ref.rbf_rows_batched(*_torch(s, ("X", "sqn", "XQ", "sqq", "gammas")),
                             dup=dup),
        *_torch(s, ("G", "alpha", "L", "U", "a_i", "L_i", "U_i", "g_i",
                    "i_idx", "use_exact")), tact).numpy()
    for impl in ("jnp", "interpret"):
        kw = dict(impl=impl, block_l=128, dup=dup)
        if masked:
            kw["act"] = jnp.asarray(act)
        j_j, gain_j = jops.rbf_row_wss_batched(*_jax(s, PASS_A), **kw)
        np.testing.assert_allclose(gain.numpy(), np.asarray(gain_j),
                                   rtol=RTOL[dtype])
        _same_picks(j.numpy(), j_j, vals, dtype)
    empty = [B - 1] + ([1] if masked else [])
    for b in empty:
        assert int(j[b]) == 0 and gain[b].item() == -np.inf, b
    # the tie across blocks (and halves) goes to the lower index in the
    # Newton-gain lanes, or to the other one where the mask hides it
    if dtype == np.float64:
        for b in range(0, B - 1, 2):
            if b not in empty:
                want = s["hi"] if masked and b == 0 else s["lo"]
                assert int(j[b]) == want, (b, int(j[b]), want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("conj", [False, True], ids=["plain", "conj"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "act"])
@pytest.mark.parametrize("dup", [False, True], ids=["h1", "h2"])
@pytest.mark.parametrize("l,d,B", SHAPES)
def test_pass_b_blocks_match_reference_at_tile_edges(l, d, B, dup, masked,
                                                     conj, dtype):
    s = _state(l, d, B, dup, seed=l + d + B + dup, dtype=dtype)
    act = s["act"] if masked else None
    tact = None if act is None else torch.as_tensor(act)
    kw = dict(block_l=128, dup=dup, act=tact)
    if conj:
        kw.update(dirv=torch.as_tensor(s["base"]),
                  mu2=torch.as_tensor(s["mu2"]))
    out = ref.rbf_update_wss_batched_blocks(*_torch(s, PASS_B, "G_b"), **kw)
    G, bmax, barg, bmin = out[:4]
    assert bmax.shape == bmin.shape == (B, 2) and barg.dtype == torch.int32
    i_next, g_i = ops._first_max(bmax, barg)
    g_dn = bmin.amin(dim=1)
    # mu = 0 (and mu2 = 0) keeps G bitwise; mu2 = 0 is the plain step's G
    assert torch.equal(G[0], torch.as_tensor(s["G_b"][0]))
    if conj:
        plain = ref.rbf_update_wss_batched_blocks(
            *_torch(s, PASS_B, "G_b"), block_l=128, dup=dup, act=tact)[0]
        assert torch.equal(G[1], plain[1])
    rtol = RTOL[dtype]
    scale = float(np.abs(s["G_b"]).max())
    up = s["alpha_new"] < s["U"]
    vals = np.where(up if act is None else up & act, G.numpy(), -np.inf)
    for impl in ("jnp", "interpret"):
        jkw = dict(impl=impl, block_l=128, dup=dup)
        if masked:
            jkw["act"] = jnp.asarray(act)
        if conj:
            jkw.update(dirv=jnp.asarray(ref.tile_rows(
                torch.as_tensor(s["base"])).numpy() if dup else s["base"]),
                mu2=jnp.asarray(s["mu2"]))
        want = jops.rbf_update_wss_batched(*_jax(s, PASS_B, "G_b"), **jkw)
        np.testing.assert_allclose(G.numpy(), np.asarray(want[0]),
                                   rtol=rtol, atol=rtol * scale)
        np.testing.assert_allclose(g_i.numpy(), np.asarray(want[2]),
                                   rtol=rtol, atol=rtol * scale)
        np.testing.assert_allclose(g_dn.numpy(), np.asarray(want[3]),
                                   rtol=rtol, atol=rtol * scale)
        _same_picks(i_next.numpy(), want[1], vals, dtype)
        if conj:
            r = ref.tile_rows(out[4]) if dup else out[4]
            np.testing.assert_allclose(r.numpy(), np.asarray(want[4]),
                                       rtol=rtol, atol=rtol)
    empty = [B - 1] + ([1] if masked else [])
    for b in empty:
        assert int(i_next[b]) == 0 and g_i[b].item() == -np.inf, b
    if dtype == np.float64:
        for b in range(B - 1):
            if b not in empty:
                want = s["hi"] if masked and b == 0 else s["lo"]
                assert int(i_next[b]) == want, (b, int(i_next[b]), want)
