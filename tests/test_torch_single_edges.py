"""The plain per-segment forms of the single-lane rbf passes, what kernels 6
and 7 return (``ref.rbf_row_wss_blocks``, ``ref.rbf_update_wss_blocks``,
through the wrappers on CPU tensors and reduced across segments with
``ops._first_max``), and the port's ``ops`` on ``impl="torch"``, against
the JAX package's ``ops`` (``impl="jnp"`` and the Pallas kernels in
interpret mode, ``block_l=128``) at the edges of the kernels' segments and
ring: l = 127 (one segment short of 128 columns), 129 (one column past a
segment), 1001 (odd rows of XT, off 16-byte alignment on the card) by
d = 1, 37 and 1000 (one feature, a ragged last stage, many stages).

The states carry an exact tie between column 5 and the last column (two
segments apart for l > 128), best in pass A under the Newton-gain rule and
in pass B's next-i scan; pass A runs both gain rules, a masked column set
that hides the tie's lower index and empties a whole segment, and the
relaunch flag both ways (a false flag keeps the stored row bitwise); pass
B a masked column set in both scans and ``mu = 0``, whose G must come back
bitwise.  Tolerances as in ``test_torch_solver_single.py``: rows, gains
and G to rtol 1e-12 (f64), indices exactly; a row's entries also to an
absolute 2.2e-308, the least normal f64, because XLA on the CPU flushes
subnormal results (far points at d = 1) to zero and PyTorch keeps them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, ops, rbf_row_wss, rbf_update_wss, ref

RTOL = 1e-12
TINY = np.finfo(np.float64).tiny
F64 = torch.float64
LS = (127, 129, 1001)
DS = (1, 37, 1000)
TA = 5
PASS_A = ("X", "sqn", "G", "alpha", "L", "U", "xq", "a_i", "L_i", "U_i",
          "g_i", "i_idx")


def _state(l, d, seed, masked=False):
    """Seeded f64 single-lane inputs with the edge cases of the module
    docstring.  With d = 1 the points are the shuffled integers, so no two
    lie so close that a near-duplicate of i outweighs the planted tie;
    gamma |x|^2 is about 2 otherwise, as on the main paths."""
    rng = np.random.default_rng(seed)
    tb = l - 1
    if d == 1:
        X = (rng.permutation(l) - l // 2).astype(np.float64)[:, None]
    else:
        X = rng.normal(size=(l, d))
    X[tb] = X[TA]
    y = rng.choice([-1.0, 1.0], size=l)
    L, U = np.minimum(0.0, 2.0 * y), np.maximum(0.0, 2.0 * y)
    frac = rng.uniform(size=l)
    frac = np.where(rng.uniform(size=l) < 0.4, np.round(frac), frac)
    frac[[TA, tb]] = 0.5
    alpha = L + (U - L) * frac
    G = rng.normal(size=l)
    G[TA] = G.min() - 50.0
    for arr in (G, alpha, L, U):
        arr[tb] = arr[TA]
    i = int(rng.integers(TA + 1, tb))
    g_i = G[i] + 1.0
    if masked:      # not selectable (alpha at L): a random 40%, the tie's
        hide = rng.uniform(size=l) < 0.4       # lower index, segment 0
        hide[TA] = True
        if l > 128:
            hide[:128] = True
        hide[tb] = False
        alpha = np.where(hide, L, alpha)
    j = int(rng.integers(0, l))
    G_b = G.copy()
    G_b[[TA, tb]] = G.max() + 5.0
    # pass B's scans: a random fifth of the columns at U (out of the max)
    # and another at L (out of the min), the tie kept in both
    pick = rng.uniform(size=l)
    alpha_b = np.where(pick < 0.2, U, np.where(pick > 0.8, L, alpha))
    alpha_b[[TA, tb]] = alpha[TA]
    return dict(X=X, sqn=(X * X).sum(axis=1), G=G, alpha=alpha, L=L, U=U,
                xq=X[i], a_i=alpha[i], L_i=L[i], U_i=U[i], g_i=g_i,
                i_idx=np.int32(i), gamma=2.0 / d, G_b=G_b,
                alpha_b=alpha_b, xq_j=X[j], mu=rng.normal())


def _torch(s, use_exact):
    return [torch.as_tensor(s[k]) for k in PASS_A] + [
        torch.tensor(use_exact), torch.tensor(s["gamma"], dtype=F64)]


def _jax(s, use_exact):
    return [jnp.asarray(s[k]) for k in PASS_A] + [
        jnp.asarray(use_exact), jnp.asarray(s["gamma"])]


def _blocks_a(args):
    """Kernel 6's per-segment result (the plain version on the CPU)."""
    xq = args[6]
    return rbf_row_wss.rbf_row_wss(*args[:7], torch.dot(xq, xq), *args[7:])


def _check_pass_a(s, l, use_exact):
    """The per-segment form and ops on impl="torch" against the reference's
    jnp and interpret kernels; returns (k, bmax, barg, j)."""
    args = _torch(s, use_exact)
    k_b, bmax, barg = _blocks_a(args)
    assert bmax.shape == barg.shape == (-(-l // build.BLOCK_L),)
    assert barg.dtype == torch.int32
    j_b, g_b = ops._first_max(bmax[None], barg[None])
    k_t, j_t, g_t = ops.rbf_row_wss(*args, impl="torch")
    np.testing.assert_array_equal(k_b.numpy(), k_t.numpy())
    assert int(j_b[0]) == int(j_t) and float(g_b[0]) == float(g_t)
    for impl in ("jnp", "interpret"):
        k_j, j_j, g_j = jops.rbf_row_wss(*_jax(s, use_exact), impl=impl,
                                         block_l=128)
        np.testing.assert_allclose(k_b.numpy(), np.asarray(k_j), rtol=RTOL,
                                   atol=TINY)
        assert int(j_b[0]) == int(j_j), impl
        np.testing.assert_allclose(float(g_b[0]), float(g_j), rtol=RTOL)
    return k_b, bmax, barg, int(j_b[0])


@pytest.mark.parametrize("use_exact", [False, True], ids=["newton", "exact"])
@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("l", LS)
def test_pass_a_segments_match_reference(l, d, use_exact):
    s = _state(l, d, seed=l + d)
    _, bmax, barg, j = _check_pass_a(s, l, use_exact)
    bl = build.BLOCK_L
    seg = torch.arange(bmax.shape[0]) * bl
    assert bool(((barg >= seg) & (barg < seg + bl)).all())
    if not use_exact:       # the tie across segments: the lower index
        assert j == TA


@pytest.mark.parametrize("l", LS)
def test_pass_a_masked_columns(l):
    s = _state(l, 37, seed=l, masked=True)
    _, bmax, barg, j = _check_pass_a(s, l, False)
    assert j == l - 1       # the tie's lower index is hidden
    if l > 128:             # an empty segment: -inf at its first column
        assert float(bmax[0]) == -np.inf and int(barg[0]) == 0


@pytest.mark.parametrize("flag", [False, True], ids=["false", "true"])
@pytest.mark.parametrize("l", LS)
def test_relaunch_flag_keeps_or_replaces_the_row(l, flag):
    s = _state(l, 37, seed=l + 1)
    args = _torch(s, False)
    run = torch.tensor(flag)
    stored = torch.full((l,), 7.0, dtype=F64)
    want = _blocks_a(args)[0] if flag else stored.clone()
    xq = args[6]
    k_w = rbf_row_wss.rbf_row_wss(*args[:7], torch.dot(xq, xq), *args[7:],
                                  k_out=stored, run=run)[0]
    k_o = ops.rbf_row_wss(*args, impl="torch", k_out=stored, run=run)[0]
    for k in (k_w, k_o):
        np.testing.assert_array_equal(k.numpy(), want.numpy())
    if flag:
        k_j = jops.rbf_row_wss(*_jax(s, False), impl="jnp", block_l=128)[0]
        np.testing.assert_allclose(k_w.numpy(), np.asarray(k_j), rtol=RTOL,
                                   atol=TINY)


@pytest.mark.parametrize("zero_mu", [False, True], ids=["mu", "mu0"])
@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("l", LS)
def test_pass_b_segments_match_reference(l, d, zero_mu):
    s = _state(l, d, seed=l + d + 1)
    X, sqn = torch.as_tensor(s["X"]), torch.as_tensor(s["sqn"])
    k_i = ref.rbf_row(X, sqn, torch.as_tensor(s["xq"]), s["gamma"])
    G, alpha, L, U, xq_j = (torch.as_tensor(s[k]) for k in (
        "G_b", "alpha_b", "L", "U", "xq_j"))
    mu = torch.tensor(0.0 if zero_mu else s["mu"], dtype=F64)
    gamma = torch.tensor(s["gamma"], dtype=F64)
    G_b, bmax, barg, bmin = rbf_update_wss.rbf_update_wss(
        X, sqn, G, k_i, alpha, L, U, xq_j, torch.dot(xq_j, xq_j), mu, gamma)
    nb = -(-l // build.BLOCK_L)
    assert bmax.shape == barg.shape == bmin.shape == (nb,)
    i_b, gi_b = ops._first_max(bmax[None], barg[None])
    gdn_b = bmin.amin()
    if zero_mu:
        assert torch.equal(G_b, G)
    G_t, i_t, gi_t, gdn_t = ops.rbf_update_wss(
        X, sqn, G, k_i, alpha, L, U, xq_j, mu, gamma, impl="torch")
    np.testing.assert_array_equal(G_b.numpy(), G_t.numpy())
    assert int(i_b[0]) == int(i_t) and float(gi_b[0]) == float(gi_t)
    assert float(gdn_b) == float(gdn_t)
    scale = float(np.abs(s["G_b"]).max())
    jargs = [jnp.asarray(a) for a in (s["X"], s["sqn"], s["G_b"],
                                      k_i.numpy(), s["alpha_b"], s["L"],
                                      s["U"], s["xq_j"])]
    for impl in ("jnp", "interpret"):
        G_j, i_j, gi_j, gdn_j = jops.rbf_update_wss(
            *jargs, jnp.asarray(float(mu)), s["gamma"], impl=impl,
            block_l=128)
        np.testing.assert_allclose(G_b.numpy(), np.asarray(G_j), rtol=RTOL,
                                   atol=RTOL * scale)
        assert int(i_b[0]) == int(i_j), impl
        np.testing.assert_allclose(float(gi_b[0]), float(gi_j), rtol=RTOL,
                                   atol=RTOL * scale)
        np.testing.assert_allclose(float(gdn_b), float(gdn_j), rtol=RTOL,
                                   atol=RTOL * scale)
    assert int(i_b[0]) == TA           # the tie across segments
