"""The port's plain pass A, pass B and Gram against the JAX package's
``ops`` (``impl="jnp"`` and the Pallas kernels in interpret mode), and the
per-block outputs the CUDA passes return against the full-row versions.

States: l not a multiple of 128, B = 1, 3 and 9, per-lane gammas,
``use_exact`` both ways, an all-masked lane (index 0, gain -inf), exact
gain ties across blocks (the lowest index wins) and a ``mu = 0`` lane
whose G must come back bitwise unchanged.  Tolerance: rows and G to
rtol 1e-12 (f64) and 1e-5 (f32); indices exactly, except that in f32 two
picks may differ where their gains agree to 1e-5 (the products sum in a
different order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import gram_block, ops, rbf_row_wss, rbf_update_wss
from repro_torch.kernels import ref

RTOL = {np.float64: 1e-12, np.float32: 1e-5}
TIE_A, TIE_B = 5, -3      # duplicated points, first and last block


def _state(l, d, B, seed, dtype):
    """Seeded pass A/B inputs with the edge cases of the module docstring."""
    rng = np.random.default_rng(seed)
    tb = l + TIE_B
    X = rng.normal(size=(l, d))
    X[tb] = X[TIE_A]
    C = rng.choice([0.5, 1.0, 10.0], size=(B, 1))
    y = rng.choice([-1.0, 1.0], size=(B, l))
    L, U = np.minimum(0.0, y * C), np.maximum(0.0, y * C)
    frac = rng.uniform(size=(B, l))
    frac = np.where(rng.uniform(size=(B, l)) < 0.4, np.round(frac), frac)
    frac[:, [TIE_A, tb]] = 0.5
    alpha = L + (U - L) * frac
    G = rng.normal(size=(B, l))
    G[:, TIE_A] = G.min(axis=1) - 5.0    # the tie carries the best gain
    for arr in (G, alpha, L, U):
        arr[:, tb] = arr[:, TIE_A]
    i_idx = rng.integers(TIE_A + 1, tb, size=B).astype(np.int32)
    lanes = np.arange(B)
    g_i = G[lanes, i_idx] + 1.0
    use_exact = np.arange(B) % 2 == 1
    if B > 1:
        alpha[-1] = L[-1]                # all-masked lane: no alpha > L
    sqn = (X * X).sum(axis=1)
    cast = lambda a: np.asarray(a, dtype)
    return dict(X=cast(X), sqn=cast(sqn), G=cast(G), alpha=cast(alpha),
                L=cast(L), U=cast(U), XQ=cast(X[i_idx]),
                sqq=cast(sqn[i_idx]), a_i=cast(alpha[lanes, i_idx]),
                L_i=cast(L[lanes, i_idx]), U_i=cast(U[lanes, i_idx]),
                g_i=cast(g_i), i_idx=i_idx, use_exact=use_exact,
                gammas=cast(rng.uniform(0.05, 0.5, B)))


PASS_A = ("X", "sqn", "G", "alpha", "L", "U", "XQ", "sqq", "a_i", "L_i",
          "U_i", "g_i", "i_idx", "use_exact", "gammas")


def _update_state(l, d, B, seed, dtype):
    """Pass B inputs: the pass A state with a second query set and mu;
    lane 0 takes mu = 0, and the last lane of B > 1 has an empty I_up."""
    s = _state(l, d, B, seed, dtype)
    rng = np.random.default_rng(seed + 100)
    j_idx = rng.integers(0, l, size=B)
    X = s["X"].astype(np.float64)
    G = s["G"].astype(np.float64)
    G[:, TIE_A] = G.max(axis=1) + 5.0
    G[:, l + TIE_B] = G[:, TIE_A]
    alpha = s["alpha"].astype(np.float64)
    if B > 1:
        alpha[-1] = s["U"][-1]
    mu = rng.normal(size=B)
    mu[0] = 0.0
    cast = lambda a: np.asarray(a, dtype)
    return dict(X=s["X"], sqn=s["sqn"], G=cast(G), alpha_new=cast(alpha),
                L=s["L"], U=s["U"], XQi=s["XQ"], sqqi=s["sqq"],
                XQj=cast(X[j_idx]), sqqj=cast((X[j_idx] ** 2).sum(axis=1)),
                mu=cast(mu), gammas=s["gammas"])


PASS_B = ("X", "sqn", "G", "alpha_new", "L", "U", "XQi", "sqqi", "XQj",
          "sqqj", "mu", "gammas")

SHAPES = [(300, 16, 1), (257, 5, 3), (300, 16, 9), (77, 3, 3)]


def _jax(s, names):
    return [jnp.asarray(s[k]) for k in names]


def _torch(s, names):
    return [torch.as_tensor(s[k]) for k in names]


def _check_picks(j_t, gain_t, j_j, gain_j, vals, dtype):
    """Indices equal; in f32 a differing pick must be a tie to 1e-5."""
    j_t, j_j = j_t.numpy(), np.asarray(j_j)
    gain_t, gain_j = gain_t.numpy(), np.asarray(gain_j)
    np.testing.assert_allclose(gain_t, gain_j, rtol=RTOL[dtype])
    for b in np.nonzero(j_t != j_j)[0]:
        assert dtype == np.float32, (b, j_t[b], j_j[b])
        np.testing.assert_allclose(vals[b, j_t[b]], vals[b, j_j[b]],
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("l,d,B", SHAPES)
def test_pass_a_matches_reference(l, d, B, dtype):
    s = _state(l, d, B, seed=l + B, dtype=dtype)
    j_t, gain_t = ops.rbf_row_wss_batched(*_torch(s, PASS_A))
    assert j_t.dtype == torch.int32
    vals = ref._wss_vals(
        ref.rbf_rows_batched(*_torch(s, ("X", "sqn", "XQ", "sqq",
                                         "gammas"))),
        *_torch(s, ("G", "alpha", "L", "U", "a_i", "L_i", "U_i", "g_i",
                    "i_idx", "use_exact"))).numpy()
    for impl in ("jnp", "interpret"):
        j_j, gain_j = jops.rbf_row_wss_batched(*_jax(s, PASS_A), impl=impl,
                                               block_l=128)
        _check_picks(j_t, gain_t, j_j, gain_j, vals, dtype)
    if B > 1:     # the all-masked lane
        assert int(j_t[-1]) == 0 and gain_t[-1].item() == -np.inf


def test_pass_a_tie_across_blocks_takes_the_lower_index():
    s = _state(300, 16, 3, seed=7, dtype=np.float64)
    j, _ = ops.rbf_row_wss_batched(*_torch(s, PASS_A))
    np.testing.assert_array_equal(j.numpy()[:2], [TIE_A, TIE_A])
    bmax, barg = rbf_row_wss.rbf_row_wss_batched(*_torch(s, PASS_A))
    # both tied points lead their blocks; the cross-block rule picks TIE_A
    assert bmax[0, 0] == bmax[0, -1] and int(barg[0, -1]) == 300 + TIE_B
    j_blk, gain_blk = ops._first_max(bmax, barg)
    np.testing.assert_array_equal(j_blk.numpy(), j.numpy())


def test_rows_match_reference():
    s = _state(257, 5, 3, seed=3, dtype=np.float64)
    from repro.kernels import ref as jref
    names = ("X", "sqn", "XQ", "sqq", "gammas")
    np.testing.assert_allclose(
        ref.rbf_rows_batched(*_torch(s, names)).numpy(),
        np.asarray(jref.rbf_rows_batched(*_jax(s, names))), rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("l,d,B", SHAPES)
def test_pass_b_matches_reference(l, d, B, dtype):
    s = _update_state(l, d, B, seed=l + B, dtype=dtype)
    G_t, i_t, gi_t, gdn_t = ops.rbf_update_wss_batched(*_torch(s, PASS_B))
    assert i_t.dtype == torch.int32
    # the mu = 0 lane is a bitwise no-op on G
    np.testing.assert_array_equal(G_t[0].numpy(), s["G"][0])
    rtol = RTOL[dtype]
    for impl in ("jnp", "interpret"):
        G_j, i_j, gi_j, gdn_j = jops.rbf_update_wss_batched(
            *_jax(s, PASS_B), impl=impl, block_l=128)
        np.testing.assert_allclose(G_t.numpy(), np.asarray(G_j), rtol=rtol,
                                   atol=rtol * float(np.abs(s["G"]).max()))
        np.testing.assert_allclose(gi_t.numpy(), np.asarray(gi_j), rtol=rtol)
        np.testing.assert_allclose(gdn_t.numpy(), np.asarray(gdn_j),
                                   rtol=rtol)
        vals = torch.where(torch.as_tensor(s["alpha_new"] < s["U"]), G_t,
                           -np.inf).numpy()
        _check_picks(i_t, gi_t, i_j, gi_j, vals, dtype)
    if B > 1:     # empty I_up: index 0, -inf
        assert int(i_t[-1]) == 0 and gi_t[-1].item() == -np.inf
    else:         # the tie across blocks: the lower index
        assert int(i_t[0]) == TIE_A


@pytest.mark.parametrize("l,d,B", SHAPES)
def test_cpu_wrappers_run_the_plain_blocks(l, d, B):
    """On CPU tensors the kernel wrappers return the plain per-block
    outputs, whose cross-block reduction equals the full-row versions, and
    launch nothing."""
    launches = (rbf_row_wss.rbf_row_wss_batched.launches,
                rbf_update_wss.rbf_update_wss_batched.launches)
    s = _state(l, d, B, seed=11, dtype=np.float64)
    bmax, barg = rbf_row_wss.rbf_row_wss_batched(*_torch(s, PASS_A))
    assert bmax.shape == (B, -(-l // 128)) and barg.dtype == torch.int32
    j_full, g_full = ref.rbf_row_wss_batched(*_torch(s, PASS_A))
    j_blk, g_blk = ops._first_max(bmax, barg)
    np.testing.assert_array_equal(j_blk.numpy(), j_full.numpy())
    np.testing.assert_array_equal(g_blk.numpy(), g_full.numpy())

    u = _update_state(l, d, B, seed=11, dtype=np.float64)
    G_blk, bmax, barg, bmin = rbf_update_wss.rbf_update_wss_batched(
        *_torch(u, PASS_B))
    full = ref.rbf_update_wss_batched(*_torch(u, PASS_B))
    i_blk, gi_blk = ops._first_max(bmax, barg)
    for got, want in zip((G_blk, i_blk, gi_blk, bmin.amin(dim=1)), full):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert launches == (rbf_row_wss.rbf_row_wss_batched.launches,
                        rbf_update_wss.rbf_update_wss_batched.launches)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("l1,l2,d", [(77, 300, 5), (130, 64, 16)])
def test_gram_matches_reference(l1, l2, d, dtype):
    rng = np.random.default_rng(l1 + l2)
    X1 = rng.normal(size=(l1, d)).astype(dtype)
    X2 = rng.normal(size=(l2, d)).astype(dtype)
    gamma = 0.3
    tdtype = torch.from_numpy(X1).dtype
    K_t = ops.gram(X1, X2, gamma, device="cpu", dtype=tdtype)
    assert K_t.dtype == tdtype
    K_w = gram_block.gram_cross(torch.as_tensor(X1), torch.as_tensor(X2),
                                gamma)
    np.testing.assert_array_equal(K_w.numpy(), K_t.numpy())
    for impl in ("jnp", "interpret"):
        K_j = jops.gram(jnp.asarray(X1), jnp.asarray(X2), gamma, impl=impl,
                        block_i=128, block_j=128)
        np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j),
                                   rtol=RTOL[dtype], atol=RTOL[dtype])
