"""Plain PyTorch versions of the port's kernels: the CPU path and the
oracle every CUDA kernel is held against.

Each function repeats the arithmetic of ``repro.kernels.ref`` in the same
order (main-path subset: one state half, no active-set mask, no conjugate
direction).  Indices leave as int32, as in the reference's index channel.

The ``*_blocks`` functions are the plain versions of what the CUDA passes
themselves return: the per-block (max, first argmax) and min over
``block_l`` columns, before the cross-block reduction in
:mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import torch

TAU = 1e-12
NEG_INF = float("-inf")
POS_INF = float("inf")


def rbf_rows_batched(X, sqn, XQ, sqq, gammas):
    """k(x_q^b, X) for a batch of query rows -> (B, l)."""
    d2 = sqq[:, None] + sqn[None, :] - 2.0 * (XQ @ X.T)
    return torch.exp(-gammas[:, None] * torch.clamp_min(d2, 0.0))


def _wss_vals(k, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx, use_exact):
    """Masked WSS2 gains per lane and column (-inf where not selectable)."""
    lv = g_i[:, None] - G
    q = torch.clamp_min(2.0 - 2.0 * k, TAU)
    g_tilde = 0.5 * lv * lv / q
    lo = torch.maximum((L_i - a_i)[:, None], alpha - U)
    hi = torch.minimum((U_i - a_i)[:, None], alpha - L)
    mu_c = torch.clamp(lv / q, lo, hi)
    g_exact = lv * mu_c - 0.5 * q * mu_c * mu_c
    gains = torch.where(use_exact[:, None], g_exact, g_tilde)
    idx = torch.arange(G.shape[1], dtype=torch.int32, device=G.device)
    mask = (alpha > L) & (lv > 0) & (idx[None, :] != i_idx[:, None])
    return torch.where(mask, gains, NEG_INF)


def _first_argmax(vals):
    """Row-wise first maximum as (int32 index, value); index 0 for an
    all -inf row, like ``jax.lax.argmax``."""
    j = torch.argmax(vals, dim=1)
    return j.to(torch.int32), vals.gather(1, j[:, None])[:, 0]


def row_wss_batched_from_k(k, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx,
                           use_exact):
    """Pass A selection algebra given the (B, l) kernel rows ``k``.

    RBF diag == 1 is hardcoded (paper setting).  Returns
    (j (B,) int32, gain_j (B,)).
    """
    return _first_argmax(_wss_vals(k, G, alpha, L, U, a_i, L_i, U_i, g_i,
                                   i_idx, use_exact))


def rbf_row_wss_batched(X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i,
                        g_i, i_idx, use_exact, gammas):
    """Batched pass A: WSS2 j-selection per lane -> (j (B,) int32, gain)."""
    k = rbf_rows_batched(X, sqn, XQ, sqq, gammas)
    return row_wss_batched_from_k(k, G, alpha, L, U, a_i, L_i, U_i, g_i,
                                  i_idx, use_exact)


def _update_vals(G, k_i, k_j, mu, alpha_new, L, U):
    """G_new and the masked values of its two scans: over ``alpha < U``
    (-inf elsewhere) and over ``alpha > L`` (+inf elsewhere)."""
    G_new = G - mu[:, None] * (k_i - k_j)
    return (G_new, torch.where(alpha_new < U, G_new, NEG_INF),
            torch.where(alpha_new > L, G_new, POS_INF))


def update_wss_batched_from_rows(G, k_i, k_j, mu, alpha_new, L, U):
    """Pass B update + stopping-scan algebra given both (B, l) rows.

    A lane with ``mu == 0`` is a bitwise no-op on G (the lane freeze).
    Returns (G_new (B, l), i_next (B,) int32, g_i_next (B,), g_dn (B,)).
    """
    G_new, vals_up, vals_dn = _update_vals(G, k_i, k_j, mu, alpha_new, L, U)
    i_next, g_i_next = _first_argmax(vals_up)
    return G_new, i_next, g_i_next, vals_dn.amin(dim=1)


def _rows_ij(X, sqn, XQi, sqqi, XQj, sqqj, gammas):
    """Both (B, l) rows k_i, k_j from one stacked (2B, d) x (d, l) product."""
    B = XQi.shape[0]
    Kr = rbf_rows_batched(X, sqn, torch.cat([XQi, XQj]),
                          torch.cat([sqqi, sqqj]),
                          torch.cat([gammas, gammas]))
    return Kr[:B], Kr[B:]


def rbf_update_wss_batched(X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj,
                           mu, gammas):
    """Batched pass B: k_i/k_j recompute + update + next i + gap ends."""
    k_i, k_j = _rows_ij(X, sqn, XQi, sqqi, XQj, sqqj, gammas)
    return update_wss_batched_from_rows(G, k_i, k_j, mu, alpha_new, L, U)


def bank_rows(gram, gram_idx, idx):
    """Rows ``gram[gram_idx, idx]`` of the Gram bank -> (B, l)."""
    return gram[gram_idx, idx.long()]


def gram_cross(X1, X2, gamma, *, out=None):
    """Cross Gram matrix k(X1, X2) -> (l1, l2), written into ``out`` when
    given."""
    s1 = torch.sum(X1 * X1, dim=-1)
    s2 = torch.sum(X2 * X2, dim=-1)
    d2 = s1[:, None] + s2[None, :] - 2.0 * (X1 @ X2.T)
    return torch.exp(-gamma * torch.clamp_min(d2, 0.0), out=out)


# ---------------------------------------------------------------------------
# Per-block outputs: the plain versions of what the CUDA passes return
# ---------------------------------------------------------------------------


def _blocks(vals, block_l: int, fill: float):
    """(B, l) -> (B, nb, block_l), the ragged tail padded with ``fill``."""
    B, l = vals.shape
    nb = -(-l // block_l)
    pad = vals.new_full((B, nb * block_l - l), fill)
    return torch.cat([vals, pad], dim=1).reshape(B, nb, block_l)


def block_first_max(vals, block_l: int):
    """Per-block (max, first argmax as a global int32 index) -> (B, nb)."""
    blk = _blocks(vals, block_l, NEG_INF)
    arg = torch.argmax(blk, dim=2)
    best = blk.gather(2, arg[..., None])[..., 0]
    base = torch.arange(blk.shape[1], device=vals.device) * block_l
    return best, (arg + base[None, :]).to(torch.int32)


def block_min(vals, block_l: int):
    return _blocks(vals, block_l, POS_INF).amin(dim=2)


def rbf_row_wss_batched_blocks(X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i,
                               U_i, g_i, i_idx, use_exact, gammas, *,
                               block_l: int):
    """Pass A as the kernel returns it: per-block (bmax, barg) (B, nb)."""
    k = rbf_rows_batched(X, sqn, XQ, sqq, gammas)
    return block_first_max(_wss_vals(k, G, alpha, L, U, a_i, L_i, U_i, g_i,
                                     i_idx, use_exact), block_l)


def rbf_update_wss_batched_blocks(X, sqn, G, alpha_new, L, U, XQi, sqqi,
                                  XQj, sqqj, mu, gammas, *, block_l: int):
    """Pass B as the kernel returns it: (G_new, bmax, barg, bmin)."""
    k_i, k_j = _rows_ij(X, sqn, XQi, sqqi, XQj, sqqj, gammas)
    G_new, vals_up, vals_dn = _update_vals(G, k_i, k_j, mu, alpha_new, L, U)
    bmax, barg = block_first_max(vals_up, block_l)
    return G_new, bmax, barg, block_min(vals_dn, block_l)


def row_wss_batched_rows_blocks(gram, gram_idx, G, alpha, L, U, a_i, L_i,
                                U_i, g_i, i_idx, use_exact, *, block_l: int):
    """Bank pass A as the kernel returns it: per-block (bmax, barg)."""
    k = bank_rows(gram, gram_idx, i_idx)
    return block_first_max(_wss_vals(k, G, alpha, L, U, a_i, L_i, U_i, g_i,
                                     i_idx, use_exact), block_l)


def update_wss_batched_rows_blocks(gram, gram_idx, G, alpha_new, L, U,
                                   i_idx, j_idx, mu, *, block_l: int):
    """Bank pass B as the kernel returns it: (G_new, bmax, barg, bmin)."""
    G_new, vals_up, vals_dn = _update_vals(
        G, bank_rows(gram, gram_idx, i_idx), bank_rows(gram, gram_idx, j_idx),
        mu, alpha_new, L, U)
    bmax, barg = block_first_max(vals_up, block_l)
    return G_new, bmax, barg, block_min(vals_dn, block_l)
