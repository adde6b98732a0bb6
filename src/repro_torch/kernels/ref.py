"""Plain PyTorch versions of the port's kernels: the CPU path and the
oracle every CUDA kernel is held against.

Each function repeats the arithmetic of ``repro.kernels.ref`` in the same
order.  Indices leave as int32, as in the reference's index channel.

The single-lane passes (:func:`rbf_row_wss`, :func:`rbf_update_wss`) take
(l,) state and 0-d scalars.  The batched passes take (B, n) lane state;
with ``dup=True`` the state is the doubled ε-SVR operator's (n = 2l) over
the base (l, d) ``X``: the row of coordinate ``k`` is the base row of
``k mod l``, tiled (:func:`tile_rows`).

The ``*_blocks`` functions are the plain versions of what the rbf CUDA
passes themselves return: the per-block (max, first argmax) and min over
``block_l`` columns, before the cross-block reduction in
:mod:`repro_torch.kernels.ops`.  With doubled state a block covers the
same ``block_l`` base columns in both halves, half 0 before half 1.  The
bank passes fold that reduction into their launch, so their plain
versions, :func:`row_wss_batched_bank` and :func:`update_wss_batched_bank`,
return the lanes' results.

``act``, an optional (B, n) bool active-set mask (soft shrinking), restricts
pass A's j-candidates and pass B's next-i scan and gap endpoints; pass B's
gradient update is never masked, so G stays exact on every coordinate.
With doubled state the mask is (B, 2l) and masks each half on its own.

``dirv``/``mu2`` engage pass B's Conjugate-SMO direction: ``dirv`` is the
previous direction's Q-product, ``mu2`` (B,) its per-lane step, and the
update gains ``- mu2 dirv`` after the ``mu`` update (the reference's
order); the pass then also returns ``r = k_i - k_j``, the next direction.
Both are (B, l) at base width, like the CUDA passes take and return them:
the doubled operator's direction is a tiled base row, so one base value
serves both halves (the reference carries it tiled; the values are the
same).  Without ``dirv`` the contracts are those of the plain step.
"""

from __future__ import annotations

import torch

TAU = 1e-12
NEG_INF = float("-inf")
POS_INF = float("inf")


# ---------------------------------------------------------------------------
# Single-lane passes (one QP, the kernel row stored between the passes)
# ---------------------------------------------------------------------------


def _lane(*scalars):
    """Single-lane scalars (0-d or (1,)) as the (1,) per-lane vectors of
    the batched algebra."""
    return [torch.as_tensor(s).reshape(1) for s in scalars]


def _row(X, sqn, xq, sqq, gamma):
    """k(x_q, X) from the query's squared norm -> (l,)."""
    d2 = sqq + sqn - 2.0 * (X @ xq)
    return torch.exp(-gamma * torch.clamp_min(d2, 0.0))


def rbf_row(X, sqn, xq, gamma):
    """k(x_q, X) for one query row -> (l,)."""
    return _row(X, sqn, xq, torch.dot(xq, xq), gamma)


def rbf_row_wss(X, sqn, G, alpha, L, U, xq, a_i, L_i, U_i, g_i, i_idx,
                use_exact, gamma):
    """Single-lane pass A: the kernel row k_i + WSS2 j-selection.

    Returns (k_i (l,), j (0-d int32), gain_j).
    """
    k = rbf_row(X, sqn, xq, gamma)
    j, gain = _first_argmax(_wss_vals(
        k[None], G[None], alpha[None], L[None], U[None], *_lane(
            a_i, L_i, U_i, g_i, i_idx, use_exact)))
    return k, j[0], gain[0]


def rbf_update_wss(X, sqn, G, k_i, xq_j, mu, alpha_new, L, U, gamma):
    """Single-lane pass B: row k_j, the gradient update with the stored
    k_i, the next i and the gap's other end.

    A ``mu == 0`` step is a bitwise no-op on G.  Returns
    (G_new (l,), i_next (0-d int32), g_i_next, g_dn).
    """
    k_j = rbf_row(X, sqn, xq_j, gamma)
    G_new, vals_up, vals_dn = _update_vals(G[None], k_i[None], k_j[None],
                                           mu.reshape(1), alpha_new[None],
                                           L[None], U[None])
    i_next, g_i_next = _first_argmax(vals_up)
    return G_new[0], i_next[0], g_i_next[0], vals_dn.amin()


def rbf_row_wss_blocks(X, sqn, G, alpha, L, U, xq, sqq, a_i, L_i, U_i, g_i,
                       i_idx, use_exact, gamma, *, block_l: int):
    """Single-lane pass A as kernel 6 returns it: (k (l,), bmax (nb,),
    barg (nb,) int32), the query's squared norm ``sqq`` given."""
    k = _row(X, sqn, xq, sqq, gamma)
    bmax, barg = block_first_max(_wss_vals(
        k[None], G[None], alpha[None], L[None], U[None], *_lane(
            a_i, L_i, U_i, g_i, i_idx, use_exact)), block_l)
    return k, bmax[0], barg[0]


def rbf_update_wss_blocks(X, sqn, G, k_i, alpha_new, L, U, xq_j, sqq_j, mu,
                          gamma, *, block_l: int):
    """Single-lane pass B as kernel 7 returns it: (G_new (l,), bmax (nb,),
    barg (nb,) int32, bmin (nb,)), the query's squared norm given."""
    k_j = _row(X, sqn, xq_j, sqq_j, gamma)
    G_new, vals_up, vals_dn = _update_vals(G[None], k_i[None], k_j[None],
                                           mu.reshape(1), alpha_new[None],
                                           L[None], U[None])
    bmax, barg = block_first_max(vals_up, block_l)
    return G_new[0], bmax[0], barg[0], block_min(vals_dn, block_l)[0]


# ---------------------------------------------------------------------------
# Batched passes (one lane per QP over a shared X)
# ---------------------------------------------------------------------------


def tile_rows(k):
    """Doubled-operator rows: (B, l) base rows -> (B, 2l).

    Row k of ``Q = [[K, K], [K, K]]`` is the base row tiled."""
    return torch.cat([k, k], dim=1)


def rbf_rows_batched(X, sqn, XQ, sqq, gammas, dup: bool = False):
    """k(x_q^b, X) for a batch of query rows -> (B, l), or the doubled
    operator's (B, 2l) rows with ``dup=True`` (the product stays l-wide)."""
    d2 = sqq[:, None] + sqn[None, :] - 2.0 * (XQ @ X.T)
    k = torch.exp(-gammas[:, None] * torch.clamp_min(d2, 0.0))
    return tile_rows(k) if dup else k


def _wss_vals(k, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx, use_exact,
              act=None):
    """Masked WSS2 gains per lane and column (-inf where not selectable,
    and outside the active set ``act`` when given)."""
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
    if act is not None:
        mask = mask & act
    return torch.where(mask, gains, NEG_INF)


def _first_argmax(vals):
    """Row-wise first maximum as (int32 index, value); index 0 for an
    all -inf row, like ``jax.lax.argmax``."""
    j = torch.argmax(vals, dim=1)
    return j.to(torch.int32), vals.gather(1, j[:, None])[:, 0]


def row_wss_batched_from_k(k, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx,
                           use_exact, act=None):
    """Pass A selection algebra given the (B, n) kernel rows ``k``.

    RBF diag == 1 is hardcoded (paper setting).  ``act`` restricts the
    j-candidates.  Returns (j (B,) int32, gain_j (B,)).
    """
    return _first_argmax(_wss_vals(k, G, alpha, L, U, a_i, L_i, U_i, g_i,
                                   i_idx, use_exact, act))


def rbf_row_wss_batched(X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i,
                        g_i, i_idx, use_exact, gammas, dup: bool = False,
                        act=None):
    """Batched pass A: WSS2 j-selection per lane -> (j (B,) int32, gain)."""
    k = rbf_rows_batched(X, sqn, XQ, sqq, gammas, dup=dup)
    return row_wss_batched_from_k(k, G, alpha, L, U, a_i, L_i, U_i, g_i,
                                  i_idx, use_exact, act)


def _update_vals(G, k_i, k_j, mu, alpha_new, L, U, act=None, dirv=None,
                 mu2=None):
    """G_new and the masked values of its two scans: over ``alpha < U``
    (-inf elsewhere) and over ``alpha > L`` (+inf elsewhere), both within
    ``act`` when given.  The update itself is never masked; the (B, l)
    ``dirv`` adds ``- mu2 dirv`` to every half after the ``mu`` step."""
    G_new = G - mu[:, None] * (k_i - k_j)
    if dirv is not None:
        B, l = dirv.shape
        G_new = (G_new.view(B, -1, l)
                 - mu2[:, None, None] * dirv[:, None, :]).view(G.shape)
    up, dn = alpha_new < U, alpha_new > L
    if act is not None:
        up, dn = up & act, dn & act
    return (G_new, torch.where(up, G_new, NEG_INF),
            torch.where(dn, G_new, POS_INF))


def update_wss_batched_from_rows(G, k_i, k_j, mu, alpha_new, L, U,
                                 act=None, dirv=None, mu2=None):
    """Pass B update + stopping-scan algebra given both (B, n) rows.

    A lane with ``mu == 0`` (and ``mu2 == 0``) is a bitwise no-op on G
    (the lane freeze).  ``act`` restricts the scans, not the update.
    Returns (G_new (B, n), i_next (B,) int32, g_i_next (B,), g_dn (B,)),
    and with the (B, l) direction ``dirv`` a fifth, the base row
    difference ``r = k_i - k_j`` (B, l).
    """
    G_new, vals_up, vals_dn = _update_vals(G, k_i, k_j, mu, alpha_new, L, U,
                                           act, dirv, mu2)
    i_next, g_i_next = _first_argmax(vals_up)
    out = (G_new, i_next, g_i_next, vals_dn.amin(dim=1))
    return out if dirv is None else out + (_base_r(k_i, k_j, dirv),)


def _base_r(k_i, k_j, dirv):
    """The next direction: the base row difference, at ``dirv``'s width."""
    return (k_i - k_j)[:, :dirv.shape[1]]


def _rows_ij(X, sqn, XQi, sqqi, XQj, sqqj, gammas, dup=False):
    """Both rows k_i, k_j from one stacked (2B, d) x (d, l) product."""
    B = XQi.shape[0]
    Kr = rbf_rows_batched(X, sqn, torch.cat([XQi, XQj]),
                          torch.cat([sqqi, sqqj]),
                          torch.cat([gammas, gammas]), dup=dup)
    return Kr[:B], Kr[B:]


def rbf_update_wss_batched(X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj,
                           mu, gammas, dup: bool = False, act=None,
                           dirv=None, mu2=None):
    """Batched pass B: k_i/k_j recompute + update + next i + gap ends (and
    ``r`` with the (B, l) direction ``dirv``)."""
    k_i, k_j = _rows_ij(X, sqn, XQi, sqqi, XQj, sqqj, gammas, dup)
    return update_wss_batched_from_rows(G, k_i, k_j, mu, alpha_new, L, U,
                                        act, dirv, mu2)


def bank_rows(gram, gram_idx, idx, dup: bool = False):
    """Rows ``gram[gram_idx, idx]`` of the Gram bank -> (B, l), or the
    doubled operator's tiled (B, 2l) rows (``idx`` folded onto the base
    axis) with ``dup=True``.  With ``gram_idx`` None, ``gram`` holds the
    lanes' (B, l) base rows already (``idx`` is not read)."""
    if gram_idx is None:
        k = gram
    else:
        k = gram[gram_idx, idx.long() % gram.shape[-1]]
    return tile_rows(k) if dup else k


def row_wss_batched_bank(gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i,
                         g_i, i_idx, use_exact, dup: bool = False,
                         act=None):
    """Bank pass A: the WSS2 pick from the lanes' bank rows (:func:`bank_rows`;
    with ``gram_idx`` None, ``gram`` holds the (B, l) rows) -> (j (B,)
    int32, gain (B,)), what the bank kernel returns."""
    return row_wss_batched_from_k(bank_rows(gram, gram_idx, i_idx, dup), G,
                                  alpha, L, U, a_i, L_i, U_i, g_i, i_idx,
                                  use_exact, act)


def update_wss_batched_bank(gram, gram_idx, G, alpha_new, L, U, i_idx,
                            j_idx, mu, dup: bool = False, act=None,
                            dirv=None, mu2=None):
    """Bank pass B from the lanes' bank rows i and j -> (G_new, i_next
    int32, g_i_next, g_dn), and ``r`` with the direction ``dirv``, what the
    bank kernel returns.  With ``gram_idx`` None, ``gram`` is the pair of
    pre-gathered (B, l) rows ``(KRi, KRj)``."""
    gi, gj = gram if gram_idx is None else (gram, gram)
    return update_wss_batched_from_rows(
        G, bank_rows(gi, gram_idx, i_idx, dup),
        bank_rows(gj, gram_idx, j_idx, dup), mu, alpha_new, L, U, act, dirv,
        mu2)


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


def _half_first_max(vals, block_l: int):
    blk = _blocks(vals, block_l, NEG_INF)
    arg = torch.argmax(blk, dim=2)
    best = blk.gather(2, arg[..., None])[..., 0]
    base = torch.arange(blk.shape[1], device=vals.device) * block_l
    return best, arg + base[None, :]


def block_first_max(vals, block_l: int, H: int = 1):
    """Per-block (max, first argmax as a global int32 index) -> (B, nb).

    ``vals`` is (B, H l): with H = 2 block b covers base columns
    ``[b block_l, (b + 1) block_l)`` of both halves, and half 1 wins only
    with a strictly larger value (its indices are the larger ones)."""
    l = vals.shape[1] // H
    best, arg = _half_first_max(vals[:, :l], block_l)
    for h in range(1, H):
        m, a = _half_first_max(vals[:, h * l:(h + 1) * l], block_l)
        arg = torch.where(m > best, a + h * l, arg)
        best = torch.maximum(m, best)
    return best, arg.to(torch.int32)


def block_min(vals, block_l: int, H: int = 1):
    """Per-block min -> (B, nb), over both halves with H = 2."""
    l = vals.shape[1] // H
    return torch.stack([_blocks(vals[:, h * l:(h + 1) * l], block_l,
                                POS_INF).amin(dim=2)
                        for h in range(H)]).amin(dim=0)


def rbf_row_wss_batched_blocks(X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i,
                               U_i, g_i, i_idx, use_exact, gammas, *,
                               block_l: int, dup: bool = False, act=None):
    """Pass A as the kernel returns it: per-block (bmax, barg) (B, nb)."""
    k = rbf_rows_batched(X, sqn, XQ, sqq, gammas, dup=dup)
    return block_first_max(_wss_vals(k, G, alpha, L, U, a_i, L_i, U_i, g_i,
                                     i_idx, use_exact, act), block_l,
                           2 if dup else 1)


def _blocks_b(G, k_i, k_j, mu, alpha_new, L, U, block_l, dup, act, dirv,
              mu2):
    """Pass B per block from the (B, n) rows: (G_new, bmax, barg, bmin),
    and ``r`` with ``dirv``."""
    H = 2 if dup else 1
    G_new, vals_up, vals_dn = _update_vals(G, k_i, k_j, mu, alpha_new, L, U,
                                           act, dirv, mu2)
    bmax, barg = block_first_max(vals_up, block_l, H)
    out = (G_new, bmax, barg, block_min(vals_dn, block_l, H))
    return out if dirv is None else out + (_base_r(k_i, k_j, dirv),)


def rbf_update_wss_batched_blocks(X, sqn, G, alpha_new, L, U, XQi, sqqi,
                                  XQj, sqqj, mu, gammas, *, block_l: int,
                                  dup: bool = False, act=None, dirv=None,
                                  mu2=None):
    """Pass B as the kernel returns it: (G_new, bmax, barg, bmin), and the
    base-width (B, l) ``r`` with the base-width direction ``dirv``."""
    k_i, k_j = _rows_ij(X, sqn, XQi, sqqi, XQj, sqqj, gammas, dup)
    return _blocks_b(G, k_i, k_j, mu, alpha_new, L, U, block_l, dup, act,
                     dirv, mu2)
