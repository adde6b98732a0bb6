"""Pass B wrappers: the gradient update + stopping-scan kernels, with both
rows recomputed from ``X`` (``csrc/rbf_update_wss.cu``: lane-batched with
one or two state halves, and single-lane reading the stored k_i) or read
from the Gram bank (``csrc/update_wss_rows.cu``: one or two state
halves).  The ``*_act`` wrappers launch the variants whose scans stay
within a (B, n) bool active-set mask (soft shrinking); their update of G
covers every coordinate.

On CUDA tensors each launches its kernel on the current stream and returns
the new gradient with the per-block next-i (max, first argmax) and gap
minimum; on CPU tensors it runs the plain version
(:func:`repro_torch.kernels.ref.rbf_update_wss_batched_blocks`,
:func:`repro_torch.kernels.ref.rbf_update_wss_blocks`,
:func:`repro_torch.kernels.ref.update_wss_batched_rows_blocks`).  There is
no fallback from one to the other.  Each wrapper's ``launches`` attribute
counts its kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.checks import (act_ptr, check_bank,
                                        check_lane_scalars, check_state,
                                        dtype_bits, on_card)


def _batched(X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj, mu, gammas,
             XT, H: int, act=None):
    """Launch the lane-batched pass B over ``H`` state halves, its scans
    within the active set ``act`` when given."""
    l, d = X.shape
    B = G.shape[0]
    if XT is None:
        XT = X.T.contiguous()
    dtype = G.dtype
    check_state("XT", XT, (d, l), dtype, G.device)
    check_state("sqn", sqn, (l,), dtype, G.device)
    for name, t in (("G", G), ("alpha_new", alpha_new), ("L", L), ("U", U)):
        check_state(name, t, (B, H * l), dtype, G.device)
    check_state("XQi", XQi, (B, d), dtype, G.device)
    check_state("XQj", XQj, (B, d), dtype, G.device)
    check_lane_scalars(B, G.device, dtype, sqqi=sqqi, sqqj=sqqj, mu=mu,
                       gammas=gammas)
    aptr = act_ptr(act, G)
    nb = -(-l // build.BLOCK_L)
    G_out = torch.empty_like(G)
    bmax = torch.empty((B, nb), dtype=dtype, device=G.device)
    barg = torch.empty((B, nb), dtype=torch.int32, device=G.device)
    bmin = torch.empty((B, nb), dtype=dtype, device=G.device)
    fn = build.entry("rbf_update_wss_batched", dtype_bits(dtype))
    ptrs = [t.data_ptr() for t in (XT, sqn, G, alpha_new, L, U, XQi, sqqi,
                                   XQj, sqqj, mu, gammas)]
    err = fn(*ptrs, aptr, *[t.data_ptr() for t in (G_out, bmax, barg,
                                                      bmin)],
             B, H, l, d, G.device.index,
             torch.cuda.current_stream(G.device).cuda_stream)
    build.check(err, "rbf_update_wss_batched")
    return G_out, bmax, barg, bmin


def rbf_update_wss_batched(X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj,
                           mu, gammas, *, XT=None):
    """Batched pass B over the shared ``X`` (l, d), one state half.

    ``G``/``alpha_new``/``L``/``U`` are (B, l); ``XQi``/``XQj`` the (B, d)
    rows of the working sets; ``sqqi``/``sqqj``/``mu``/``gammas`` (B,) in
    the data dtype.  ``XT`` is ``X`` transposed to (d, l), made here when
    not given.  G is written out of place.  Returns (G_new (B, l),
    bmax (B, nb), barg (B, nb) int32, bmin (B, nb)).
    """
    if not on_card(G, "pass B"):
        return ref.rbf_update_wss_batched_blocks(
            X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj, mu, gammas,
            block_l=build.BLOCK_L)
    out = _batched(X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj, mu,
                   gammas, XT, 1)
    rbf_update_wss_batched.launches += 1
    return out


rbf_update_wss_batched.launches = 0


def rbf_update_wss_batched_h2(X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj,
                              sqqj, mu, gammas, *, XT=None):
    """Batched pass B for the doubled ε-SVR operator (H = 2 state halves).

    As :func:`rbf_update_wss_batched`, with (B, 2l) state over the base
    ``X`` (l, d) and ``XQi``/``XQj`` the base rows of the working sets;
    both halves take the same update.  Returns (G_new (B, 2l),
    bmax (B, nb), barg (B, nb) int32 with doubled indices, bmin (B, nb)).
    """
    if not on_card(G, "pass B"):
        return ref.rbf_update_wss_batched_blocks(
            X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj, mu, gammas,
            block_l=build.BLOCK_L, dup=True)
    out = _batched(X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj, mu,
                   gammas, XT, 2)
    rbf_update_wss_batched_h2.launches += 1
    return out


rbf_update_wss_batched_h2.launches = 0


def rbf_update_wss_batched_act(X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj,
                               sqqj, mu, gammas, act, *, XT=None,
                               dup: bool = False):
    """Batched pass B with its scans within a per-lane active set (soft
    shrinking).

    As :func:`rbf_update_wss_batched` (or, with ``dup=True``,
    :func:`rbf_update_wss_batched_h2`), with ``act`` a (B, n) bool mask:
    the next-i scan and the gap's minimum skip the coordinates outside it,
    while G is updated on every coordinate.  Returns (G_new, bmax, barg
    int32, bmin).
    """
    if not on_card(G, "pass B"):
        return ref.rbf_update_wss_batched_blocks(
            X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj, mu, gammas,
            block_l=build.BLOCK_L, dup=dup, act=act)
    out = _batched(X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj, mu,
                   gammas, XT, 2 if dup else 1, act)
    rbf_update_wss_batched_act.launches += 1
    return out


rbf_update_wss_batched_act.launches = 0


def rbf_update_wss(X, sqn, G, k_i, alpha_new, L, U, xq_j, sqq_j, mu, gamma,
                   *, XT=None):
    """Single-lane pass B over ``X`` (l, d) with the stored row ``k_i``.

    ``G``/``k_i``/``alpha_new``/``L``/``U`` are (l,), ``xq_j`` the (d,)
    row of j; ``sqq_j``/``mu``/``gamma`` hold one value each (0-d or (1,))
    in the data dtype.  G is written out of place; ``mu == 0`` leaves it
    bitwise unchanged.  Returns (G_new (l,), bmax (nb,), barg (nb,) int32,
    bmin (nb,)).
    """
    if not on_card(G, "pass B"):
        return ref.rbf_update_wss_blocks(
            X, sqn, G, k_i, alpha_new, L, U, xq_j, sqq_j, mu, gamma,
            block_l=build.BLOCK_L)
    l, d = X.shape
    if XT is None:
        XT = X.T.contiguous()
    dtype = G.dtype
    check_state("XT", XT, (d, l), dtype, G.device)
    for name, t in (("sqn", sqn), ("G", G), ("k_i", k_i),
                    ("alpha_new", alpha_new), ("L", L), ("U", U)):
        check_state(name, t, (l,), dtype, G.device)
    check_state("xq_j", xq_j, (d,), dtype, G.device)
    check_lane_scalars(1, G.device, dtype, sqq_j=sqq_j.reshape(1),
                       mu=mu.reshape(1), gamma=gamma.reshape(1))
    nb = -(-l // build.BLOCK_L)
    G_out = torch.empty_like(G)
    bmax = torch.empty((nb,), dtype=dtype, device=G.device)
    barg = torch.empty((nb,), dtype=torch.int32, device=G.device)
    bmin = torch.empty((nb,), dtype=dtype, device=G.device)
    fn = build.entry("rbf_update_wss", dtype_bits(dtype))
    ptrs = [t.data_ptr() for t in (XT, sqn, G, k_i, alpha_new, L, U, xq_j,
                                   sqq_j, mu, gamma, G_out, bmax, barg,
                                   bmin)]
    err = fn(*ptrs, l, d, G.device.index,
             torch.cuda.current_stream(G.device).cuda_stream)
    rbf_update_wss.launches += 1
    build.check(err, "rbf_update_wss")
    return G_out, bmax, barg, bmin


rbf_update_wss.launches = 0


def _bank(gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu, H: int,
          act=None):
    """Launch bank pass B over ``H`` state halves, its scans within the
    active set ``act`` when given."""
    B, n = G.shape
    l = n // H
    dtype = G.dtype
    check_bank(gram, gram_idx, B, l, dtype, G.device)
    for name, t in (("G", G), ("alpha_new", alpha_new), ("L", L), ("U", U)):
        check_state(name, t, (B, H * l), dtype, G.device)
    check_lane_scalars(B, G.device, dtype, mu=mu)
    check_lane_scalars(B, G.device, torch.int32, i_idx=i_idx, j_idx=j_idx)
    aptr = act_ptr(act, G)
    nb = -(-l // build.BLOCK_L)
    G_out = torch.empty_like(G)
    bmax = torch.empty((B, nb), dtype=dtype, device=G.device)
    barg = torch.empty((B, nb), dtype=torch.int32, device=G.device)
    bmin = torch.empty((B, nb), dtype=dtype, device=G.device)
    fn = build.entry("update_wss_batched_rows", dtype_bits(dtype))
    ptrs = [t.data_ptr() for t in (gram, gram_idx, i_idx, j_idx, G,
                                   alpha_new, L, U, mu)]
    err = fn(*ptrs, aptr, *[t.data_ptr() for t in (G_out, bmax, barg,
                                                      bmin)],
             B, H, l, G.device.index,
             torch.cuda.current_stream(G.device).cuda_stream)
    build.check(err, "update_wss_batched_rows")
    return G_out, bmax, barg, bmin


def update_wss_batched_rows(gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx,
                            mu):
    """Batched pass B over the Gram bank ``gram`` (n_stack, l, l).

    Lane b's rows are ``gram[gram_idx[b], i_idx[b]]`` and
    ``gram[gram_idx[b], j_idx[b]]``, read by the kernel in place;
    ``i_idx``/``j_idx`` are (B,) int32, ``gram_idx`` (B,) int64 and ``mu``
    (B,) in the data dtype.  G is written out of place.  Returns
    (G_new (B, l), bmax (B, nb), barg (B, nb) int32, bmin (B, nb)).
    """
    if not on_card(G, "bank pass B"):
        return ref.update_wss_batched_rows_blocks(
            gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu,
            block_l=build.BLOCK_L)
    out = _bank(gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu, 1)
    update_wss_batched_rows.launches += 1
    return out


update_wss_batched_rows.launches = 0


def update_wss_batched_rows_h2(gram, gram_idx, G, alpha_new, L, U, i_idx,
                               j_idx, mu):
    """Bank pass B for the doubled ε-SVR operator (H = 2 state halves).

    As :func:`update_wss_batched_rows`, with (B, 2l) state over the
    (n_stack, l, l) base bank and doubled indices ``i_idx``/``j_idx``: the
    rows are the base rows of ``i mod l`` and ``j mod l``, and both halves
    take the same update.  Returns (G_new (B, 2l), bmax (B, nb),
    barg (B, nb) int32 with doubled indices, bmin (B, nb)).
    """
    if not on_card(G, "bank pass B"):
        return ref.update_wss_batched_rows_blocks(
            gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu,
            block_l=build.BLOCK_L, dup=True)
    out = _bank(gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu, 2)
    update_wss_batched_rows_h2.launches += 1
    return out


update_wss_batched_rows_h2.launches = 0


def update_wss_batched_rows_act(gram, gram_idx, G, alpha_new, L, U, i_idx,
                                j_idx, mu, act, *, dup: bool = False):
    """Bank pass B with its scans within a per-lane active set (soft
    shrinking): as :func:`update_wss_batched_rows` (or
    :func:`update_wss_batched_rows_h2` with ``dup=True``), with ``act`` a
    (B, n) bool mask that the update of G ignores.  Returns (G_new, bmax,
    barg int32, bmin)."""
    if not on_card(G, "bank pass B"):
        return ref.update_wss_batched_rows_blocks(
            gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu,
            block_l=build.BLOCK_L, dup=dup, act=act)
    out = _bank(gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu,
                2 if dup else 1, act)
    update_wss_batched_rows_act.launches += 1
    return out


update_wss_batched_rows_act.launches = 0
