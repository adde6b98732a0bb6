"""Pass B wrappers: the gradient update + stopping-scan kernels, with both
rows recomputed from ``X`` (``csrc/rbf_update_wss.cuh``: lane-batched with
one or two state halves; ``csrc/rbf_update_wss_single.cu``: single-lane
reading the stored k_i) or read
from the Gram bank (``csrc/update_wss_rows.cu``: one or two state
halves).  The ``*_act`` wrappers launch the variants whose scans stay
within a (B, n) bool active-set mask (soft shrinking); their update of G
covers every coordinate.  The ``*_conj`` wrappers launch the Conjugate-SMO
variants (one or two halves, with or without the mask): they take the
previous direction's base-width row ``dirv`` and per-lane ``mu2``, add
``- mu2 dirv`` to the update and return the base row difference
``r = k_i - k_j`` as a fifth output.

On CUDA tensors each launches its kernel on the current stream; on CPU
tensors it runs the plain version.  The rbf passes return the new gradient
with the per-block next-i (max, first argmax) and gap minimum (plain
versions :func:`repro_torch.kernels.ref.rbf_update_wss_batched_blocks`,
:func:`repro_torch.kernels.ref.rbf_update_wss_blocks`); the bank passes
fold the cross-block reductions into their launch and return the new
gradient with the lanes' (i_next, g_i_next, g_dn)
(:func:`repro_torch.kernels.ref.update_wss_batched_bank`).  There is no
fallback from one to the other.  Each wrapper's ``launches`` attribute
counts its kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, lane_pick, ref, tally
from repro_torch.kernels.checks import (act_ptr, bank_strides,
                                        check_lane_scalars, check_state,
                                        dirv_ptr, dtype_bits, on_card)


def _batched(X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj, mu, gammas,
             XT, H: int, act=None, dirv=None, mu2=None):
    """Launch the lane-batched pass B over ``H`` state halves, its scans
    within the active set ``act`` when given, with the conjugate direction
    ``dirv``/``mu2`` when given (then ``r`` is returned fifth)."""
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
    dptr, m2ptr = dirv_ptr(dirv, mu2, G, H)
    G_out, bmax, barg, bmin, r_out = _outputs(G, l, dirv is not None)
    fn = build.entry("rbf_update_wss_batched", dtype_bits(dtype))
    ptrs = [t.data_ptr() for t in (XT, sqn, G, alpha_new, L, U, XQi, sqqi,
                                   XQj, sqqj, mu, gammas)]
    err = fn(*ptrs, aptr, dptr, m2ptr,
             *[t.data_ptr() for t in (G_out, bmax, barg, bmin)],
             None if r_out is None else r_out.data_ptr(),
             B, H, l, d, G.device.index,
             torch.cuda.current_stream(G.device).cuda_stream)
    build.check(err, "rbf_update_wss_batched")
    out = (G_out, bmax, barg, bmin)
    return out if r_out is None else out + (r_out,)


def _outputs(G, l: int, conj: bool):
    """The batched passes' outputs for the (B, n) state ``G``: G_out, the
    (B, nb) block max, arg and min, and the (B, l) ``r`` (None without the
    conjugate direction)."""
    B = G.shape[0]
    nb = -(-l // build.BLOCK_L)
    bmax = torch.empty((B, nb), dtype=G.dtype, device=G.device)
    barg = torch.empty((B, nb), dtype=torch.int32, device=G.device)
    bmin = torch.empty((B, nb), dtype=G.dtype, device=G.device)
    r_out = (torch.empty((B, l), dtype=G.dtype, device=G.device) if conj
             else None)
    return torch.empty_like(G), bmax, barg, bmin, r_out


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
    tally.count(rbf_update_wss_batched)
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
    tally.count(rbf_update_wss_batched_h2)
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
    tally.count(rbf_update_wss_batched_act)
    return out


rbf_update_wss_batched_act.launches = 0


def rbf_update_wss_batched_conj(X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj,
                                sqqj, mu, gammas, dirv, mu2, *, XT=None,
                                dup: bool = False, act=None):
    """Batched pass B with the Conjugate-SMO direction.

    As :func:`rbf_update_wss_batched` (``dup=True``: the doubled operator's
    two halves; ``act``: scans within the (B, n) bool mask), with ``dirv``
    the previous direction's (B, l) base-width row and ``mu2`` (B,) its
    step: G gains ``- mu2 dirv`` after the ``mu`` update, on every half.
    A lane with ``mu == mu2 == 0`` leaves G bitwise unchanged.  Returns
    (G_new, bmax, barg int32, bmin, r (B, l) = k_i - k_j).
    """
    if not on_card(G, "pass B"):
        return ref.rbf_update_wss_batched_blocks(
            X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj, mu, gammas,
            block_l=build.BLOCK_L, dup=dup, act=act, dirv=dirv, mu2=mu2)
    out = _batched(X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj, mu,
                   gammas, XT, 2 if dup else 1, act, dirv, mu2)
    tally.count(rbf_update_wss_batched_conj)
    return out


rbf_update_wss_batched_conj.launches = 0


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
    tally.count(rbf_update_wss)
    build.check(err, "rbf_update_wss")
    return G_out, bmax, barg, bmin


rbf_update_wss.launches = 0


def _bank(gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu, H: int,
          act=None, dirv=None, mu2=None):
    """Launch bank pass B over ``H`` state halves, its scans within the
    active set ``act`` when given, with the conjugate direction
    ``dirv``/``mu2`` when given (then ``r`` is returned fifth): one
    launch, the lanes' picks and minima folded in."""
    B, n = G.shape
    l = n // H
    dtype = G.dtype
    if gram_idx is None:
        gram_i, gram_j = gram
        strides = bank_strides("KRi", gram_i, None, B, l, dtype, G.device)
        bank_strides("KRj", gram_j, None, B, l, dtype, G.device)
    else:
        gram_i = gram_j = gram
        strides = bank_strides("gram", gram, gram_idx, B, l, dtype,
                               G.device)
        check_lane_scalars(B, G.device, torch.int32, i_idx=i_idx,
                           j_idx=j_idx)
    for name, t in (("G", G), ("alpha_new", alpha_new), ("L", L), ("U", U)):
        check_state(name, t, (B, H * l), dtype, G.device)
    check_lane_scalars(B, G.device, dtype, mu=mu)
    aptr = act_ptr(act, G)
    dptr, m2ptr = dirv_ptr(dirv, mu2, G, H)
    part_v, part_m, part_i, nb_cap = lane_pick.partials(B, l, dtype,
                                                        G.device, 2)
    G_out = torch.empty_like(G)
    i_next = torch.empty((B,), dtype=torch.int32, device=G.device)
    g_i_next = torch.empty((B,), dtype=dtype, device=G.device)
    g_dn = torch.empty((B,), dtype=dtype, device=G.device)
    r_out = (torch.empty((B, l), dtype=dtype, device=G.device)
             if dirv is not None else None)
    fn = build.entry("update_wss_batched_rows", dtype_bits(dtype))
    rows = (None,) * 3 if gram_idx is None else (gram_idx, i_idx, j_idx)
    ptrs = [None if t is None else t.data_ptr()
            for t in (gram_i, gram_j, *rows, G, alpha_new, L, U, mu)]
    err = fn(*ptrs, aptr, dptr, m2ptr,
             *[t.data_ptr() for t in (G_out, part_v, part_i, part_m,
                                      lane_pick.tickets(G.device), i_next,
                                      g_i_next, g_dn)],
             None if r_out is None else r_out.data_ptr(),
             B, H, l, nb_cap, *strides, G.device.index,
             torch.cuda.current_stream(G.device).cuda_stream)
    build.check(err, "update_wss_batched_rows")
    out = (G_out, i_next, g_i_next, g_dn)
    return out if r_out is None else out + (r_out,)


def update_wss_batched_rows(gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx,
                            mu):
    """Batched pass B over the Gram bank ``gram`` (n_stack, l, l).

    Lane b's rows are ``gram[gram_idx[b], i_idx[b]]`` and
    ``gram[gram_idx[b], j_idx[b]]``, read by the kernel in place;
    ``i_idx``/``j_idx`` are (B,) int32, ``gram_idx`` (B,) int64 and ``mu``
    (B,) in the data dtype.  With ``gram_idx`` None, ``gram`` is the pair
    of pre-gathered rows ``(KRi, KRj)``, each (B, l) (the reference's
    form), and ``i_idx``/``j_idx`` are not read (None will do).  G is
    written out of place.  Returns (G_new (B, l), i_next (B,) int32,
    g_i_next (B,), g_dn (B,)): the kernel reduces across its blocks in the
    same launch.
    """
    if not on_card(G, "bank pass B"):
        return ref.update_wss_batched_bank(gram, gram_idx, G, alpha_new, L,
                                           U, i_idx, j_idx, mu)
    out = _bank(gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu, 1)
    tally.count(update_wss_batched_rows)
    return out


update_wss_batched_rows.launches = 0


def update_wss_batched_rows_h2(gram, gram_idx, G, alpha_new, L, U, i_idx,
                               j_idx, mu):
    """Bank pass B for the doubled ε-SVR operator (H = 2 state halves).

    As :func:`update_wss_batched_rows`, with (B, 2l) state over the
    (n_stack, l, l) base bank and doubled indices ``i_idx``/``j_idx``: the
    rows are the base rows of ``i mod l`` and ``j mod l``, and both halves
    take the same update.  Returns (G_new (B, 2l), i_next (B,) int32, a
    doubled index, g_i_next, g_dn).
    """
    if not on_card(G, "bank pass B"):
        return ref.update_wss_batched_bank(gram, gram_idx, G, alpha_new, L,
                                           U, i_idx, j_idx, mu, dup=True)
    out = _bank(gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu, 2)
    tally.count(update_wss_batched_rows_h2)
    return out


update_wss_batched_rows_h2.launches = 0


def update_wss_batched_rows_act(gram, gram_idx, G, alpha_new, L, U, i_idx,
                                j_idx, mu, act, *, dup: bool = False):
    """Bank pass B with its scans within a per-lane active set (soft
    shrinking): as :func:`update_wss_batched_rows` (or
    :func:`update_wss_batched_rows_h2` with ``dup=True``), with ``act`` a
    (B, n) bool mask that the update of G ignores.  Returns (G_new,
    i_next int32, g_i_next, g_dn)."""
    if not on_card(G, "bank pass B"):
        return ref.update_wss_batched_bank(gram, gram_idx, G, alpha_new, L,
                                           U, i_idx, j_idx, mu, dup=dup,
                                           act=act)
    out = _bank(gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu,
                2 if dup else 1, act)
    tally.count(update_wss_batched_rows_act)
    return out


update_wss_batched_rows_act.launches = 0


def update_wss_batched_rows_conj(gram, gram_idx, G, alpha_new, L, U, i_idx,
                                 j_idx, mu, dirv, mu2, *, dup: bool = False,
                                 act=None):
    """Bank pass B with the Conjugate-SMO direction: as
    :func:`update_wss_batched_rows` (``dup=True``: the H = 2 halves;
    ``act``: scans within the mask), with the (B, l) base-width direction
    ``dirv`` and per-lane ``mu2`` as in :func:`rbf_update_wss_batched_conj`.
    Returns (G_new, i_next int32, g_i_next, g_dn, r (B, l))."""
    if not on_card(G, "bank pass B"):
        return ref.update_wss_batched_bank(gram, gram_idx, G, alpha_new, L,
                                           U, i_idx, j_idx, mu, dup=dup,
                                           act=act, dirv=dirv, mu2=mu2)
    out = _bank(gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu,
                2 if dup else 1, act, dirv, mu2)
    tally.count(update_wss_batched_rows_conj)
    return out


update_wss_batched_rows_conj.launches = 0
