"""Pass A wrappers: the WSS2 selection kernels, with rows recomputed from
``X`` (``csrc/rbf_row_wss.cuh``: lane-batched with one or two state
halves; ``csrc/rbf_row_wss_single.cu``: single-lane with the row stored) or read from the Gram bank
(``csrc/row_wss_rows.cu``: one or two state halves).  The ``*_act``
wrappers launch the variants that take a (B, n) bool active-set mask
(soft shrinking), with one state half or two (``dup=True``).

On CUDA tensors each launches its kernel on the current stream; on CPU
tensors it runs the plain version.  The rbf passes return the per-block
(max, first argmax) pairs (plain versions
:func:`repro_torch.kernels.ref.rbf_row_wss_batched_blocks`,
:func:`repro_torch.kernels.ref.rbf_row_wss_blocks`); the bank passes fold
the cross-block pick into their launch and return the lanes' (j, gain)
(:func:`repro_torch.kernels.ref.row_wss_batched_bank`).  There is no
fallback from one to the other.  Each wrapper's ``launches`` attribute
counts its kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, lane_pick, ref, tally
from repro_torch.kernels.checks import (act_ptr, bank_strides,
                                        check_lane_scalars, check_state,
                                        dtype_bits, on_card)


def _batched(X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i, g_i, i_idx,
             use_exact, gammas, XT, H: int, act=None):
    """Launch the lane-batched pass A over ``H`` state halves, within the
    active set ``act`` when given."""
    l, d = X.shape
    B = G.shape[0]
    if XT is None:
        XT = X.T.contiguous()
    dtype = G.dtype
    check_state("XT", XT, (d, l), dtype, G.device)
    check_state("sqn", sqn, (l,), dtype, G.device)
    for name, t in (("G", G), ("alpha", alpha), ("L", L), ("U", U)):
        check_state(name, t, (B, H * l), dtype, G.device)
    check_state("XQ", XQ, (B, d), dtype, G.device)
    check_lane_scalars(B, G.device, dtype, sqq=sqq, a_i=a_i, L_i=L_i,
                       U_i=U_i, g_i=g_i, gammas=gammas)
    check_lane_scalars(B, G.device, torch.int32, i_idx=i_idx)
    check_lane_scalars(B, G.device, torch.bool, use_exact=use_exact)
    aptr = act_ptr(act, G)
    nb = -(-l // build.BLOCK_L)
    bmax = torch.empty((B, nb), dtype=dtype, device=G.device)
    barg = torch.empty((B, nb), dtype=torch.int32, device=G.device)
    fn = build.entry("rbf_row_wss_batched", dtype_bits(dtype))
    ptrs = [t.data_ptr() for t in (XT, sqn, G, alpha, L, U, XQ, sqq, a_i,
                                   L_i, U_i, g_i, i_idx, use_exact, gammas)]
    err = fn(*ptrs, aptr, bmax.data_ptr(), barg.data_ptr(), B, H, l, d,
             G.device.index, torch.cuda.current_stream(G.device).cuda_stream)
    build.check(err, "rbf_row_wss_batched")
    return bmax, barg


def rbf_row_wss_batched(X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i, g_i,
                        i_idx, use_exact, gammas, *, XT=None):
    """Batched pass A over the shared ``X`` (l, d), one state half.

    ``G``/``alpha``/``L``/``U`` are (B, l); ``XQ`` is the (B, d) query rows;
    ``sqq``/``a_i``/``L_i``/``U_i``/``g_i``/``gammas`` are (B,) in the data
    dtype, ``i_idx`` (B,) int32 and ``use_exact`` (B,) bool.  ``XT`` is
    ``X`` transposed to (d, l) and contiguous, which the kernel reads; it is
    made here when not given.  Returns (bmax (B, nb), barg (B, nb) int32),
    ``nb = ceil(l / BLOCK_L)``.
    """
    if not on_card(G, "pass A"):
        return ref.rbf_row_wss_batched_blocks(
            X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i, g_i, i_idx,
            use_exact, gammas, block_l=build.BLOCK_L)
    out = _batched(X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i, g_i,
                   i_idx, use_exact, gammas, XT, 1)
    tally.count(rbf_row_wss_batched)
    return out


rbf_row_wss_batched.launches = 0


def rbf_row_wss_batched_h2(X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i,
                           g_i, i_idx, use_exact, gammas, *, XT=None):
    """Batched pass A for the doubled ε-SVR operator (H = 2 state halves).

    As :func:`rbf_row_wss_batched`, with ``G``/``alpha``/``L``/``U`` (B, 2l)
    over the base ``X`` (l, d) and ``i_idx`` a doubled index in [0, 2l):
    coordinate ``h l + j`` takes the base row's column ``j``.  Returns
    (bmax (B, nb), barg (B, nb) int32) with doubled indices, ``nb`` the
    blocks of the base axis.
    """
    if not on_card(G, "pass A"):
        return ref.rbf_row_wss_batched_blocks(
            X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i, g_i, i_idx,
            use_exact, gammas, block_l=build.BLOCK_L, dup=True)
    out = _batched(X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i, g_i,
                   i_idx, use_exact, gammas, XT, 2)
    tally.count(rbf_row_wss_batched_h2)
    return out


rbf_row_wss_batched_h2.launches = 0


def rbf_row_wss_batched_act(X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i,
                            g_i, i_idx, use_exact, gammas, act, *, XT=None,
                            dup: bool = False):
    """Batched pass A within a per-lane active set (soft shrinking).

    As :func:`rbf_row_wss_batched` (or, with ``dup=True``,
    :func:`rbf_row_wss_batched_h2`), with ``act`` a (B, n) bool mask:
    a coordinate outside it is no j-candidate.  Returns (bmax (B, nb),
    barg (B, nb) int32).
    """
    if not on_card(G, "pass A"):
        return ref.rbf_row_wss_batched_blocks(
            X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i, g_i, i_idx,
            use_exact, gammas, block_l=build.BLOCK_L, dup=dup, act=act)
    out = _batched(X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i, g_i,
                   i_idx, use_exact, gammas, XT, 2 if dup else 1, act)
    tally.count(rbf_row_wss_batched_act)
    return out


rbf_row_wss_batched_act.launches = 0


def rbf_row_wss(X, sqn, G, alpha, L, U, xq, sqq, a_i, L_i, U_i, g_i, i_idx,
                use_exact, gamma, *, XT=None, k_out=None, run=None):
    """Single-lane pass A over ``X`` (l, d), the kernel row stored.

    ``G``/``alpha``/``L``/``U`` are (l,), ``xq`` the (d,) query row;
    ``sqq``/``a_i``/``L_i``/``U_i``/``g_i``/``gamma`` hold one value each
    (0-d or (1,)) in the data dtype, ``i_idx`` int32, ``use_exact`` bool.
    The row k_i is written into ``k_out`` (l,), made here when not given.
    With ``run`` (one bool on the device) a false flag makes the launch
    a no-op: ``k_out`` keeps its row bitwise and ``bmax``/``barg`` are
    undefined; the plain version selects with ``torch.where``.  Returns
    (k (l,), bmax (nb,), barg (nb,) int32).
    """
    if not on_card(G, "pass A"):
        k, bmax, barg = ref.rbf_row_wss_blocks(
            X, sqn, G, alpha, L, U, xq, sqq, a_i, L_i, U_i, g_i, i_idx,
            use_exact, gamma, block_l=build.BLOCK_L)
        if run is not None:
            k = torch.where(run.reshape(()), k, k_out)
        return k, bmax, barg
    l, d = X.shape
    if XT is None:
        XT = X.T.contiguous()
    dtype = G.dtype
    check_state("XT", XT, (d, l), dtype, G.device)
    for name, t in (("sqn", sqn), ("G", G), ("alpha", alpha), ("L", L),
                    ("U", U)):
        check_state(name, t, (l,), dtype, G.device)
    check_state("xq", xq, (d,), dtype, G.device)
    scal = dict(sqq=sqq, a_i=a_i, L_i=L_i, U_i=U_i, g_i=g_i, gamma=gamma)
    check_lane_scalars(1, G.device, dtype,
                       **{k: v.reshape(1) for k, v in scal.items()})
    check_lane_scalars(1, G.device, torch.int32, i_idx=i_idx.reshape(1))
    check_lane_scalars(1, G.device, torch.bool,
                       use_exact=use_exact.reshape(1))
    if run is not None:
        if k_out is None:
            raise ValueError("a relaunch flag needs the stored row k_out")
        check_lane_scalars(1, G.device, torch.bool, run=run.reshape(1))
    if k_out is None:
        k_out = torch.empty_like(G)
    check_state("k_out", k_out, (l,), dtype, G.device)
    nb = -(-l // build.BLOCK_L)
    bmax = torch.empty((nb,), dtype=dtype, device=G.device)
    barg = torch.empty((nb,), dtype=torch.int32, device=G.device)
    fn = build.entry("rbf_row_wss", dtype_bits(dtype))
    ptrs = [t.data_ptr() for t in (XT, sqn, G, alpha, L, U, xq, sqq, a_i,
                                   L_i, U_i, g_i, i_idx, use_exact, gamma)]
    err = fn(*ptrs, None if run is None else run.data_ptr(),
             k_out.data_ptr(), bmax.data_ptr(), barg.data_ptr(), l, d,
             G.device.index, torch.cuda.current_stream(G.device).cuda_stream)
    tally.count(rbf_row_wss)
    build.check(err, "rbf_row_wss")
    return k_out, bmax, barg


rbf_row_wss.launches = 0


def _bank(gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx,
          use_exact, H: int, act=None):
    """Launch bank pass A over ``H`` state halves, within the active set
    ``act`` when given: one launch, the lanes' picks folded in."""
    B, n = G.shape
    l = n // H
    dtype = G.dtype
    strides = bank_strides("gram", gram, gram_idx, B, l, dtype, G.device)
    for name, t in (("G", G), ("alpha", alpha), ("L", L), ("U", U)):
        check_state(name, t, (B, H * l), dtype, G.device)
    check_lane_scalars(B, G.device, dtype, a_i=a_i, L_i=L_i, U_i=U_i,
                       g_i=g_i)
    check_lane_scalars(B, G.device, torch.int32, i_idx=i_idx)
    check_lane_scalars(B, G.device, torch.bool, use_exact=use_exact)
    aptr = act_ptr(act, G)
    part_v, part_i, nb_cap = lane_pick.partials(B, l, dtype, G.device, 1)
    j = torch.empty((B,), dtype=torch.int32, device=G.device)
    gain = torch.empty((B,), dtype=dtype, device=G.device)
    fn = build.entry("row_wss_batched_rows", dtype_bits(dtype))
    ptrs = [None if t is None else t.data_ptr()
            for t in (gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i,
                      i_idx, use_exact)]
    err = fn(*ptrs, aptr,
             *[t.data_ptr() for t in (part_v, part_i,
                                      lane_pick.tickets(G.device), j, gain)],
             B, H, l, nb_cap, *strides, G.device.index,
             torch.cuda.current_stream(G.device).cuda_stream)
    build.check(err, "row_wss_batched_rows")
    return j, gain


def row_wss_batched_rows(gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i,
                         i_idx, use_exact):
    """Batched pass A over the Gram bank ``gram`` (n_stack, l, l).

    Lane b's kernel row is ``gram[gram_idx[b], i_idx[b]]``, read by the
    kernel in place.  ``gram_idx`` is (B,) int64, checked against the bank
    by :func:`repro_torch.kernels.row_source.bank_source`; the other
    arguments are as in :func:`rbf_row_wss_batched`.  With ``gram_idx``
    None, ``gram`` is the lanes' rows pre-gathered, (B, l) (the
    reference's ``KR``), read as a bank of B entries of one row.  Returns
    the lanes' picks (j (B,) int32, gain (B,)): the kernel reduces across
    its blocks in the same launch.
    """
    if not on_card(G, "bank pass A"):
        return ref.row_wss_batched_bank(gram, gram_idx, G, alpha, L, U, a_i,
                                        L_i, U_i, g_i, i_idx, use_exact)
    out = _bank(gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx,
                use_exact, 1)
    tally.count(row_wss_batched_rows)
    return out


row_wss_batched_rows.launches = 0


def row_wss_batched_rows_h2(gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i,
                            g_i, i_idx, use_exact):
    """Bank pass A for the doubled ε-SVR operator (H = 2 state halves).

    As :func:`row_wss_batched_rows`, with (B, 2l) state over the
    (n_stack, l, l) base bank and ``i_idx`` a doubled index in [0, 2l):
    lane b reads the base row ``gram[gram_idx[b], i_idx[b] mod l]``.
    Returns (j (B,) int32, a doubled index, gain (B,)).
    """
    if not on_card(G, "bank pass A"):
        return ref.row_wss_batched_bank(gram, gram_idx, G, alpha, L, U, a_i,
                                        L_i, U_i, g_i, i_idx, use_exact,
                                        dup=True)
    out = _bank(gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx,
                use_exact, 2)
    tally.count(row_wss_batched_rows_h2)
    return out


row_wss_batched_rows_h2.launches = 0


def row_wss_batched_rows_act(gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i,
                             g_i, i_idx, use_exact, act, *,
                             dup: bool = False):
    """Bank pass A within a per-lane active set (soft shrinking): as
    :func:`row_wss_batched_rows` (or :func:`row_wss_batched_rows_h2` with
    ``dup=True``), with ``act`` a (B, n) bool mask; a lane with no active
    candidate returns index 0 and -inf.  Returns (j (B,) int32, gain
    (B,))."""
    if not on_card(G, "bank pass A"):
        return ref.row_wss_batched_bank(gram, gram_idx, G, alpha, L, U, a_i,
                                        L_i, U_i, g_i, i_idx, use_exact,
                                        dup=dup, act=act)
    out = _bank(gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx,
                use_exact, 2 if dup else 1, act)
    tally.count(row_wss_batched_rows_act)
    return out


row_wss_batched_rows_act.launches = 0
