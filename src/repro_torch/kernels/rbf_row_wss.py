"""Pass A wrappers: the lane-batched WSS2 selection kernels, with rows
recomputed from ``X`` (``csrc/rbf_row_wss.cu``) or read from the Gram bank
(``csrc/row_wss_rows.cu``).

On CUDA tensors each launches its kernel on the current stream and returns
the per-block (max, first argmax) pairs; on CPU tensors it runs the plain
version (:func:`repro_torch.kernels.ref.rbf_row_wss_batched_blocks`,
:func:`repro_torch.kernels.ref.row_wss_batched_rows_blocks`).  There is no
fallback from one to the other.  Each wrapper's ``launches`` attribute
counts its kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.checks import (check_bank, check_lane_scalars,
                                        check_state, dtype_bits)


def rbf_row_wss_batched(X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i, g_i,
                        i_idx, use_exact, gammas, *, XT=None):
    """Batched pass A over the shared ``X`` (l, d).

    ``G``/``alpha``/``L``/``U`` are (B, l); ``XQ`` is the (B, d) query rows;
    ``sqq``/``a_i``/``L_i``/``U_i``/``g_i``/``gammas`` are (B,) in the data
    dtype, ``i_idx`` (B,) int32 and ``use_exact`` (B,) bool.  ``XT`` is
    ``X`` transposed to (d, l) and contiguous, which the kernel reads; it is
    made here when not given.  Returns (bmax (B, nb), barg (B, nb) int32),
    ``nb = ceil(l / BLOCK_L)``.
    """
    if G.device.type == "cpu":
        return ref.rbf_row_wss_batched_blocks(
            X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i, g_i, i_idx,
            use_exact, gammas, block_l=build.BLOCK_L)
    if G.device.type != "cuda":
        raise ValueError(f"pass A runs on cuda or cpu tensors, got "
                         f"{G.device}")
    l, d = X.shape
    B = G.shape[0]
    if XT is None:
        XT = X.T.contiguous()
    dtype = G.dtype
    check_state("XT", XT, (d, l), dtype, G.device)
    check_state("sqn", sqn, (l,), dtype, G.device)
    for name, t in (("G", G), ("alpha", alpha), ("L", L), ("U", U)):
        check_state(name, t, (B, l), dtype, G.device)
    check_state("XQ", XQ, (B, d), dtype, G.device)
    check_lane_scalars(B, G.device, dtype, sqq=sqq, a_i=a_i, L_i=L_i,
                       U_i=U_i, g_i=g_i, gammas=gammas)
    check_lane_scalars(B, G.device, torch.int32, i_idx=i_idx)
    check_lane_scalars(B, G.device, torch.bool, use_exact=use_exact)
    nb = -(-l // build.BLOCK_L)
    bmax = torch.empty((B, nb), dtype=dtype, device=G.device)
    barg = torch.empty((B, nb), dtype=torch.int32, device=G.device)
    fn = build.entry("rbf_row_wss_batched", dtype_bits(dtype))
    ptrs = [t.data_ptr() for t in (XT, sqn, G, alpha, L, U, XQ, sqq, a_i,
                                   L_i, U_i, g_i, i_idx, use_exact, gammas,
                                   bmax, barg)]
    err = fn(*ptrs, B, l, d, G.device.index,
             torch.cuda.current_stream(G.device).cuda_stream)
    rbf_row_wss_batched.launches += 1
    build.check(err, "rbf_row_wss_batched")
    return bmax, barg


rbf_row_wss_batched.launches = 0


def row_wss_batched_rows(gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i,
                         i_idx, use_exact):
    """Batched pass A over the Gram bank ``gram`` (n_stack, l, l).

    Lane b's kernel row is ``gram[gram_idx[b], i_idx[b]]``, read by the
    kernel in place.  ``gram_idx`` is (B,) int64, checked against the bank
    by :func:`repro_torch.kernels.row_source.bank_source`; the other
    arguments are as in :func:`rbf_row_wss_batched`.  Returns
    (bmax (B, nb), barg (B, nb) int32), ``nb = ceil(l / BLOCK_L)``.
    """
    if G.device.type == "cpu":
        return ref.row_wss_batched_rows_blocks(
            gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx,
            use_exact, block_l=build.BLOCK_L)
    if G.device.type != "cuda":
        raise ValueError(f"bank pass A runs on cuda or cpu tensors, got "
                         f"{G.device}")
    B, l = G.shape
    dtype = G.dtype
    check_bank(gram, gram_idx, B, l, dtype, G.device)
    for name, t in (("G", G), ("alpha", alpha), ("L", L), ("U", U)):
        check_state(name, t, (B, l), dtype, G.device)
    check_lane_scalars(B, G.device, dtype, a_i=a_i, L_i=L_i, U_i=U_i,
                       g_i=g_i)
    check_lane_scalars(B, G.device, torch.int32, i_idx=i_idx)
    check_lane_scalars(B, G.device, torch.bool, use_exact=use_exact)
    nb = -(-l // build.BLOCK_L)
    bmax = torch.empty((B, nb), dtype=dtype, device=G.device)
    barg = torch.empty((B, nb), dtype=torch.int32, device=G.device)
    fn = build.entry("row_wss_batched_rows", dtype_bits(dtype))
    ptrs = [t.data_ptr() for t in (gram, gram_idx, G, alpha, L, U, a_i, L_i,
                                   U_i, g_i, i_idx, use_exact, bmax, barg)]
    err = fn(*ptrs, B, l, G.device.index,
             torch.cuda.current_stream(G.device).cuda_stream)
    row_wss_batched_rows.launches += 1
    build.check(err, "row_wss_batched_rows")
    return bmax, barg


row_wss_batched_rows.launches = 0
