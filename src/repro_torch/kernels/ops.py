"""Dispatch between the CUDA kernels and their plain PyTorch versions.

``impl`` selects the backend:

* ``"cuda"``  — the hand-written Hopper kernels (CUDA tensors only; CPU
  tensors raise);
* ``"torch"`` — the plain PyTorch versions in :mod:`repro_torch.kernels.ref`
  on whatever device the tensors are on;
* ``"auto"``  — ``"cuda"`` for CUDA tensors, ``"torch"`` for CPU tensors.

Nothing falls back: a kernel that fails to build or launch raises.

The CUDA passes return per-block reductions; the cross-block step,
:func:`_first_max`, stays here, as the reference keeps it outside its
kernels.  Working-set indices stay int32 at every kernel boundary; Gram
bank indices are int64.

Unlike the reference's rows variants, which take rows gathered from the
bank, :func:`row_wss_batched_rows` and :func:`update_wss_batched_rows`
take the bank and the per-lane indices: the CUDA passes read the rows in
place.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.kernels import gram_block, rbf_row_wss, rbf_update_wss
from repro_torch.kernels import ref as ref_ops
from repro_torch.kernels.row_source import RowSource

IMPLS = ("auto", "cuda", "torch")


def resolve_impl(impl: str, device) -> str:
    """``"cuda"`` or ``"torch"`` for tensors on ``device``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    kind = torch.device(device).type
    if impl == "auto":
        return "cuda" if kind == "cuda" else "torch"
    if impl == "cuda" and kind != "cuda":
        raise ValueError(f"impl='cuda' runs the CUDA kernels and needs CUDA "
                         f"tensors, got tensors on {kind}")
    return impl


def _first_max(bmax, barg):
    """Cross-block reduction matching ``jax.lax.argmax`` tie-breaking.

    Picks the LOWEST global index among blocks attaining the max, so an
    all -inf lane gives index 0.  Returns (idx (B,) int32, max (B,)).
    """
    best = bmax.amax(dim=1, keepdim=True)
    cand = torch.where(bmax == best, barg, torch.iinfo(torch.int32).max)
    return cand.amin(dim=1), best[:, 0]


def rbf_row_wss_batched(X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i,
                        g_i, i_idx, use_exact, gammas, *, impl: str = "auto",
                        XT=None):
    """Batched pass A: per-lane WSS2 selection -> (j (B,) int32, gain)."""
    if resolve_impl(impl, G.device) == "torch":
        return ref_ops.rbf_row_wss_batched(X, sqn, G, alpha, L, U, XQ, sqq,
                                           a_i, L_i, U_i, g_i, i_idx,
                                           use_exact, gammas)
    bmax, barg = rbf_row_wss.rbf_row_wss_batched(
        X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i, g_i, i_idx,
        use_exact, gammas, XT=XT)
    return _first_max(bmax, barg)


def rbf_update_wss_batched(X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj,
                           mu, gammas, *, impl: str = "auto", XT=None):
    """Batched pass B -> (G_new (B, l), i_next (B,) int32, g_i_next, g_dn).

    A lane with ``mu == 0`` leaves G bitwise unchanged."""
    if resolve_impl(impl, G.device) == "torch":
        return ref_ops.rbf_update_wss_batched(X, sqn, G, alpha_new, L, U,
                                              XQi, sqqi, XQj, sqqj, mu,
                                              gammas)
    G_new, bmax, barg, bmin = rbf_update_wss.rbf_update_wss_batched(
        X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj, mu, gammas, XT=XT)
    i_next, g_i_next = _first_max(bmax, barg)
    return G_new, i_next, g_i_next, bmin.amin(dim=1)


def row_wss_batched_rows(gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i,
                         i_idx, use_exact, *, impl: str = "auto"):
    """Batched pass A over the Gram bank: lane b's kernel row is
    ``gram[gram_idx[b], i_idx[b]]`` -> (j (B,) int32, gain)."""
    if resolve_impl(impl, G.device) == "torch":
        return ref_ops.row_wss_batched_from_k(
            ref_ops.bank_rows(gram, gram_idx, i_idx), G, alpha, L, U, a_i,
            L_i, U_i, g_i, i_idx, use_exact)
    bmax, barg = rbf_row_wss.row_wss_batched_rows(
        gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx, use_exact)
    return _first_max(bmax, barg)


def update_wss_batched_rows(gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx,
                            mu, *, impl: str = "auto"):
    """Batched pass B over the Gram bank -> (G_new (B, l), i_next (B,)
    int32, g_i_next, g_dn).  A lane with ``mu == 0`` leaves G bitwise
    unchanged."""
    if resolve_impl(impl, G.device) == "torch":
        return ref_ops.update_wss_batched_from_rows(
            G, ref_ops.bank_rows(gram, gram_idx, i_idx),
            ref_ops.bank_rows(gram, gram_idx, j_idx), mu, alpha_new, L, U)
    G_new, bmax, barg, bmin = rbf_update_wss.update_wss_batched_rows(
        gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu)
    i_next, g_i_next = _first_max(bmax, barg)
    return G_new, i_next, g_i_next, bmin.amin(dim=1)


def source_row_wss(src: RowSource, G, alpha, L, U, i_idx, a_i, L_i, U_i,
                   g_i, use_exact, *, impl: str = "auto"):
    """Batched pass A against a :class:`RowSource` -> (j (B,), gain (B,))."""
    if src.is_bank:
        return row_wss_batched_rows(src.gram, src.gram_idx, G, alpha, L, U,
                                    a_i, L_i, U_i, g_i, i_idx, use_exact,
                                    impl=impl)
    XQ, sqq = src.query(i_idx)
    return rbf_row_wss_batched(src.X, src.sqn, G, alpha, L, U, XQ, sqq, a_i,
                               L_i, U_i, g_i, i_idx, use_exact, src.gammas,
                               impl=impl, XT=src.XT)


def source_update_wss(src: RowSource, G, alpha_new, L, U, i_idx, j_idx, mu,
                      *, impl: str = "auto"):
    """Batched pass B against a :class:`RowSource`.

    Returns (G_new (B, n), i_next (B,), g_i_next (B,), g_dn (B,)).
    """
    if src.is_bank:
        return update_wss_batched_rows(src.gram, src.gram_idx, G, alpha_new,
                                       L, U, i_idx, j_idx, mu, impl=impl)
    B = G.shape[0]
    XQ, sqq = src.query(torch.cat([i_idx, j_idx]))
    return rbf_update_wss_batched(src.X, src.sqn, G, alpha_new, L, U,
                                  XQ[:B], sqq[:B], XQ[B:], sqq[B:], mu,
                                  src.gammas, impl=impl, XT=src.XT)


def gram(X1, X2=None, gamma=1.0, *, impl: str = "auto", device=None,
         dtype=None):
    """(Cross-)Gram matrix k(X1, X2) -> (l1, l2).

    An entry point: inputs (arrays or tensors) are moved to ``device``,
    which defaults to the CUDA card and raises without one; pass
    ``device="cpu"`` for the plain path on the CPU.  ``dtype`` defaults to
    ``X1``'s when it is a floating tensor, else to
    ``torch.get_default_dtype()``.
    """
    dev = resolve_device(device)
    if dtype is None and torch.is_tensor(X1) and X1.is_floating_point():
        dtype = X1.dtype
    dtype = resolve_dtype(dtype)
    X1 = torch.as_tensor(X1, dtype=dtype, device=dev).contiguous()
    X2 = X1 if X2 is None else torch.as_tensor(
        X2, dtype=dtype, device=dev).contiguous()
    if resolve_impl(impl, dev) == "torch":
        return ref_ops.gram_cross(X1, X2, gamma)
    return gram_block.gram_cross(X1, X2, gamma)


def gram_bank(X, gammas, *, impl: str = "auto"):
    """The (n_gamma, l, l) Gram bank over ``X`` (l, d): one Gram per gamma,
    written in place into one preallocated tensor (one kernel launch per
    gamma on the card), so no second l x l buffer is made per entry."""
    l = X.shape[0]
    bank = torch.empty((len(gammas), l, l), dtype=X.dtype, device=X.device)
    fn = (gram_block.gram_cross if resolve_impl(impl, X.device) == "cuda"
          else ref_ops.gram_cross)
    for g, gamma in enumerate(gammas):
        fn(X, X, float(gamma), out=bank[g])
    return bank
