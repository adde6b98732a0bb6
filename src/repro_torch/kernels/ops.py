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
kernels.  Working-set indices stay int32 at every kernel boundary.
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


def source_row_wss(src: RowSource, G, alpha, L, U, i_idx, a_i, L_i, U_i,
                   g_i, use_exact, *, impl: str = "auto"):
    """Batched pass A against a :class:`RowSource` -> (j (B,), gain (B,))."""
    XQ, sqq = src.query(i_idx)
    return rbf_row_wss_batched(src.X, src.sqn, G, alpha, L, U, XQ, sqq, a_i,
                               L_i, U_i, g_i, i_idx, use_exact, src.gammas,
                               impl=impl, XT=src.XT)


def source_update_wss(src: RowSource, G, alpha_new, L, U, i_idx, j_idx, mu,
                      *, impl: str = "auto"):
    """Batched pass B against a :class:`RowSource`.

    Returns (G_new (B, n), i_next (B,), g_i_next (B,), g_dn (B,)).
    """
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
