"""Dispatch between the CUDA kernels and their plain PyTorch versions.

``impl`` selects the backend:

* ``"cuda"``  — the hand-written Hopper kernels (CUDA tensors only; CPU
  tensors raise);
* ``"torch"`` — the plain PyTorch versions in :mod:`repro_torch.kernels.ref`
  on whatever device the tensors are on;
* ``"auto"``  — ``"cuda"`` for CUDA tensors, ``"torch"`` for CPU tensors.

Nothing falls back: a kernel that fails to build or launch raises.

The rbf CUDA passes (kernels 1, 2, 6 and 7) return per-block reductions,
and their cross-block step, :func:`_first_max`, stays here, as the
reference keeps it outside its kernels.  The Gram-bank passes (kernels 4
and 5) fold it into their one launch and return each lane's result, so
the bank dispatchers hand it on as it comes.  Working-set indices stay
int32 at every kernel boundary; Gram bank indices are int64.

``dup=True`` runs the batched passes on the doubled ε-SVR operator's
(B, 2l) lane state over the base ``X`` or the base Gram bank: on the card
the H = 2 variants of pass A and pass B.  ``act``, an optional (B, n) bool
active-set mask (soft shrinking), restricts pass A's j-candidates and pass
B's scans, never pass B's update of G: on the card the ``*_act`` variants,
which take the mask in place (the reference stacks it into the data dtype;
the selection is the same).  ``dirv``/``mu2`` engage pass B's
Conjugate-SMO direction: ``dirv`` (B, l) is the previous direction's
Q-product, ``mu2`` (B,) its step; the update gains ``- mu2 dirv`` and the
pass returns a fifth output, the next direction ``r = k_i - k_j``.  Both
are at base width: the doubled operator's direction is a tiled base row,
which the reference carries tiled (B, 2l); one base value serves both
halves, and on the card the ``*_conj`` variants launch.

:func:`row_wss_batched_rows` and :func:`update_wss_batched_rows` take the
reference's arguments, rows gathered from the bank beforehand (``KR``;
``KRi``, ``KRj``).  The solvers call the bank forms,
:func:`row_wss_batched_bank` and :func:`update_wss_batched_bank`, which
take the bank and the per-lane indices: the CUDA passes read the rows in
place, and no gather runs.  Both forms launch the same two kernels.

Every pass wrapper takes the reference's ``block_l=`` and ignores it: the
CUDA passes fix their block of columns when they are built
(:data:`repro_torch.kernels.build.BLOCK_L`).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.kernels import gram_block
from repro_torch.kernels import rbf_row_wss as pass_a
from repro_torch.kernels import rbf_update_wss as pass_b
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


def rbf_row_wss(X, sqn, G, alpha, L, U, xq, a_i, L_i, U_i, g_i, i_idx,
                use_exact, gamma, *, impl: str = "auto", block_l: int = 1024,
                XT=None, k_out=None, run=None):
    """Single-lane pass A -> (k_i (l,), j (0-d int32), gain_j).

    On the card the row is stored into ``k_out`` when given.  ``run``, a
    0-d bool tensor, makes the pass conditional without a host sync: the
    row is replaced only where ``run`` is true (on the card a false flag
    turns the launch into a no-op), and ``(j, gain)`` are then undefined.
    """
    del block_l
    if resolve_impl(impl, G.device) == "torch":
        out = ref_ops.rbf_row_wss(X, sqn, G, alpha, L, U, xq, a_i, L_i, U_i,
                                  g_i, i_idx, use_exact, gamma)
        if run is None:
            return out
        return (torch.where(run, out[0], k_out),) + out[1:]
    k, bmax, barg = pass_a.rbf_row_wss(
        X, sqn, G, alpha, L, U, xq, torch.dot(xq, xq), a_i, L_i, U_i, g_i,
        i_idx, use_exact, gamma, XT=XT, k_out=k_out, run=run)
    j, gain = _first_max(bmax[None], barg[None])
    return k, j[0], gain[0]


def rbf_update_wss(X, sqn, G, k_i, alpha_new, L, U, xq_j, mu, gamma, *,
                   impl: str = "auto", block_l: int = 1024, XT=None):
    """Single-lane pass B with the stored row ``k_i`` ->
    (G_new (l,), i_next (0-d int32), g_i_next, g_dn).

    ``mu == 0`` leaves G bitwise unchanged."""
    del block_l
    if resolve_impl(impl, G.device) == "torch":
        return ref_ops.rbf_update_wss(X, sqn, G, k_i, xq_j, mu, alpha_new, L,
                                      U, gamma)
    G_new, bmax, barg, bmin = pass_b.rbf_update_wss(
        X, sqn, G, k_i, alpha_new, L, U, xq_j, torch.dot(xq_j, xq_j), mu,
        gamma, XT=XT)
    i_next, g_i_next = _first_max(bmax[None], barg[None])
    return G_new, i_next[0], g_i_next[0], bmin.amin()


def rbf_row_wss_batched(X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i,
                        g_i, i_idx, use_exact, gammas, *, impl: str = "auto",
                        block_l: int = 1024, XT=None, dup: bool = False,
                        act=None):
    """Batched pass A: per-lane WSS2 selection -> (j (B,) int32, gain)."""
    del block_l
    if resolve_impl(impl, G.device) == "torch":
        return ref_ops.rbf_row_wss_batched(X, sqn, G, alpha, L, U, XQ, sqq,
                                           a_i, L_i, U_i, g_i, i_idx,
                                           use_exact, gammas, dup=dup,
                                           act=act)
    args = (X, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i, g_i, i_idx,
            use_exact, gammas)
    if act is not None:
        bmax, barg = pass_a.rbf_row_wss_batched_act(*args, act, XT=XT,
                                                    dup=dup)
    elif dup:
        bmax, barg = pass_a.rbf_row_wss_batched_h2(*args, XT=XT)
    else:
        bmax, barg = pass_a.rbf_row_wss_batched(*args, XT=XT)
    return _first_max(bmax, barg)


def _pass_b_out(out):
    """The dispatched pass B result from a kernel's per-block outputs:
    (G_new, i_next, g_i_next, g_dn), and ``r`` when the kernel returned
    one."""
    G_new, bmax, barg, bmin = out[:4]
    i_next, g_i_next = _first_max(bmax, barg)
    return (G_new, i_next, g_i_next, bmin.amin(dim=1)) + tuple(out[4:])


def rbf_update_wss_batched(X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj,
                           mu, gammas, *, impl: str = "auto",
                           block_l: int = 1024, XT=None, dup: bool = False,
                           act=None, dirv=None, mu2=None):
    """Batched pass B -> (G_new (B, n), i_next (B,) int32, g_i_next, g_dn),
    and ``r`` (B, l) fifth with the direction ``dirv`` (B, l)/``mu2``.

    A lane with ``mu == 0`` (and ``mu2 == 0``) leaves G bitwise
    unchanged."""
    del block_l
    if resolve_impl(impl, G.device) == "torch":
        return ref_ops.rbf_update_wss_batched(X, sqn, G, alpha_new, L, U,
                                              XQi, sqqi, XQj, sqqj, mu,
                                              gammas, dup=dup, act=act,
                                              dirv=dirv, mu2=mu2)
    args = (X, sqn, G, alpha_new, L, U, XQi, sqqi, XQj, sqqj, mu, gammas)
    if dirv is not None:
        out = pass_b.rbf_update_wss_batched_conj(*args, dirv, mu2, XT=XT,
                                                 dup=dup, act=act)
    elif act is not None:
        out = pass_b.rbf_update_wss_batched_act(*args, act, XT=XT, dup=dup)
    elif dup:
        out = pass_b.rbf_update_wss_batched_h2(*args, XT=XT)
    else:
        out = pass_b.rbf_update_wss_batched(*args, XT=XT)
    return _pass_b_out(out)


def _bank_a(gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx,
            use_exact, impl, dup, act):
    """Pass A over bank rows: ``gram[gram_idx[b], i_idx[b]]``, or with
    ``gram_idx`` None the pre-gathered (B, l) rows ``gram``."""
    args = (gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx,
            use_exact)
    if resolve_impl(impl, G.device) == "torch":
        return ref_ops.row_wss_batched_bank(*args, dup=dup, act=act)
    if act is not None:
        return pass_a.row_wss_batched_rows_act(*args, act, dup=dup)
    if dup:
        return pass_a.row_wss_batched_rows_h2(*args)
    return pass_a.row_wss_batched_rows(*args)


def row_wss_batched_rows(KR, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx,
                         use_exact, *, impl: str = "auto",
                         block_l: int = 1024, dup: bool = False, act=None):
    """Batched pass A from pre-gathered base rows ``KR`` (B, l), the
    reference's form -> (j (B,) int32, gain).  On the card the bank
    kernel reads ``KR`` as a bank of B one-row entries."""
    del block_l
    return _bank_a(KR, None, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx,
                   use_exact, impl, dup, act)


def row_wss_batched_bank(gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i,
                         i_idx, use_exact, *, impl: str = "auto",
                         dup: bool = False, act=None):
    """Batched pass A over the Gram bank: lane b's kernel row is
    ``gram[gram_idx[b], i_idx[b]]`` (of ``i_idx[b] mod l`` with
    ``dup=True``), read in place -> (j (B,) int32, gain)."""
    return _bank_a(gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i,
                   i_idx, use_exact, impl, dup, act)


def _bank_b(gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu, impl, dup,
            act, dirv, mu2):
    """Pass B over bank rows; with ``gram_idx`` None ``gram`` is the pair
    of pre-gathered rows ``(KRi, KRj)``."""
    args = (gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu)
    if resolve_impl(impl, G.device) == "torch":
        return ref_ops.update_wss_batched_bank(*args, dup=dup, act=act,
                                               dirv=dirv, mu2=mu2)
    if dirv is not None:
        return pass_b.update_wss_batched_rows_conj(*args, dirv, mu2,
                                                   dup=dup, act=act)
    if act is not None:
        return pass_b.update_wss_batched_rows_act(*args, act, dup=dup)
    if dup:
        return pass_b.update_wss_batched_rows_h2(*args)
    return pass_b.update_wss_batched_rows(*args)


def update_wss_batched_rows(KRi, KRj, G, alpha_new, L, U, mu, *,
                            impl: str = "auto", block_l: int = 1024,
                            dup: bool = False, act=None, dirv=None,
                            mu2=None):
    """Batched pass B from pre-gathered base rows ``KRi``, ``KRj`` (B, l),
    the reference's form -> (G_new (B, n), i_next (B,) int32, g_i_next,
    g_dn), and ``r`` (B, l) fifth with the direction ``dirv``/``mu2``.  On
    the card the bank kernel reads them as banks of B one-row entries."""
    del block_l
    return _bank_b((KRi, KRj), None, G, alpha_new, L, U, None, None, mu,
                   impl, dup, act, dirv, mu2)


def update_wss_batched_bank(gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx,
                            mu, *, impl: str = "auto", dup: bool = False,
                            act=None, dirv=None, mu2=None):
    """Batched pass B over the Gram bank -> (G_new (B, n), i_next (B,)
    int32, g_i_next, g_dn), and ``r`` (B, l) fifth with the direction
    ``dirv`` (B, l)/``mu2``.  A lane with ``mu == 0`` (and ``mu2 == 0``)
    leaves G bitwise unchanged."""
    return _bank_b(gram, gram_idx, G, alpha_new, L, U, i_idx, j_idx, mu,
                   impl, dup, act, dirv, mu2)


def source_row_wss(src: RowSource, G, alpha, L, U, i_idx, a_i, L_i, U_i,
                   g_i, use_exact, *, impl: str = "auto",
                   block_l: int = 1024, act=None):
    """Batched pass A against a :class:`RowSource`, within the active set
    ``act`` when given -> (j (B,), gain (B,))."""
    del block_l
    if src.is_bank:
        return row_wss_batched_bank(src.gram, src.gram_idx, G, alpha, L, U,
                                    a_i, L_i, U_i, g_i, i_idx, use_exact,
                                    impl=impl, dup=src.dup, act=act)
    XQ, sqq = src.query(i_idx)
    return rbf_row_wss_batched(src.X, src.sqn, G, alpha, L, U, XQ, sqq, a_i,
                               L_i, U_i, g_i, i_idx, use_exact, src.gammas,
                               impl=impl, XT=src.XT, dup=src.dup, act=act)


def source_update_wss(src: RowSource, G, alpha_new, L, U, i_idx, j_idx, mu,
                      *, impl: str = "auto", block_l: int = 1024, act=None,
                      dirv=None, mu2=None):
    """Batched pass B against a :class:`RowSource`, its scans within the
    active set ``act`` when given (the update of G is never masked), with
    the Conjugate-SMO direction ``dirv`` (B, l) and step ``mu2`` (B,) when
    given.

    Returns (G_new (B, n), i_next (B,), g_i_next (B,), g_dn (B,)), and
    ``r = k_i - k_j`` (B, l) fifth with ``dirv``.
    """
    del block_l
    if src.is_bank:
        return update_wss_batched_bank(src.gram, src.gram_idx, G, alpha_new,
                                       L, U, i_idx, j_idx, mu, impl=impl,
                                       dup=src.dup, act=act, dirv=dirv,
                                       mu2=mu2)
    B = G.shape[0]
    XQ, sqq = src.query(torch.cat([i_idx, j_idx]))
    return rbf_update_wss_batched(src.X, src.sqn, G, alpha_new, L, U,
                                  XQ[:B], sqq[:B], XQ[B:], sqq[B:], mu,
                                  src.gammas, impl=impl, XT=src.XT,
                                  dup=src.dup, act=act, dirv=dirv, mu2=mu2)


def gram(X1, X2=None, gamma=1.0, *, impl: str = "auto", block_i: int = 256,
         block_j: int = 256, device=None, dtype=None):
    """(Cross-)Gram matrix k(X1, X2) -> (l1, l2).

    An entry point: inputs (arrays or tensors) are moved to ``device``,
    which defaults to the CUDA card and raises without one; pass
    ``device="cpu"`` for the plain path on the CPU.  ``dtype`` defaults to
    ``X1``'s when it is a floating tensor, else to
    ``torch.get_default_dtype()``.  ``block_i``/``block_j`` are accepted
    and ignored: the CUDA kernel fixes its output tile by dtype when it is
    built (:data:`repro_torch.kernels.gram_block.TILE`).
    """
    del block_i, block_j
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
