"""RowSource: where pass A/B obtain kernel rows.

Two suppliers:

* **rbf** — rows are recomputed from the shared ``X`` inside the passes;
  no Gram matrix is ever built.  ``XT``, ``X`` transposed to (d, l) and
  contiguous, is made once per fit here, so the CUDA passes read
  neighbouring columns with neighbouring threads.
* **bank** — a shared (n_stack, l, l) Gram bank plus a per-lane stack
  index ``gram_idx`` (int64): the exp work is paid once per distinct gamma,
  and the CUDA bank passes read their rows from the bank in place.  Lanes
  that share a gamma share bank entries; no per-lane copy exists.

``dup=True`` marks the doubled ε-SVR operator: the lane state has 2l
coordinates, and row k of ``Q = [[K, K], [K, K]]`` is the base row of
``k mod l``, so every row and entry folds its index onto the base axis
(:meth:`RowSource.base_idx`) and the O(l d) work never doubles; the
passes read the base row once per state half.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class RowSource:
    """Rows of the RBF operator: exactly one of (``X``, ``XT``, ``sqn``)
    and (``gram``, ``gram_idx``) supplies them.  ``gammas`` is the (B,)
    per-lane RBF width; ``dup`` marks the doubled ε-SVR operator (module
    notes)."""

    X: Optional[torch.Tensor] = None          # (l, d) inputs
    XT: Optional[torch.Tensor] = None         # (d, l) the same, transposed
    sqn: Optional[torch.Tensor] = None        # (l,) squared norms
    gammas: Optional[torch.Tensor] = None     # (B,) per-lane RBF widths
    gram: Optional[torch.Tensor] = None       # (n_stack, l, l) Gram bank
    gram_idx: Optional[torch.Tensor] = None   # (B,) int64 lane -> entry
    dup: bool = False

    @property
    def is_bank(self) -> bool:
        return self.gram is not None

    @property
    def base_l(self) -> int:
        """Example count l."""
        return self.gram.shape[-1] if self.is_bank else self.X.shape[0]

    def base_idx(self, idx):
        """Fold a (possibly doubled) coordinate index onto the example
        axis: ``k mod l`` with the doubled operator, else the identity."""
        return idx % self.base_l if self.dup else idx

    def query(self, idx):
        """Per-lane pass inputs at the stacked (reps*B,) indices ``idx``.

        Bank: the (reps*B, l) rows ``gram[gram_idx, idx]``.  Rbf: the
        (m, d) query rows and their squared norms.
        """
        b = self.base_idx(idx).long()
        if self.is_bank:
            reps = idx.shape[0] // self.gram_idx.shape[0]
            return self.gram[self.gram_idx.repeat(reps), b]
        return self.X.index_select(0, b), self.sqn.index_select(0, b)

    def entry_pairs(self, a, b, reps: int):
        """O(1) kernel entries for ``reps`` stacked (reps*B,) index pairs."""
        a = self.base_idx(a).long()
        b = self.base_idx(b).long()
        if self.is_bank:
            return self.gram[self.gram_idx.repeat(reps), a, b]
        d2 = (self.sqn[a] + self.sqn[b]
              - 2.0 * torch.sum(self.X[a] * self.X[b], dim=-1))
        return torch.exp(-self.gammas.repeat(reps)
                         * torch.clamp_min(d2, 0.0))

    def matvec(self, v, block: int = 256):
        """Per-lane operator matvec ``Q_b v_b`` for a (B, n) stack.

        The doubled operator folds its halves first, ``Q v = tile(K (v+ +
        v-))``, so the contraction runs at base width.  The bank contracts
        every entry with every lane and keeps each lane's own; the rbf
        supplier blocks over rows of ``X`` with per-lane gammas, so no
        (l, l) matrix is built.
        """
        l = self.base_l
        if self.dup:
            v = v[:, :l] + v[:, l:]
        if self.is_bank:
            mv = torch.einsum("sij,bj->sbi", self.gram, v)
            out = mv[self.gram_idx, torch.arange(v.shape[0],
                                                 device=v.device)]
        else:
            out = torch.empty_like(v)
            for r0 in range(0, l, block):
                Xb = self.X[r0:r0 + block]
                d2 = (self.sqn[r0:r0 + block, None] + self.sqn[None, :]
                      - 2.0 * (Xb @ self.X.T))
                k = torch.exp(-self.gammas[:, None, None]
                              * torch.clamp_min(d2, 0.0)[None])
                out[:, r0:r0 + block] = torch.einsum("bkl,bl->bk", k, v)
        return torch.cat([out, out], dim=1) if self.dup else out


def rbf_source(X: torch.Tensor, gammas, B: int, *,
               dup: bool = False) -> RowSource:
    """Row source recomputing rows from the shared ``X`` (l, d)."""
    gammas = torch.as_tensor(gammas, dtype=X.dtype, device=X.device)
    return RowSource(X=X, XT=X.T.contiguous(),
                     sqn=torch.sum(X * X, dim=-1),
                     gammas=gammas.broadcast_to((B,)).contiguous(), dup=dup)


def bank_source(gram: torch.Tensor, gram_idx, gammas=None, *,
                dup: bool = False) -> RowSource:
    """Row source reading rows from the shared (n_stack, l, l) Gram bank.

    ``gram_idx`` (B,) maps each lane to its bank entry; it is checked
    against the bank here, once, because the CUDA passes read
    ``gram[gram_idx[b]]`` by pointer.
    """
    if gram.ndim != 3 or gram.shape[1] != gram.shape[2]:
        raise ValueError(f"the Gram bank must be (n_stack, l, l), got "
                         f"{tuple(gram.shape)}")
    if not gram.is_contiguous():
        raise ValueError("the Gram bank must be contiguous")
    gram_idx = torch.as_tensor(gram_idx, dtype=torch.int64,
                               device=gram.device).contiguous()
    if gram_idx.ndim != 1:
        raise ValueError(f"gram_idx must be (B,), got "
                         f"{tuple(gram_idx.shape)}")
    if gram_idx.numel() and not (0 <= int(gram_idx.min())
                                 and int(gram_idx.max()) < gram.shape[0]):
        raise ValueError(f"gram_idx must index the {gram.shape[0]} bank "
                         f"entries")
    if gammas is not None:
        gammas = torch.as_tensor(gammas, dtype=gram.dtype,
                                 device=gram.device)
        gammas = gammas.broadcast_to(gram_idx.shape).contiguous()
    return RowSource(gammas=gammas, gram=gram, gram_idx=gram_idx, dup=dup)
