"""RowSource: where pass A/B obtain kernel rows.

This slice has the rbf supplier only: rows are recomputed from the shared
``X`` inside the passes, and no Gram matrix is ever built (the Gram-bank
supplier and the doubled ε-SVR operator are later slices).  ``XT``, ``X``
transposed to (d, l) and contiguous, is made once per fit here, so the CUDA
passes read neighbouring columns with neighbouring threads.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RowSource:
    """Rows of the RBF operator over the shared ``X`` (l, d)."""

    X: torch.Tensor        # (l, d) inputs
    XT: torch.Tensor       # (d, l) the same, transposed and contiguous
    sqn: torch.Tensor      # (l,) squared norms
    gammas: torch.Tensor   # (B,) per-lane RBF widths

    def base_idx(self, idx):
        """Fold a coordinate index onto the example axis (the identity
        without the doubled operator)."""
        return idx

    def query(self, idx):
        """The (m, d) query rows and their squared norms at ``idx`` (m,)."""
        b = self.base_idx(idx).long()
        return self.X.index_select(0, b), self.sqn.index_select(0, b)

    def entry_pairs(self, a, b, reps: int):
        """O(1) kernel entries for ``reps`` stacked (reps*B,) index pairs."""
        a = self.base_idx(a).long()
        b = self.base_idx(b).long()
        d2 = (self.sqn[a] + self.sqn[b]
              - 2.0 * torch.sum(self.X[a] * self.X[b], dim=-1))
        return torch.exp(-self.gammas.repeat(reps)
                         * torch.clamp_min(d2, 0.0))


def rbf_source(X: torch.Tensor, gammas, B: int) -> RowSource:
    """Row source recomputing rows from the shared ``X`` (l, d)."""
    gammas = torch.as_tensor(gammas, dtype=X.dtype, device=X.device)
    return RowSource(X=X, XT=X.T.contiguous(),
                     sqn=torch.sum(X * X, dim=-1),
                     gammas=gammas.broadcast_to((B,)).contiguous())
