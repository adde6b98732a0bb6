"""Deterministic, indexable token pipeline.

A numpy copy of ``repro.data.tokens.SyntheticTokens``: ``batch_at(step)``
is a pure function of (seed, step, shape), bitwise equal to the
reference's, so any step can be replayed after a restore without
pipeline state (the checkpoint needs only the step counter).  The stream
is markov-ish: each sequence follows a seeded hash of its previous token,
low-entropy targets a model can learn.  :func:`to_device` puts a host
batch on a device; :func:`shard_batch` places it on a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov chain parameters give non-uniform, learnable structure
    branching: int = 64

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        B, S = self.global_batch, self.seq_len
        # per-batch random "grammar": next token depends on current token
        # through a seeded hash
        base = rng.integers(0, self.vocab, size=(B, 1), dtype=np.int64)
        mults = rng.integers(1, self.branching, size=(B, S), dtype=np.int64)
        toks = np.zeros((B, S), np.int64)
        toks[:, 0] = base[:, 0]
        for t in range(1, S):
            toks[:, t] = (toks[:, t - 1] * 6364136223846793005
                          + mults[:, t]) % self.vocab
        tokens = toks.astype(np.int32)
        labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
        return {"tokens": tokens, "labels": labels}


def shard_batch(batch: Dict[str, np.ndarray], mesh,
                rules=None) -> Dict[str, torch.Tensor]:
    """Place a host batch (the same on every rank) onto ``mesh``: the
    leading dimension by the ``batch`` rule, the others replicated.  Each
    rank keeps its own rows, cut locally; on a one-device mesh the arrays
    stay plain tensors (see :func:`repro_torch.sharding.place`)."""
    from repro_torch.sharding import DEFAULT_RULES, NamedSharding, place, \
        spec_for
    rules = rules or DEFAULT_RULES
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        names = ("batch",) + (None,) * (v.ndim - 1)
        sh = NamedSharding(mesh, spec_for(v.shape, names, mesh, rules))
        out[k] = place(v, sh)
    return out


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (dtypes kept)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
