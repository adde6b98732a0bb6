"""Serving: batched prefill + single-token decode steps.

The port of ``repro.train.serve_step``.  ``make_serve_step`` returns the
one-new-token function (params, cache, tokens, pos) -> (logits, cache);
the cache is updated in place, as the reference's donated cache is.
``greedy_generate`` is ``greedy_prefill`` then ``greedy_decode``, the
halves the launcher times apart; they cast the parameters once, not at
every step.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models.layers import tree_map

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cast(tree, dtype):
    """Floating leaves of ``tree`` in ``dtype`` (no copy where they are
    already); other leaves as they are."""
    return tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def make_serve_step(cfg: ModelConfig, sc: ServeConfig):
    cdt = DTYPES[sc.compute_dtype]

    def serve_step(params, cache, tokens, pos):
        return registry.decode_step(_cast(params, cdt), cfg, cache, tokens,
                                    pos)

    return serve_step


def make_prefill(cfg: ModelConfig, sc: ServeConfig):
    cdt = DTYPES[sc.compute_dtype]
    kdt = DTYPES[sc.kv_dtype]

    def prefill(params, batch: Dict[str, Any]):
        return registry.prefill(_cast(params, cdt), cfg, batch, sc.seq_len,
                                kv_dtype=kdt)

    return prefill


def greedy_prefill(cfg: ModelConfig, sc: ServeConfig, params,
                   prompt: Dict[str, Any], *, device=None):
    """The first half of :func:`greedy_generate`: ``params`` and ``prompt``
    move to ``device`` (the CUDA card by default; raises without one), the
    parameters are cast to the compute dtype once, and the prompt is
    prefilled.  Returns (cast params, cache, first token (B, 1) int32)."""
    dev = resolve_device(device)
    params = _cast(tree_map(lambda t: t.to(dev), params),
                   DTYPES[sc.compute_dtype])
    prompt = {k: torch.as_tensor(v, device=dev) for k, v in prompt.items()}
    logits, cache = make_prefill(cfg, sc)(params, prompt)
    return params, cache, torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


def greedy_decode(cfg: ModelConfig, params, cache, tok, pos: int,
                  steps: int):
    """The second half of :func:`greedy_generate`: ``steps - 1`` greedy
    decode steps from ``tok`` at absolute position ``pos``, with
    ``params`` already cast by :func:`greedy_prefill`.  Returns the
    (B, steps) int32 tokens, ``tok`` first."""
    out = [tok]
    for t in range(steps - 1):
        logits, cache = registry.decode_step(params, cfg, cache, tok,
                                             pos + t)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)


def greedy_generate(cfg: ModelConfig, sc: ServeConfig, params,
                    prompt: Dict[str, Any], steps: int, *, device=None):
    """Batched greedy generation: prefill, then ``steps - 1`` decode steps
    through the ring cache.  Returns the (B, steps) int32 tokens.
    ``params`` and ``prompt`` move to ``device``, which defaults to the
    CUDA card and raises without one; the parameters are cast to the
    compute dtype once, before the prefill."""
    params, cache, tok = greedy_prefill(cfg, sc, params, prompt,
                                        device=device)
    return greedy_decode(cfg, params, cache, tok,
                         prompt["tokens"].shape[1], steps)
