"""InternVL2-class VLM: vision stub + dense LM backbone.

The port of ``repro.models.vlm``.  The InternViT frontend is a stub:
the caller provides patch embeddings (B, Tv, d_model) already projected
into the LM embedding space.  They replace the first Tv embedding rows of
the token sequence; everything else is the dense GQA decoder of
:mod:`repro_torch.models.transformer`.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T

init_params = T.init_params
init_cache = T.init_cache
param_shapes = T.param_shapes
param_logical = T.param_logical
cache_logical = T.cache_logical


def apply(params, cfg, tokens, patch_embeds, *, remat: str = "none",
          return_hidden: bool = False):
    return T.apply(params, cfg, tokens, remat=remat,
                   prefix_embeds=patch_embeds, return_hidden=return_hidden)


def prefill(params, cfg, tokens, patch_embeds, horizon,
            kv_dtype=torch.bfloat16):
    return T.prefill(params, cfg, tokens, horizon, kv_dtype,
                     prefix_embeds=patch_embeds)


def decode_step(params, cfg, cache, tokens, pos):
    return T.decode_step(params, cfg, cache, tokens, pos)
