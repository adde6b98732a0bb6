"""Unified model API across families (the port of
``repro.models.registry``: the forward, the training loss and serving).

Every family of the configs runs here: dense, VLM, MoE, SSM (Mamba2),
hybrid (RecurrentGemma: RG-LRU and local MQA) and encoder-decoder
(whisper).  The MoE forward returns its load-balance aux, which
:func:`loss_fn` adds; the encoder-decoder takes ``batch["frames"]`` and
the VLM ``batch["patches"]`` beside the tokens.  ``demo_batch`` is data
for any family, drawn exactly as the reference draws it, so one seed
gives the reference's batch bitwise.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, moe, rglru, ssm, transformer, vlm

_MODULES = {"dense": transformer, "vlm": vlm, "moe": moe, "ssm": ssm,
            "hybrid": rglru, "encdec": encdec}


def get_module(cfg: ModelConfig):
    return _MODULES[cfg.family]


def init_params(generator, cfg: ModelConfig, dtype=torch.float32, *,
                device=None):
    """Random parameters (see :func:`transformer.init_params`)."""
    return get_module(cfg).init_params(generator, cfg, dtype, device=device)


def demo_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
               dtype=torch.float32, *, device=None) -> Dict[str, Any]:
    """A small real batch: tokens and labels (int32), VLM patches and
    encoder-decoder frames, from ``np.random.default_rng(seed)`` in the
    reference's order.  ``device`` defaults to the CUDA card and raises
    without one."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def ints():
        return torch.as_tensor(
            rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32),
            device=dev)

    def normal(rows):
        return torch.as_tensor(
            rng.normal(size=(batch, rows, cfg.d_model)) * 0.02,
            dtype=dtype, device=dev)

    out = {"tokens": ints(), "labels": ints()}
    if cfg.family == "encdec":
        out["frames"] = normal(cfg.encoder_seq)
    if cfg.family == "vlm":
        out["patches"] = normal(cfg.vision_tokens)
    return out


def forward_logits(params, cfg: ModelConfig, batch: Dict[str, Any],
                   remat: str = "none"):
    """Family-dispatched forward.  Returns (logits, aux_loss): the MoE
    family's mean load-balance aux over its layers, 0.0 for the others."""
    mod = get_module(cfg)
    if cfg.family == "moe":
        return mod.apply(params, cfg, batch["tokens"], remat=remat)
    if cfg.family == "encdec":
        return mod.apply(params, cfg, batch["tokens"], batch["frames"],
                         remat=remat), 0.0
    if cfg.family == "vlm":
        return mod.apply(params, cfg, batch["tokens"], batch["patches"],
                         remat=remat), 0.0
    return mod.apply(params, cfg, batch["tokens"], remat=remat), 0.0


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any],
            remat: str = "none", aux_weight: float = 0.01):
    """Next-token cross entropy (+ ``aux_weight`` times the MoE
    load-balance aux, 0 for the other families): the logits in float32,
    ``logsumexp`` minus the gold logit, averaged.  Returns (loss, {"nll",
    "aux"})."""
    logits, aux = forward_logits(params, cfg, batch, remat)
    logits = logits.float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None],
                                dim=-1).squeeze(-1)
    nll = torch.mean(logz - gold)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, horizon: int,
               dtype=torch.bfloat16, *, device=None):
    return get_module(cfg).init_cache(cfg, batch, horizon, dtype,
                                      device=device)


def decode_step(params, cfg: ModelConfig, cache, tokens, pos):
    return get_module(cfg).decode_step(params, cfg, cache, tokens, pos)


def prefill(params, cfg: ModelConfig, batch: Dict[str, Any], horizon: int,
            kv_dtype=torch.bfloat16):
    mod = get_module(cfg)
    if cfg.family == "encdec":
        return mod.prefill(params, cfg, batch["tokens"], batch["frames"],
                           horizon, kv_dtype)
    if cfg.family == "vlm":
        return mod.prefill(params, cfg, batch["tokens"], batch["patches"],
                           horizon, kv_dtype)
    return mod.prefill(params, cfg, batch["tokens"], horizon, kv_dtype)
