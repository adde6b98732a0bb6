"""Unified model API across families (the port of
``repro.models.registry``: the forward, the training loss and serving).

Every family of the configs runs here: dense, VLM, MoE, SSM (Mamba2),
hybrid (RecurrentGemma: RG-LRU and local MQA) and encoder-decoder
(whisper).  The MoE forward returns its load-balance aux, which
:func:`loss_fn` adds; the encoder-decoder takes ``batch["frames"]`` and
the VLM ``batch["patches"]`` beside the tokens.  ``demo_batch`` is data
for any family, drawn exactly as the reference draws it, so one seed
gives the reference's batch bitwise.

The sharding side (:func:`param_logical`, :func:`cache_logical`,
:func:`train_input_logical`) and the input specs of a dry-run cell
(:func:`train_input_specs`, :func:`cache_specs`,
:func:`decode_input_specs`) are the reference's; a spec is a ``meta``
tensor, the counterpart of ``jax.ShapeDtypeStruct`` (no storage).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, moe, rglru, ssm, transformer, vlm
from repro_torch.sharding import is_dtensor, local_call, logical as lg

_MODULES = {"dense": transformer, "vlm": vlm, "moe": moe, "ssm": ssm,
            "hybrid": rglru, "encdec": encdec}


def get_module(cfg: ModelConfig):
    return _MODULES[cfg.family]


def init_params(generator, cfg: ModelConfig, dtype=torch.float32, *,
                device=None):
    """Random parameters (see :func:`transformer.init_params`)."""
    return get_module(cfg).init_params(generator, cfg, dtype, device=device)


def param_shapes(cfg: ModelConfig):
    return get_module(cfg).param_shapes(cfg)


def param_logical(cfg: ModelConfig):
    return get_module(cfg).param_logical(cfg)


def supports_cell(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Harness skip rules: long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full quadratic attention at 524288 tokens"
    return True, ""


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` tensors of a training batch: tokens and labels (int32),
    encoder-decoder frames and VLM patches (bfloat16)."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": _spec((B, S), torch.int32),
             "labels": _spec((B, S), torch.int32)}
    if cfg.family == "encdec":
        specs["frames"] = _spec((B, cfg.encoder_seq, cfg.d_model),
                                torch.bfloat16)
    if cfg.family == "vlm":
        specs["patches"] = _spec((B, cfg.vision_tokens, cfg.d_model),
                                 torch.bfloat16)
    return specs


def train_input_logical(cfg: ModelConfig) -> Dict[str, Any]:
    specs = {"tokens": lg("batch", "seq"), "labels": lg("batch", "seq")}
    if cfg.family == "encdec":
        specs["frames"] = lg("batch", "seq", None)
    if cfg.family == "vlm":
        specs["patches"] = lg("batch", "seq", None)
    return specs


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
    vocab = _vocab_mesh_dims(logits)
    if vocab:
        logz, gold = _logz_and_gold_on_shards(logits, labels, vocab)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[..., None],
                                    dim=-1).squeeze(-1)
    nll = torch.mean(logz - gold)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def _vocab_mesh_dims(logits) -> list:
    """The mesh dimensions that shard DTensor logits' vocabulary; none
    for a plain tensor or a replicated vocabulary, which take the plain
    formula (bitwise that of one device)."""
    if not is_dtensor(logits):
        return []
    from torch.distributed.tensor import Shard
    return [i for i, p in enumerate(logits.placements)
            if isinstance(p, Shard) and p.dim % logits.ndim == 2]


def _logz_and_gold_on_shards(logits, labels, vocab):
    """:func:`loss_fn`'s ``logsumexp`` and gold logit of DTensor logits
    whose vocabulary the mesh dimensions ``vocab`` shard, kept sharded as
    GSPMD keeps it: only (batch, seq) values cross ranks, never a (batch,
    seq, vocab) gather.  ``logsumexp`` is its own formula on DTensor ops
    (the row maximum, then the sum of the shifted exponentials, each
    reduced over the vocabulary shards); each rank takes the gold logits
    its vocabulary shard holds, and the ``Partial`` sum over those shards
    is the gold logit."""
    from torch.distributed.tensor import Partial, Replicate
    mesh, pl = logits.device_mesh, tuple(logits.placements)
    rows = tuple(Replicate() if i in vocab else p for i, p in enumerate(pl))
    m = logits.detach().amax(dim=-1, keepdim=True).redistribute(mesh, rows)
    # the sum reduced onto the rows' placements: left ``Partial``, DTensor
    # may scatter it over the rows instead, and the backward then moves
    # (batch, seq, vocab) gradients back onto the vocabulary shards
    total = torch.sum(torch.exp(logits - m), dim=-1).redistribute(mesh, rows)
    logz = m.squeeze(-1) + torch.log(total)
    # this rank's first vocabulary entry: plain ``Shard`` splits in mesh
    # order, and ``spec_for`` shards only dimensions that divide evenly
    block = 0
    for i in vocab:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    first = block * (logits.shape[-1] // math.prod(mesh.size(i)
                                                   for i in vocab))

    def gold_of_shard(z, lab):
        idx = lab - first
        mine = (idx >= 0) & (idx < z.shape[-1])
        g = torch.take_along_dim(z, idx.clamp(0, z.shape[-1] - 1)[..., None],
                                 dim=-1).squeeze(-1)
        return torch.where(mine, g, torch.zeros_like(g))

    gold = local_call(gold_of_shard, mesh, (pl, rows),
                      tuple(Partial() if i in vocab else p
                            for i, p in enumerate(pl)), logits, labels)
    return logz, gold


def init_cache(cfg: ModelConfig, batch: int, horizon: int,
               dtype=torch.bfloat16, *, device=None):
    return get_module(cfg).init_cache(cfg, batch, horizon, dtype,
                                      device=device)


def cache_logical(cfg: ModelConfig):
    return get_module(cfg).cache_logical(cfg)


def cache_specs(cfg: ModelConfig, batch: int, horizon: int,
                dtype=torch.bfloat16):
    """The decode cache as ``meta`` tensors (no storage)."""
    return get_module(cfg).init_cache(cfg, batch, horizon, dtype,
                                      device="meta")


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """A decode step's inputs: tokens (B, 1) int32 and the position, a
    0-d int32 (the port's decode steps take it as an int)."""
    return {"tokens": _spec((shape.global_batch, 1), torch.int32),
            "pos": _spec((), torch.int32)}


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
