"""Mixture-of-Experts decoder (grok-1 / mixtral): top-2 router, GShard-style
capacity dispatch, sliding-window attention (mixtral).

The port of ``repro.models.moe``.  Routing follows the reference op for op:
router logits in the activations' dtype, then float32; a softmax; the top K
experts a token, the lower expert index first on equal probabilities; the
K gates renormalised; each (token, k)'s slot in its expert's buffer by an
exclusive cumsum over the flattened (S·K) order; a capacity cut
(:func:`capacity`) that drops every slot past it.  The dispatch and combine
tensors are (B, S, E, C) in the activations' dtype, and the experts' gated
SiLU MLPs are batched matmuls over the expert axis, as the reference's
einsums are: none of it is a Pallas kernel there.  The reference pins
its layouts to a mesh at the same six points (``constrain``); on one
device that does nothing.

Attention, the ring cache and the logits are the dense model's
(:mod:`repro_torch.models.transformer`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import constrain, logical as lg


class MoEParams(NamedTuple):
    router: torch.Tensor    # (d, E)
    w_gate: torch.Tensor    # (E, d, f)
    w_up: torch.Tensor      # (E, d, f)
    w_down: torch.Tensor    # (E, f, d)


class MoEBlockParams(NamedTuple):
    ln1: torch.Tensor
    attn: L.AttnParams
    ln2: torch.Tensor
    moe: MoEParams


class MoEModelParams(NamedTuple):
    embed: torch.Tensor                 # (V, d)
    blocks: MoEBlockParams              # stacked (L, ...)
    ln_f: torch.Tensor                  # (d,)
    unembed: Optional[torch.Tensor]     # (V, d) or None when tied


def param_shapes(cfg) -> MoEModelParams:
    """The parameter tree of ``cfg`` with each leaf's shape in its place
    (``None`` for an absent bias and for the tied unembedding)."""
    dense = T.param_shapes(cfg)
    n, d, f, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    return MoEModelParams(
        embed=dense.embed,
        blocks=MoEBlockParams(
            ln1=(n, d), attn=dense.blocks.attn, ln2=(n, d),
            moe=MoEParams(router=(n, d, E), w_gate=(n, E, d, f),
                          w_up=(n, E, d, f), w_down=(n, E, f, d))),
        ln_f=dense.ln_f, unembed=dense.unembed)


def init_params(generator, cfg, dtype=torch.float32, *,
                device=None) -> MoEModelParams:
    """Random parameters of ``cfg``, the reference's distributions: dense
    weights and the router truncated normal with std ``1/sqrt(fan_in)``,
    embeddings with std 0.02, norms and biases zero.  ``generator`` is a
    ``torch.Generator`` on ``device`` or an int seed; draws run embed,
    then each stacked block weight (wq, wk, wv, wo, router, w_gate, w_up,
    w_down), then the untied unembedding.  ``device`` defaults to the
    CUDA card and raises without one."""
    dev = resolve_device(device)
    gen = T.generator_on(generator, dev)
    s = param_shapes(cfg)
    a, m = s.blocks.attn, s.blocks.moe
    d = cfg.d_model

    def zeros(shape):
        return None if shape is None else torch.zeros(shape, dtype=dtype,
                                                      device=dev)

    def dense(shape, fan_in):
        return L.dense_init(gen, fan_in, shape, dtype, dev)

    def embed(shape):
        return L.trunc_normal(gen, shape, 0.02, dtype, dev)

    emb = embed(s.embed)
    attn = L.AttnParams(
        wq=dense(a.wq, d), wk=dense(a.wk, d), wv=dense(a.wv, d),
        wo=dense(a.wo, cfg.n_heads * cfg.head_dim),
        bq=zeros(a.bq), bk=zeros(a.bk), bv=zeros(a.bv))
    moe = MoEParams(router=dense(m.router, d), w_gate=dense(m.w_gate, d),
                    w_up=dense(m.w_up, d), w_down=dense(m.w_down, cfg.d_ff))
    return MoEModelParams(
        embed=emb,
        blocks=MoEBlockParams(ln1=zeros(s.blocks.ln1), attn=attn,
                              ln2=zeros(s.blocks.ln2), moe=moe),
        ln_f=zeros(s.ln_f),
        unembed=None if s.unembed is None else embed(s.unembed))


def moe_logical(cfg) -> MoEParams:
    return MoEParams(router=lg("embed", None),
                     w_gate=lg("expert", None, "moe_ff"),
                     w_up=lg("expert", None, "moe_ff"),
                     w_down=lg("expert", "moe_ff", None))


def param_logical(cfg) -> MoEModelParams:
    block = MoEBlockParams(ln1=lg("embed"), attn=L.attn_logical(cfg),
                           ln2=lg("embed"), moe=moe_logical(cfg))
    return MoEModelParams(
        embed=L.embed_logical(), blocks=T.stack_logical(block),
        ln_f=lg("embed"),
        unembed=None if cfg.tie_embeddings else L.embed_logical())


cache_logical = T.cache_logical


def capacity(cfg, seq: int) -> int:
    """Slots an expert takes per sequence: ``capacity_factor · top_k · seq
    / n_experts`` rounded up to a multiple of 8, at least 8, at most
    ``seq``."""
    cap = int(cfg.capacity_factor * cfg.top_k * seq / cfg.n_experts)
    return max(8, min(seq, (cap + 7) // 8 * 8))


def route(p: MoEParams, cfg, x):
    """The router of :func:`moe_apply`: (probs (B, S, E) float32, gate
    values (B, S, K) float32 renormalised, expert indices (B, S, K)
    int64).  The top K come from a stable descending sort, so equal
    probabilities put the lower expert index first, as ``lax.top_k``
    does (``torch.topk`` promises no order between equal values)."""
    logits = (x @ p.router).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.top_k
    gate_vals, gate_idx = vals[..., :K], idx[..., :K]
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), gate_idx


def moe_apply(p: MoEParams, cfg, x):
    """x: (B, S, d) -> (y, aux_loss).  GShard top-k with capacity drop.

    ``aux`` is the Switch load-balance loss ``E · Σ_e mean(p_e) ·
    mean(count_e)``, a 0-d float32 tensor."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    probs, gate_vals, gate_idx = route(p, cfg, x)
    onehot_e = F.one_hot(gate_idx, E).float()                  # (B,S,K,E)
    me = probs.mean(dim=(0, 1))
    ce = onehot_e.sum(dim=2).mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)

    # position of each (token, k) inside its expert's capacity buffer;
    # a position >= C matches no slot, so its dispatch row is all zero
    flat = onehot_e.reshape(B, S * K, E)
    pos_in_e = (torch.cumsum(flat, dim=1) - flat).reshape(B, S, K, E)
    slots = torch.arange(C, dtype=pos_in_e.dtype, device=x.device)
    dispatch = torch.zeros((B, S, E, C), dtype=x.dtype, device=x.device)
    combine = torch.zeros_like(dispatch)
    for k in range(K):
        oc = (pos_in_e[:, :, k, :, None] == slots).to(x.dtype)  # (B,S,E,C)
        dpk = onehot_e[:, :, k, :, None].to(x.dtype) * oc
        dispatch = dispatch + dpk
        combine = combine + gate_vals[:, :, k, None, None].to(x.dtype) * dpk

    # (E, B, C, d): the tokens each expert takes, in slot order; the
    # experts' matmuls run over its (E, B·C, d) view
    xin = constrain(torch.einsum("bsec,bsd->ebcd", dispatch, x),
                    "expert", "batch", None, None)
    f = p.w_gate.shape[-1]
    xin = xin.reshape(E, B * C, d)
    g = constrain(torch.bmm(xin, p.w_gate).reshape(E, B, C, f),
                  "expert", "batch", None, "moe_ff")
    h = torch.bmm(F.silu(g).reshape(E, B * C, f) * torch.bmm(xin, p.w_up),
                  p.w_down)
    h = constrain(h.reshape(E, B, C, d), "expert", "batch", None, None)
    # einsum("bsec,ebcd->bsd") as one batched matmul over (e, c), e the
    # outer index of the merged dimension (einsum's own order would merge
    # a sharded e inside c, which DTensor has no matmul rule for)
    y = torch.bmm(combine.reshape(B, S, E * C),
                  h.permute(1, 0, 2, 3).reshape(B, E * C, d))
    return constrain(y, "batch", "seq", "embed"), aux


def _block_apply(cfg, positions, tables, x, blk: MoEBlockParams):
    """One block: attention and the MoE MLP, each with its residual ->
    (x, aux, (k, v))."""
    h, kv = L.attn_apply(blk.attn, cfg, L.rms_norm(x, blk.ln1, cfg.norm_eps),
                         positions, tables, causal=True,
                         window=cfg.sliding_window)
    x = x + h
    y, aux = moe_apply(blk.moe, cfg, L.rms_norm(x, blk.ln2, cfg.norm_eps))
    return constrain(x + y, "batch", "seq", "embed"), aux, kv


def apply(params: MoEModelParams, cfg, tokens, *, remat: str = "none",
          return_hidden: bool = False):
    """Train/eval forward: (B, S) int tokens -> (logits (B, S, V), the
    mean aux over layers); with ``return_hidden`` the final normed hidden
    states (B, S, d) in place of the logits.  ``remat="full"`` recomputes
    each block in the backward (``"selective"`` is ``"none"``, as in the
    reference)."""
    if remat not in T.REMAT:
        raise ValueError(f"remat must be one of {T.REMAT}, got {remat!r}")
    x = L.embed_lookup(params.embed, tokens)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    tables = T._rope_tables(cfg, positions)
    auxs = []
    for blk in T.layers(params.blocks, cfg.n_layers):
        if remat == "full":
            x, aux, _ = checkpoint(_block_apply, cfg, positions, tables, x,
                                   blk, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            x, aux, _ = _block_apply(cfg, positions, tables, x, blk)
        auxs.append(aux)
    aux = torch.stack(auxs).mean()
    if return_hidden:
        return L.rms_norm(x, params.ln_f, cfg.norm_eps), aux
    return T._unembed(params, cfg, x), aux


# ---------------------------------------------------------------------------
# serving: the dense model's ring cache
# ---------------------------------------------------------------------------

init_cache = T.init_cache


def prefill(params: MoEModelParams, cfg, tokens, horizon,
            kv_dtype=torch.bfloat16):
    """Full forward + cache build: returns (logits, Cache)."""
    x = L.embed_lookup(params.embed, tokens)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    cap = T.cache_capacity(cfg, horizon)
    tables = T._rope_tables(cfg, positions)
    kvs = []
    for blk in T.layers(params.blocks, cfg.n_layers):
        x, _, (k, v) = _block_apply(cfg, positions, tables, x, blk)
        kvs.append(L.kv_cache_from_prefill(k, v, positions, cap, kv_dtype))
    kv = L.KVCache(*(torch.stack(leaves) for leaves in zip(*kvs)))
    return T._unembed(params, cfg, x), T.Cache(kv=kv)


def decode_step(params: MoEModelParams, cfg, cache: T.Cache, tokens, pos):
    """One-token decode: tokens (B, 1) int, ``pos`` the absolute position
    (an int).  Writes the new keys and values into ``cache`` in place and
    returns (logits (B, 1, V), cache).  The MoE layer routes the one token
    with the capacity of a one-token sequence (8 slots)."""
    pos = int(pos)
    x = L.embed_lookup(params.embed, tokens)
    tables = T._rope_tables(cfg, torch.full((1,), pos, dtype=torch.int32,
                                            device=x.device))
    n = cfg.n_layers
    for blk, kv in zip(T.layers(params.blocks, n), T.layers(cache.kv, n)):
        h, _ = L.attn_decode(blk.attn, cfg,
                             L.rms_norm(x, blk.ln1, cfg.norm_eps), kv, pos,
                             tables, window=cfg.sliding_window)
        x = x + h
        y, _ = moe_apply(blk.moe, cfg, L.rms_norm(x, blk.ln2, cfg.norm_eps))
        x = x + y
    return T._unembed(params, cfg, x), cache
