"""Dense GQA decoder-only LM (stablelm / qwen / deepseek / VLM backbone).

The port of ``repro.models.transformer``.  Block parameters are stacked
along a leading L axis, as the reference's are; the layers run in a Python
loop over views of that stack.  :func:`apply` is the training forward too:
autograd runs through it, and ``remat="full"`` recomputes each block in the
backward (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` around its scan body does.  Parameters are drawn from
an explicit ``torch.Generator`` (or a seed), on the CUDA card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.sharding import constrain, logical as lg, map_logical
from repro_torch.tree import leaves, unflatten


class BlockParams(NamedTuple):
    ln1: torch.Tensor
    attn: L.AttnParams
    ln2: torch.Tensor
    mlp: L.MLPParams


class DenseParams(NamedTuple):
    embed: torch.Tensor                 # (V, d)
    blocks: BlockParams                 # stacked (L, ...)
    ln_f: torch.Tensor                  # (d,)
    unembed: Optional[torch.Tensor]     # (V, d) or None when tied


class Cache(NamedTuple):
    kv: L.KVCache                       # stacked (L, ...) ring caches


def param_shapes(cfg) -> DenseParams:
    """The parameter tree of ``cfg`` with each leaf's shape in its place
    (``None`` for an absent bias and for the tied unembedding)."""
    n, d, f, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bias = cfg.qkv_bias
    return DenseParams(
        embed=(V, d),
        blocks=BlockParams(
            ln1=(n, d),
            attn=L.AttnParams(
                wq=(n, d, H, hd), wk=(n, d, KH, hd), wv=(n, d, KH, hd),
                wo=(n, H, hd, d),
                bq=(n, H, hd) if bias else None,
                bk=(n, KH, hd) if bias else None,
                bv=(n, KH, hd) if bias else None),
            ln2=(n, d),
            mlp=L.MLPParams(w_gate=(n, d, f), w_up=(n, d, f),
                            w_down=(n, f, d))),
        ln_f=(d,),
        unembed=None if cfg.tie_embeddings else (V, d))


def stack_logical(tree):
    """Prepend the 'layers' axis to every leaf annotation."""
    return map_logical(lambda x, _: lg("layers", *x.names), tree, tree)


def param_logical(cfg) -> DenseParams:
    block = BlockParams(ln1=lg("embed"), attn=L.attn_logical(cfg),
                        ln2=lg("embed"), mlp=L.mlp_logical(cfg))
    return DenseParams(
        embed=L.embed_logical(), blocks=stack_logical(block),
        ln_f=lg("embed"),
        unembed=None if cfg.tie_embeddings else L.embed_logical())


def generator_on(generator, device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device``: an int seeds a new one; a
    generator must already live there."""
    if isinstance(generator, torch.Generator):
        if generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device}, parameters "
                             f"on {device}")
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))


def init_params(generator, cfg, dtype=torch.float32, *,
                device=None) -> DenseParams:
    """Random parameters of ``cfg``, the reference's distributions: dense
    weights truncated normal with std ``1/sqrt(fan_in)``, embeddings with
    std 0.02, norms and biases zero.  ``generator`` is a
    ``torch.Generator`` on ``device`` or an int seed; draws run embed,
    then each stacked block weight (wq, wk, wv, wo, w_gate, w_up,
    w_down), then the untied unembedding.  ``device`` defaults to the
    CUDA card and raises without one."""
    dev = resolve_device(device)
    gen = generator_on(generator, dev)
    s = param_shapes(cfg)
    a, m = s.blocks.attn, s.blocks.mlp
    H, hd = cfg.n_heads, cfg.head_dim

    def zeros(shape):
        return None if shape is None else torch.zeros(shape, dtype=dtype,
                                                      device=dev)

    def dense(shape, fan_in):
        return L.dense_init(gen, fan_in, shape, dtype, dev)

    def embed(shape):
        return L.trunc_normal(gen, shape, 0.02, dtype, dev)

    emb = embed(s.embed)
    attn = L.AttnParams(
        wq=dense(a.wq, cfg.d_model), wk=dense(a.wk, cfg.d_model),
        wv=dense(a.wv, cfg.d_model), wo=dense(a.wo, H * hd),
        bq=zeros(a.bq), bk=zeros(a.bk), bv=zeros(a.bv))
    mlp = L.MLPParams(w_gate=dense(m.w_gate, cfg.d_model),
                      w_up=dense(m.w_up, cfg.d_model),
                      w_down=dense(m.w_down, cfg.d_ff))
    return DenseParams(
        embed=emb,
        blocks=BlockParams(ln1=zeros(s.blocks.ln1), attn=attn,
                           ln2=zeros(s.blocks.ln2), mlp=mlp),
        ln_f=zeros(s.ln_f),
        unembed=None if s.unembed is None else embed(s.unembed))


def layers(tree, n: int) -> list:
    """The ``n`` layers of a stacked (L, ...) tree, views from one
    ``unbind`` a leaf.  Under autograd the backward of each ``unbind``
    stacks the layers' gradients once, where ``n`` selections would each
    write a zero-filled gradient the size of the whole stack."""
    stacks = [t.unbind(0) for t in leaves(tree)]
    return [unflatten(tree, [s[i] for s in stacks]) for i in range(n)]


def _embed(params: DenseParams, tokens, prefix_embeds):
    x = L.embed_lookup(params.embed, tokens)
    if prefix_embeds is not None:
        P = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(x.dtype), x[:, P:]], dim=1)
    return x


def _mlp_residual(x, blk: BlockParams, cfg):
    return x + L.mlp_apply(blk.mlp, L.rms_norm(x, blk.ln2, cfg.norm_eps))


def _unembed(params: DenseParams, cfg, x):
    x = L.rms_norm(x, params.ln_f, cfg.norm_eps)
    table = params.embed if params.unembed is None else params.unembed
    return L.logits_proj(table, x)


REMAT = ("none", "full", "selective")


def _rope_tables(cfg, positions):
    """The RoPE tables of a forward, once for all its layers (None
    without rotary embeddings)."""
    return L.rope_tables(positions, cfg.head_dim, cfg.rope_theta) \
        if cfg.use_rope else None


def _block_apply(cfg, positions, tables, x, blk: BlockParams):
    h, _ = L.attn_apply(blk.attn, cfg, L.rms_norm(x, blk.ln1, cfg.norm_eps),
                        positions, tables, causal=True,
                        window=cfg.sliding_window)
    return constrain(_mlp_residual(x + h, blk, cfg), "batch", "seq", "embed")


def apply(params: DenseParams, cfg, tokens, *, remat: str = "none",
          prefix_embeds: Optional[torch.Tensor] = None,
          return_hidden: bool = False) -> torch.Tensor:
    """Train/eval forward: (B, S) int tokens -> (B, S, V) logits.

    ``remat``: ``"full"`` saves only each block's input for the backward
    and recomputes the block there; ``"selective"`` is ``"none"`` in the
    dense model, as in the reference.  ``prefix_embeds`` (B, P, d) replace
    the first P embedding rows (VLM patch embeddings; not prepended).
    ``return_hidden`` yields the final normed hidden states (B, S, d)
    instead of logits (feature extraction, SVM probes)."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    x = _embed(params, tokens, prefix_embeds)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    tables = _rope_tables(cfg, positions)
    for blk in layers(params.blocks, cfg.n_layers):
        if remat == "full":
            x = checkpoint(_block_apply, cfg, positions, tables, x, blk,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block_apply(cfg, positions, tables, x, blk)
    if return_hidden:
        return L.rms_norm(x, params.ln_f, cfg.norm_eps)
    return _unembed(params, cfg, x)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cache_capacity(cfg, horizon: int) -> int:
    return min(horizon, cfg.sliding_window) if cfg.sliding_window > 0 \
        else horizon


def init_cache(cfg, batch, horizon, dtype=torch.bfloat16, *,
               device=None) -> Cache:
    """An empty stacked ring cache; ``device`` defaults to the CUDA card
    and raises without one."""
    dev = resolve_device(device)
    cap = cache_capacity(cfg, horizon)
    one = L.kv_cache_init(batch, cap, cfg.n_kv_heads, cfg.head_dim, dtype,
                          dev)
    return Cache(kv=L.tree_map(
        lambda t: t.expand((cfg.n_layers,) + t.shape).clone(), one))


def cache_logical(cfg) -> Cache:
    return Cache(kv=L.KVCache(
        k=lg("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        v=lg("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        kpos=lg("layers", "kv_seq")))


def prefill(params: DenseParams, cfg, tokens, horizon,
            kv_dtype=torch.bfloat16,
            prefix_embeds: Optional[torch.Tensor] = None):
    """Full forward + cache build: returns (logits, Cache)."""
    x = _embed(params, tokens, prefix_embeds)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    cap = cache_capacity(cfg, horizon)
    tables = _rope_tables(cfg, positions)
    kvs = []
    for blk in layers(params.blocks, cfg.n_layers):
        h, (k, v) = L.attn_apply(
            blk.attn, cfg, L.rms_norm(x, blk.ln1, cfg.norm_eps), positions,
            tables, causal=True, window=cfg.sliding_window)
        x = constrain(_mlp_residual(x + h, blk, cfg), "batch", "seq", "embed")
        kvs.append(L.kv_cache_from_prefill(k, v, positions, cap, kv_dtype))
    kv = L.KVCache(*(torch.stack(leaves) for leaves in zip(*kvs)))
    return _unembed(params, cfg, x), Cache(kv=kv)


def decode_step(params: DenseParams, cfg, cache: Cache, tokens, pos):
    """One-token decode: tokens (B, 1) int, ``pos`` the absolute position
    (an int).  Writes the new keys and values into ``cache`` in place and
    returns (logits (B, 1, V), cache)."""
    pos = int(pos)
    x = L.embed_lookup(params.embed, tokens)
    tables = _rope_tables(cfg, torch.full((1,), pos, dtype=torch.int32,
                                          device=x.device))
    n = cfg.n_layers
    for blk, kv in zip(layers(params.blocks, n), layers(cache.kv, n)):
        h, _ = L.attn_decode(blk.attn, cfg,
                             L.rms_norm(x, blk.ln1, cfg.norm_eps), kv, pos,
                             tables, window=cfg.sliding_window)
        x = _mlp_residual(x + h, blk, cfg)
    return _unembed(params, cfg, x), cache
