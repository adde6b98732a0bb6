"""Whisper-class encoder-decoder backbone.

The port of ``repro.models.encdec``.  The conv/mel frontend is a stub:
the caller provides precomputed frame embeddings (B, S_enc, d).  Encoder:
bidirectional self-attention; decoder: causal self-attention and
cross-attention to the encoder's output.  Sinusoidal absolute positions
(no RoPE).  Decode keeps the decoder's self-attention ring (capacity the
horizon) and each layer's encoder keys and values, computed once by the
prefill.  The projections, MLPs and attention are matmuls and SDPA, as the
reference's einsums are: none of it is a Pallas kernel there.

One departure: the frames are cast to the parameters' dtype before the
encoder (JAX promotes float32 frames against bfloat16 weights and runs
the encoder in float32; PyTorch's matmul takes no mixed dtypes).  With
frames in the parameters' dtype, as every caller draws them, the two
agree.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import constrain, logical as lg


class EncBlockParams(NamedTuple):
    ln1: torch.Tensor
    attn: L.AttnParams
    ln2: torch.Tensor
    mlp: L.MLPParams


class DecBlockParams(NamedTuple):
    ln1: torch.Tensor
    self_attn: L.AttnParams
    ln_x: torch.Tensor
    cross_attn: L.AttnParams
    ln2: torch.Tensor
    mlp: L.MLPParams


class EncDecParams(NamedTuple):
    embed: torch.Tensor                 # (V, d) decoder token embeddings
    enc_blocks: EncBlockParams          # stacked (Le, ...)
    enc_ln_f: torch.Tensor
    dec_blocks: DecBlockParams          # stacked (Ld, ...)
    ln_f: torch.Tensor
    unembed: Optional[torch.Tensor]


class EncDecCache(NamedTuple):
    self_kv: L.KVCache                  # stacked (Ld, ...) decoder ring
    cross_k: torch.Tensor               # (Ld, B, S_enc, KH, hd)
    cross_v: torch.Tensor


def _inv_freq(d, device):
    """(d // 2,) float32 ``10000 ** (2 i / d)``, the exponent in float32.
    The power is taken in float64 and rounded: that is the reference's
    float32 ``jnp.power`` bitwise, where float32 ``torch.pow`` is one
    ulp off at some i (at d = 384, i = 80), and an angle ``pos / 10000
    ** (2 i / d)`` at pos 1500 then moves by 4e-6."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    return torch.pow(10_000.0, (2.0 * dim / d).double()).float()


def sinusoidal(S, d, dtype=torch.float32, device=None):
    """(S, d) positions: [sin, cos] of ``pos / 10000 ** (2 i / d)`` in
    float32, in the reference's order, cast to ``dtype``."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    ang = pos / _inv_freq(d, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def sinusoidal_at(pos, d, dtype, device=None):
    """The (d,) row of :func:`sinusoidal` at position ``pos`` (an int)."""
    ang = torch.full((), pos, dtype=torch.float32,
                     device=device) / _inv_freq(d, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)]).to(dtype)


def param_shapes(cfg) -> EncDecParams:
    """The parameter tree of ``cfg`` with each leaf's shape in its place
    (``None`` for an absent bias and for the tied unembedding)."""
    def blocks(n):      # the dense block's shapes: ln1, attn, ln2, mlp
        return T.param_shapes(dataclasses.replace(cfg, n_layers=n)).blocks

    d, V = cfg.d_model, cfg.vocab
    dec = blocks(cfg.n_layers)
    return EncDecParams(
        embed=(V, d),
        enc_blocks=EncBlockParams(*blocks(cfg.encoder_layers)),
        enc_ln_f=(d,),
        dec_blocks=DecBlockParams(ln1=dec.ln1, self_attn=dec.attn,
                                  ln_x=dec.ln1, cross_attn=dec.attn,
                                  ln2=dec.ln2, mlp=dec.mlp),
        ln_f=(d,),
        unembed=None if cfg.tie_embeddings else (V, d))


def param_logical(cfg) -> EncDecParams:
    enc = EncBlockParams(ln1=lg("embed"), attn=L.attn_logical(cfg),
                         ln2=lg("embed"), mlp=L.mlp_logical(cfg))
    dec = DecBlockParams(ln1=lg("embed"), self_attn=L.attn_logical(cfg),
                         ln_x=lg("embed"), cross_attn=L.attn_logical(cfg),
                         ln2=lg("embed"), mlp=L.mlp_logical(cfg))
    return EncDecParams(
        embed=L.embed_logical(), enc_blocks=T.stack_logical(enc),
        enc_ln_f=lg("embed"), dec_blocks=T.stack_logical(dec),
        ln_f=lg("embed"),
        unembed=None if cfg.tie_embeddings else L.embed_logical())


def cache_logical(cfg) -> EncDecCache:
    ckv = lg("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return EncDecCache(self_kv=T.cache_logical(cfg).kv, cross_k=ckv,
                       cross_v=ckv)


def init_params(generator, cfg, dtype=torch.float32, *,
                device=None) -> EncDecParams:
    """Random parameters of ``cfg``, the reference's distributions: dense
    weights truncated normal with std ``1/sqrt(fan_in)``, embeddings with
    std 0.02, norms and biases zero.  ``generator`` is a
    ``torch.Generator`` on ``device`` or an int seed; draws run embed,
    then the stacked encoder blocks (wq, wk, wv, wo, w_gate, w_up,
    w_down), then the decoder blocks (self-attention's four, then
    cross-attention's, then the MLP's three), then the untied
    unembedding.  ``device`` defaults to the CUDA card and raises without
    one."""
    dev = resolve_device(device)
    gen = T.generator_on(generator, dev)
    s = param_shapes(cfg)
    d = cfg.d_model

    def zeros(shape):
        return None if shape is None else torch.zeros(shape, dtype=dtype,
                                                      device=dev)

    def dense(shape, fan_in):
        return L.dense_init(gen, fan_in, shape, dtype, dev)

    def attn(a):
        return L.AttnParams(
            wq=dense(a.wq, d), wk=dense(a.wk, d), wv=dense(a.wv, d),
            wo=dense(a.wo, cfg.n_heads * cfg.head_dim),
            bq=zeros(a.bq), bk=zeros(a.bk), bv=zeros(a.bv))

    def mlp(m):
        return L.MLPParams(w_gate=dense(m.w_gate, d), w_up=dense(m.w_up, d),
                           w_down=dense(m.w_down, cfg.d_ff))

    emb = L.trunc_normal(gen, s.embed, 0.02, dtype, dev)
    e, b = s.enc_blocks, s.dec_blocks
    enc = EncBlockParams(ln1=zeros(e.ln1), attn=attn(e.attn),
                         ln2=zeros(e.ln2), mlp=mlp(e.mlp))
    dec = DecBlockParams(ln1=zeros(b.ln1), self_attn=attn(b.self_attn),
                         ln_x=zeros(b.ln_x), cross_attn=attn(b.cross_attn),
                         ln2=zeros(b.ln2), mlp=mlp(b.mlp))
    return EncDecParams(
        embed=emb, enc_blocks=enc, enc_ln_f=zeros(s.enc_ln_f),
        dec_blocks=dec, ln_f=zeros(s.ln_f),
        unembed=None if s.unembed is None else L.trunc_normal(
            gen, s.unembed, 0.02, dtype, dev))


# ---------------------------------------------------------------------------
# the encoder, cross-attention and the forward
# ---------------------------------------------------------------------------

def _enc_block(cfg, positions, x, blk: EncBlockParams):
    h, _ = L.attn_apply(blk.attn, cfg, L.rms_norm(x, blk.ln1, cfg.norm_eps),
                        positions, None, causal=False)
    x = x + h
    x = x + L.mlp_apply(blk.mlp, L.rms_norm(x, blk.ln2, cfg.norm_eps), "gelu")
    return constrain(x, "batch", "seq", "embed")


def encode(params: EncDecParams, cfg, frames):
    """frames: (B, S_enc, d) stub embeddings -> (B, S_enc, d).  Each block
    is recomputed in the backward, as the reference's ``encode``
    checkpoints its scan body whatever ``remat`` is."""
    S = frames.shape[1]
    x = frames.to(params.embed.dtype)
    x = x + sinusoidal(S, cfg.d_model, x.dtype, x.device)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    for blk in T.layers(params.enc_blocks, cfg.encoder_layers):
        x = checkpoint(_enc_block, cfg, positions, x, blk,
                       use_reentrant=False, preserve_rng_state=False)
    return L.rms_norm(x, params.enc_ln_f, cfg.norm_eps)


def _cross_attend(p: L.AttnParams, cfg, x, enc_k, enc_v):
    """Cross attention: q from x (B, S, d), k/v precomputed (B, T, KH, hd);
    no RoPE and no mask (so the positions go unread)."""
    q = L._proj(x, p.wq)
    if p.bq is not None:
        q = q + p.bq
    o = L.attention(q, enc_k, enc_v, None, None, causal=False)
    return L.attn_out(p, o)


def _enc_kv(p: L.AttnParams, enc_out):
    k, v = L._proj(enc_out, p.wk), L._proj(enc_out, p.wv)
    if p.bk is not None:
        k = k + p.bk
        v = v + p.bv
    return k, v


def _dec_block(cfg, positions, tables, enc_out, x, blk: DecBlockParams):
    """One decoder block -> (x, self-attention (k, v), cross (k, v))."""
    h, kv = L.attn_apply(blk.self_attn, cfg,
                         L.rms_norm(x, blk.ln1, cfg.norm_eps), positions,
                         tables, causal=True)
    x = x + h
    ck, cv = _enc_kv(blk.cross_attn, enc_out)
    x = x + _cross_attend(blk.cross_attn, cfg,
                          L.rms_norm(x, blk.ln_x, cfg.norm_eps), ck, cv)
    x = x + L.mlp_apply(blk.mlp, L.rms_norm(x, blk.ln2, cfg.norm_eps),
                        "gelu")
    return constrain(x, "batch", "seq", "embed"), kv, (ck, cv)


def _decoder_in(params: EncDecParams, cfg, tokens):
    """Token embeddings plus positions, the positions and their RoPE
    tables (None: whisper has none)."""
    x = L.embed_lookup(params.embed, tokens)
    S = tokens.shape[1]
    x = x + sinusoidal(S, cfg.d_model, x.dtype, x.device)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    return x, positions, T._rope_tables(cfg, positions)


def apply(params: EncDecParams, cfg, tokens, frames, *, remat: str = "none",
          return_hidden: bool = False):
    """Teacher-forced training forward: (tokens (B, S_dec), frames
    (B, S_enc, d)) -> logits (B, S_dec, V), or with ``return_hidden`` the
    decoder's final normed hidden states.  ``remat="full"`` recomputes
    each decoder block in the backward too."""
    if remat not in T.REMAT:
        raise ValueError(f"remat must be one of {T.REMAT}, got {remat!r}")
    enc_out = encode(params, cfg, frames)
    x, positions, tables = _decoder_in(params, cfg, tokens)
    for blk in T.layers(params.dec_blocks, cfg.n_layers):
        if remat == "full":
            x = checkpoint(_dec_block, cfg, positions, tables, enc_out, x,
                           blk, use_reentrant=False,
                           preserve_rng_state=False)[0]
        else:
            x = _dec_block(cfg, positions, tables, enc_out, x, blk)[0]
    if return_hidden:
        return L.rms_norm(x, params.ln_f, cfg.norm_eps)
    return T._unembed(params, cfg, x)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, horizon, dtype=torch.bfloat16, *,
               device=None) -> EncDecCache:
    """An empty decoder ring of ``horizon`` slots a layer and zero encoder
    keys and values; ``device`` defaults to the CUDA card and raises
    without one."""
    dev = resolve_device(device)
    Ld = cfg.n_layers
    one = L.kv_cache_init(batch, horizon, cfg.n_kv_heads, cfg.head_dim,
                          dtype, dev)
    cross = (Ld, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
    return EncDecCache(
        self_kv=L.tree_map(lambda t: t.expand((Ld,) + t.shape).clone(), one),
        cross_k=torch.zeros(cross, dtype=dtype, device=dev),
        cross_v=torch.zeros(cross, dtype=dtype, device=dev))


def prefill(params: EncDecParams, cfg, tokens, frames, horizon,
            kv_dtype=torch.bfloat16):
    """Encode + teacher-forced decoder pass building both caches: returns
    (logits, EncDecCache), the encoder's keys and values in
    ``kv_dtype``."""
    enc_out = encode(params, cfg, frames)
    x, positions, tables = _decoder_in(params, cfg, tokens)
    kvs, cks, cvs = [], [], []
    for blk in T.layers(params.dec_blocks, cfg.n_layers):
        x, (k, v), (ck, cv) = _dec_block(cfg, positions, tables, enc_out, x,
                                         blk)
        kvs.append(L.kv_cache_from_prefill(k, v, positions, horizon,
                                           kv_dtype))
        cks.append(ck.to(kv_dtype))
        cvs.append(cv.to(kv_dtype))
    kv = L.KVCache(*(torch.stack(leaves) for leaves in zip(*kvs)))
    return T._unembed(params, cfg, x), EncDecCache(
        self_kv=kv, cross_k=torch.stack(cks), cross_v=torch.stack(cvs))


def decode_step(params: EncDecParams, cfg, cache: EncDecCache, tokens, pos):
    """One-token decode: tokens (B, 1) int, ``pos`` the absolute position
    (an int).  Writes the new self-attention keys and values into
    ``cache`` in place (the encoder's stay as the prefill left them) and
    returns (logits (B, 1, V), cache)."""
    pos = int(pos)
    x = L.embed_lookup(params.embed, tokens)
    x = x + sinusoidal_at(pos, cfg.d_model, x.dtype, x.device)
    tables = T._rope_tables(cfg, torch.full((1,), pos, dtype=torch.int32,
                                            device=x.device))
    n = cfg.n_layers
    for blk, kv, ck, cv in zip(T.layers(params.dec_blocks, n),
                               T.layers(cache.self_kv, n),
                               cache.cross_k.unbind(0),
                               cache.cross_v.unbind(0)):
        h, _ = L.attn_decode(blk.self_attn, cfg,
                             L.rms_norm(x, blk.ln1, cfg.norm_eps), kv, pos,
                             tables)
        x = x + h
        x = x + _cross_attend(blk.cross_attn, cfg,
                              L.rms_norm(x, blk.ln_x, cfg.norm_eps),
                              ck.to(x.dtype), cv.to(x.dtype))
        x = x + L.mlp_apply(blk.mlp, L.rms_norm(x, blk.ln2, cfg.norm_eps),
                            "gelu")
    return T._unembed(params, cfg, x), cache
