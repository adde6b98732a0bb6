"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local MQA
in a (rec, rec, attn) pattern.

The port of ``repro.models.rglru``.  The linear recurrence
h_t = a_t h_{t-1} + b_t runs over the whole sequence at once in
training and prefill: :func:`_associative_scan` is the odd/even recursion
of ``jax.lax.associative_scan`` (pair up neighbours, recurse on the
pairs, fill in the rest), O(S) work in log2(S) levels of a few tensor
ops each, combining the products in the reference's order.  A one-token
decode step computes h = a h0 + b directly.  All gate math is float32.

Decode carries a (B, w) float32 recurrent state and the last K-1 raw
conv inputs a recurrent layer, and a ring of ``min(horizon,
local_window)`` keys and values an attention layer (the window's MQA: one
KV head), all written in place.

The triples are stacked along a leading axis, as the reference's scanned
triples are, and run in a Python loop over views of the stack; the
``n_layers % 3`` tail recurrent blocks (26 = 8·3 + 2) follow them.  The
projections, MLPs and attention are matmuls and SDPA, as the reference's
einsums are: none of it is a Pallas kernel there.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import constrain, logical as lg
from repro_torch.models.ssm import _causal_conv

_C = 8.0  # RG-LRU gate sharpness constant (Griffin)


class RecBlockParams(NamedTuple):
    ln1: torch.Tensor       # (d,)
    w_x: torch.Tensor       # (d, w)
    w_gate: torch.Tensor    # (d, w)
    conv_w: torch.Tensor    # (K, w)
    conv_b: torch.Tensor    # (w,)
    lam: torch.Tensor       # (w,) Lambda
    w_a: torch.Tensor       # (w, w) recurrence gate
    b_a: torch.Tensor       # (w,)
    w_i: torch.Tensor       # (w, w) input gate
    b_i: torch.Tensor       # (w,)
    w_out: torch.Tensor     # (w, d)
    ln2: torch.Tensor       # (d,)
    mlp: L.MLPParams


class AttnBlockParams(NamedTuple):
    ln1: torch.Tensor
    attn: L.AttnParams
    ln2: torch.Tensor
    mlp: L.MLPParams


class TripleParams(NamedTuple):
    rec1: RecBlockParams
    rec2: RecBlockParams
    attn: AttnBlockParams


class GriffinParams(NamedTuple):
    embed: torch.Tensor                 # (V, d)
    triples: TripleParams               # stacked (n_triples, ...)
    tail: Optional[RecBlockParams]      # stacked (n_tail, ...) or None
    ln_f: torch.Tensor                  # (d,)
    unembed: Optional[torch.Tensor]     # (V, d) or None when tied


class RecState(NamedTuple):
    h: torch.Tensor        # (B, w) float32
    conv: torch.Tensor     # (B, K-1, w) the last K-1 raw conv inputs


class GriffinCache(NamedTuple):
    rec1: RecState          # stacked (n_triples, ...)
    rec2: RecState
    attn: L.KVCache         # stacked (n_triples, ...)
    tail: Optional[RecState]  # stacked (n_tail, ...) or None


def _width(cfg):
    return cfg.rglru_width or cfg.d_model


def layout(cfg) -> Tuple[int, int]:
    """(n_triples, n_tail_rec) for the (rec, rec, attn) pattern."""
    n_triples = cfg.n_layers // 3
    return n_triples, cfg.n_layers - 3 * n_triples


def _rec_shapes(cfg, n) -> RecBlockParams:
    d, w, f, K = cfg.d_model, _width(cfg), cfg.d_ff, cfg.conv_kernel
    return RecBlockParams(
        ln1=(n, d), w_x=(n, d, w), w_gate=(n, d, w), conv_w=(n, K, w),
        conv_b=(n, w), lam=(n, w), w_a=(n, w, w), b_a=(n, w),
        w_i=(n, w, w), b_i=(n, w), w_out=(n, w, d), ln2=(n, d),
        mlp=L.MLPParams(w_gate=(n, d, f), w_up=(n, d, f), w_down=(n, f, d)))


def _rec_logical(cfg) -> RecBlockParams:
    return RecBlockParams(
        ln1=lg("embed"), w_x=lg("embed", "mlp"), w_gate=lg("embed", "mlp"),
        conv_w=lg("conv", "mlp"), conv_b=lg("mlp"), lam=lg("mlp"),
        w_a=lg("mlp", None), b_a=lg("mlp"), w_i=lg("mlp", None),
        b_i=lg("mlp"), w_out=lg("mlp", "embed"), ln2=lg("embed"),
        mlp=L.mlp_logical(cfg))


def _attn_logical(cfg) -> AttnBlockParams:
    return AttnBlockParams(ln1=lg("embed"), attn=L.attn_logical(cfg),
                           ln2=lg("embed"), mlp=L.mlp_logical(cfg))


def param_logical(cfg) -> GriffinParams:
    n_tail = layout(cfg)[1]
    triple = TripleParams(rec1=_rec_logical(cfg), rec2=_rec_logical(cfg),
                          attn=_attn_logical(cfg))
    return GriffinParams(
        embed=L.embed_logical(),
        triples=T.stack_logical(triple),
        tail=T.stack_logical(_rec_logical(cfg)) if n_tail else None,
        ln_f=lg("embed"),
        unembed=None if cfg.tie_embeddings else L.embed_logical())


def cache_logical(cfg) -> GriffinCache:
    n_tail = layout(cfg)[1]
    rec = RecState(h=lg("layers", "batch", "mlp"),
                   conv=lg("layers", "batch", None, "mlp"))
    kv = T.cache_logical(cfg).kv
    return GriffinCache(rec1=rec, rec2=rec, attn=kv,
                        tail=rec if n_tail else None)


def param_shapes(cfg) -> GriffinParams:
    """The parameter tree of ``cfg`` with each leaf's shape in its place
    (``None`` for an absent bias, the tail when ``n_layers % 3 == 0`` and
    the tied unembedding)."""
    n_triples, n_tail = layout(cfg)
    d, V = cfg.d_model, cfg.vocab
    # the dense block's fields are the attention block's: ln1, attn, ln2, mlp
    dense = T.param_shapes(dataclasses.replace(cfg, n_layers=n_triples))
    return GriffinParams(
        embed=(V, d),
        triples=TripleParams(rec1=_rec_shapes(cfg, n_triples),
                             rec2=_rec_shapes(cfg, n_triples),
                             attn=AttnBlockParams(*dense.blocks)),
        tail=_rec_shapes(cfg, n_tail) if n_tail else None,
        ln_f=(d,),
        unembed=None if cfg.tie_embeddings else (V, d))


def init_params(generator, cfg, dtype=torch.float32, *,
                device=None) -> GriffinParams:
    """Random parameters of ``cfg``, the reference's distributions: dense
    weights truncated normal with std ``1/sqrt(fan_in)`` (the conv's
    fan-in is its width K), embeddings with std 0.02, norms and biases
    zero, and Lambda the inverse softplus of ``-log(u) / 8`` with u
    uniform in [0.9, 0.999] (drawn in float32), so that ``a^c`` starts in
    [0.9, 0.999].  ``generator`` is a ``torch.Generator`` on ``device`` or
    an int seed; draws run embed, then rec1, rec2 and the attention block
    of the stacked triples, then the tail, then the untied unembedding; a
    recurrent block draws u, w_x, w_gate, conv_w, w_a, w_i, w_out and its
    MLP.  ``device`` defaults to the CUDA card and raises without one."""
    dev = resolve_device(device)
    gen = T.generator_on(generator, dev)
    s = param_shapes(cfg)
    d, w, K = cfg.d_model, _width(cfg), cfg.conv_kernel

    def zeros(shape):
        return None if shape is None else torch.zeros(shape, dtype=dtype,
                                                      device=dev)

    def dense(shape, fan_in):
        return L.dense_init(gen, fan_in, shape, dtype, dev)

    def mlp(m):
        return L.MLPParams(w_gate=dense(m.w_gate, d), w_up=dense(m.w_up, d),
                           w_down=dense(m.w_down, cfg.d_ff))

    def rec(r):
        u = torch.empty(r.lam, dtype=torch.float32, device=dev)
        u.uniform_(0.9, 0.999, generator=gen)
        lam = torch.log(torch.expm1(-torch.log(u) / _C))   # inverse softplus
        return RecBlockParams(
            ln1=zeros(r.ln1), w_x=dense(r.w_x, d),
            w_gate=dense(r.w_gate, d), conv_w=dense(r.conv_w, K),
            conv_b=zeros(r.conv_b), lam=lam.to(dtype), w_a=dense(r.w_a, w),
            b_a=zeros(r.b_a), w_i=dense(r.w_i, w), b_i=zeros(r.b_i),
            w_out=dense(r.w_out, w), ln2=zeros(r.ln2), mlp=mlp(r.mlp))

    def attn_block(b):
        a = b.attn
        return AttnBlockParams(
            ln1=zeros(b.ln1),
            attn=L.AttnParams(
                wq=dense(a.wq, d), wk=dense(a.wk, d), wv=dense(a.wv, d),
                wo=dense(a.wo, cfg.n_heads * cfg.head_dim),
                bq=zeros(a.bq), bk=zeros(a.bk), bv=zeros(a.bv)),
            ln2=zeros(b.ln2), mlp=mlp(b.mlp))

    emb = L.trunc_normal(gen, s.embed, 0.02, dtype, dev)
    triples = TripleParams(rec1=rec(s.triples.rec1),
                           rec2=rec(s.triples.rec2),
                           attn=attn_block(s.triples.attn))
    return GriffinParams(
        embed=emb, triples=triples,
        tail=None if s.tail is None else rec(s.tail),
        ln_f=zeros(s.ln_f),
        unembed=None if s.unembed is None else L.trunc_normal(
            gen, s.unembed, 0.02, dtype, dev))


# ---------------------------------------------------------------------------
# the RG-LRU
# ---------------------------------------------------------------------------

def _combine(a1, b1, a2, b2):
    """The composition of h -> a1 h + b1, then h -> a2 h + b2."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """Along dim 1: even[0], odd[0], even[1], ... (``even`` has as many
    rows as ``odd`` or one more)."""
    m = odd.shape[1]
    out = torch.stack([even[:, :m], odd], dim=2).flatten(1, 2)
    return out if even.shape[1] == m else torch.cat([out, even[:, m:]], 1)


def _associative_scan(a, b):
    """The prefix compositions (A_t, B_t) of (a, b) along dim 1, so that
    h_t = A_t h_0 + B_t: ``jax.lax.associative_scan``'s recursion with
    :func:`_combine`."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine adjacent pairs, then scan the pairs
    odd_a, odd_b = _associative_scan(*_combine(
        a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]))
    # the even positions after the first: the odd prefix before each
    if n % 2 == 0:
        even_a, even_b = _combine(odd_a[:, :-1], odd_b[:, :-1], a[:, 2::2],
                                  b[:, 2::2])
    else:
        even_a, even_b = _combine(odd_a, odd_b, a[:, 2::2], b[:, 2::2])
    even_a = torch.cat([a[:, :1], even_a], 1)
    even_b = torch.cat([b[:, :1], even_b], 1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def _rglru(xb, r_gate, i_gate, lam, h0=None):
    """RG-LRU scan.  xb: (B, S, w); gates the same shape; returns (y in
    xb's dtype, h_last float32).

    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t),
    a_t = exp(-c softplus(lam) r_t).
    """
    log_a = (-_C * F.softplus(lam.float())
             * r_gate.float())                      # (B,S,w), negative
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    b = mult * (i_gate.float() * xb.float())
    # a one-step scan is its own prefix (decode)
    A, Bc = (a, b) if xb.shape[1] == 1 else _associative_scan(a, b)
    y = Bc if h0 is None else A * h0[:, None, :].float() + Bc
    return y.to(xb.dtype), y[:, -1, :]


# ---------------------------------------------------------------------------
# blocks and the forward
# ---------------------------------------------------------------------------

def _rec_apply(p: RecBlockParams, cfg, x, state: Optional[RecState] = None):
    """Recurrent residual block + MLP.  Returns (x, new_state): the final
    recurrent state and the last K-1 raw conv inputs, merged with
    ``state``'s so that a one-token step keeps a full window."""
    u = L.rms_norm(x, p.ln1, cfg.norm_eps)
    gate = L.gelu(u @ p.w_gate)
    xb = constrain(u @ p.w_x, "batch", "seq", "mlp")
    if state is not None:
        ring = torch.cat([state.conv.to(xb.dtype), xb], dim=1)
        conv = _causal_conv(ring, p.conv_w, p.conv_b)[:, state.conv.shape[1]:]
        h0 = state.h
    else:
        ring = xb
        conv = _causal_conv(xb, p.conv_w, p.conv_b)
        h0 = None
    # on a mesh the gates' products are partial sums over the sharded
    # width; they are reduced onto it before the sharded biases add
    r_gate = torch.sigmoid(
        constrain(conv @ p.w_a, "batch", "seq", "mlp") + p.b_a)
    i_gate = torch.sigmoid(
        constrain(conv @ p.w_i, "batch", "seq", "mlp") + p.b_i)
    y, h_last = _rglru(conv, r_gate, i_gate, p.lam, h0)
    x = x + constrain((y * gate) @ p.w_out, "batch", "seq", "embed")
    x = x + L.mlp_apply(p.mlp, L.rms_norm(x, p.ln2, cfg.norm_eps), "gelu")
    return x, RecState(h=h_last, conv=ring[:, -(cfg.conv_kernel - 1):, :])


def _attn_apply_block(p: AttnBlockParams, cfg, x, positions, tables):
    """Local (windowed) MQA + MLP.  Returns (x, (k, v))."""
    h, kv = L.attn_apply(p.attn, cfg, L.rms_norm(x, p.ln1, cfg.norm_eps),
                         positions, tables, causal=True,
                         window=cfg.local_window)
    x = x + h
    x = x + L.mlp_apply(p.mlp, L.rms_norm(x, p.ln2, cfg.norm_eps), "gelu")
    return x, kv


def _triple(cfg, positions, tables, x, trip: TripleParams):
    """rec, rec, attn -> (x, rec1 state, rec2 state, (k, v))."""
    x, s1 = _rec_apply(trip.rec1, cfg, x)
    x, s2 = _rec_apply(trip.rec2, cfg, x)
    x, kv = _attn_apply_block(trip.attn, cfg, x, positions, tables)
    return x, s1, s2, kv


def _tail(tree, cfg) -> list:
    """The tail's layers (none when ``n_layers % 3 == 0``)."""
    n_tail = layout(cfg)[1]
    return T.layers(tree, n_tail) if n_tail else []


def apply(params: GriffinParams, cfg, tokens, *, remat: str = "none",
          return_hidden: bool = False):
    """Train/eval forward: (B, S) int tokens -> (B, S, V) logits, or with
    ``return_hidden`` the final normed hidden states (B, S, d).
    ``remat="full"`` recomputes each triple in the backward (the tail
    blocks keep their activations, as in the reference)."""
    if remat not in T.REMAT:
        raise ValueError(f"remat must be one of {T.REMAT}, got {remat!r}")
    x = L.embed_lookup(params.embed, tokens)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    tables = T._rope_tables(cfg, positions)
    for trip in T.layers(params.triples, layout(cfg)[0]):
        if remat == "full":
            x = checkpoint(_triple, cfg, positions, tables, x, trip,
                           use_reentrant=False, preserve_rng_state=False)[0]
        else:
            x = _triple(cfg, positions, tables, x, trip)[0]
    for blk in _tail(params.tail, cfg):
        x, _ = _rec_apply(blk, cfg, x)
    if return_hidden:
        return L.rms_norm(x, params.ln_f, cfg.norm_eps)
    return T._unembed(params, cfg, x)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _stack(items):
    """A list of like NamedTuples of tensors -> one, each leaf stacked."""
    return type(items[0])(*(torch.stack(ls) for ls in zip(*items)))


def init_cache(cfg, batch, horizon, dtype=torch.bfloat16, *,
               device=None) -> GriffinCache:
    """Zero recurrent states (h float32, the conv ring in ``dtype``) and
    empty attention rings of ``min(horizon, local_window)`` slots;
    ``device`` defaults to the CUDA card and raises without one."""
    dev = resolve_device(device)
    n_triples, n_tail = layout(cfg)
    w = _width(cfg)

    def rec(n):
        return RecState(
            h=torch.zeros((n, batch, w), dtype=torch.float32, device=dev),
            conv=torch.zeros((n, batch, cfg.conv_kernel - 1, w), dtype=dtype,
                             device=dev))

    one = L.kv_cache_init(batch, min(horizon, cfg.local_window),
                          cfg.n_kv_heads, cfg.head_dim, dtype, dev)
    kv = L.tree_map(lambda t: t.expand((n_triples,) + t.shape).clone(), one)
    return GriffinCache(rec1=rec(n_triples), rec2=rec(n_triples), attn=kv,
                        tail=rec(n_tail) if n_tail else None)


def _stored(state: RecState, kv_dtype) -> RecState:
    return RecState(h=state.h, conv=state.conv.to(kv_dtype))


def prefill(params: GriffinParams, cfg, tokens, horizon,
            kv_dtype=torch.bfloat16):
    """Full forward + decode state: returns (logits, GriffinCache): each
    recurrent layer's final state (float32) and last K-1 conv inputs, each
    attention layer's ring of the last ``min(horizon, local_window)``
    keys and values (both in ``kv_dtype``)."""
    x = L.embed_lookup(params.embed, tokens)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    tables = T._rope_tables(cfg, positions)
    cap = min(horizon, cfg.local_window)
    s1s, s2s, kvs = [], [], []
    for trip in T.layers(params.triples, layout(cfg)[0]):
        x, s1, s2, (k, v) = _triple(cfg, positions, tables, x, trip)
        s1s.append(_stored(s1, kv_dtype))
        s2s.append(_stored(s2, kv_dtype))
        kvs.append(L.kv_cache_from_prefill(k, v, positions, cap, kv_dtype))
    tails = []
    for blk in _tail(params.tail, cfg):
        x, st = _rec_apply(blk, cfg, x)
        tails.append(_stored(st, kv_dtype))
    cache = GriffinCache(rec1=_stack(s1s), rec2=_stack(s2s),
                         attn=_stack(kvs),
                         tail=_stack(tails) if tails else None)
    return T._unembed(params, cfg, x), cache


def _rec_step(p: RecBlockParams, cfg, x, state: RecState):
    """One decode step of a recurrent block; its new state is written
    into ``state``'s tensors in place."""
    x, new = _rec_apply(p, cfg, x, state)
    state.h.copy_(new.h)
    state.conv.copy_(new.conv)
    return x


def decode_step(params: GriffinParams, cfg, cache: GriffinCache, tokens,
                pos):
    """One-token decode: tokens (B, 1) int, ``pos`` the absolute position
    (an int).  Writes each layer's new state, conv ring and keys and
    values into ``cache`` in place and returns (logits (B, 1, V),
    cache)."""
    pos = int(pos)
    x = L.embed_lookup(params.embed, tokens)
    tables = T._rope_tables(cfg, torch.full((1,), pos, dtype=torch.int32,
                                            device=x.device))
    n = layout(cfg)[0]
    for trip, s1, s2, kv in zip(T.layers(params.triples, n),
                                T.layers(cache.rec1, n),
                                T.layers(cache.rec2, n),
                                T.layers(cache.attn, n)):
        x = _rec_step(trip.rec1, cfg, x, s1)
        x = _rec_step(trip.rec2, cfg, x, s2)
        blk = trip.attn
        h, _ = L.attn_decode(blk.attn, cfg,
                             L.rms_norm(x, blk.ln1, cfg.norm_eps), kv, pos,
                             tables, window=cfg.local_window)
        x = x + h
        x = x + L.mlp_apply(blk.mlp, L.rms_norm(x, blk.ln2, cfg.norm_eps),
                            "gelu")
    for blk, st in zip(_tail(params.tail, cfg), _tail(cache.tail, cfg)):
        x = _rec_step(blk, cfg, x, st)
    return T._unembed(params, cfg, x), cache

