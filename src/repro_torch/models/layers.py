"""Shared transformer layers: RMSNorm, RoPE, GQA attention, gated MLP.

The port of ``repro.models.layers``; autograd differentiates it for
training.  Tensors keep the reference's layouts: activations (B, S, d),
heads (B, S, H, hd), weights as :class:`AttnParams` / :class:`MLPParams`
below.  The projections, the MLP and the logits are matmuls, as the
reference's einsums are: none of them is a Pallas kernel there.

Attention is one function here.  The reference computes it with two
schedules of the same arithmetic (its ``_chunk_attn`` scan and
``flash.flash_attention``, chosen by the ``REPRO_ATTN`` environment
variable); :func:`attention` computes that function, causal or windowed
GQA softmax attention on absolute positions, with
``torch.nn.functional.scaled_dot_product_attention``, whose own backward
is the gradient (the tests hold it against ``jax.vjp`` of the reference's
``flash_attention``).  Decode attention
(:func:`attn_decode`) follows the reference op for op: dots against the
cache in its storage dtype, accumulated in float32, masked scores
``NEG``.

Parameter trees are NamedTuples whose leaves are tensors or ``None`` (an
absent bias); :func:`repro_torch.tree.tree_map` walks them.  Each has its
logical annotation (``attn_logical``, ``mlp_logical``,
``embed_logical``), and the activations are constrained at the
reference's points (``repro_torch.sharding.constrain``: nothing on plain
tensors).  On a mesh the leaves are DTensors; where DTensor has no rule
or picks a layout the next op cannot take, a function runs on each
rank's shards (``sharding.local_call``): the head projections,
attention, the prefill cache and the decode step.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding import constrain, is_dtensor, local_call, \
    logical as lg
from repro_torch.tree import tree_map  # noqa: F401  (the models' walker)

NEG = -1e30


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def trunc_normal(gen: torch.Generator, shape, std, dtype, device):
    """Normal(0, std) truncated at +-2 std, drawn in float32 (inverse CDF
    of a uniform draw from ``gen``) and cast to ``dtype``, as the
    reference's ``trunc_normal`` draws its values."""
    lo, hi = (math.erf(z / math.sqrt(2.0)) for z in (-2.0, 2.0))
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(lo, hi, generator=gen)
    z = u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return z.mul_(std).to(dtype)


def dense_init(gen, fan_in, shape, dtype, device):
    return trunc_normal(gen, shape, 1.0 / math.sqrt(fan_in), dtype, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_tables(positions, dim: int, theta=10_000.0):
    """cos and sin of RoPE's angles, each (..., S, 1, dim // 2) float32,
    for heads of ``dim`` at ``positions`` (..., S) int.  The frequencies
    are ``exp(-arange(half) * log(theta) / half)`` in float32, the
    reference's formula (``theta ** (-2i / D)`` rounds differently)."""
    half = dim // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs          # (..., S, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope(x, tables):
    """Rotary embedding, llama-style half rotation.

    x: (..., S, H, D); ``tables``: :func:`rope_tables` of x's positions
    (the reference's ``rope(x, positions, theta)`` computes them in each
    call; a forward or decode step here computes them once for every
    layer)."""
    half = x.shape[-1] // 2
    cos, sin = tables
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin,
                      xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention(q, k, v, q_positions, k_positions, *, causal=True, window=0):
    """GQA softmax attention on absolute positions.

    q: (B, Sq, H, D); k, v: (B, T, KH, D), H % KH == 0; positions (Sq,)
    and (T,), RoPE already applied by the caller.  Query q sees key t when
    ``q_pos >= k_pos`` (causal) and ``q_pos - k_pos < window`` (window >
    0).  Self-attention over one sequence passes the same ascending
    positions tensor twice; that is the top-left causal mask, which
    ``is_causal`` gives without a mask tensor.

    Grouped heads (KH < H) are handed to SDPA with K and V repeated to H
    heads, head h reading KV head h // G, the reference's grouping.  With
    ``enable_gqa`` instead, PyTorch has no fused kernel for float32 or for
    a mask tensor other than cuDNN's (bf16 only), and the math backend
    then holds every (Sq, T) score; the repeat is a (B, T, H, D) copy, and
    its backward sums each group's gradients."""
    if is_dtensor(q):
        return _attention_on_shards(q, k, v, q_positions, k_positions,
                                    causal=causal, window=window)
    Sq, T = q.shape[1], k.shape[1]
    H, KH = q.shape[2], k.shape[2]
    if KH != H:
        k, v = (_repeat_heads(t, H // KH) for t in (k, v))
    mask, is_causal = None, False
    if causal and window == 0 and q_positions is k_positions and Sq == T:
        is_causal = True
    elif causal or window > 0:
        rel = q_positions[:, None] - k_positions[None, :]
        mask = torch.ones((Sq, T), dtype=torch.bool, device=q.device)
        if causal:
            mask &= rel >= 0
        if window > 0:
            mask &= rel < window
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=is_causal)
    return out.transpose(1, 2)


def _attention_on_shards(q, k, v, q_positions, k_positions, **kw):
    """:func:`attention` of DTensors, computed on each rank's shard.
    Attention is independent over the batch and over KV-head groups, so
    each mesh dimension keeps q's batch sharding, or its head sharding
    where the KV heads are sharded there too (q head h reads KV head
    h // G, which then lies in the same shard); anything else, a partial
    sum of v included, is gathered first.  The output comes back on those
    placements.  (DTensor has no sharding rule for SDPA's CPU kernel; the
    card runs the same local computation.)"""
    from torch.distributed.tensor import Replicate, Shard
    pl = []
    for a, b in zip(q.placements, k.placements):
        if isinstance(a, Shard) and a.dim == 0:
            pl.append(Shard(0))
        elif isinstance(a, Shard) and a.dim == 2 and b == a:
            pl.append(Shard(2))
        else:
            pl.append(Replicate())
    return local_call(
        lambda q, k, v: attention(q, k, v, q_positions, k_positions,
                                  **kw).contiguous(),
        q.device_mesh, (pl,) * 3, pl, q, k, v)


def _repeat_heads(t, G: int):
    """(B, T, KH, D) -> (B, T, KH * G, D), each KV head repeated G times
    next to itself (an expand and a copy; no index gather, whose backward
    on the card would add with atomics)."""
    B, T, KH, D = t.shape
    return t[:, :, :, None].expand(B, T, KH, G, D).reshape(B, T, KH * G, D)


class AttnParams(NamedTuple):
    wq: torch.Tensor            # (d, H, hd)
    wk: torch.Tensor            # (d, KH, hd)
    wv: torch.Tensor            # (d, KH, hd)
    wo: torch.Tensor            # (H, hd, d)
    bq: Optional[torch.Tensor]  # (H, hd) or None
    bk: Optional[torch.Tensor]
    bv: Optional[torch.Tensor]


def attn_logical(cfg) -> AttnParams:
    bias = cfg.qkv_bias
    return AttnParams(
        wq=lg("embed", "heads", "head_dim"),
        wk=lg("embed", "kv_heads", "head_dim"),
        wv=lg("embed", "kv_heads", "head_dim"),
        wo=lg("heads", "head_dim", "embed"),
        bq=lg("heads", "head_dim") if bias else None,
        bk=lg("kv_heads", "head_dim") if bias else None,
        bv=lg("kv_heads", "head_dim") if bias else None)


def _proj(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul."""
    if is_dtensor(w):
        return _proj_on_shards(x, w)
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _proj_on_shards(x, w):
    """:func:`_proj` of DTensors on each rank's shard: x's batch rows and
    w's heads stay sharded, the contraction dimension is gathered (FSDP's
    gather of the weight; its gradient comes back reduce-scattered).
    DTensor's own matmul rule may shard the (H·hd) output columns over an
    axis that does not divide H, and the split into heads is then
    undefined."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    xp, wp, yp, xg, wg = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        if isinstance(a, Shard) and a.dim == 0:      # batch rows
            xp.append(a), wp.append(Replicate()), yp.append(a)
            xg.append(a), wg.append(Partial())
        elif isinstance(b, Shard) and b.dim == 1:    # heads
            xp.append(Replicate()), wp.append(b), yp.append(Shard(2))
            xg.append(Partial()), wg.append(b)
        else:
            xp.append(Replicate()), wp.append(Replicate())
            yp.append(Replicate()), xg.append(Replicate())
            wg.append(Replicate())
    return local_call(_proj, w.device_mesh, (xp, wp), yp, x, w,
                      grad_placements=(xg, wg))


def attn_project(p: AttnParams, x):
    """x (B, S, d) -> q (B,S,H,hd), k/v (B,S,KH,hd), biases added."""
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if p.bq is not None:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    return q, k, v


def attn_qkv(p: AttnParams, x, tables):
    """Project + RoPE (``tables``: :func:`rope_tables` of x's positions;
    None skips rotary — whisper-style absolute).

    x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,KH,hd)."""
    q, k, v = attn_project(p, x)
    q = constrain(q, "batch", "seq", "heads", None)
    k = constrain(k, "batch", "seq", "kv_heads", None)
    if tables is not None:
        q, k = rope(q, tables), rope(k, tables)
    return q, k, v


def out_proj(p: AttnParams, o):
    """``einsum("bshk,hkd->bsd", o, wo)`` as one matmul (decode's output
    projection, unconstrained as the reference's ``attn_out_decode``)."""
    return _merged(o, -2) @ _merged(p.wo, 0)


def _merged(t, dim: int):
    """``t.flatten(dim, dim + 1)``, the heads and head_dim merged.  A
    DTensor merges on each rank's shard, keeping its heads and other
    dimensions' shardings (the heads are the outer index, so a heads
    shard is a shard of the merged dimension): DTensor's own view rule
    would, in the backward, have to split a merged dimension sharded over
    an axis that does not divide the heads."""
    if not is_dtensor(t):
        return t.flatten(dim, dim + 1)
    from torch.distributed.tensor import Replicate, Shard
    d = dim % t.ndim
    pl = tuple(pl if isinstance(pl, Shard) and pl.dim != d + 1
               else Replicate() for pl in t.placements)
    out = tuple(Shard(pl.dim - 1) if isinstance(pl, Shard) and pl.dim > d
                else pl for pl in pl)
    return local_call(lambda x: x.flatten(d, d + 1), t.device_mesh, (pl,),
                      out, t)


def attn_out(p: AttnParams, o):
    return constrain(out_proj(p, o), "batch", "seq", "embed")


def attn_apply(p: AttnParams, cfg, x, positions, tables, *, causal=True,
               window=0):
    """Full-sequence self-attention (training, prefill, feature
    extraction); ``tables`` as :func:`attn_qkv` takes them (None when
    ``cfg`` has no RoPE)."""
    q, k, v = attn_qkv(p, x, tables)
    o = attention(q, k, v, positions, positions, causal=causal,
                  window=window)
    return attn_out(p, o), (k, v)


class KVCache(NamedTuple):
    """Ring-buffer KV cache: slot t holds the token whose absolute position
    is ``kpos[t]`` (-1 = empty).  For full attention the ring never wraps
    (capacity == horizon); for sliding-window attention the capacity is
    the window, so a long stream needs only O(window) device memory."""

    k: torch.Tensor     # (B, Tc, KH, hd)
    v: torch.Tensor     # (B, Tc, KH, hd)
    kpos: torch.Tensor  # (Tc,) int32 absolute positions; -1 = empty


def kv_cache_init(batch, capacity, kv_heads, head_dim, dtype,
                  device) -> KVCache:
    shape = (batch, capacity, kv_heads, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        kpos=torch.full((capacity,), -1, dtype=torch.int32, device=device))


def kv_cache_from_prefill(k, v, positions, capacity, dtype) -> KVCache:
    """Keep the last ``capacity`` tokens of a prefill (window semantics).
    DTensor keys and values build their cache on each rank's shard (the
    cache is per batch row and KV head): the cache's k and v come back
    on k's placements, kpos replicated."""
    if is_dtensor(k):
        from torch.distributed.tensor import Replicate
        pl, rep = tuple(k.placements), (Replicate(),) * k.device_mesh.ndim
        return KVCache(*local_call(
            lambda k, v: tuple(kv_cache_from_prefill(k, v, positions,
                                                     capacity, dtype)),
            k.device_mesh, (pl, pl), (pl, pl, rep), k, v))
    B, S = k.shape[:2]
    cache = kv_cache_init(B, capacity, k.shape[2], k.shape[3], dtype,
                          k.device)
    if S <= capacity:
        cache.k[:, :S] = k
        cache.v[:, :S] = v
        cache.kpos[:S] = positions
        return cache
    # ring layout: the token at absolute position p sits in slot p % capacity
    tail_pos = positions[S - capacity:]
    slots = (tail_pos % capacity).long()
    cache.k[:, slots] = k[:, S - capacity:].to(dtype)
    cache.v[:, slots] = v[:, S - capacity:].to(dtype)
    cache.kpos[slots] = tail_pos.to(torch.int32)
    return cache


def attn_decode(p: AttnParams, cfg, x, cache: KVCache, pos: int, tables,
                *, window=0):
    """One-token decode against a ring cache.

    x: (B, 1, d); pos: the new token's absolute position (an int);
    ``tables``: :func:`rope_tables` of ``pos`` as a (1,) tensor, None when
    ``cfg`` has no RoPE.  The new k, v and position are written into
    ``cache`` in place, at slot ``pos % Tc`` (the reference donates its
    cache for the same update).  Returns (y, cache)."""
    q, k, v = attn_qkv(p, x, tables)
    if is_dtensor(cache.k):
        # per batch row and KV head: run on each rank's shard of the
        # cache, in place in its own storage (q, k, v follow its placements)
        pl, kp = tuple(cache.k.placements), tuple(cache.kpos.placements)
        o = local_call(
            lambda *a: _decode_attend(*a, pos, window), cache.k.device_mesh,
            (pl,) * 5 + (kp,), pl, q, k, v, cache.k, cache.v, cache.kpos)
    else:
        o = _decode_attend(q, k, v, cache.k, cache.v, cache.kpos, pos,
                           window)
    return out_proj(p, o), cache


def _decode_attend(q, k, v, cache_k, cache_v, kpos, pos: int, window):
    """The new token's k, v and position written at slot ``pos % Tc``,
    then its attention over the cache -> o (B, 1, H, D) in q's dtype."""
    B = q.shape[0]
    Tc, KH = cache_k.shape[1], cache_k.shape[2]
    slot = pos % Tc
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    kpos[slot] = pos
    H, D = q.shape[2], q.shape[3]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    # The cache stays in its storage dtype, as the reference keeps it: no
    # float32 copy of it.  Its (B, Tc, KH, D) layout has no single batch
    # stride over (batch, KV head), so the dots run over its (B, Tc, KH*D)
    # view: the queries sit block-diagonally over the KV heads (the other
    # heads' blocks add exact zeros), and of the outputs only the diagonal
    # blocks are kept.
    qb = torch.zeros((B, KH, G, KH, D), dtype=cache_k.dtype,
                     device=q.device)
    qb.diagonal(dim1=1, dim2=3).copy_(
        q.reshape(B, KH, G, D).permute(0, 2, 3, 1))
    s = _dots_f32(qb.reshape(B, H, KH * D),
                  cache_k.reshape(B, Tc, KH * D).transpose(1, 2)) * scale
    mask = (kpos >= 0) & (kpos <= pos)
    if window > 0:
        mask &= kpos > pos - window
    s = torch.where(mask[None, None, :], s, NEG)
    pattn = torch.softmax(s, dim=-1)
    o = _dots_f32(pattn.to(cache_v.dtype), cache_v.reshape(B, Tc, KH * D))
    o = o.reshape(B, KH, G, KH, D).diagonal(dim1=1, dim2=3)
    return o.permute(0, 3, 1, 2).reshape(B, 1, H, D).to(q.dtype)


def _dots_f32(a, b):
    """``torch.bmm(a, b)`` of storage-dtype operands, accumulated and
    returned in float32 (the reference's ``preferred_element_type``).  On
    the card cuBLAS writes the float32 product of bfloat16 operands
    directly; on the CPU the operands are upcast, which is exact."""
    if a.dtype == torch.float32 or not a.is_cuda:
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b, out_dtype=torch.float32)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLPParams(NamedTuple):
    w_gate: torch.Tensor   # (d, f)
    w_up: torch.Tensor     # (d, f)
    w_down: torch.Tensor   # (f, d)


def mlp_logical(cfg) -> MLPParams:
    return MLPParams(w_gate=lg("embed", "mlp"), w_up=lg("embed", "mlp"),
                     w_down=lg("mlp", "embed"))


def mlp_apply(p: MLPParams, x, activation="silu"):
    """The gated MLP: SiLU (the dense, VLM and MoE families) or
    ``"gelu"``, which is ``jax.nn.gelu``'s default, the tanh form (the
    hybrid and encoder-decoder families)."""
    act = F.silu if activation == "silu" else gelu
    g = constrain(x @ p.w_gate, "batch", "seq", "mlp")
    y = (act(g) * (x @ p.w_up)) @ p.w_down
    return constrain(y, "batch", "seq", "embed")


def gelu(x):
    """``jax.nn.gelu`` as the reference calls it (``approximate=True``):
    the tanh form, not the exact erf one (they differ by up to 4.7e-4)."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def embed_logical():
    return lg("vocab", "embed")


def embed_lookup(table, tokens):
    return constrain(F.embedding(tokens, _gathered(table, (0, 1))),
                     "batch", "seq", "embed")


def logits_proj(table_or_w, x):
    """Final projection; ``table_or_w`` is (V, d) (tied or untied)."""
    return constrain(x @ _gathered(table_or_w, (1,)).T,
                     "batch", "seq", "vocab")


def _gathered(table, dims):
    """A DTensor table with its shards along ``dims`` gathered (FSDP's
    gather before use; the backward reduce-scatters the gradient back onto
    the table's own placements, so the lookup's and the projection's
    gradients of a tied table meet in one layout).  The lookup gathers
    the vocabulary too: DTensor's masked-partial lookup on a
    vocabulary-sharded table mis-reduces when the tokens are sharded over
    another mesh dimension (torch 2.13).  The projection keeps the
    vocabulary sharded.  A plain tensor as it is."""
    if not is_dtensor(table):
        return table
    from torch.distributed.tensor import Replicate, Shard
    want = [Replicate() if isinstance(pl, Shard) and pl.dim in dims else pl
            for pl in table.placements]
    return table.redistribute(table.device_mesh, want)
