"""Mamba2 (SSD — state-space duality) blocks, attention-free LM.

The port of ``repro.models.ssm``.  :func:`ssd_chunked` is the chunked SSD
algorithm (Dao & Gu, 2024): within a chunk the quadratic
"attention-like" form, across chunks a linear recurrence over per-chunk
states, O(S) work in all.  The reference scans over the chunks
(``lax.scan``); here a loop over the chunks carries the (B, H, P, N) state.
Decode keeps an O(1) recurrent state (B, H, P, N) a layer in float32 and
a (K-1)-row ring of the causal convolution's inputs.

Single B/C group (n_groups = 1, the mamba2 default).  All decay math is in
float32.  The products are matmuls and einsums, as the reference's are:
none of it is a Pallas kernel there.

One departure: the reference's ``_segsum_exp`` computes
``where(mask, exp(diff), 0)``, and above the diagonal ``diff`` is positive.
At full width (32 heads, so A reaches -32, and a 256-step chunk) ``exp``
overflows to inf there; the forward is still right, but the backward
multiplies the zero cotangent by inf and the gradient of ``dA`` is NaN.
:func:`_segsum_exp` masks ``diff`` to -inf before ``exp``: the same
values, and a finite gradient.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import constrain, is_dtensor, local_call, \
    logical as lg


class SSMBlockParams(NamedTuple):
    ln: torch.Tensor          # (d,)
    w_z: torch.Tensor         # (d, din)
    w_xbc: torch.Tensor       # (d, din + 2N)
    w_dt: torch.Tensor        # (d, H)
    dt_bias: torch.Tensor     # (H,)
    A_log: torch.Tensor       # (H,)
    D: torch.Tensor           # (H,)
    conv_w: torch.Tensor      # (K, din + 2N) depthwise
    conv_b: torch.Tensor      # (din + 2N,)
    norm: torch.Tensor        # (din,)
    w_out: torch.Tensor       # (din, d)


class SSMParams(NamedTuple):
    embed: torch.Tensor
    blocks: SSMBlockParams    # stacked (L, ...)
    ln_f: torch.Tensor
    unembed: Optional[torch.Tensor]


class SSMCache(NamedTuple):
    """Decode state: recurrent state + causal-conv ring buffer."""

    h: torch.Tensor        # (layers, B, H, P, N) float32
    conv: torch.Tensor     # (layers, B, K-1, din + 2N)


def block_logical(cfg) -> SSMBlockParams:
    return SSMBlockParams(
        ln=lg("embed"), w_z=lg("embed", "mlp"), w_xbc=lg("embed", "mlp"),
        w_dt=lg("embed", None), dt_bias=lg(None), A_log=lg(None),
        D=lg(None), conv_w=lg("conv", "mlp"), conv_b=lg("mlp"),
        norm=lg("mlp"), w_out=lg("mlp", "embed"))


def param_logical(cfg) -> SSMParams:
    return SSMParams(
        embed=L.embed_logical(), blocks=T.stack_logical(block_logical(cfg)),
        ln_f=lg("embed"),
        unembed=None if cfg.tie_embeddings else L.embed_logical())


def cache_logical(cfg) -> SSMCache:
    return SSMCache(h=lg("layers", "batch", "heads", None, None),
                    conv=lg("layers", "batch", None, "mlp"))


def _dims(cfg):
    din = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = din // P
    N = cfg.ssm_state
    return din, H, P, N


def param_shapes(cfg) -> SSMParams:
    """The parameter tree of ``cfg`` with each leaf's shape in its place
    (``None`` for the tied unembedding)."""
    n, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    din, H, P, N = _dims(cfg)
    ch = din + 2 * N
    return SSMParams(
        embed=(V, d),
        blocks=SSMBlockParams(
            ln=(n, d), w_z=(n, d, din), w_xbc=(n, d, ch), w_dt=(n, d, H),
            dt_bias=(n, H), A_log=(n, H), D=(n, H),
            conv_w=(n, cfg.conv_kernel, ch), conv_b=(n, ch), norm=(n, din),
            w_out=(n, din, d)),
        ln_f=(d,),
        unembed=None if cfg.tie_embeddings else (V, d))


def init_params(generator, cfg, dtype=torch.float32, *,
                device=None) -> SSMParams:
    """Random parameters of ``cfg``, the reference's distributions: dense
    weights truncated normal with std ``1/sqrt(fan_in)`` (the conv's fan-in
    is its width K), embeddings with std 0.02, norms and the conv bias
    zero, ``D`` one, ``A_log = log(1..H)`` and ``dt_bias`` the inverse
    softplus of a dt log-uniform in [1e-3, 1e-1] (drawn in float32).
    ``generator`` is a ``torch.Generator`` on ``device`` or an int seed;
    draws run embed, then each stacked block weight (w_z, w_xbc, w_dt, dt,
    conv_w, w_out), then the untied unembedding.  ``device`` defaults to
    the CUDA card and raises without one."""
    dev = resolve_device(device)
    gen = T.generator_on(generator, dev)
    s = param_shapes(cfg)
    b = s.blocks
    d = cfg.d_model
    din, H, _, _ = _dims(cfg)

    def dense(shape, fan_in):
        return L.dense_init(gen, fan_in, shape, dtype, dev)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    emb = L.trunc_normal(gen, s.embed, 0.02, dtype, dev)
    w_z, w_xbc, w_dt = dense(b.w_z, d), dense(b.w_xbc, d), dense(b.w_dt, d)
    dt = torch.empty(b.dt_bias, dtype=torch.float32, device=dev)
    dt.uniform_(math.log(1e-3), math.log(1e-1), generator=gen).exp_()
    dt_bias = dt + torch.log(-torch.expm1(-dt))       # inverse softplus
    a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                   device=dev))
    blocks = SSMBlockParams(
        ln=full(b.ln, 0.0), w_z=w_z, w_xbc=w_xbc, w_dt=w_dt,
        dt_bias=dt_bias.to(dtype),
        A_log=a_log.expand(b.A_log).to(dtype).contiguous(),
        D=full(b.D, 1.0), conv_w=dense(b.conv_w, cfg.conv_kernel),
        conv_b=full(b.conv_b, 0.0), norm=full(b.norm, 0.0),
        w_out=dense(b.w_out, din))
    return SSMParams(
        embed=emb, blocks=blocks, ln_f=full(s.ln_f, 0.0),
        unembed=None if s.unembed is None else L.trunc_normal(
            gen, s.unembed, 0.02, dtype, dev))


def _causal_conv(x, w, b):
    """Depthwise causal conv: x (B, S, ch), w (K, ch), summed in the
    reference's k order.  DTensors run it on each rank's shard
    (:func:`_causal_conv_on_shards`)."""
    if is_dtensor(x):
        return _causal_conv_on_shards(x, w, b)
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[0]
    for k in range(1, K):
        out = out + xp[:, k:k + S] * w[k]
    return out + b


def _causal_conv_on_shards(x, w, b):
    """:func:`_causal_conv` of DTensors on each rank's shard: the conv is
    independent over batch rows and channels, so x keeps its batch
    sharding, and its channel sharding where w's channels shard the same
    way; the rest is gathered first (the padding of a sharded DTensor
    fails in some torch releases' redistribution).  Weights replicated
    over a batch-sharded mesh dimension get ``Partial`` gradients
    there."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    wpl = w.placements if is_dtensor(w) else \
        (Replicate(),) * x.device_mesh.ndim
    xp, wp, bp, wg, bg = [], [], [], [], []
    for a, c in zip(x.placements, wpl):
        if isinstance(a, Shard) and a.dim == 0:
            xp.append(a), wp.append(Replicate()), bp.append(Replicate())
            wg.append(Partial()), bg.append(Partial())
        elif isinstance(a, Shard) and a.dim == 2 and c == Shard(1):
            xp.append(a), wp.append(c), bp.append(Shard(0))
            wg.append(c), bg.append(Shard(0))
        else:
            for lst in (xp, wp, bp, wg, bg):
                lst.append(Replicate())
    return local_call(_causal_conv, x.device_mesh, (xp, wp, bp), xp, x, w,
                      b, grad_placements=(xp, wg, bg))


def _batch_placements(t):
    """``t``'s batch (dim 0) sharding kept, every other mesh dimension
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(pl if isinstance(pl, Shard) and pl.dim == 0
                 else Replicate() for pl in t.placements)


def _segsum_exp(a_cum):
    """exp(a_cum[..., i] - a_cum[..., j]) masked to i >= j.

    a_cum: (..., Q); returns (..., Q, Q).  ``diff`` is masked to -inf
    before ``exp`` (module docstring): above the diagonal ``exp`` is
    exactly 0 and so is its gradient."""
    Q = a_cum.shape[-1]
    diff = a_cum[..., :, None] - a_cum[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool,
                      device=a_cum.device).tril()
    return torch.exp(diff.masked_fill(~mask, -math.inf))


def ssd_chunked(xdt, dA, Bm, Cm, chunk, h0=None):
    """Chunked SSD scan.

    xdt: (B, S, H, P) inputs premultiplied by dt;
    dA:  (B, S, H) per-step log decay (dt * A, negative);
    Bm, Cm: (B, S, N) shared across heads (single group);
    h0: (B, H, P, N) float32 initial state, zeros when None.
    Chunks of Q = min(chunk, S) steps, one chunk of S when Q does not
    divide S.  Returns (y (B, S, H, P) float32, h_final (B, H, P, N)).
    DTensors scan on each rank's batch rows (every row is independent;
    the other mesh dimensions are gathered first)."""
    if is_dtensor(xdt):
        pl = _batch_placements(xdt)
        args = (xdt, dA, Bm, Cm) + (() if h0 is None else (h0,))
        return local_call(
            lambda *a: ssd_chunked(*a[:4], chunk, *a[4:]), xdt.device_mesh,
            (pl,) * len(args), (pl, pl), *args)
    Bsz, S, H, P = xdt.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q != 0:
        Q = S
    nc = S // Q
    f32 = torch.float32
    xdt = xdt.reshape(Bsz, nc, Q, H, P).to(f32)
    dA = dA.reshape(Bsz, nc, Q, H).to(f32)
    Bm = Bm.reshape(Bsz, nc, Q, N).to(f32)
    Cm = Cm.reshape(Bsz, nc, Q, N).to(f32)

    a_cum_h = torch.cumsum(dA, dim=2).movedim(-1, 2)        # (B,nc,H,Q)

    # 1. intra-chunk (diagonal blocks): (L ∘ C Bᵀ) x, per head
    scores = torch.einsum("bcqn,bckn->bcqk", Cm, Bm)          # (B,nc,Q,Q)
    M = _segsum_exp(a_cum_h) * scores[:, :, None]             # (B,nc,H,Q,Q)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", M, xdt)

    # 2. per-chunk end states
    decay_end = torch.exp(a_cum_h[..., -1:] - a_cum_h)        # (B,nc,H,Q)
    states = torch.einsum("bckn,bckhp->bchpn", Bm,
                          xdt * decay_end.movedim(2, 3)[..., None])

    # 3. inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(a_cum_h[..., -1])                 # (B,nc,H)
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=xdt.device)
         if h0 is None else h0.to(f32))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                       # (B,nc,H,P,N)

    # 4. inter-chunk contribution
    decay_in = torch.exp(a_cum_h).movedim(2, 3)               # (B,nc,Q,H)
    y_inter = (torch.einsum("bcqn,bchpn->bcqhp", Cm, h_prev)
               * decay_in[..., None])

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y, h


def _block_apply(p: SSMBlockParams, cfg, x, h0=None, conv_state=None):
    """x: (B, S, d).  Returns (y, h_final, conv_tail)."""
    din, H, P, N = _dims(cfg)
    u = L.rms_norm(x, p.ln, cfg.norm_eps)
    z = u @ p.w_z
    xbc = constrain(u @ p.w_xbc, "batch", "seq", "mlp")
    if conv_state is not None:
        xbc_ext = torch.cat([conv_state, xbc], dim=1)
        conv = _causal_conv(xbc_ext, p.conv_w, p.conv_b)[
            :, conv_state.shape[1]:]
    else:
        conv = _causal_conv(xbc, p.conv_w, p.conv_b)
    conv = F.silu(conv)
    xs = conv[..., :din]
    Bm = conv[..., din:din + N]
    Cm = conv[..., din + N:]
    dt = F.softplus((u @ p.w_dt).float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())
    xh = xs.reshape(*xs.shape[:2], H, P)
    y, h_final = ssd_chunked(xh * dt[..., None], dt * A, Bm, Cm,
                             cfg.ssm_chunk, h0)
    y = y + xh.float() * p.D.float()[:, None]
    y = y.reshape(*xs.shape[:2], din).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    out = y @ p.w_out
    conv_tail = xbc[:, -(cfg.conv_kernel - 1):, :]
    return constrain(out, "batch", "seq", "embed"), h_final, conv_tail


def _residual(cfg, x, blk: SSMBlockParams):
    return x + _block_apply(blk, cfg, x)[0]


def apply(params: SSMParams, cfg, tokens, *, remat: str = "none",
          return_hidden: bool = False):
    """Train/eval forward: (B, S) int tokens -> (B, S, V) logits, or with
    ``return_hidden`` the final normed hidden states (B, S, d).
    ``remat="full"`` recomputes each block in the backward."""
    if remat not in T.REMAT:
        raise ValueError(f"remat must be one of {T.REMAT}, got {remat!r}")
    x = L.embed_lookup(params.embed, tokens)
    for blk in T.layers(params.blocks, cfg.n_layers):
        if remat == "full":
            x = checkpoint(_residual, cfg, x, blk, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _residual(cfg, x, blk)
    if return_hidden:
        return L.rms_norm(x, params.ln_f, cfg.norm_eps)
    return T._unembed(params, cfg, x)


# ---------------------------------------------------------------------------
# serving: O(1) state a layer
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, horizon, dtype=torch.bfloat16, *,
               device=None) -> SSMCache:
    """Zero decode state, whatever the horizon (the state does not grow
    with the context); ``device`` defaults to the CUDA card and raises
    without one."""
    del horizon
    dev = resolve_device(device)
    din, H, P, N = _dims(cfg)
    n = cfg.n_layers
    return SSMCache(
        h=torch.zeros((n, batch, H, P, N), dtype=torch.float32, device=dev),
        conv=torch.zeros((n, batch, cfg.conv_kernel - 1, din + 2 * N),
                         dtype=dtype, device=dev))


def prefill(params: SSMParams, cfg, tokens, horizon,
            kv_dtype=torch.bfloat16):
    """Full forward + decode state: returns (logits, SSMCache): each
    layer's final SSD state (float32) and the last K-1 conv inputs (in
    ``kv_dtype``)."""
    del horizon
    x = L.embed_lookup(params.embed, tokens)
    hs, convs = [], []
    for blk in T.layers(params.blocks, cfg.n_layers):
        y, h, conv_tail = _block_apply(blk, cfg, x)
        x = x + y
        hs.append(h)
        convs.append(conv_tail.to(kv_dtype))
    return T._unembed(params, cfg, x), SSMCache(h=torch.stack(hs),
                                                conv=torch.stack(convs))


def decode_step(params: SSMParams, cfg, cache: SSMCache, tokens, pos):
    """One-token decode: tokens (B, 1) int; ``pos`` is ignored (the state
    needs no position).  Each layer's state and conv ring (rolled by one
    row) are written into ``cache`` in place; returns (logits (B, 1, V),
    cache)."""
    del pos
    x = L.embed_lookup(params.embed, tokens)
    n = cfg.n_layers
    for i, blk in enumerate(T.layers(params.blocks, n)):
        conv_state = cache.conv[i]
        y, h, conv_tail = _block_apply(blk, cfg, x, h0=cache.h[i],
                                       conv_state=conv_state.to(x.dtype))
        new_conv = torch.cat([conv_state[:, 1:],
                              conv_tail.to(conv_state.dtype)], dim=1)
        cache.h[i] = h
        cache.conv[i] = new_conv
        x = x + y
    return T._unembed(params, cfg, x), cache
