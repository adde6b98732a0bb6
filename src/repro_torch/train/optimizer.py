"""In-house optimizers: AdamW, Adafactor(-lite), momentum SGD.

The port of ``repro.train.optimizer``: the same states, the same
arithmetic in the same order (``torch.optim.AdamW`` rounds its steps in
another order, and PyTorch has no Adafactor of this form).  Moments are
float32 by default and bfloat16 when ``TrainConfig.opt_state_dtype`` asks
for it; every update computes in float32 and casts back.  Updates are
functional: they return new trees and write nothing they are given.
Trees are walked by :mod:`repro_torch.tree`; ``step`` is a 0-d int32
tensor on the parameters' device, and ``lr`` may be a 0-d tensor there,
so an update reads nothing back to the host.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.tree import leaves, tree_map, tree_map_n


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any          # tree like params
    v: Any


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any         # row second moment (last dim reduced)
    vc: Any         # column second moment (second-to-last reduced)
    v: Any          # full second moment of tensors below 2-D


class SGDMState(NamedTuple):
    step: torch.Tensor
    m: Any


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params, tc: TrainConfig) -> AdamWState:
    dt = _dtype(tc.opt_state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return AdamWState(step=_step0(params), m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def adamw_update(grads, state: AdamWState, params, tc: TrainConfig,
                 lr: Optional[torch.Tensor] = None):
    lr = tc.learning_rate if lr is None else lr
    b1, b2, eps = tc.beta1, tc.beta2, 1e-8
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(g, m, v, p):
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + eps) + tc.weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        return new_p, m32.to(m.dtype), v32.to(v.dtype)

    new_p, new_m, new_v = tree_map_n(upd, 3, grads, state.m, state.v,
                                     params)
    return new_p, AdamWState(step=step, m=new_m, v=new_v)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments: sublinear optimizer memory)
# ---------------------------------------------------------------------------

def _factored(p) -> bool:
    return p.dim() >= 2


def adafactor_init(params, tc: TrainConfig) -> AdafactorState:
    dt = _dtype(tc.opt_state_dtype)

    def zeros(p, shape):
        return torch.zeros(shape, dtype=dt, device=p.device)

    def vr(p):
        return zeros(p, p.shape[:-1] if _factored(p) else ())

    def vc(p):
        return zeros(p, p.shape[:-2] + p.shape[-1:] if _factored(p) else ())

    def vf(p):
        return zeros(p, () if _factored(p) else p.shape)

    return AdafactorState(step=_step0(params), vr=tree_map(vr, params),
                          vc=tree_map(vc, params), v=tree_map(vf, params))


def adafactor_update(grads, state: AdafactorState, params, tc: TrainConfig,
                     lr: Optional[torch.Tensor] = None):
    lr = tc.learning_rate if lr is None else lr
    step = state.step + 1
    t = step.float()
    beta2 = 1.0 - t ** -0.8
    eps = 1e-30

    def upd(g, vr, vc, v, p):
        g32 = g.float()
        g2 = g32 * g32 + eps
        if _factored(p):
            vr32 = beta2 * vr.float() + (1 - beta2) * torch.mean(g2, dim=-1)
            vc32 = beta2 * vc.float() + (1 - beta2) * torch.mean(g2, dim=-2)
            rfac = vr32 / torch.clamp_min(
                torch.mean(vr32, dim=-1, keepdim=True), eps)
            pre = rfac[..., None] * vc32[..., None, :]
            upd_ = g32 * torch.rsqrt(torch.clamp_min(pre, eps))
            v32 = v.float()
        else:
            v32 = beta2 * v.float() + (1 - beta2) * g2
            upd_ = g32 * torch.rsqrt(torch.clamp_min(v32, eps))
            vr32 = vr.float()
            vc32 = vc.float()
        # update clipping (Shazeer & Stern)
        rms = torch.sqrt(torch.mean(upd_ * upd_))
        upd_ = upd_ / torch.clamp_min(rms, 1.0)
        p32 = p.float()
        new_p = (p32 - lr * upd_ - lr * tc.weight_decay * p32).to(p.dtype)
        return new_p, vr32.to(vr.dtype), vc32.to(vc.dtype), v32.to(v.dtype)

    new_p, vr, vc, v = tree_map_n(upd, 4, grads, state.vr, state.vc,
                                  state.v, params)
    return new_p, AdafactorState(step=step, vr=vr, vc=vc, v=v)


# ---------------------------------------------------------------------------
# momentum SGD
# ---------------------------------------------------------------------------

def sgdm_init(params, tc: TrainConfig) -> SGDMState:
    dt = _dtype(tc.opt_state_dtype)
    return SGDMState(step=_step0(params), m=tree_map(
        lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params))


def sgdm_update(grads, state: SGDMState, params, tc: TrainConfig,
                lr: Optional[torch.Tensor] = None):
    lr = tc.learning_rate if lr is None else lr

    def upd(g, m, p):
        m32 = 0.9 * m.float() + g.float()
        p32 = p.float()
        new_p = (p32 - lr * m32 - lr * tc.weight_decay * p32).to(p.dtype)
        return new_p, m32.to(m.dtype)

    new_p, m = tree_map_n(upd, 2, grads, state.m, params)
    return new_p, SGDMState(step=state.step + 1, m=m)


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

def init(params, tc: TrainConfig):
    return {"adamw": adamw_init, "adafactor": adafactor_init,
            "sgdm": sgdm_init}[tc.optimizer](params, tc)


def update(grads, state, params, tc: TrainConfig, lr=None):
    fn = {"adamw": adamw_update, "adafactor": adafactor_update,
          "sgdm": sgdm_update}[tc.optimizer]
    return fn(grads, state, params, tc, lr)


def lr_schedule(tc: TrainConfig, step: torch.Tensor, warmup: int = 100,
                total: int = 10_000) -> torch.Tensor:
    """Linear warmup + cosine decay, a 0-d float32 tensor on ``step``'s
    device: 0 at step 0, ``learning_rate`` at the end of the warmup, a
    floor of 0.1 of it."""
    t = step.float()
    warm = t / max(warmup, 1)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tc.learning_rate * torch.clamp_max(warm, 1.0) * \
        torch.clamp_min(cos, 0.1)
