"""Training step: mixed precision, microbatch gradient accumulation,
clipping, optional gradient compression, optimizer apply.

The port of ``repro.train.train_step``.  ``make_train_step(cfg, tc)``
returns ``train_step(state, batch) -> (state, metrics)``, which honours
every :class:`TrainConfig` knob of the reference: ``param_dtype``,
``compute_dtype`` (the loss runs on the parameters cast to it; the
gradients come back in the parameter dtype), ``microbatches`` with both
``accum_mode``s and ``accum_dtype``, ``remat``, ``compress_grads``,
``grad_clip``, the optimizer and its ``opt_state_dtype``, and the
learning-rate schedule.

The step is functional, as the reference's jitted step is: it returns a
new :class:`TrainState` and writes nothing of the state it is given
(autograd runs on detached aliases of the parameters).  So a caller may
keep an old state, restart from it (``runtime.fault.run_resilient``
restarts from its ``init_state``) or snapshot it while later steps run.
Metrics are 0-d tensors on the device (the reference's ``loss``,
``grad_norm`` and ``lr``, and ``aux``, the MoE load-balance aux averaged
over the microbatches, 0 for the other families); nothing in a step reads
back to the host.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.compression import ef_compress_grads
from repro_torch.train.serve_step import DTYPES, _cast
from repro_torch.tree import leaves, tree_map, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: Any
    ef: Any          # error-feedback residuals (compression) or None
    step: torch.Tensor


def init_state(generator, cfg: ModelConfig, tc: TrainConfig, *,
               device=None) -> TrainState:
    """Random parameters in ``tc.param_dtype`` (``generator`` a
    ``torch.Generator`` on ``device`` or an int seed), zero optimizer
    state and step 0.  ``device`` defaults to the CUDA card and raises
    without one."""
    dev = resolve_device(device)
    params = registry.init_params(generator, cfg, DTYPES[tc.param_dtype],
                                  device=dev)
    ef = None
    if tc.compress_grads:
        ef = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=dev), params)
    return TrainState(params=params, opt=opt_mod.init(params, tc), ef=ef,
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _microbatches(batch: Dict[str, Any], M: int) -> list:
    for k, v in batch.items():
        if v.shape[0] % M:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not a "
                             f"multiple of microbatches={M}")
    split = {k: v.reshape((M, v.shape[0] // M) + tuple(v.shape[1:]))
             for k, v in batch.items()}
    return [{k: v[m] for k, v in split.items()} for m in range(M)]


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    cdt = DTYPES[tc.compute_dtype]
    adt = DTYPES[tc.accum_dtype]
    if tc.accum_mode not in ("inside_grad", "outside"):
        raise ValueError(f"accum_mode must be 'inside_grad' or 'outside', "
                         f"got {tc.accum_mode!r}")

    def loss_of(params, mb):
        """(loss, the MoE aux as a detached float32 0-d tensor)."""
        loss, parts = registry.loss_fn(_cast(params, cdt), cfg, mb,
                                       remat=tc.remat)
        aux = parts["aux"]
        if torch.is_tensor(aux):
            return loss, aux.detach().float()
        return loss, torch.full((), aux, dtype=torch.float32,
                                device=loss.device)

    def grads_of(params, batch):
        """(loss, aux, gradients in the parameter dtype; float32 for
        ``accum_mode="outside"``); loss and aux are means over the
        microbatches."""
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        flat = leaves(live)
        M = tc.microbatches
        if M <= 1:
            loss, aux = loss_of(live, batch)
            return loss.detach(), aux, unflatten(
                params, torch.autograd.grad(loss, flat))
        mbs = _microbatches(batch, M)
        if tc.accum_mode == "inside_grad":
            # the gradient of sum(l_m) / M: each microbatch's backward
            # accumulates into the parameter-dtype gradients
            total = torch.zeros((), dtype=torch.float32,
                                device=flat[0].device)
            aux_total = torch.zeros_like(total)
            for mb in mbs:
                loss, aux = loss_of(live, mb)
                (loss / M).backward()
                total = total + loss.detach()
                aux_total = aux_total + aux
            return total / M, aux_total / M, tree_map(lambda p: p.grad,
                                                      live)
        acc = [torch.zeros(p.shape, dtype=adt, device=p.device)
               for p in flat]
        losses, auxs = [], []
        for mb in mbs:
            loss, aux = loss_of(live, mb)
            g = torch.autograd.grad(loss, flat)
            acc = [a + gg.to(adt) for a, gg in zip(acc, g)]
            losses.append(loss.detach())
            auxs.append(aux)
        return torch.mean(torch.stack(losses)), torch.mean(
            torch.stack(auxs)), unflatten(params, [a.float() / M
                                                   for a in acc])

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params = state.params
        loss, aux, grads = grads_of(params, batch)
        with torch.no_grad():
            ef = state.ef
            if tc.compress_grads:
                grads, ef = ef_compress_grads(grads, ef)
            grads, gnorm = opt_mod.clip_by_global_norm(grads, tc.grad_clip)
            lr = opt_mod.lr_schedule(tc, state.step)
            new_params, new_opt = opt_mod.update(grads, state.opt, params,
                                                 tc, lr)
        new_state = TrainState(params=new_params, opt=new_opt, ef=ef,
                               step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr,
                           "aux": aux}

    return train_step
