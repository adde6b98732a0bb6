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
from repro_torch.sharding import is_dtensor
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


def state_shardings(state: TrainState, cfg: ModelConfig, mesh, rules=None):
    """A :class:`repro_torch.sharding.NamedSharding` for every leaf of
    ``state``, as the reference's launcher places a state: parameters,
    the optimizer's leaves shaped like their parameters (AdamW's and
    SGDM's moments, Adafactor's unfactored ones) and the error-feedback
    residuals by the parameters' logical axes; every other leaf (step
    counters, Adafactor's factored moments) replicated."""
    from repro_torch.sharding import (DEFAULT_RULES, NamedSharding, P,
                                      tree_shardings)
    sh = tree_shardings(registry.param_logical(cfg), state.params, mesh,
                        rules or DEFAULT_RULES)

    def rep(t):
        return NamedSharding(mesh, P(*[None] * t.ndim))

    def by_shape(tree):
        if len(leaves(tree)) != len(leaves(sh)):
            return tree_map(rep, tree)
        return tree_map(lambda t, s, p: s if t.shape == p.shape else rep(t),
                        tree, sh, state.params)

    opt = state.opt._replace(**{f: by_shape(getattr(state.opt, f))
                                for f in state.opt._fields})
    return TrainState(params=sh, opt=opt,
                      ef=None if state.ef is None else sh,
                      step=rep(state.step))


def shard_state(state: TrainState, cfg: ModelConfig, mesh,
                rules=None) -> TrainState:
    """``state`` placed by :func:`state_shardings`; on a one-device mesh
    every leaf stays a plain tensor."""
    from repro_torch.sharding import place_tree
    return place_tree(state, state_shardings(state, cfg, mesh, rules))


def _microbatches(batch: Dict[str, Any], M: int) -> list:
    for k, v in batch.items():
        if v.shape[0] % M:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not a "
                             f"multiple of microbatches={M}")
    out = [{} for _ in range(M)]
    for k, v in batch.items():
        if is_dtensor(v):
            # microbatch m is rows [m B/M, (m+1) B/M), as on one device:
            # gathered (a batch is small), cut, and each cut placed back
            # on the batch's placements (local slices, no communication)
            from torch.distributed.tensor import Replicate
            pl, mesh = v.placements, v.device_mesh
            whole = v.redistribute(mesh, [Replicate()] * mesh.ndim)
            n = v.shape[0] // M
            for m in range(M):
                out[m][k] = whole[m * n:(m + 1) * n].redistribute(mesh, pl)
        else:
            split = v.reshape((M, v.shape[0] // M) + tuple(v.shape[1:]))
            for m in range(M):
                out[m][k] = split[m]
    return out


def _on_placements_of(new: TrainState, old: TrainState) -> TrainState:
    """``new`` with every DTensor leaf on the placements of its leaf in
    ``old``, as the reference's step returns its state on the state's
    shardings.  The update's arithmetic follows DTensor's propagation,
    which may leave a leaf where its gradient was, not where the
    parameter was (a stacked (layers, d) norm weight sharded over its
    layers), and the next step's layer split cannot take that."""
    def keep(n, o):
        if is_dtensor(n) and tuple(n.placements) != tuple(o.placements):
            return n.redistribute(o.device_mesh, o.placements)
        return n
    return tree_map(keep, new, old)


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
        if is_dtensor(state.step):
            new_state = _on_placements_of(new_state, state)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr,
                           "aux": aux}

    return train_step
