"""The one-vs-rest (C, gamma) model-selection grid:
``repro_torch.core.grid.solve_grid(..., impl="auto")``, the fused lane
batch of every (gamma, class, C) QP, then ``grid_decision`` on the
held-out points.  The gammas are the hyper-parameter set's factors times
``gamma="scale"``, which the user works out from the training inputs.
The rows come from the Gram bank (``precompute=True``): kernel 3 builds
it, kernels 4 and 5 read it.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from portbench import solving
from portbench.work import (gram_block, row_wss_batched_rows, solve,
                            update_wss_batched_rows)
from repro_torch.core import grid


def prepare(conf: dict, cell: dict, inputs: dict, device) -> SimpleNamespace:
    hyper = conf[cell["hyper"]]
    k = conf["n_classes"]
    y = inputs["y"]
    Y = torch.where(y[None, :] == torch.arange(k, device=device)[:, None],
                    1.0, -1.0).to(inputs["X"].dtype)
    return SimpleNamespace(conf=conf, X=inputs["X"], Y=Y, Xq=inputs["Xq"],
                           k=k, factors=hyper["gamma_factors"],
                           Cs=hyper["Cs"], device=device)


def fit(ctx, max_iter):
    g = solving.scale_gamma(ctx.X)
    gammas = [g * f for f in ctx.factors]
    res = grid.solve_grid(ctx.X, ctx.Y, ctx.Cs, gammas,
                          solving.solver_config(ctx.conf, max_iter),
                          impl="auto", precompute=True,
                          device=ctx.device)
    return SimpleNamespace(res=res, gammas=gammas)


def decide(ctx, fitted) -> dict:
    D = grid.grid_decision(ctx.Xq, ctx.X, fitted.gammas, fitted.res.alpha,
                           fitted.res.b)
    return solving.host_lanes(fitted.res, D, ctx.X.shape[0])


def _shape(ctx):
    l, d = ctx.X.shape
    return l, d, ctx.Xq.shape[0], ctx.X.element_size()


def launch_work(ctx) -> dict:
    """{launch counter: (bytes, operations) of one launch}."""
    l, d, m, item = _shape(ctx)
    B = len(ctx.factors) * ctx.k * len(ctx.Cs)
    return {"gram_block": gram_block.cross(m, l, d, item),
            "gram_block:symmetric": gram_block.symmetric(l, d, item),
            "row_wss_batched_rows": row_wss_batched_rows.need(l, B, 1, item),
            "update_wss_batched_rows": update_wss_batched_rows.need(
                l, B, 1, item)}


def need_s(ctx, out: dict) -> float:
    """The least seconds the solve ``out`` needs at the peaks."""
    l, d, m, _ = _shape(ctx)
    dtype = ctx.conf["dtype"]
    nG = len(ctx.factors)
    s = solve.loop_s(out["iterations"].tolist(), l=l, d=d, H=1,
                     dtype=dtype, bank=True)
    s += solve.decision_s([ctx.k * len(ctx.Cs)] * nG, m=m, l=l, d=d,
                          dtype=dtype)
    return s + solve.bank_s(nG, l=l, d=d, dtype=dtype)
