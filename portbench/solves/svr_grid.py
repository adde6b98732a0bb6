"""The epsilon-SVR model-selection grid:
``repro_torch.core.grid.solve_grid_svr(..., impl="auto")``, the fused
lane batch of every (gamma, epsilon, C) doubled QP, then the held-out
predictions of every lane through ``grid_decision`` on the folded
coefficients.  The gammas are the set's factors times ``gamma="scale"``.
The rows come from the base Gram bank (``precompute=True``): kernel 3
builds it, the H = 2 variants of kernels 4 and 5 read it.
"""

from __future__ import annotations

from types import SimpleNamespace

from portbench import solving
from portbench.work import (gram_block, row_wss_batched_rows, solve,
                            update_wss_batched_rows)
from repro_torch.core import grid
from repro_torch.core.qp import svr_fold


def prepare(conf: dict, cell: dict, inputs: dict, device) -> SimpleNamespace:
    hyper = conf[cell["hyper"]]
    return SimpleNamespace(conf=conf, X=inputs["X"], y=inputs["y"],
                           Xq=inputs["Xq"], factors=hyper["gamma_factors"],
                           epsilons=hyper["epsilons"], Cs=hyper["Cs"],
                           device=device)


def fit(ctx, max_iter):
    g = solving.scale_gamma(ctx.X)
    gammas = [g * f for f in ctx.factors]
    res = grid.solve_grid_svr(ctx.X, ctx.y, ctx.Cs, ctx.epsilons, gammas,
                              solving.solver_config(ctx.conf, max_iter),
                              impl="auto", precompute=True,
                              device=ctx.device)
    return SimpleNamespace(res=res, gammas=gammas)


def decide(ctx, fitted) -> dict:
    D = grid.grid_decision(ctx.Xq, ctx.X, fitted.gammas,
                           svr_fold(fitted.res.alpha), fitted.res.b)
    return solving.host_lanes(fitted.res, D, 2 * ctx.X.shape[0])


def _lanes_per_gamma(ctx) -> int:
    return len(ctx.epsilons) * len(ctx.Cs)


def launch_work(ctx) -> dict:
    l, d = ctx.X.shape
    m, item = ctx.Xq.shape[0], ctx.X.element_size()
    B = len(ctx.factors) * _lanes_per_gamma(ctx)
    return {"gram_block": gram_block.cross(m, l, d, item),
            "gram_block:symmetric": gram_block.symmetric(l, d, item),
            "row_wss_batched_rows_h2": row_wss_batched_rows.need(l, B, 2,
                                                                 item),
            "update_wss_batched_rows_h2": update_wss_batched_rows.need(
                l, B, 2, item)}


def need_s(ctx, out: dict) -> float:
    l, d = ctx.X.shape
    dtype = ctx.conf["dtype"]
    nG = len(ctx.factors)
    s = solve.loop_s(out["iterations"].tolist(), l=l, d=d, H=2,
                     dtype=dtype, bank=True)
    s += solve.decision_s([_lanes_per_gamma(ctx)] * nG, m=ctx.Xq.shape[0],
                          l=l, d=d, dtype=dtype)
    return s + solve.bank_s(nG, l=l, d=d, dtype=dtype)
