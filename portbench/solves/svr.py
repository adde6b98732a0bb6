"""The single regression fit: ``repro_torch.svm.SVR(C, epsilon,
gamma="scale").fit`` (one lane of the doubled 2l-coordinate operator,
rows from ``X``: the H = 2 variants of kernels 1 and 2), then
``predict`` on the held-out points (kernel 3, cross)."""

from __future__ import annotations

from types import SimpleNamespace

from portbench import solving
from portbench.work import (gram_block, rbf_row_wss_batched,
                            rbf_update_wss_batched, solve)
from repro_torch import svm


def prepare(conf: dict, cell: dict, inputs: dict, device) -> SimpleNamespace:
    hyper = conf[cell["hyper"]]
    if (list(hyper["gamma_factors"]) != [1.0] or len(hyper["Cs"]) != 1
            or len(hyper["epsilons"]) != 1):
        raise ValueError("a single fit takes gamma='scale', one C and one "
                         "epsilon")
    return SimpleNamespace(conf=conf, X=inputs["X"], y=inputs["y"],
                           Xq=inputs["Xq"], C=float(hyper["Cs"][0]),
                           epsilon=float(hyper["epsilons"][0]),
                           device=device)


def fit(ctx, max_iter):
    cfg = solving.solver_config(ctx.conf, max_iter)
    return svm.SVR(C=ctx.C, epsilon=ctx.epsilon, gamma="scale",
                   algorithm=cfg.algorithm, eps=cfg.eps,
                   max_iter=cfg.max_iter, device=ctx.device,
                   dtype=ctx.X.dtype).fit(ctx.X, ctx.y)


def decide(ctx, reg) -> dict:
    return solving.host_lanes(reg.fit_result_, reg.predict(ctx.Xq)[None],
                              2 * ctx.X.shape[0])


def launch_work(ctx) -> dict:
    l, d = ctx.X.shape
    m, item = ctx.Xq.shape[0], ctx.X.element_size()
    return {"rbf_row_wss_batched_h2": rbf_row_wss_batched.need(l, d, 1, 2,
                                                               item),
            "rbf_update_wss_batched_h2": rbf_update_wss_batched.need(
                l, d, 1, 2, item),
            "gram_block": gram_block.cross(m, l, d, item)}


def need_s(ctx, out: dict) -> float:
    l, d = ctx.X.shape
    dtype = ctx.conf["dtype"]
    return (solve.loop_s(out["iterations"].tolist(), l=l, d=d, H=2,
                         dtype=dtype, bank=False)
            + solve.decision_s([1], m=ctx.Xq.shape[0], l=l, d=d,
                               dtype=dtype))
