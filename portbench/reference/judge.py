"""Judge a solve's outputs against the reference.

Each number is the worst over the solve's lanes; :func:`judge_all` takes
the worst over the window's solves and holds each against the cell's
limit (``limits`` in the cell file, set in ``PERF.md`` from the program's
readings and the control's):

* ``unconverged``: lanes that the program does not report converged
  (exact: 0).
* ``kkt_gap``: the KKT gap ``max_{a < U} G - min_{a > L} G`` of the
  program's ``alpha`` with the gradient recomputed here (the
  configuration's ``eps``).
* ``equality``: ``|sum(alpha)|`` over the box's width.
* ``gradient``: the program's carried G against ``p - Q alpha``, over
  ``max(1, |p|)``.
* ``bias``: the program's b against the midpoint of the recomputed gap's
  ends (the surviving end where one side is empty, 0 where both are),
  over ``max(1, |p|)``.
* ``objective``: the program's objective against ``p.a - a.Q.a / 2``,
  over ``max(1, |objective|)``.
* ``decision``: the program's held-out decision values against
  ``k(x, X) @ coefficients + b`` (with the program's b, judged above),
  over ``max(1, |decision|)``.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import problems, rbf

def _safe_bias(g_up, g_dn):
    fu, fd = torch.isfinite(g_up), torch.isfinite(g_dn)
    gu = torch.where(fu, g_up, g_dn)
    gd = torch.where(fd, g_dn, g_up)
    return torch.where(fu | fd, 0.5 * (gu + gd), torch.zeros_like(g_up))


def judge(hyper: dict, inputs: dict, out: dict) -> dict:
    """{number: value} of one solve's outputs ``out`` (host tensors:
    ``alpha``, ``G`` (B, n), ``b``, ``objective``, ``converged`` (B,),
    ``decision`` (B, m)) for the inputs it was given."""
    X, y, Xq = inputs["X"], inputs["y"], inputs["Xq"]
    dev, f64 = X.device, torch.float64
    qp = problems.lanes(hyper, X, y)
    a = out["alpha"].to(dev, f64)
    G = out["G"].to(dev, f64)
    b = out["b"].to(dev, f64).reshape(-1)
    obj = out["objective"].to(dev, f64).reshape(-1)
    D = out["decision"].to(dev, f64)
    conv = out["converged"].reshape(-1)
    B, n = a.shape
    l = X.shape[0]
    coef = a[:, :l] + a[:, l:] if qp.doubled else a
    KA = torch.empty((B, l), dtype=f64, device=dev)
    KqA = torch.empty((B, Xq.shape[0]), dtype=f64, device=dev)
    for g in sorted(set(qp.gammas)):
        idx = torch.tensor([i for i, v in enumerate(qp.gammas) if v == g],
                           device=dev)
        KA[idx] = rbf.products(X, X, g, coef[idx]).T
        KqA[idx] = rbf.products(X, Xq, g, coef[idx]).T
    Qa = torch.cat([KA, KA], dim=1) if qp.doubled else KA
    G_ref = qp.P - Qa
    g_up = torch.where(a < qp.U, G_ref, -math.inf).amax(dim=1)
    g_dn = torch.where(a > qp.L, G_ref, math.inf).amin(dim=1)
    gap = g_up - g_dn
    gap = torch.where(torch.isfinite(gap), gap, torch.zeros_like(gap))
    b_ref = _safe_bias(g_up, g_dn)
    obj_ref = 0.5 * ((qp.P * a).sum(dim=1) + (G_ref * a).sum(dim=1))
    D_ref = KqA + b[:, None]
    width = (qp.U - qp.L).amax(dim=1)
    scale_p = qp.P.abs().amax(dim=1).clamp_min(1.0)
    vals = {
        "unconverged": float((~conv.bool()).sum()),
        "kkt_gap": gap.amax(),
        "equality": (a.sum(dim=1).abs() / width).amax(),
        "gradient": ((G - G_ref).abs().amax(dim=1) / scale_p).amax(),
        "bias": ((b - b_ref).abs() / scale_p).amax(),
        "objective": ((obj - obj_ref).abs()
                      / obj_ref.abs().clamp_min(1.0)).amax(),
        "decision": ((D - D_ref).abs().amax(dim=1)
                     / D_ref.abs().amax(dim=1).clamp_min(1.0)).amax(),
    }
    return {k: float(v) for k, v in vals.items()}


def judge_all(conf: dict, cell: dict, inputs: dict, outs: list) -> dict:
    """{number: (worst value, limit)} over the solves ``outs``, in the
    order of the cell's ``limits``, and ``_each``: whether each solve kept
    every limit.  A value that is not a number (NaN) keeps no limit."""
    hyper = conf[cell["hyper"]]
    limits = cell["limits"]
    worst, each = {}, []
    for out in outs:
        vals = judge(hyper, inputs, out)
        each.append(all(vals[k] <= lim for k, lim in limits.items()))
        for k in limits:
            v = vals[k]
            if (k not in worst or math.isnan(v)
                    or (not math.isnan(worst[k]) and v > worst[k])):
                worst[k] = v
    res = {k: (worst[k], limits[k]) for k in limits}
    res["_each"] = each
    return res
