"""The classic PA-SMO / SMO solver (``repro.core.solver``), lane-batched.

Implements, selectable through :class:`SolverConfig`:

* ``algorithm="smo"``          — Algorithm 1 with WSS2 (eq. 3), LIBSVM's
                                 baseline;
* ``algorithm="pasmo"``        — Algorithm 5 (Alg. 3 selection + Alg. 4
                                 update), the paper's method;
                                 ``plan_candidates=N > 1`` is §7.4's
                                 multiple planning-ahead;
* ``algorithm="pasmo_simple"`` — Algorithm 2 (plan after any SMO step,
                                 plain WSS2; no convergence guarantee);
* ``algorithm="overshoot"``    — §7.3's heuristic (clipped ``1.1 mu*``);
* ``wss="mvp"``                — first-order selection (ablation);
* ``step="conjugate"``         — the Conjugate-SMO two-direction step;

with the per-step counters ``n_free``/``n_clipped``/``n_reverted``, soft
shrinking (``shrink_every``), the Fig. 3 recorder of planning-step ratios
(``record_trace``) and the trajectory recorder (``record_steps``).  Kernel
rows come from an oracle of :mod:`repro_torch.core.qp` (a precomputed
Gram, a shared Gram bank, rows recomputed from ``X``, the doubled ε-SVR
operator), so one loop serves every dual.

The reference runs one ``lax.while_loop`` and batches it with ``vmap``.
Here every state field has a leading lane axis and one host loop advances
all lanes (:func:`repro_torch.core.solver_fused._drive`, which replays
``check_every`` iterations as a CUDA graph on the card).  As under
``vmap``, the body runs on every lane and a lane whose own condition
(``~done & t < max_iter``) is false keeps its old state: every field
passes through ``torch.where(running, new, old)``, so a frozen lane is
held bitwise and ``max_iter`` is exact per lane.  The reference's
``lax.cond`` branches are both evaluated and selected per lane, as
``vmap`` does.  Nothing in the body reads the host: the shrink refresh is
decided per lane from that lane's own ``t``.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch

from repro_torch.core import qp as qp_mod
from repro_torch.core import step as step_mod
from repro_torch.core import wss as wss_mod
from repro_torch.core.qp import TAU, Bounds
from repro_torch.device import resolve_device, resolve_dtype

# Host-check cadence of the classic loop: iterations between reads of
# any(~done), and the length of one CUDA graph on the card.
CHECK_EVERY = 32

# Soft-shrinking cadence when a config has none of its own.
DEFAULT_SHRINK_EVERY = 64


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration, field for field as
    ``repro.core.solver.SolverConfig``."""

    algorithm: str = "pasmo"       # smo | pasmo | pasmo_simple | overshoot
    wss: str = "wss2"              # wss2 | mvp
    eps: float = 1e-3              # KKT stopping accuracy (paper default)
    eta: float = 0.9               # Alg. 3 ratio window (paper fixes 0.9)
    overshoot: float = 1.1         # §7.3 factor (only algorithm="overshoot")
    max_iter: int = 1_000_000
    plan_candidates: int = 1       # N of §7.4; 1 = plain PA-SMO
    record_trace: bool = False     # record mu/mu* of planning steps (Fig. 3)
    trace_cap: int = 16384
    shrink_every: int = 0          # 0 = off; else re-evaluate mask every k its
    record_steps: bool = False     # record (i, j, mu) per iteration (debug /
    step_cap: int = 4096           # trajectory-parity tests)
    step: str = "plain"            # plain | conjugate (Conjugate-SMO 2-dir)

    def __post_init__(self):
        assert self.algorithm in ("smo", "pasmo", "pasmo_simple", "overshoot")
        assert self.wss in ("wss2", "mvp")
        assert self.plan_candidates >= 1
        assert self.step in ("plain", "conjugate")
        # The conjugate step replaces the planning-ahead machinery (both
        # re-use the previous working set as the second direction), so it
        # only composes with the plain SMO base algorithm.
        assert self.step == "plain" or self.algorithm == "smo", \
            "step='conjugate' requires algorithm='smo'"


def resolve_shrink_cfg(cfg: SolverConfig, shrinking) -> SolverConfig:
    """Fold a ``shrinking=True|False|None`` knob into ``cfg.shrink_every``.

    ``None`` defers to the config; ``True`` enables it with
    :data:`DEFAULT_SHRINK_EVERY` when the config has no cadence of its own;
    ``False`` forces it off.
    """
    if shrinking is None:
        return cfg
    every = (cfg.shrink_every or DEFAULT_SHRINK_EVERY) if shrinking else 0
    if every == cfg.shrink_every:
        return cfg
    return dataclasses.replace(cfg, shrink_every=every)


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Solver output, field for field as ``repro.core.solver.SolveResult``.

    ``n_free``/``n_clipped``/``n_reverted`` are per-step counters; the
    fused engine does not track the step type and fills them with
    ``repro_torch.core.grid.UNTRACKED`` (-1), never with zeros.
    ``n_free_sv`` is the number of strictly interior (free) support
    vectors at the returned ``alpha``.  ``trace``/``n_trace`` and the
    ``steps_*`` recorders are filled by the classic engine when its config
    asks for them, and are placeholders otherwise.
    """

    alpha: torch.Tensor
    b: torch.Tensor
    G: torch.Tensor
    iterations: torch.Tensor
    objective: torch.Tensor
    kkt_gap: torch.Tensor
    converged: torch.Tensor
    n_planning: torch.Tensor
    n_free: torch.Tensor
    n_clipped: torch.Tensor
    n_reverted: torch.Tensor
    n_free_sv: torch.Tensor
    trace: torch.Tensor
    n_trace: torch.Tensor
    steps_i: torch.Tensor
    steps_j: torch.Tensor
    steps_mu: torch.Tensor


class SolverState(NamedTuple):
    """The classic loop's state; every field has a leading lane axis."""

    alpha: torch.Tensor          # (B, n)
    G: torch.Tensor              # (B, n) gradient p - Q alpha
    t: torch.Tensor              # (B,) int32 iteration counter
    done: torch.Tensor           # (B,) bool
    gap: torch.Tensor            # (B,) last KKT gap
    hist_i: torch.Tensor         # (B, N + 1) int32 recent working sets,
    hist_j: torch.Tensor         # newest first
    n_hist: torch.Tensor         # (B,) int32 valid history entries
    p_smo: torch.Tensor          # (B,) bool: the last step was a SMO step
    prev_free: torch.Tensor      # (B,) bool: ... and it was free
    prev_ratio_ok: torch.Tensor  # (B,) bool: last ratio in [1-eta, 1+eta]
    dir_u: torch.Tensor          # (B, n) Q (e_pi - e_pj) of the last step;
                                 # (B, 1) unused (plain step)
    conj_ok: torch.Tensor        # (B,) bool: dir_u usable as conjugate
    active: torch.Tensor         # (B, n) bool soft-shrinking mask
    n_planning: torch.Tensor     # (B,) int32 counters
    n_free: torch.Tensor
    n_clipped: torch.Tensor
    n_reverted: torch.Tensor
    trace: torch.Tensor          # (B, trace_cap) ratios; (B, 1) unused
    n_trace: torch.Tensor        # (B,) int32
    steps_i: torch.Tensor        # (B, step_cap) int32; (B, 1) unused
    steps_j: torch.Tensor
    steps_mu: torch.Tensor       # (B, step_cap)


def _shrink_mask(G, alpha, bounds: Bounds):
    """Conservative adaptive shrinking (the shared rule of
    :func:`repro_torch.core.qp.shrink_mask`).  Masked variables still
    receive exact gradient updates, so reactivation is free."""
    return qp_mod.shrink_mask(G, alpha, bounds.lower, bounds.upper)


def _make_body(kernel, p, bounds: Bounds, diag, cfg: SolverConfig):
    """One iteration of every lane: ``body(state, refresh)`` (``refresh``,
    the fused driver's static flag, is unused: the refresh is per lane)."""
    B, n = p.shape
    N = cfg.plan_candidates
    dtype, dev = p.dtype, p.device
    eps, eta = cfg.eps, cfg.eta
    planning_enabled = cfg.algorithm in ("pasmo", "pasmo_simple")
    conjugate = cfg.step == "conjugate"
    L, U = bounds.lower, bounds.upper
    # history slots of the extra candidates (1..N) and of planning (0..N-1)
    cand_slot = torch.arange(1, N + 1, dtype=torch.int32, device=dev)
    plan_slot = torch.arange(N, dtype=torch.int32, device=dev)
    take = qp_mod.take

    def body(s: SolverState, refresh: bool) -> SolverState:
        del refresh
        running = (~s.done) & (s.t < cfg.max_iter)
        alpha, G = s.alpha, s.G
        up = (alpha < U) & s.active
        dn = (alpha > L) & s.active

        # ------------------------------------------------------------------
        # Working set selection (Alg. 3 for pasmo, plain WSS2/MVP otherwise)
        # ------------------------------------------------------------------
        i0, g_i0 = wss_mod.select_i(G, up)
        row_i0 = kernel.row(i0)
        use_exact = torch.zeros_like(s.p_smo)
        if cfg.wss == "mvp":
            sel = wss_mod.select_mvp(G, up, dn)
            sel = sel._replace(gain=torch.zeros_like(sel.gain))
        elif cfg.algorithm == "pasmo":
            use_exact = (~s.p_smo) & (~s.prev_ratio_ok)
            sel = wss_mod.select_wss2_either(G, row_i0, diag, alpha, bounds,
                                             up, dn, i0, g_i0, use_exact)
        else:
            sel = wss_mod.select_wss2(G, row_i0, diag, up, dn, i0, g_i0)

        i, j = sel.i, sel.j
        if cfg.algorithm == "pasmo":
            # Extra candidates: the working sets used for planning, history
            # entries 1..N (entry 0 is B^(t-1), the planning target).  The
            # reference's chain of strict improvements over them takes the
            # first best candidate that beats the selection's gain.
            ci, cj = s.hist_i[:, 1:], s.hist_j[:, 1:]         # (B, N)
            kcc = kernel.entry(ci, cj)
            kci, kcj = take(diag, ci), take(diag, cj)
            cg = torch.where(
                use_exact[:, None],
                wss_mod.candidate_exact_gain(ci, cj, G, kci, kcc, kcj, alpha,
                                             bounds, up, dn),
                wss_mod.candidate_newton_gain(ci, cj, G, kci, kcc, kcj, up,
                                              dn))
            cg = torch.where((~s.p_smo)[:, None]
                             & (s.n_hist[:, None] > cand_slot), cg,
                             wss_mod.NEG_INF)
            h = torch.argmax(cg, dim=-1)
            won = take(cg, h) > sel.gain
            i = torch.where(won, take(ci, h), i)
            j = torch.where(won, take(cj, h), j)

        rows = kernel.row(torch.stack([i, j], dim=-1))        # (B, 2, n)
        row_i = torch.where((i == i0)[:, None], row_i0, rows[:, 0])
        row_j = rows[:, 1]

        # ------------------------------------------------------------------
        # Step computation (Alg. 4 / eq. 2 / §7.3)
        # ------------------------------------------------------------------
        ij = torch.stack([i, j], dim=-1)
        G_ij, a_ij, L_ij, U_ij, d_ij = (take(v, ij)
                                        for v in (G, alpha, L, U, diag))
        l = G_ij[:, 0] - G_ij[:, 1]
        q11 = torch.clamp_min(d_ij[:, 0] - 2.0 * take(row_i, j) + d_ij[:, 1],
                              TAU)
        sb = step_mod.step_bounds(a_ij[:, 0], a_ij[:, 1], L_ij[:, 0],
                                  U_ij[:, 0], L_ij[:, 1], U_ij[:, 1])
        mu_star = l / q11
        if cfg.algorithm == "overshoot":
            mu_smo, free_smo = step_mod.overshoot_step(l, q11, sb,
                                                       cfg.overshoot)
        else:
            mu_smo, free_smo = step_mod.smo_step(l, q11, sb)

        do_plan = torch.zeros_like(s.p_smo)
        mu_plan = mu_smo
        if planning_enabled:
            allow = s.prev_free if cfg.algorithm == "pasmo" else s.p_smo
            pi, pj = s.hist_i[:, :N], s.hist_j[:, :N]         # (B, N)
            w2 = take(G, pi) - take(G, pj)
            q22 = (take(diag, pi) - 2.0 * kernel.entry(pi, pj)
                   + take(diag, pj))
            q12 = (take(row_i, pi) - take(row_i, pj) - take(row_j, pi)
                   + take(row_j, pj))
            terms = step_mod.PlanningTerms(w1=l[:, None], w2=w2,
                                           Q11=q11[:, None], Q22=q22,
                                           Q12=q12)
            mu1, okdet = step_mod.planning_step(terms)
            mu2 = step_mod.planned_second_step(mu1, terms)
            interior1 = (sb.lo[:, None] < mu1) & (mu1 < sb.hi[:, None])
            d_pi = ((pi == i[:, None]).to(dtype)
                    - (pi == j[:, None]).to(dtype))
            d_pj = ((pj == i[:, None]).to(dtype)
                    - (pj == j[:, None]).to(dtype))
            sb2 = step_mod.step_bounds(
                take(alpha, pi) + mu1 * d_pi, take(alpha, pj) + mu1 * d_pj,
                take(L, pi), take(U, pi), take(L, pj), take(U, pj))
            interior2 = (sb2.lo < mu2) & (mu2 < sb2.hi)
            feasible = (okdet & interior1 & interior2
                        & (s.n_hist[:, None] > plan_slot))
            # the reference's chain of strict improvements from -inf: the
            # first feasible candidate of the largest two-step gain
            g2 = torch.where(feasible, step_mod.double_step_gain(mu1, terms),
                             wss_mod.NEG_INF)
            h = torch.argmax(g2, dim=-1)
            mu_plan = torch.where(take(g2, h) > wss_mod.NEG_INF,
                                  take(mu1, h), mu_smo)
            do_plan = allow & feasible.any(dim=-1)

        if conjugate:
            # Conjugate-SMO step: the exact 2x2 subproblem on v1 = e_i - e_j
            # and the previous direction v2 = e_pi - e_pj, whose Q-product
            # is carried in dir_u (no extra kernel rows)
            cpi, cpj = s.hist_i[:, 0], s.hist_j[:, 0]
            w2 = take(G, cpi) - take(G, cpj)
            q22 = take(s.dir_u, cpi) - take(s.dir_u, cpj)
            q12 = take(s.dir_u, i) - take(s.dir_u, j)
            terms = step_mod.PlanningTerms(w1=l, w2=w2, Q11=q11, Q22=q22,
                                           Q12=q12)
            mu1c, mu2c, okdet = step_mod.conjugate_step(terms)
            # net displacement of the four touched coordinates; indicator
            # arithmetic handles overlapping pairs exactly
            c4 = torch.stack([i, j, cpi, cpj], dim=-1)

            def ind(a, b):
                return (c4 == a[:, None]).to(dtype) - (c4 == b[:, None]).to(
                    dtype)

            a_c = take(alpha, c4) + (mu1c[:, None] * ind(i, j)
                                     + mu2c[:, None] * ind(cpi, cpj))
            inter = ((take(L, c4) < a_c) & (a_c < take(U, c4))).all(dim=-1)
            g2 = 0.5 * (l * mu1c + w2 * mu2c)
            g1 = step_mod.gain_newton(l, q11)
            accept = (s.conj_ok & (s.n_hist >= 1) & okdet & inter
                      & (g2 + TAU >= g1))
            do_plan = accept
            mu_plan = mu1c
            mu2v = torch.where(accept, mu2c, 0.0)

        mu = torch.where(do_plan, mu_plan, mu_smo)
        reverted = (s.prev_free if cfg.algorithm == "pasmo" else s.p_smo)
        reverted = reverted & ~do_plan & planning_enabled

        # ------------------------------------------------------------------
        # Update (steps 2-3 of Alg. 1): one scatter per index, in the
        # reference's order, so i == j rounds as there
        # ------------------------------------------------------------------
        def scatter(a, idx, v):
            return a.scatter_add(1, idx.long()[:, None], v[:, None])

        alpha_new = scatter(scatter(alpha, i, mu), j, -mu)
        G_new = G - mu[:, None] * (row_i - row_j)
        if conjugate:
            # a rejected conjugate step has mu2v == 0: exact no-ops
            alpha_new = scatter(scatter(alpha_new, cpi, mu2v), cpj, -mu2v)
            G_new = G_new - mu2v[:, None] * s.dir_u

        # ------------------------------------------------------------------
        # Bookkeeping, shrinking, stopping
        # ------------------------------------------------------------------
        ratio = mu_plan / torch.where(torch.abs(mu_star) > 0, mu_star, 1.0)
        ratio_ok = (ratio >= 1.0 - eta) & (ratio <= 1.0 + eta)
        hist_i = torch.cat([i[:, None], s.hist_i[:, :-1]], dim=1)
        hist_j = torch.cat([j[:, None], s.hist_j[:, :-1]], dim=1)

        trace, n_trace = s.trace, s.n_trace
        if cfg.record_trace:
            slot = torch.clamp_max(s.n_trace, cfg.trace_cap - 1)[:, None]
            traced = torch.where(do_plan[:, None], ratio[:, None],
                                 take(s.trace, slot))
            trace = s.trace.scatter(1, slot.long(), traced)
            n_trace = s.n_trace + do_plan.to(torch.int32)

        steps_i, steps_j, steps_mu = s.steps_i, s.steps_j, s.steps_mu
        if cfg.record_steps:
            slot = torch.clamp_max(s.t, cfg.step_cap - 1).long()[:, None]
            steps_i = s.steps_i.scatter(1, slot, i[:, None])
            steps_j = s.steps_j.scatter(1, slot, j[:, None])
            steps_mu = s.steps_mu.scatter(1, slot, mu[:, None])

        active = s.active
        refresh = unshrunk = torch.zeros_like(s.p_smo)
        if cfg.shrink_every > 0:
            refresh = (s.t % cfg.shrink_every) == (cfg.shrink_every - 1)
            active = torch.where(refresh[:, None],
                                 _shrink_mask(G_new, alpha_new, bounds),
                                 active)
            gap_masked = qp_mod.finite_gap(
                qp_mod.kkt_gap(G_new, alpha_new, bounds, active))
            # unshrink when the masked problem looks solved
            unshrunk = gap_masked <= eps
            active = active | unshrunk[:, None]

        dir_u, conj_ok = s.dir_u, s.conj_ok
        if conjugate:
            # reset on clip: the direction survives free steps only; a
            # clipped fallback, a mask refresh or an unshrink clears it
            dir_u = row_i - row_j
            conj_ok = (do_plan | free_smo) & ~refresh & ~unshrunk

        gap = qp_mod.finite_gap(qp_mod.kkt_gap(G_new, alpha_new, bounds))
        smo_free = (~do_plan) & free_smo
        new = SolverState(
            alpha=alpha_new, G=G_new, t=s.t + 1, done=gap <= eps, gap=gap,
            hist_i=hist_i, hist_j=hist_j,
            n_hist=torch.clamp_max(s.n_hist + 1, N + 1),
            p_smo=~do_plan, prev_free=smo_free,
            prev_ratio_ok=torch.where(do_plan, ratio_ok, s.prev_ratio_ok),
            dir_u=dir_u, conj_ok=conj_ok, active=active,
            n_planning=s.n_planning + do_plan.to(torch.int32),
            n_free=s.n_free + smo_free.to(torch.int32),
            n_clipped=s.n_clipped + ((~do_plan) & ~free_smo).to(torch.int32),
            n_reverted=s.n_reverted + reverted.to(torch.int32),
            trace=trace, n_trace=n_trace,
            steps_i=steps_i, steps_j=steps_j, steps_mu=steps_mu)
        # a lane whose loop condition is false keeps its old state bitwise
        # (a field this config never changes needs no select)
        return SolverState(*(
            nw if nw is old else torch.where(
                running.view((B,) + (1,) * (old.ndim - 1)), nw, old)
            for nw, old in zip(new, s)))

    return body


def init_state(kernel, p, bounds: Bounds, cfg: SolverConfig,
               alpha0=None, G0=None) -> SolverState:
    """The loop's starting state for the (B, n) lanes ``p``.  Without
    ``alpha0`` the lanes start at alpha = 0, G = p (no kernel work; 0 must
    be feasible); an ``alpha0`` without ``G0`` gets ``G0 = p - Q alpha0``
    from one matvec."""
    B, n = p.shape
    dtype, dev = p.dtype, p.device
    if alpha0 is None:
        alpha0, G0 = torch.zeros_like(p), p
    elif G0 is None:
        G0 = p - kernel.matvec(alpha0)
    N = cfg.plan_candidates
    cap = cfg.trace_cap if cfg.record_trace else 1
    scap = cfg.step_cap if cfg.record_steps else 1
    gap = qp_mod.finite_gap(qp_mod.kkt_gap(G0, alpha0, bounds))

    def zeros(*shape, dt=torch.int32):
        return torch.zeros((B,) + shape, dtype=dt, device=dev)

    no = zeros(dt=torch.bool)
    return SolverState(
        alpha=alpha0, G=G0, t=zeros(), done=gap <= cfg.eps, gap=gap,
        hist_i=zeros(N + 1), hist_j=zeros(N + 1), n_hist=zeros(),
        p_smo=~no, prev_free=no, prev_ratio_ok=~no,
        # (B, 1) placeholder when the conjugate step is off
        dir_u=zeros(n if cfg.step == "conjugate" else 1, dt=dtype),
        conj_ok=no, active=zeros(n, dt=torch.bool) | True,
        n_planning=zeros(), n_free=zeros(), n_clipped=zeros(),
        n_reverted=zeros(), trace=zeros(cap, dt=dtype), n_trace=zeros(),
        steps_i=zeros(scap), steps_j=zeros(scap), steps_mu=zeros(scap,
                                                                  dt=dtype))


def _finalize(s: SolverState, p, bounds: Bounds) -> SolveResult:
    up = s.alpha < bounds.upper
    dn = s.alpha > bounds.lower
    g_up = torch.where(up, s.G, float("-inf")).amax(dim=-1)
    g_dn = torch.where(dn, s.G, float("inf")).amin(dim=-1)
    # f(a) = p.a - 1/2 a.Q a = 1/2 (p.a + G.a)  since G = p - Q a
    objective = 0.5 * (torch.sum(p * s.alpha, dim=-1)
                       + torch.sum(s.G * s.alpha, dim=-1))
    return SolveResult(
        alpha=s.alpha, b=qp_mod.safe_bias(g_up, g_dn), G=s.G,
        iterations=s.t, objective=objective, kkt_gap=s.gap,
        converged=s.done, n_planning=s.n_planning, n_free=s.n_free,
        n_clipped=s.n_clipped, n_reverted=s.n_reverted,
        n_free_sv=torch.sum(up & dn, dim=-1, dtype=torch.int32),
        trace=s.trace, n_trace=s.n_trace, steps_i=s.steps_i,
        steps_j=s.steps_j, steps_mu=s.steps_mu)


def solve_lanes(kernel, p, L, U, cfg: SolverConfig = SolverConfig(),
                alpha0=None, G0=None, *,
                check_every: int = CHECK_EVERY) -> SolveResult:
    """The classic loop over the (B, n) lanes ``p``, box ``L``/``U``,
    with optional (B, n) warm starts, on the tensors' own device and
    dtype.  ``kernel`` serves every lane (a shared oracle, or a
    :class:`~repro_torch.core.qp.StackedKernel` over B bank indices).
    Returns a :class:`SolveResult` with a leading lane axis."""
    # the graph driver lives with the fused engine, which imports this
    # module's config
    from repro_torch.core.solver_fused import (_check_cadence, _drive,
                                               _loop_for, _use_graphs)
    _check_cadence(check_every)
    B, n = p.shape
    if kernel.n != n:
        raise ValueError(f"the oracle has {kernel.n} coordinates, the lanes "
                         f"{n}")
    bounds = Bounds(lower=L, upper=U)
    loop = _loop_for((kernel, p, L, U),
                     lambda: _classic_loop(kernel, p, bounds, cfg))
    s = init_state(kernel, p, bounds, cfg, alpha0, G0)
    s, _ = _drive(loop.body, s, cfg.max_iter, check_every, _use_graphs(p))
    return _finalize(s, p, bounds)


def _classic_loop(kernel, p, bounds: Bounds, cfg: SolverConfig):
    """The classic loop of :func:`solve_lanes`: ``body`` over the oracle's
    diagonal, and ``reload()``, which recomputes that diagonal in place for
    a chunked round that wrote new bank indices into the oracle's ``g``
    (:func:`repro_torch.core.solver_fused._loop_for`)."""
    B, n = p.shape
    diag = kernel.diag().to(p.dtype, copy=True)

    def reload():
        diag.copy_(kernel.diag())

    body = _make_body(kernel, p, bounds, diag.expand(B, n), cfg)
    return SimpleNamespace(body=body, reload=reload)


def _lanes(t, dev, dtype):
    """A (B, n) lane batch (a 1-D ``t`` is one lane) and whether it was."""
    t = torch.as_tensor(t, dtype=dtype, device=dev)
    return (t[None], True) if t.ndim == 1 else (t, False)


def placement(data, device, dtype):
    """An entry point's device and dtype: ``device`` defaults to the CUDA
    card and raises without one, ``dtype`` to ``data``'s when it is a
    floating tensor, else to ``torch.get_default_dtype()``."""
    dev = resolve_device(device)
    if dtype is None and torch.is_tensor(data) and data.is_floating_point():
        dtype = data.dtype
    return dev, resolve_dtype(dtype)


def solve_qp(kernel, qp: qp_mod.DualQP, cfg: SolverConfig = SolverConfig(),
             alpha0=None, G0=None, *, shrinking: Optional[bool] = None,
             device=None, dtype=None,
             check_every: int = CHECK_EVERY) -> SolveResult:
    """Solve a general :class:`~repro_torch.core.qp.DualQP` (``max p.a -
    1/2 a.Q a`` over a box with one equality constraint).

    ``kernel`` is any oracle of :mod:`repro_torch.core.qp` (wrap the base
    oracle in :class:`~repro_torch.core.qp.DoubledKernel` for ε-SVR).  A
    problem whose feasible set does not hold 0 (one-class) needs a
    feasible ``alpha0``; ``G0`` is then one matvec if omitted.  ``qp``'s
    leaves and the warm starts are (n,) for one problem, with 0-d results
    as the reference's, or (B, n) for B lanes (results with a leading lane
    axis).  ``shrinking`` overrides ``cfg.shrink_every``
    (:func:`resolve_shrink_cfg`).  An entry point: everything moves to
    ``device``, which defaults to the CUDA card and raises without one
    (``device="cpu"`` runs on the CPU); ``dtype`` defaults to ``qp.p``'s.
    ``check_every`` is the host loop's cadence; no result depends on it.
    """
    cfg = resolve_shrink_cfg(cfg, shrinking)
    dev, dtype = placement(qp.p, device, dtype)
    kernel = qp_mod.oracle_to(kernel, dev, dtype)
    p, one = _lanes(qp.p, dev, dtype)
    L, _ = _lanes(qp.bounds.lower, dev, dtype)
    U, _ = _lanes(qp.bounds.upper, dev, dtype)
    if alpha0 is not None:
        alpha0, _ = _lanes(alpha0, dev, dtype)
    if G0 is not None:
        G0, _ = _lanes(G0, dev, dtype)
    res = solve_lanes(kernel, p, L, U, cfg, alpha0, G0,
                      check_every=check_every)
    if one:
        res = SolveResult(**{f.name: getattr(res, f.name)[0]
                             for f in dataclasses.fields(res)})
    return res


def solve(kernel, y, C, cfg: SolverConfig = SolverConfig(), alpha0=None,
          G0=None, *, shrinking: Optional[bool] = None, device=None,
          dtype=None, check_every: int = CHECK_EVERY) -> SolveResult:
    """Solve the dual SVM classification QP (eq. 1): the ``p = y``
    instance of :func:`solve_qp`.  ``y`` is (l,) signed labels (0-d
    results) or (B, l) lanes; ``C`` a scalar, or a per-sample budget
    broadcasting against ``y``.  ``shrinking``, ``device``, ``dtype`` and
    ``check_every`` are as in :func:`solve_qp`."""
    dev, dtype = placement(y, device, dtype)
    y = torch.as_tensor(y, dtype=dtype, device=dev)
    qp = qp_mod.classification_qp(
        y, torch.as_tensor(C, dtype=dtype, device=dev))
    return solve_qp(kernel, qp, cfg, alpha0, G0, shrinking=shrinking,
                    device=dev, dtype=dtype, check_every=check_every)


def solve_batched(Ks, ys, C, cfg: SolverConfig = SolverConfig(), *,
                  shrinking: Optional[bool] = None, device=None, dtype=None,
                  check_every: int = CHECK_EVERY) -> SolveResult:
    """B precomputed-kernel QPs as the lanes of one loop: ``Ks`` (B, l, l),
    ``ys`` (B, l), ``C`` a scalar or (B,) per-problem budgets.  Lane b
    reads entry b of the stack (a
    :class:`~repro_torch.core.qp.StackedKernel`).  ``shrinking``,
    ``device``, ``dtype`` and ``check_every`` are as in :func:`solve_qp`.
    """
    dev, dtype = placement(ys, device, dtype)
    ys = torch.as_tensor(ys, dtype=dtype, device=dev)
    Ks = torch.as_tensor(Ks, dtype=dtype, device=dev).contiguous()
    B = ys.shape[0]
    Cs = torch.as_tensor(C, dtype=dtype, device=dev).broadcast_to((B,))
    kernel = qp_mod.StackedKernel(
        Ks, torch.arange(B, dtype=torch.int32, device=dev))
    return solve(kernel, ys, Cs[:, None], cfg, shrinking=shrinking,
                 device=dev, dtype=dtype, check_every=check_every)
