"""Distributed PA-SMO (``repro.core.sharded``): the example axis l sharded
over the ranks of a ``torch.distributed`` process group.

Every rank holds a slab of ``nloc = l_padded / P`` rows of ``X``, ``y``,
``alpha`` and ``G``; SMO's working set of two is what makes this cheap.
Each iteration makes five collectives, the reference's (its module notes)
with the O(1) fetches folded into the point broadcasts:

  1. all_gather of each rank's (value, global index) first-order i-pick
     (the first maximum wins),
  2. one sum all_reduce of x_i, alpha_i, y_i and the O(1) history
     entries: G at the previous two working sets, and for planning alpha
     and y there        (payload d + 8, with planning d + 14),
  3. all_gather of the (value, index) WSS2 j-picks,
  4. one sum all_reduce of x_j, alpha_j, y_j and G_j     (payload d + 3),
  5. one max all_reduce of the KKT gap's two ends        (payload 2).

A sum all_reduce is a broadcast: the owning rank adds the value and every
other rank 0.  Alg. 3's B^(t-2) candidate and the planning step's 2x2
terms are computed on every rank from replicated points (x_i, x_j and the
previous two working sets' rows, carried), so planning adds no
collective; when the candidate wins, its points are the carried ones.
The two kernel rows (three with the j-selection's) and the gradient
update run on the local rows only, in plain ``torch`` (``X_local @ xq``
and ``exp``), as the reference runs them in plain ``jnp``.  The loop is
the fused engines' host loop (:func:`repro_torch.core.solver_fused.
_drive`): on the cards its chunks replay as CUDA graphs, the NCCL
collectives captured with the rest.

The process group plays the mesh axis: ``mesh=None`` is the default
group.  Every rank calls :func:`solve_sharded` with the whole ``X`` and
``y`` and keeps rows ``[rank nloc, (rank + 1) nloc)`` of the padded set;
the padded tail has ``L = U = 0`` and never enters a working set.  The
host reads the all-reduced ``done`` every ``check_every`` iterations, the
same value on every rank, so every rank runs (and captures) the same
chunks; after convergence an iteration steps by 0 and counts nothing.
RBF kernel only (the paper's setting, diagonal 1).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import solver_fused
from repro_torch.core import step as step_mod
from repro_torch.core.qp import TAU
from repro_torch.core.solver import SolverConfig
from repro_torch.device import resolve_device, resolve_dtype


class ShardedResult(NamedTuple):
    alpha: torch.Tensor       # (l_padded,) all-gathered, on every rank
    iterations: torch.Tensor
    objective: torch.Tensor
    kkt_gap: torch.Tensor
    converged: torch.Tensor
    n_planning: torch.Tensor
    b: torch.Tensor


class _Carry(NamedTuple):
    alpha: torch.Tensor       # (nloc,) the local slab
    G: torch.Tensor           # (nloc,)
    t: torch.Tensor           # iterations until convergence
    done: torch.Tensor
    gap: torch.Tensor
    pi: torch.Tensor          # previous / prev-prev working sets (global)
    pj: torch.Tensor
    qi: torch.Tensor
    qj: torch.Tensor
    x_pi: torch.Tensor        # their rows, replicated
    x_pj: torch.Tensor
    x_qi: torch.Tensor
    x_qj: torch.Tensor
    n_hist: torch.Tensor
    p_smo: torch.Tensor
    prev_free: torch.Tensor
    prev_ratio_ok: torch.Tensor
    n_planning: torch.Tensor


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    pad = n - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def _rank_device(device) -> torch.device:
    """``device``, or this process's card: ``cuda:<LOCAL_RANK>`` when a
    launcher set ``LOCAL_RANK`` (as ``torchrun`` does), else the current
    CUDA device.  Not the rank in the group: the ranks of a subgroup, or
    of groups not laid out host by host, would share cards."""
    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        return resolve_device(None)        # raises: no card, no "cpu"
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        return resolve_device(None)
    return resolve_device(f"cuda:{int(local)}")


def solve_sharded(X, y, C, gamma, mesh=None,
                  cfg: SolverConfig = SolverConfig(), *, device=None,
                  dtype=None, check_every: int = solver_fused.CHECK_EVERY
                  ) -> ShardedResult:
    """Solve the RBF classification dual with l sharded over the ranks of
    the process group ``mesh`` (``None``: the default group, which the
    caller has initialised: NCCL on the cards, gloo with
    ``device="cpu"``).

    Every rank passes the whole ``X`` (l, d) and signed labels ``y``
    (l,); ``C`` and ``gamma`` are scalars.  ``device`` defaults to the
    process's card (``cuda:<LOCAL_RANK>``, else the current CUDA device);
    ``dtype`` to ``y``'s when it
    is a floating tensor, else to ``torch.get_default_dtype()``.  The
    host reads ``done`` every ``check_every`` iterations.  Supports
    ``algorithm`` in {smo, pasmo} with ``plan_candidates == 1``, as the
    reference does.  Returns a :class:`ShardedResult` whose ``alpha`` is
    the whole padded dual on every rank and whose other fields are 0-d.
    """
    if cfg.algorithm not in ("smo", "pasmo"):
        raise ValueError(f"the sharded solver runs algorithm smo or pasmo, "
                         f"got {cfg.algorithm!r}")
    if cfg.plan_candidates != 1:
        raise ValueError("the sharded solver plans one candidate "
                         "(plan_candidates == 1)")
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    body, c, (yl, gap_ends, n_ranks) = sharded_iteration(
        X, y, C, gamma, mesh, cfg, device=device, dtype=dtype)
    # on the cards the chunks replay as CUDA graphs, collectives included
    c, _ = solver_fused._drive(body, c, cfg.max_iter, check_every,
                               solver_fused._use_graphs(yl))

    # ---- finalize: f = 1/2 (y.a + G.a) (local dots, one sum) --------------
    obj = (0.5 * (torch.dot(yl, c.alpha) + torch.dot(c.G, c.alpha)))
    obj = obj.reshape(1)
    dist.all_reduce(obj, group=mesh)
    g_up, g_dn = gap_ends(c.alpha, c.G)
    parts = [torch.empty_like(c.alpha) for _ in range(n_ranks)]
    dist.all_gather(parts, c.alpha, group=mesh)
    return ShardedResult(alpha=torch.cat(parts), iterations=c.t,
                         objective=obj[0], kkt_gap=c.gap,
                         converged=c.done, n_planning=c.n_planning,
                         b=0.5 * (g_up + g_dn))


def sharded_iteration(X, y, C, gamma, mesh=None,
                      cfg: SolverConfig = SolverConfig(), *, device=None,
                      dtype=None):
    """The set-up of :func:`solve_sharded` on this rank: (``body``, the
    initial carry, (the local labels, ``gap_ends``, the rank count)).
    ``body(carry, refresh)`` is one iteration, its five collectives
    included; :func:`solve_sharded` drives it, and the dry-run
    (``repro_torch.launch.dryrun_solver``) traces it once.  Arguments as
    :func:`solve_sharded` takes them."""
    dev = _rank_device(device)
    if dtype is None and torch.is_tensor(y) and y.is_floating_point():
        dtype = y.dtype
    dtype = resolve_dtype(dtype)
    n_ranks, me = dist.get_world_size(mesh), dist.get_rank(mesh)
    X = torch.as_tensor(X, dtype=dtype, device=dev)
    y = torch.as_tensor(y, dtype=dtype, device=dev)
    l, d = X.shape
    lp = -(-l // n_ranks) * n_ranks
    nloc = lp // n_ranks
    offset = me * nloc
    # padded labels 0 give L = U = 0
    Xl = _pad_to(X, lp)[offset:offset + nloc].contiguous()
    yl = _pad_to(y, lp)[offset:offset + nloc].contiguous()
    C = torch.as_tensor(C, dtype=dtype, device=dev)
    gamma = torch.as_tensor(gamma, dtype=dtype, device=dev)
    eps, eta = cfg.eps, cfg.eta
    planning = cfg.algorithm == "pasmo"
    gidx = offset + torch.arange(nloc, device=dev)
    sql = torch.sum(Xl * Xl, dim=-1)
    Ll = torch.clamp_max(yl * C, 0.0)
    Ul = torch.clamp_min(yl * C, 0.0)
    neg_inf = torch.tensor(float("-inf"), dtype=dtype, device=dev)

    def rbf_block(xq):
        """The local kernel-row block k(x_q, X_local)."""
        d2 = torch.dot(xq, xq) + sql - 2.0 * (Xl @ xq)
        return torch.exp(-gamma * torch.clamp_min(d2, 0.0))

    def k(xa, xb):
        """One RBF entry from two replicated rows."""
        return torch.exp(-gamma * torch.clamp_min(
            torch.sum((xa - xb) ** 2), 0.0))

    def box(y_):
        return torch.clamp_max(y_ * C, 0.0), torch.clamp_min(y_ * C, 0.0)

    def global_argmax(vals):
        """The first maximum over every rank's slab: (global index, value).
        One all_gather of each rank's (value, index) pair, in float64 (an
        index below 2^53 and any value of the data dtype are exact)."""
        li = torch.argmax(vals).reshape(1)
        mine = torch.cat([vals.take(li).double(),  # static-ok: f64
                          (offset + li).double()])  # static-ok: f64
        parts = [torch.empty_like(mine) for _ in range(n_ranks)]
        dist.all_gather(parts, mine, group=mesh)
        got = torch.stack(parts)
        best = got.index_select(0, torch.argmax(got[:, 0]).reshape(1))[0]
        return best[1].long(), best[0].to(dtype)

    def broadcast(g, scalars):
        """Replicate the row ``x_g`` (``g`` a global index) and the entries
        ``vec[idx]`` of each (vec, global indices) in ``scalars`` in one
        sum all_reduce, to which the owning rank adds each value and the
        others 0: (x_g (d,), the entries in order)."""
        row = torch.where((g // nloc) == me,
                          Xl.index_select(0, (g % nloc).reshape(1))[0], 0.0)
        vals = [torch.where((idx // nloc) == me, vec.take(idx % nloc), 0.0)
                for vec, idx in scalars]
        buf = torch.cat([row] + vals)
        dist.all_reduce(buf, group=mesh)
        return buf[:d], buf[d:]

    def gap_ends(alpha, G):
        """(g_up, g_dn) over every rank: one max all_reduce of the pair."""
        ends = torch.stack([
            torch.where(alpha < Ul, G, neg_inf).amax(),
            torch.where(alpha > Ll, -G, neg_inf).amax()])
        dist.all_reduce(ends, op=dist.ReduceOp.MAX, group=mesh)
        return ends[0], -ends[1]

    def body(c: _Carry, refresh: bool) -> _Carry:
        del refresh                  # no shrinking
        alpha, G = c.alpha, c.G
        active = ~c.done
        up = alpha < Ul
        dn = alpha > Ll

        # ---- i selection (first-order part of WSS2) -----------------------
        i_g, g_i = global_argmax(torch.where(up, G, neg_inf))
        # x_i, alpha_i, y_i and the O(1) history entries in one all_reduce:
        # G at (pi, pj, qi, qj) and alpha at (qi, qj); with planning also y
        # at (qi, qj, pi, pj) and alpha at (pi, pj)
        hist = torch.stack([c.pi, c.pj, c.qi, c.qj])
        i1 = i_g.reshape(1)
        sc = [(alpha, i1), (yl, i1), (G, hist), (alpha, hist[2:])]
        if planning:
            sc += [(yl, torch.stack([c.qi, c.qj, c.pi, c.pj])),
                   (alpha, hist[:2])]
        x_i, v = broadcast(i_g, sc)
        a_i, y_i = v[0], v[1]
        G_pi, G_pj, G_qi, G_qj = v[2], v[3], v[4], v[5]
        a_qi, a_qj = v[6], v[7]
        L_i, U_i = box(y_i)
        k_i = rbf_block(x_i)

        # ---- j selection --------------------------------------------------
        use_exact = (~c.p_smo) & (~c.prev_ratio_ok) if planning else no
        lvec = g_i - G
        qvec = torch.clamp_min(1.0 - 2.0 * k_i + 1.0, TAU)  # RBF diag = 1
        g_tilde = 0.5 * lvec * lvec / qvec
        lo_v = torch.maximum(L_i - a_i, alpha - Ul)
        hi_v = torch.minimum(U_i - a_i, alpha - Ll)
        mu_v = torch.minimum(torch.maximum(lvec / qvec, lo_v), hi_v)
        g_exact = lvec * mu_v - 0.5 * qvec * mu_v * mu_v
        gains = torch.where(use_exact, g_exact, g_tilde)
        cand = dn & (lvec > 0) & (gidx != i_g)
        j_g, best_gain = global_argmax(torch.where(cand, gains, neg_inf))
        j1 = j_g.reshape(1)
        x_j, w = broadcast(j_g, [(alpha, j1), (yl, j1), (G, j1)])
        a_j, y_j, G_j = w[0], w[1], w[2]

        # ---- Alg. 3 extra candidate B^(t-2), from replicated points -------
        x_i2, a_i2, y_i2, G_i2 = x_i, a_i, y_i, g_i
        x_j2, a_j2, y_j2, G_j2 = x_j, a_j, y_j, G_j
        i_sel, j_sel = i_g, j_g
        if planning:
            y_qi, y_qj, y_pi, y_pj = v[8], v[9], v[10], v[11]
            a_pi, a_pj = v[12], v[13]
            L_qi, U_qi = box(y_qi)
            L_qj, U_qj = box(y_qj)
            K_qq = k(c.x_qi, c.x_qj)
            l_q = G_qi - G_qj
            q_q = torch.clamp_min(2.0 - 2.0 * K_qq, TAU)
            lo_q = torch.maximum(L_qi - a_qi, a_qj - U_qj)
            hi_q = torch.minimum(U_qi - a_qi, a_qj - L_qj)
            mu_q = torch.minimum(torch.maximum(l_q / q_q, lo_q), hi_q)
            cg_exact = l_q * mu_q - 0.5 * q_q * mu_q * mu_q
            cg_tilde = 0.5 * l_q * l_q / q_q
            cg = torch.where(use_exact, cg_exact, cg_tilde)
            adm = ((a_qi < U_qi) & (a_qj > L_qj) & (l_q > 0)
                   & (c.qi != c.qj) & (c.n_hist > 1))
            take = (~c.p_smo) & adm & (cg > best_gain)
            i_sel = torch.where(take, c.qi, i_g)
            j_sel = torch.where(take, c.qj, j_g)
            # the winning candidate's points are the carried ones
            x_i2 = torch.where(take, c.x_qi, x_i)
            x_j2 = torch.where(take, c.x_qj, x_j)
            a_i2 = torch.where(take, a_qi, a_i)
            a_j2 = torch.where(take, a_qj, a_j)
            y_i2 = torch.where(take, y_qi, y_i)
            y_j2 = torch.where(take, y_qj, y_j)
            G_i2 = torch.where(take, G_qi, g_i)
            G_j2 = torch.where(take, G_qj, G_j)
        k_i2 = rbf_block(x_i2)
        k_j2 = rbf_block(x_j2)

        # ---- step (Alg. 4 / eq. 2) ----------------------------------------
        L_i2, U_i2 = box(y_i2)
        L_j2, U_j2 = box(y_j2)
        lw = G_i2 - G_j2
        q11 = torch.clamp_min(2.0 - 2.0 * k(x_i2, x_j2), TAU)
        sb = step_mod.step_bounds(a_i2, a_j2, L_i2, U_i2, L_j2, U_j2)
        mu_star = lw / q11
        mu_smo, free_smo = step_mod.smo_step(lw, q11, sb)

        do_plan = no
        mu_plan = mu_smo
        ratio_ok = c.prev_ratio_ok
        if planning:
            # every 2x2 cross term is local: the x vectors are replicated
            w2 = G_pi - G_pj
            q22 = torch.clamp_min(2.0 - 2.0 * k(c.x_pi, c.x_pj), TAU)
            q12 = (k(x_i2, c.x_pi) - k(x_i2, c.x_pj)
                   - k(x_j2, c.x_pi) + k(x_j2, c.x_pj))
            terms = step_mod.PlanningTerms(w1=lw, w2=w2, Q11=q11, Q22=q22,
                                           Q12=q12)
            mu1, okdet = step_mod.planning_step(terms)
            mu2 = step_mod.planned_second_step(mu1, terms)
            interior1 = (sb.lo < mu1) & (mu1 < sb.hi)
            a_pi = a_pi + mu1 * ((c.pi == i_sel).to(dtype)
                                 - (c.pi == j_sel).to(dtype))
            a_pj = a_pj + mu1 * ((c.pj == i_sel).to(dtype)
                                 - (c.pj == j_sel).to(dtype))
            sb2 = step_mod.step_bounds(a_pi, a_pj, *box(y_pi), *box(y_pj))
            interior2 = (sb2.lo < mu2) & (mu2 < sb2.hi)
            feasible = okdet & interior1 & interior2 & (c.n_hist > 0)
            do_plan = c.prev_free & feasible
            mu_plan = torch.where(do_plan, mu1, mu_smo)
            ratio = mu1 / torch.where(torch.abs(mu_star) > 0, mu_star, 1.0)
            ratio_ok = torch.where(do_plan,
                                   (ratio >= 1.0 - eta)
                                   & (ratio <= 1.0 + eta),
                                   c.prev_ratio_ok)

        # after convergence the step is 0: alpha and G stay bitwise
        mu = torch.where(active, torch.where(do_plan, mu_plan, mu_smo), 0.0)

        # ---- update -------------------------------------------------------
        sel_vec = (gidx == i_sel).to(dtype) - (gidx == j_sel).to(dtype)
        alpha_new = alpha + mu * sel_vec
        G_new = G - mu * (k_i2 - k_j2)

        # ---- stopping -----------------------------------------------------
        g_up, g_dn = gap_ends(alpha_new, G_new)
        gap = g_up - g_dn
        return _Carry(
            alpha=alpha_new, G=G_new, t=c.t + active.to(torch.int32),
            done=c.done | (gap <= eps), gap=gap,
            pi=i_sel, pj=j_sel, qi=c.pi, qj=c.pj,
            x_pi=x_i2, x_pj=x_j2, x_qi=c.x_pi, x_qj=c.x_pj,
            n_hist=torch.clamp_max(c.n_hist + 1, 2),
            p_smo=~do_plan, prev_free=(~do_plan) & free_smo,
            prev_ratio_ok=ratio_ok,
            n_planning=c.n_planning + (do_plan & active).to(torch.int32))

    # ---- init: alpha = 0, G = y -------------------------------------------
    no = torch.zeros((), dtype=torch.bool, device=dev)
    alpha0 = torch.zeros_like(yl)
    g_up0, g_dn0 = gap_ends(alpha0, yl)
    zi = torch.zeros((), dtype=torch.int64, device=dev)
    zt = torch.zeros((), dtype=torch.int32, device=dev)
    zd = torch.zeros((d,), dtype=dtype, device=dev)
    c = _Carry(alpha=alpha0, G=yl, t=zt, done=(g_up0 - g_dn0) <= eps,
               gap=g_up0 - g_dn0, pi=zi, pj=zi, qi=zi, qj=zi, x_pi=zd,
               x_pj=zd, x_qi=zd, x_qj=zd, n_hist=zt, p_smo=~no,
               prev_free=no, prev_ratio_ok=~no, n_planning=zt)
    return body, c, (yl, gap_ends, n_ranks)
