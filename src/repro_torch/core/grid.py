"""C/gamma model-selection grids (``repro.core.grid``): the classic
engine's warm-started C chain, and one fused lane batch.

A hyper-parameter grid over an RBF-SVM is ``n_gamma * n_class * n_C``
QPs that share one dataset.  ``impl=None`` (the default) runs the classic
engine (:mod:`repro_torch.core.solver`): the (gamma, class) lanes index a
shared (n_gamma, l, l) Gram bank (the Gram kernel on the card) through a
:class:`~repro_torch.core.qp.StackedKernel`, and the C axis runs in
ascending order, each C warm-started from the last optimum scaled by
``r = C / C_prev``: ``a0 = r alpha`` is feasible for the grown box and
``g0 = (1 - r) y + r G`` is its exact gradient, so a restart costs O(l).
A kernel backend name (``impl="auto"``, ``"cuda"``, ``"torch"``) runs
the fused drivers, which flatten every grid axis
into the B lanes of one :func:`~repro_torch.core.solver_fused.
solve_fused_batched_qp` loop: two batched kernel passes per iteration,
converged lanes frozen in the passes, lane order (gamma, class, C)
row-major, which is also the order of the result axes.  All lanes start
cold (one-class lanes from LIBSVM's feasible point), so the C axis needs
no warm-start chain.

``precompute`` picks the row source: ``True`` builds one Gram matrix per
gamma into a shared (n_gamma, l, l) bank (the Gram kernel, one launch per
gamma, on the card) and the bank passes read their rows from it; ``False``
recomputes rows from ``X`` in the rbf passes and builds no Gram at all;
``None`` banks on the plain backend only, as the reference does on
``"jnp"``.  The ε-SVR grid's doubled lanes read the same base bank (the
H = 2 bank passes on the card).

``shrinking=True`` turns on soft active-set shrinking in the fused loop
(:func:`~repro_torch.core.solver_fused.solve_fused_batched_qp`); optima do
not change.  :func:`solve_grid_compacted` runs the grid in chunks and
compacts lanes, and with ``shrinking=True`` rows, between them
(:func:`~repro_torch.core.solver_fused.solve_fused_chunked_qp`).

``cfg.step == "conjugate"`` (with ``cfg.algorithm == "smo"``) runs every
driver's lanes with the Conjugate-SMO step (the conjugate variants of the
pass B kernels on the card); in :func:`solve_grid_compacted` each chunk
starts a fresh direction, as the reference's chunk seam does.

``diagnostics=`` (a :class:`repro_torch.telemetry.Diagnostics`) on the
fused drivers turns on the flight recorder: the call records its spans
(``fit``, ending in a phase event, ``fit.prep``, ``grid.bank``, the
loop's chunks; :mod:`repro_torch.telemetry.spans`), every lane's ring is
drained into the handle's sink keyed by its hyper-parameters in the
caller's order, and the (gamma, class, C) grids' ``trace``/``n_trace``
carry the Fig. 3 mu/mu* channel.  The classic ``impl=None`` drivers
refuse it, as the reference's do; ``telemetry.recording(diag)`` records
the spans of either engine, and :func:`grid_decision`'s ``decide``.

The fused engine does not track the per-step counters ``n_free`` /
``n_clipped`` / ``n_reverted``: they carry the ``UNTRACKED`` (-1)
sentinel, never zeros; the classic engine counts them.  ``n_free_sv``,
the free support vectors at the final ``alpha``, is reported for every
lane.

Axis convention for stacked results: ``(n_gamma, n_class, n_C, ...)``.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core import qp as qp_mod
from repro_torch.core import sharded_lanes, solver_fused
from repro_torch.core.solver import (SolveResult, SolverConfig,
                                     resolve_shrink_cfg, solve_lanes)
from repro_torch.core.solver_fused import (FusedResult, _pow2,
                                           solve_fused_chunked_qp)
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.kernels import ops, row_source
from repro_torch.telemetry import ring as ring_mod
from repro_torch.telemetry import spans

UNTRACKED = -1  # sentinel for counters the fused iteration never tracks


def sqdist(X: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances (l, l), the gamma-free part of the Gram
    work: ``K_gamma = exp(-gamma * sqdist(X))``."""
    sq = torch.sum(X * X, dim=-1)
    return torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (X @ X.T), 0.0)


def _free_sv_count(alpha, L, U) -> torch.Tensor:
    """Per-lane count of strictly interior (free) support vectors."""
    return torch.sum((alpha > L) & (alpha < U), dim=-1).to(torch.int32)


def _use_bank(impl: str, precompute, device) -> bool:
    """The row-source policy: ``None`` banks exactly on the plain backend."""
    if precompute is None:
        return ops.resolve_impl(impl, device) == "torch"
    return bool(precompute)


def _trace_fields(dims, dtype, device, ring=None) -> dict:
    """The trace/step-recording buffers of a fused-engine
    :class:`SolveResult`: placeholders, and when the flight recorder ran
    (``ring``, the grid-shaped ring) ``trace``/``n_trace`` carry its Fig. 3
    mu/mu* channel with the classic semantics: one entry an accepted
    planning step, the oldest kept at the cap, the count running on."""
    cap = tuple(dims) + (1,)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    fields = dict(trace=zeros(cap, dtype), n_trace=zeros(dims, torch.int32),
                  steps_i=zeros(cap, torch.int32),
                  steps_j=zeros(cap, torch.int32),
                  steps_mu=zeros(cap, dtype))
    if ring is not None:
        fields["trace"] = ring.ratio.to(dtype)
        fields["n_trace"] = ring.n_ratio
    return fields


def _ring_map(fn, ring):
    """``fn`` applied to every field of a ring."""
    return ring_mod.TelemetryRing(*(fn(getattr(ring, f))
                                    for f in ring_mod.FIELDS))


def _drain_grid_ring(diagnostics, ring, meta, result):
    """Flatten a grid-shaped ring to lanes and hand it to ``diagnostics``
    (a result without a field leaves it out of the lane events)."""
    ndim = result.iterations.ndim
    flat = _ring_map(lambda x: x.reshape((-1,) + x.shape[ndim:]), ring)
    flat_res = SimpleNamespace(**{
        k: getattr(result, k).reshape(-1)
        for k in ("iterations", "kkt_gap", "converged", "n_planning",
                  "n_unshrink") if getattr(result, k, None) is not None})
    return diagnostics.drain_ring(flat, meta, flat_res)


def _ring_config(diagnostics):
    return None if diagnostics is None else diagnostics.ring_config


def _lane_mesh(impl, mesh, devices):
    """The lane mesh of a sharded grid, or ``None`` without
    ``mesh``/``devices``; the classic engine (``impl=None``) refuses
    them."""
    if mesh is None and devices is None:
        return None
    if impl is None:
        raise ValueError("lane sharding runs on the fused engine: set impl "
                         "(e.g. impl='auto') with mesh/devices")
    return sharded_lanes.resolve_lane_mesh(mesh, devices)


def _check_classic_diagnostics(diagnostics):
    if diagnostics is not None:
        raise ValueError("diagnostics rides the fused engine: set impl "
                         "(e.g. impl='auto') with diagnostics")


def _as_data(X, device, dtype):
    """``X`` on the resolved device in the resolved dtype (that of a
    floating tensor ``X`` unless ``dtype`` is given)."""
    dev = resolve_device(device)
    if dtype is None and torch.is_tensor(X) and X.is_floating_point():
        dtype = X.dtype
    dtype = resolve_dtype(dtype)
    return torch.as_tensor(X, dtype=dtype, device=dev).contiguous(), dev


def _grid_inputs(X, Y, Cs, gammas, device, dtype):
    """The (C, gamma) grid's inputs: ``X`` and the (k, l) labels ``Y`` (a
    1-D ``y`` is one class head) on the resolved device and dtype, and
    the (n_C,), (n_gamma,) float64 axes."""
    X, dev = _as_data(X, device, dtype)
    Y = torch.as_tensor(Y, dtype=X.dtype, device=dev)
    if Y.ndim == 1:
        Y = Y[None, :]
    return (X, Y.contiguous(), np.asarray(Cs, dtype=np.float64).reshape(-1),
            np.asarray(gammas, dtype=np.float64).reshape(-1))


def _gram_bank(X, gammas, impl: str):
    """``ops.gram_bank``, as the span ``grid.bank`` while a recorder is
    active."""
    rec = spans.active()
    if rec is None:
        return ops.gram_bank(X, gammas, impl=impl)
    with rec.span("grid.bank", X.device):
        return ops.gram_bank(X, gammas, impl=impl)


def _bank_kw(X, gammas, lanes_per_gamma: int, impl: str) -> dict:
    """The shared (n_gamma, l, l) Gram bank and each lane's entry."""
    bank = _gram_bank(X, gammas, impl)
    gidx = torch.arange(len(gammas), device=X.device).repeat_interleave(
        lanes_per_gamma)
    return dict(gram=bank, gram_idx=gidx)


def _grid_lanes(X, Y, Cs, gammas):
    """The flat (gamma, class, C) lanes, row-major as the result axes:
    labels (B, l), box L and U (B, l), gammas (B,)."""
    k = Y.shape[0]
    nG, nC = len(gammas), len(Cs)
    dev, dtype = X.device, X.dtype
    Yf = Y.repeat(nG, 1).repeat_interleave(nC, dim=0)
    gf = torch.as_tensor(gammas, dtype=dtype,
                         device=dev).repeat_interleave(k * nC)
    Cf = torch.as_tensor(Cs, dtype=dtype, device=dev).repeat(nG * k)
    YC = Yf * Cf[:, None]
    return Yf, torch.clamp_max(YC, 0.0), torch.clamp_min(YC, 0.0), gf


def _grid_result(fr: FusedResult, L, U, dims, ring=None) -> SolveResult:
    """A flat :class:`FusedResult` as the grid's :class:`SolveResult`
    (``ring``: the grid-shaped ring, whose ratio channel fills
    ``trace``/``n_trace``)."""
    dev, dtype = fr.alpha.device, fr.alpha.dtype

    def to_grid(t):
        return t.reshape(dims + t.shape[1:])

    untracked = torch.full(dims, UNTRACKED, dtype=torch.int32, device=dev)
    return SolveResult(
        alpha=to_grid(fr.alpha), b=to_grid(fr.b), G=to_grid(fr.G),
        iterations=to_grid(fr.iterations), objective=to_grid(fr.objective),
        kkt_gap=to_grid(fr.kkt_gap), converged=to_grid(fr.converged),
        n_planning=to_grid(fr.n_planning), n_free=untracked,
        n_clipped=untracked, n_reverted=untracked,
        n_free_sv=to_grid(_free_sv_count(fr.alpha, L, U)),
        **_trace_fields(dims, dtype, dev, ring))


def _solve_grid_fused(X, Y, Cs, gammas, cfg, impl, precompute, shrinking,
                      chunk=None, diagnostics=None, mesh=None):
    """The flat (gamma, class, C) lanes through one fused loop, or with
    ``chunk`` through the chunked driver, which drops converged lanes and,
    with ``shrinking``, gathers the surviving rows between chunks (the
    reference's ``_compacted_fused_flat``); with a lane ``mesh`` sharded
    over its slabs.  With a ring in ``diagnostics`` returns
    ``(SolveResult, grid-shaped ring, flat FusedResult)``, else
    ``(SolveResult, None, flat FusedResult)``."""
    Yf, L, U, gf = _grid_lanes(X, Y, Cs, gammas)
    k = Y.shape[0]
    dims = (len(gammas), k, len(Cs))
    rc = _ring_config(diagnostics)
    kw = (_bank_kw(X, gammas, k * len(Cs), impl)
          if _use_bank(impl, precompute, X.device) else {})
    if chunk is None:
        solve = sharded_lanes.lane_solver(mesh)
        kw.update(telemetry=rc)
    else:
        solve = solve_fused_chunked_qp
        kw.update(chunk=chunk, diagnostics=diagnostics, mesh=mesh)
    fr = solve(X, Yf, L, U, gf, cfg, impl=impl, shrinking=shrinking, **kw)
    ring = None
    if rc is not None:
        fr, ring = fr
        ring = _ring_map(lambda x: x.reshape(dims + x.shape[1:]), ring)
    return _grid_result(fr, L, U, dims, ring), ring, fr


def _classic_lanes(X, Y, gammas):
    """The classic grid's (gamma, class) lanes: labels (B, l) and a
    :class:`~repro_torch.core.qp.StackedKernel` over the Gram bank (the
    Gram kernel on the card)."""
    k = Y.shape[0]
    bank = _gram_bank(X, gammas, "auto")
    g = torch.arange(len(gammas), dtype=torch.int32,
                     device=X.device).repeat_interleave(k)
    return Y.repeat(len(gammas), 1), qp_mod.StackedKernel(bank, g)


def _box(Y, C):
    YC = Y * C
    return torch.clamp_max(YC, 0.0), torch.clamp_min(YC, 0.0)


def _stack_c(results, dims) -> SolveResult:
    """Per-C lane-flat results as one (n_gamma, k, n_C, ...) result."""
    return SolveResult(**{f.name: torch.stack(
        [getattr(r, f.name) for r in results], dim=1).reshape(
        dims + getattr(results[0], f.name).shape[1:])
        for f in dataclasses.fields(SolveResult)})


def _solve_grid_classic(X, Y, Cs, gammas, cfg, warm_start) -> SolveResult:
    """The classic engine over the C axis in the (ascending) order of
    ``Cs``, each C one loop over the (gamma, class) lanes."""
    Yf, kern = _classic_lanes(X, Y, gammas)
    Cs_t = torch.as_tensor(Cs, dtype=X.dtype, device=X.device)
    # alpha = 0, G = y is the C-free cold start: the scaled carry maps it
    # to itself, so the first step is exact for any C_prev
    alpha, G, C_prev = torch.zeros_like(Yf), Yf, Cs_t[0]
    out = []
    for C in Cs_t:
        r = C / C_prev
        res = solve_lanes(kern, Yf, *_box(Yf, C), cfg, alpha * r,
                          (1.0 - r) * Yf + r * G)
        if warm_start:
            alpha, G, C_prev = res.alpha, res.G, C
        out.append(res)
    return _stack_c(out, (len(gammas), Y.shape[0], len(Cs)))


# step-type counters a chunked solve resumes across chunks (plain
# per-step sums, so the per-chunk values add up to solve_grid's)
_CHUNK_COUNTERS = ("iterations", "n_planning", "n_free", "n_clipped",
                   "n_reverted")


def _classic_buffers(kern, bsz: int, l: int, dtype) -> SimpleNamespace:
    """The buffers of a classic chunked round's cache entry (lane bucket
    ``bsz``): the lanes' oracle over the bank, whose index ``g`` the round
    writes, and their labels ``p`` and box ``L``, ``U`` (bsz, l)."""
    def zeros():
        return torch.zeros((bsz, l), dtype=dtype, device=kern.Ks.device)

    g = torch.zeros((bsz,), dtype=kern.g.dtype, device=kern.Ks.device)
    return SimpleNamespace(kernel=qp_mod.StackedKernel(kern.Ks, g),
                           p=zeros(), L=zeros(), U=zeros())


def _compacted_classic(X, Y, Cs_np, gammas_np, cfg, chunk) -> SolveResult:
    """The classic chunked grid: the C axis ascending with scaled warm
    starts, and within each C the (gamma, class) lanes solved ``chunk``
    iterations at a time, with the converged lanes dropped between chunks
    (lane counts bucketed to powers of two by repeating the first live
    lane).  Each chunk starts a fresh planning history; the carried alpha
    and G stay in float64 on the device.  The chunks of one lane bucket
    solve one loop over one set of buffers
    (:class:`~repro_torch.core.solver_fused._GraphCache`), so on the card
    they replay its CUDA graphs."""
    dev, dtype = X.device, X.dtype
    k, l = Y.shape
    nG, nC = len(gammas_np), len(Cs_np)
    B = nG * k
    Yf, kern = _classic_lanes(X, Y, gammas_np)
    Y64 = Yf.double()
    # never exceed the caller's budget: the last chunk may be partial
    ccfg = dataclasses.replace(cfg, max_iter=min(chunk, cfg.max_iter))
    order = np.argsort(Cs_np, kind="stable")
    alpha = torch.zeros((B, l), dtype=torch.float64, device=dev)
    G = Y64.clone()
    C_prev = float(Cs_np[order][0])

    def zeros(*shape, dt=torch.float64):
        return torch.zeros((B, nC) + shape, dtype=dt, device=dev)

    out = dict(alpha=zeros(l), G=zeros(l), b=zeros(), objective=zeros(),
               kkt_gap=zeros(), converged=zeros(dt=torch.bool),
               **{f: zeros(dt=torch.int64) for f in _CHUNK_COUNTERS})
    max_chunks = max(1, -(-cfg.max_iter // chunk))
    # the chunks' loops and CUDA graphs, one entry a lane bucket, shared
    # by the rounds of every C
    cache = solver_fused._GraphCache()
    for ci in order:
        C = float(Cs_np[ci])
        r = C / C_prev
        a_c = alpha * r                                  # scaled warm start
        g_c = (1.0 - r) * Y64 + r * G
        live = np.arange(B)
        for _ in range(max_chunks):
            n = len(live)
            bsz = _pow2(n)
            idx = torch.as_tensor(np.concatenate(
                [live, np.repeat(live[:1], bsz - n)]), device=dev)
            ent = cache.entry((bsz, dtype, ccfg),
                              lambda: _classic_buffers(kern, bsz, l, dtype))
            b = ent.bufs
            b.kernel.g.copy_(kern.g[idx])
            b.p.copy_(Yf[idx])
            for buf, v in zip((b.L, b.U), _box(b.p, C)):
                buf.copy_(v)
            with solver_fused._solving(ent):
                res = solve_lanes(b.kernel, b.p, b.L, b.U, ccfg,
                                  a_c[idx].to(dtype), g_c[idx].to(dtype))
            at = idx[:n]
            a_c[at] = res.alpha[:n].double()
            g_c[at] = res.G[:n].double()
            for f in _CHUNK_COUNTERS:
                out[f][at, ci] += getattr(res, f)[:n]
            for f in ("b", "objective", "kkt_gap", "converged"):
                out[f][at, ci] = getattr(res, f)[:n].to(out[f].dtype)
            live = live[~res.converged[:n].cpu().numpy()]
            if len(live) == 0:
                break
        out["alpha"][:, ci] = a_c
        out["G"][:, ci] = g_c
        alpha, G, C_prev = a_c, g_c, C

    YC = Y64[:, None, :] * torch.as_tensor(Cs_np, device=dev)[None, :, None]
    n_free_sv = _free_sv_count(out["alpha"], torch.clamp_max(YC, 0.0),
                               torch.clamp_min(YC, 0.0))
    dims = (nG, k, nC)

    def shape(t, dt):
        return t.reshape(dims + t.shape[2:]).to(dt)

    ints = dict(n_free_sv=shape(n_free_sv, torch.int32), **{
        f: shape(out[f], torch.int32) for f in _CHUNK_COUNTERS})
    return SolveResult(
        **{f: shape(out[f], dtype) for f in ("alpha", "b", "G", "objective",
                                             "kkt_gap")},
        converged=shape(out["converged"], torch.bool), **ints,
        **_trace_fields(dims, dtype, dev))


def _grid_meta(gammas_np, k, Cs_np):
    """The (gamma, class, C) lanes' keys, row-major as the result axes."""
    return [{"gamma": float(g), "label": int(c), "C": float(Cv)}
            for g in gammas_np for c in range(k) for Cv in Cs_np]


def solve_grid(X, Y, Cs, gammas, cfg: SolverConfig = SolverConfig(), *,
               warm_start: bool = True, impl: str | None = None,
               block_l: int = 1024, precompute: bool | None = None,
               shrinking: bool = False, mesh=None, devices=None,
               diagnostics=None, device=None, dtype=None) -> SolveResult:
    """Solve the full (gamma, class, C) grid.

    ``X``: (l, d) shared inputs; ``Y``: (k, l) signed label vectors (a 1-D
    ``y`` is one class head); ``Cs``: (n_C,); ``gammas``: (n_gamma,)
    (scalars are promoted).  Returns a :class:`SolveResult` whose leaves
    have leading axes ``(n_gamma, n_class, n_C)`` in the *input* order of
    ``Cs`` and ``gammas`` (the C axis is solved sorted and scattered back,
    as the reference does).

    ``impl=None`` (the default) runs the classic engine over the Gram
    bank, the C axis chained by scaled warm starts (``warm_start=False``:
    every C starts cold, the same optima in more iterations), with the
    per-step counters counted.  ``impl`` ``"cuda"``, ``"torch"`` or
    ``"auto"`` picks the kernels of the fused engine, where every lane
    starts cold and ``warm_start`` has no effect; ``precompute`` picks its
    row source (module notes).  ``device`` defaults to the CUDA card and
    raises without one; ``dtype`` defaults to ``X``'s when it is a
    floating tensor, else to ``torch.get_default_dtype()``.
    ``shrinking=True`` turns on soft shrinking (the classic engine's
    ``cfg.shrink_every`` cycle; the fused passes' masked scans); the
    optima do not change.  ``block_l`` is accepted and ignored: the CUDA
    passes tile the example axis at
    :data:`repro_torch.kernels.build.BLOCK_L`.  ``mesh``/``devices``
    (fused engine only; ``impl=None`` raises ``ValueError``) shard the
    flat lane batch over a lane mesh
    (:mod:`repro_torch.core.sharded_lanes`): a
    :class:`~repro_torch.launch.mesh.LaneMesh` with a ``data`` axis, or a
    device list (``devices=("cpu",) * 2`` on the CPU).

    ``diagnostics`` (a :class:`repro_torch.telemetry.Diagnostics`; fused
    engine only, ``impl=None`` raises ``ValueError``) turns on the flight
    recorder: the call records its spans (its ``fit`` span ends in a
    ``solve_grid_fused`` phase event), every lane's ring is drained into
    the handle's sink keyed by (gamma, class, C) in the caller's order,
    and ``trace``/``n_trace`` carry the Fig. 3 planning-ratio channel.
    """
    del block_l
    mesh = _lane_mesh(impl, mesh, devices)
    if impl is None:
        _check_classic_diagnostics(diagnostics)
    phase = "solve_grid_classic" if impl is None else "solve_grid_fused"
    with spans.fit_span(diagnostics, phase, resolve_device(device)) as sp:
        X, Y, Cs_np, gammas_np = _grid_inputs(X, Y, Cs, gammas, device,
                                              dtype)
        dev = X.device
        if sp is not None:
            sp.meta.update(lanes=len(gammas_np) * Y.shape[0] * len(Cs_np))
        order = np.argsort(Cs_np, kind="stable")
        ring = None
        if impl is None:
            res = _solve_grid_classic(
                X, Y, Cs_np[order], gammas_np,
                resolve_shrink_cfg(cfg, True) if shrinking else cfg,
                warm_start)
        else:
            res, ring, _ = _solve_grid_fused(
                X, Y, Cs_np[order], gammas_np, cfg,
                ops.resolve_impl(impl, dev), precompute, shrinking,
                diagnostics=diagnostics, mesh=mesh)
        if np.any(order != np.arange(len(Cs_np))):
            inv = torch.as_tensor(np.argsort(order, kind="stable"),
                                  device=dev)
            res = SolveResult(**{
                f.name: getattr(res, f.name).index_select(2, inv)
                for f in dataclasses.fields(res)})
            if ring is not None:
                ring = _ring_map(lambda x: x.index_select(2, inv), ring)
        if ring is not None:
            _drain_grid_ring(diagnostics, ring,
                             _grid_meta(gammas_np, Y.shape[0], Cs_np), res)
        return res


def solve_grid_oneclass(X, nus, gammas, cfg: SolverConfig = SolverConfig(),
                        *, impl: str = "auto", block_l: int = 1024,
                        precompute: bool | None = None,
                        shrinking: bool = False, mesh=None, devices=None,
                        diagnostics=None, device=None,
                        dtype=None) -> FusedResult:
    """Solve the one-class (gamma, nu) grid as one fused lane batch.

    Every lane is the nu dual (``p = 0``, box ``[0, 1/(nu l)]``,
    ``sum(a) = 1``) started from LIBSVM's feasible point with its gradient
    ``G0 = -K alpha0``: one matvec per lane, paid once before the loop,
    against the bank when there is one and blocked over rows of ``X``
    (:meth:`repro_torch.core.qp.RBFKernel.matvec`) when there is not.
    ``precompute``, ``impl``, ``shrinking``, ``device``, ``dtype`` and
    ``mesh``/``devices`` are as in :func:`solve_grid` (the deal's cost is
    the box width ``1/(nu l)``: the small-nu stragglers spread over the
    slabs); ``block_l`` is accepted and ignored.  ``diagnostics`` turns on
    the flight recorder as in :func:`solve_grid` (phase
    ``solve_grid_oneclass``, lanes keyed by (gamma, nu)).  Returns a
    :class:`~repro_torch.core.solver_fused.FusedResult` with leading axes
    ``(n_gamma, n_nu)``; the decision offset is ``rho = -b``.
    """
    del block_l
    mesh = _lane_mesh(impl, mesh, devices)
    with spans.fit_span(diagnostics, "solve_grid_oneclass",
                        resolve_device(device)) as sp:
        return _solve_oneclass(X, nus, gammas, cfg, impl, precompute,
                               shrinking, mesh, diagnostics, device, dtype,
                               sp)


def _solve_oneclass(X, nus, gammas, cfg, impl, precompute, shrinking, mesh,
                    diagnostics, device, dtype, sp) -> FusedResult:
    """The body of :func:`solve_grid_oneclass` inside its ``fit`` span
    ``sp`` (``None`` while nothing records)."""
    X, dev = _as_data(X, device, dtype)
    dtype = X.dtype
    l = X.shape[0]
    impl = ops.resolve_impl(impl, dev)
    nus_np = np.asarray(nus, np.float64).reshape(-1)
    gammas_np = np.asarray(gammas, np.float64).reshape(-1)
    nG, nN = len(gammas_np), len(nus_np)
    if sp is not None:
        sp.meta.update(lanes=nG * nN)
    A0 = torch.stack([qp_mod.oneclass_alpha0(l, nu, dtype, dev)
                      for nu in nus_np])                          # (nN, l)
    U_n = torch.stack([qp_mod.oneclass_qp(l, nu, dtype, dev).bounds.upper
                       for nu in nus_np])
    zeros = torch.zeros((nG * nN, l), dtype=dtype, device=dev)
    Uf = U_n.repeat(nG, 1)
    gf = torch.as_tensor(gammas_np, dtype=dtype,
                         device=dev).repeat_interleave(nN)
    alpha0 = A0.repeat(nG, 1)
    bank_kw = {}
    if _use_bank(impl, precompute, dev):
        bank_kw = _bank_kw(X, gammas_np, nN, impl)
        G0 = -row_source.bank_source(**bank_kw).matvec(alpha0)
    else:
        G0 = -torch.cat([torch.stack([qp_mod.make_rbf(X, g).matvec(a)
                                      for a in A0]) for g in gammas_np])
    rc = _ring_config(diagnostics)
    out = sharded_lanes.lane_solver(mesh)(
        X, zeros, zeros, Uf, gf, cfg, impl=impl, alpha0=alpha0, G0=G0,
        shrinking=shrinking, telemetry=rc, **bank_kw)
    if rc is not None:
        out, ring = out
        diagnostics.drain_ring(ring, [{"gamma": g, "nu": float(nu)}
                                      for g in gf[::nN].tolist()
                                      for nu in nus_np], out)
    return FusedResult(**{f.name: getattr(out, f.name).reshape(
        (nG, nN) + getattr(out, f.name).shape[1:])
        for f in dataclasses.fields(out)})


def solve_grid_svr(X, y, Cs, epsilons, gammas,
                   cfg: SolverConfig = SolverConfig(), *, impl: str = "auto",
                   block_l: int = 1024, precompute: bool | None = None,
                   shrinking: bool = False, mesh=None, devices=None,
                   diagnostics=None, device=None,
                   dtype=None) -> FusedResult:
    """Solve the ε-SVR (gamma, epsilon, C) grid as one fused lane batch.

    ``X``: (l, d); ``y``: (l,) real targets; ``Cs``: (n_C,); ``epsilons``:
    (n_eps,) tube widths; ``gammas``: (n_gamma,) (scalars are promoted).
    Every lane runs the doubled 2l-variable operator over the base ``X``
    (on the card the H = 2 passes, whose products stay l-wide); lane order
    is (gamma, epsilon, C) row-major.  ``precompute`` picks the row source
    as in :func:`solve_grid` (the base bank, read by the H = 2 bank passes
    on the card); ``shrinking=True`` masks each half of the doubled state
    on its own.  ``impl``, ``device``, ``dtype`` and ``mesh``/``devices``
    are as in :func:`solve_grid`; ``block_l`` is
    accepted and ignored.  ``diagnostics`` turns on the flight recorder as
    in :func:`solve_grid` (phase ``solve_grid_svr``, lanes keyed by
    (gamma, epsilon, C)).  Returns a
    :class:`~repro_torch.core.solver_fused.FusedResult` with leading axes
    ``(n_gamma, n_eps, n_C)``; ``alpha`` is the doubled (..., 2l) dual,
    folded to coefficients by :func:`repro_torch.core.qp.svr_fold`.
    """
    del block_l
    mesh = _lane_mesh(impl, mesh, devices)
    with spans.fit_span(diagnostics, "solve_grid_svr",
                        resolve_device(device)) as sp:
        return _solve_svr(X, y, Cs, epsilons, gammas, cfg, impl, precompute,
                          shrinking, mesh, diagnostics, device, dtype, sp)


def _solve_svr(X, y, Cs, epsilons, gammas, cfg, impl, precompute, shrinking,
               mesh, diagnostics, device, dtype, sp) -> FusedResult:
    """The body of :func:`solve_grid_svr` inside its ``fit`` span ``sp``
    (``None`` while nothing records)."""
    X, dev = _as_data(X, device, dtype)
    dtype = X.dtype
    impl = ops.resolve_impl(impl, dev)
    y = torch.as_tensor(y, dtype=dtype, device=dev).reshape(-1)
    l = y.shape[0]
    gammas_np = np.asarray(gammas, np.float64).reshape(-1)
    Cs_t, eps_t, gam_t = (
        torch.as_tensor(np.asarray(v, np.float64).reshape(-1), dtype=dtype,
                        device=dev) for v in (Cs, epsilons, gammas_np))
    nG, nE, nC = len(gam_t), len(eps_t), len(Cs_t)
    if sp is not None:
        sp.meta.update(lanes=nG * nE * nC)
    zl = torch.zeros((nC, l), dtype=dtype, device=dev)
    # P varies along epsilon, the box along C
    P_e = torch.cat([y[None, :] - eps_t[:, None],
                     y[None, :] + eps_t[:, None]], dim=1)      # (nE, 2l)
    Pf = P_e.repeat_interleave(nC, dim=0).repeat(nG, 1)        # (B, 2l)
    L_c = torch.cat([zl, -Cs_t[:, None] + zl], dim=1)          # (nC, 2l)
    U_c = torch.cat([Cs_t[:, None] + zl, zl], dim=1)
    Lf, Uf = L_c.repeat(nG * nE, 1), U_c.repeat(nG * nE, 1)
    gf = gam_t.repeat_interleave(nE * nC)
    bank_kw = (_bank_kw(X, gammas_np, nE * nC, impl)
               if _use_bank(impl, precompute, dev) else {})
    rc = _ring_config(diagnostics)
    out = sharded_lanes.lane_solver(mesh)(
        X, Pf, Lf, Uf, gf, cfg, impl=impl, doubled=True, shrinking=shrinking,
        telemetry=rc, **bank_kw)
    if rc is not None:
        out, ring = out
        # lane order (gamma, epsilon, C) row-major, as the result axes
        diagnostics.drain_ring(
            ring, [{"gamma": float(g), "epsilon": float(e), "C": float(Cv)}
                   for g in gam_t.tolist() for e in eps_t.tolist()
                   for Cv in Cs_t.tolist()], out)
    return FusedResult(**{f.name: getattr(out, f.name).reshape(
        (nG, nE, nC) + getattr(out, f.name).shape[1:])
        for f in dataclasses.fields(out)})


def solve_grid_compacted(X, Y, Cs, gammas, cfg: SolverConfig = SolverConfig(),
                         *, chunk: int = 96, impl: str | None = None,
                         block_l: int = 1024, precompute: bool | None = None,
                         shrinking: bool = False, mesh=None, devices=None,
                         diagnostics=None, device=None,
                         dtype=None) -> SolveResult:
    """The (gamma, class, C) grid of :func:`solve_grid`, run in chunks of
    ``chunk`` iterations and compacted between them, so converged lanes
    stop costing time.

    ``impl=None`` (the default) runs the classic engine: the C axis
    ascending with scaled warm starts, each C's (gamma, class) lanes in
    chunks over the Gram bank, the converged lanes dropped between chunks
    and the live ones bucketed to a power of two; the per-step counters
    add up over chunks and each chunk starts a fresh planning history.
    ``shrinking=True`` there turns on the ``cfg.shrink_every`` cycle in
    each chunk.  A kernel backend ``impl`` runs the fused branch: every
    (gamma, class, C) point is a cold-started lane in the flat layout, the
    result axes follow the *input* order of ``Cs`` and ``gammas``, and
    ``precompute`` picks the row source as in :func:`solve_grid` (the bank
    is sliced to the kept rows per chunk).  ``shrinking=True`` adds hard
    row compaction with an exact rebuild of G and a full-set KKT check
    before any lane retires (unshrink events counted per lane), and soft
    shrinking inside each chunk.  ``n_free``/``n_clipped``/``n_reverted``
    carry the ``UNTRACKED`` sentinel, ``n_free_sv`` the free SVs.
    ``device``, ``dtype``, ``block_l`` and ``mesh``/``devices`` are as in
    :func:`solve_grid` (fused branch only): every chunk is lane-sharded,
    the compaction stays on the host between chunks.

    ``diagnostics`` (fused branch only; ``impl=None`` raises
    ``ValueError``) turns on the flight recorder: the call records its
    spans as :func:`solve_grid` does (phase ``solve_grid_compacted``), the
    chunked driver's rounds among them, and emits a ``chunk_solve`` phase
    event a round and ``straggler_warning`` events, the chunks' rings are
    merged into run-wide per-lane series, and ``trace``/``n_trace`` carry
    the Fig. 3 planning-ratio channel as in :func:`solve_grid`.
    """
    del block_l
    mesh = _lane_mesh(impl, mesh, devices)
    if impl is None:
        _check_classic_diagnostics(diagnostics)
    with spans.fit_span(diagnostics, "solve_grid_compacted",
                        resolve_device(device)) as sp:
        X, Y, Cs_np, gammas_np = _grid_inputs(X, Y, Cs, gammas, device,
                                              dtype)
        if sp is not None:
            sp.meta.update(lanes=len(gammas_np) * Y.shape[0] * len(Cs_np))
        if impl is None:
            return _compacted_classic(
                X, Y, Cs_np, gammas_np,
                resolve_shrink_cfg(cfg, True) if shrinking else cfg, chunk)
        impl = ops.resolve_impl(impl, X.device)
        res, ring, fr = _solve_grid_fused(X, Y, Cs_np, gammas_np, cfg, impl,
                                          precompute, shrinking, chunk,
                                          diagnostics, mesh)
        if ring is not None:
            # no C sort on this path: the lanes are in the caller's order
            _drain_grid_ring(diagnostics, ring,
                             _grid_meta(gammas_np, Y.shape[0], Cs_np),
                             SimpleNamespace(
                                 iterations=res.iterations,
                                 kkt_gap=res.kkt_gap,
                                 converged=res.converged,
                                 n_planning=res.n_planning,
                                 n_unshrink=fr.n_unshrink.reshape(
                                     res.iterations.shape)))
        return res


def grid_decision(Xq, X, gammas, alpha: torch.Tensor, b: torch.Tensor, *,
                  impl: str = "auto") -> torch.Tensor:
    """Decision values of every grid point on query inputs.

    ``alpha``: (n_gamma, k, n_C, l) signed duals from :func:`solve_grid`;
    ``b``: (n_gamma, k, n_C).  ``Xq`` (m, d) and ``X`` (l, d) move to
    ``alpha``'s device and dtype.  Returns (n_gamma, k, n_C, m): the query
    cross-Gram is computed once per gamma (the Gram kernel on the card)
    and shared by all (class, C) heads.  While a recorder is active the
    call is its span ``decide``.
    """
    dev, dtype = alpha.device, alpha.dtype
    with spans.decide_span(None, dev):
        Xq = torch.as_tensor(Xq, dtype=dtype, device=dev).contiguous()
        X = torch.as_tensor(X, dtype=dtype, device=dev).contiguous()
        gammas_np = np.asarray(gammas, np.float64).reshape(-1)
        out = []
        for g, gamma in enumerate(gammas_np):
            Kq = ops.gram(Xq, X, float(gamma), impl=impl, device=dev,
                          dtype=dtype)                       # (m, l)
            out.append(torch.einsum("ml,kcl->kcm", Kq, alpha[g])
                       + b[g][..., None])
        return torch.stack(out)
