"""Lane-sharded fused engine (``repro.core.sharded_lanes``): the flat lane
batch split into slabs, one slab a device of a lane mesh.

The batched engine (:func:`repro_torch.core.solver_fused.
solve_fused_batched_qp`) advances every lane in one loop on one device.
Lanes are independent: every per-iteration quantity of lane b (selection,
step, planning history, freezing, the shrink mask) is a function of lane
b's state alone, and the shared operands, ``X`` and the optional Gram
bank, are read only.  So the lane axis shards with no communication in
the loop: each slab runs the batched engine, unchanged, on its own device
and stops when its own lanes have converged.

* **cost-balanced round-robin** (:func:`lane_schedule`): big-C lanes
  iterate longest, so the lanes are dealt round-robin in descending box
  width (``max(U - L)``: C for classification and ε-SVR lanes, ``1/(nu
  l)`` for one-class lanes), the caller's index breaking ties; the
  inverse permutation restores the caller's lane order when the results
  are gathered.
* **pad lanes** (:func:`pad_lanes`): the batch pads to a multiple of the
  slab count with ``L = U = 0`` lanes, which converge at t = 0 and which
  every pass leaves bitwise as they are; they are stripped from every
  returned field.

Each slab's lanes, and ``X`` and the bank replicated, are copied to the
slab's device; the slabs run concurrently, one host thread a distinct
device (a graph replay and a synchronisation release the interpreter
lock), each on the stream its device had in the caller's thread; slabs
on one device run one after another in its thread.  In a chunked
driver's round (:func:`repro_torch.core.solver_fused._solving`) each slab
solves in a cache entry of its own (:meth:`repro_torch.core.
solver_fused._Entry.slab`), which its thread enters itself.  Every result
field, and every ring field with ``telemetry``, comes back to the
caller's device in the caller's lane order.

A lane's arithmetic does not depend on where it sits in its batch: on
one slab the deal permutes the lanes and the result is bitwise that of
the batched engine.  Slabs of another lane count than the whole batch
may take other rounding paths in the plain versions' products (a product
of one query row, say), and then stop at other eps-optimal points: the
objectives agree to the solver's tolerance, not bitwise.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
from types import SimpleNamespace

import torch

from repro_torch.core import solver_fused
from repro_torch.core.solver import SolverConfig
from repro_torch.core.solver_fused import FusedResult
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.launch.mesh import LaneMesh, make_lane_mesh
from repro_torch.telemetry import ring as ring_mod
from repro_torch.telemetry.ring import RingConfig, TelemetryRing


def resolve_lane_mesh(mesh: LaneMesh | None = None, devices=None,
                      axis: str = "data", home=None) -> LaneMesh:
    """The lane mesh: an explicit ``mesh`` (which must have ``axis``), else
    a 1-D mesh over ``devices``; by default every CUDA device, or ``home``
    alone when the caller's data lies on the CPU."""
    if mesh is not None:
        if not isinstance(mesh, LaneMesh):
            raise TypeError(f"mesh must be a LaneMesh "
                            f"(repro_torch.launch.mesh), got "
                            f"{type(mesh).__name__}")
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no {axis!r} axis: {mesh.shape}")
        if devices is not None:
            raise ValueError("pass either mesh or devices, not both")
        return mesh
    if devices is None and home is not None and torch.device(
            home).type == "cpu":
        devices = (home,)
    return make_lane_mesh(devices, axis=axis)


def lane_solver(mesh: LaneMesh | None):
    """The lane engine of a driver: the batched engine without a ``mesh``,
    else :func:`solve_fused_sharded_qp` over it (the same signature)."""
    if mesh is None:
        return solver_fused.solve_fused_batched_qp
    return functools.partial(solve_fused_sharded_qp, mesh=mesh)


def lane_schedule(cost: torch.Tensor, n_shards: int):
    """Cost-balanced round-robin lane permutation for ``n_shards`` slabs.

    ``cost`` (B,) is each lane's straggler proxy; B must be a multiple of
    ``n_shards``.  Returns int64 ``(order, inv)``: ``lanes[order]`` lays
    the batch out slab-major, so contiguous slab p holds the lanes at
    descending-cost ranks ``p, p + n_shards, ...`` (a stable sort: equal
    costs keep the caller's order); ``inv`` undoes it
    (``result[order][inv] == result``).
    """
    B = cost.shape[0]
    if B % n_shards:
        raise ValueError(f"{B} lanes do not deal evenly over {n_shards} "
                         f"slabs: pad them first (pad_lanes)")
    srt = torch.sort(-cost, stable=True).indices
    order = srt.reshape(B // n_shards, n_shards).T.reshape(-1)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(B, device=order.device)
    return order, inv


def pad_lanes(A: torch.Tensor, pad: int, value=0.0) -> torch.Tensor:
    """``A`` with ``pad`` inert lanes appended along axis 0 (the ``L = U =
    0`` convention: every padded quantity is ``value``, 0 but for
    gamma)."""
    if pad == 0:
        return A
    return torch.cat([A, A.new_full((pad,) + tuple(A.shape[1:]), value)])


def _group(devices) -> list:
    """The slabs each host thread runs: one list of slab indices a
    distinct device, in order of first appearance."""
    out = {}
    for p, dev in enumerate(devices):
        out.setdefault(dev, []).append(p)
    return list(out.values())


@contextlib.contextmanager
def _on(dev, stream):
    """The slab's device and stream as the current ones (CUDA only)."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


def _solve_slab(p: int, job, cfg, kw):
    """Slab ``p``: the batched engine on the slab's device, in the slab's
    cache entry when a chunked round runs (``job.entry``)."""
    del p
    entry = (contextlib.nullcontext() if job.entry is None
             else solver_fused._solving(job.entry))
    with _on(job.device, job.stream), entry:
        return solver_fused.solve_fused_batched_qp(
            job.X, job.P, job.L, job.U, job.gam, cfg, alpha0=job.alpha0,
            G0=job.G0, gram=job.gram, gram_idx=job.gidx, **kw)


def _run(jobs, cfg, kw) -> list:
    """Every slab's result, in slab order: the slabs of a device one after
    another, distinct devices in threads of their own."""
    groups = _group([j.device for j in jobs])

    def run(group):
        return [(p, _solve_slab(p, jobs[p], cfg, kw)) for p in group]

    if len(groups) == 1:
        done = run(groups[0])
    else:
        with concurrent.futures.ThreadPoolExecutor(len(groups)) as ex:
            futs = [ex.submit(run, g) for g in groups]
            concurrent.futures.wait(futs)
        errs = [f.exception() for f in futs]
        for e in errs:
            if e is not None:
                raise e
        done = [r for f in futs for r in f.result()]
    return [r for _, r in sorted(done, key=lambda pr: pr[0])]


class _Replicas:
    """``X`` and the bank on each slab's device: the caller's own tensors
    on its device, one copy a device elsewhere.  In a chunked round the
    copies are the cache's buffers, written once a round."""

    def __init__(self, home, parent):
        self.home, self.parent, self.made = home, parent, {}

    def __call__(self, name, t, dev):
        if t is None or dev == self.home:
            return t
        if (name, dev) not in self.made:
            if self.parent is None or self.parent.cache is None:
                buf = t.to(dev)
            else:
                buf = self.parent.cache.slice(
                    ("replica", name, tuple(t.shape), t.dtype, dev),
                    lambda: torch.empty_like(t, device=dev))
                buf.copy_(t)
            self.made[(name, dev)] = buf
        return self.made[(name, dev)]


def _jobs(X, slabs, gram, devices, parent, batch) -> list:
    """Each slab's inputs on its device: the lanes' values (``slabs``, one
    dict a slab), ``X`` and the bank replicated, and ``batch``, the shape
    of the whole lane state.  Outside a chunked round they are copies; in
    one (``parent``, the round's cache entry) the lane values are written
    into the slab entry's buffers, which its captured graphs read."""
    home = X.device
    replica = _Replicas(home, parent)
    jobs = []
    for p, (dev, lanes) in enumerate(zip(devices, slabs)):
        job = SimpleNamespace(
            device=dev, batch=batch, X=replica("X", X, dev),
            gram=replica("gram", gram, dev), entry=None,
            stream=(torch.cuda.current_stream(dev) if dev.type == "cuda"
                    else None),
            alpha0=None, G0=None, gidx=None)
        warm = {k: lanes.pop(k) for k in ("alpha0", "G0") if k in lanes}
        job.__dict__.update({k: v.to(dev) for k, v in warm.items()})
        if parent is None:
            job.__dict__.update({k: v.to(dev) for k, v in lanes.items()})
        else:
            job.entry = parent.slab(p, dev, lambda: {
                k: torch.empty_like(v, device=dev)
                for k, v in lanes.items()})
            for k, v in lanes.items():
                job.entry.bufs[k].copy_(v)
            job.__dict__.update(job.entry.bufs)
        jobs.append(job)
    return jobs


def _solve_sharded(X, P, L, U, gamma, cfg, mesh, impl, alpha0, G0, gram,
                   gram_idx, doubled, shrinking, check_every, telemetry):
    devices = mesh.devices
    n_slabs = len(devices)
    dtype, home = P.dtype, P.device
    B, n = P.shape
    L = torch.as_tensor(L, dtype=dtype, device=home).broadcast_to((B, n))
    U = torch.as_tensor(U, dtype=dtype, device=home).broadcast_to((B, n))
    gamma = torch.as_tensor(gamma, dtype=dtype,
                            device=home).reshape(-1).broadcast_to((B,))

    # ---- pad to a multiple of the slab count (frozen L = U = 0 lanes) ----
    pad = (-B) % n_slabs
    lanes = dict(P=pad_lanes(P, pad), L=pad_lanes(L, pad),
                 U=pad_lanes(U, pad), gam=pad_lanes(gamma, pad, 1.0))
    if alpha0 is not None:
        for k, v in (("alpha0", alpha0), ("G0", G0)):
            lanes[k] = pad_lanes(torch.as_tensor(v, dtype=dtype,
                                                 device=home), pad)
    if gram is not None:
        lanes["gidx"] = pad_lanes(torch.as_tensor(
            gram_idx, dtype=torch.int64, device=home), pad, 0)

    # ---- cost-balanced round-robin deal: pads have width 0, sort last ----
    order, inv = lane_schedule((lanes["U"] - lanes["L"]).amax(dim=1),
                               n_slabs)
    per = (B + pad) // n_slabs
    slabs = [{k: v.index_select(0, order[p * per:(p + 1) * per])
              for k, v in lanes.items()} for p in range(n_slabs)]
    jobs = _jobs(X, slabs, gram, devices, solver_fused._ROUND.get(),
                 (B, n))
    outs = _run(jobs, cfg, dict(impl=impl, doubled=doubled,
                                shrinking=shrinking, check_every=check_every,
                                telemetry=telemetry))

    # ---- gather back: undo the deal, strip the pad lanes ------------------
    back = inv[:B]

    def gather(leaves):
        return torch.cat([x.to(home) for x in leaves]).index_select(0, back)

    if telemetry is None:
        return FusedResult(*(gather([getattr(r, f.name) for r in outs])
                             for f in dataclasses.fields(FusedResult)))
    res = FusedResult(*(gather([getattr(r, f.name) for r, _ in outs])
                        for f in dataclasses.fields(FusedResult)))
    return res, TelemetryRing(*(gather([getattr(g, f) for _, g in outs])
                                for f in ring_mod.FIELDS))


def solve_fused_sharded_qp(X, P, L, U, gamma,
                           cfg: SolverConfig = SolverConfig(), *,
                           mesh: LaneMesh | None = None, devices=None,
                           axis: str = "data", impl: str = "auto",
                           block_l: int = 1024, alpha0=None, G0=None,
                           gram=None, gram_idx=None, doubled: bool = False,
                           shrinking: bool = False,
                           check_every: int = solver_fused.CHECK_EVERY,
                           telemetry: RingConfig | None = None):
    """Lane-sharded :func:`~repro_torch.core.solver_fused.
    solve_fused_batched_qp`.

    The problem layout and the result are the batched engine's: B general
    dual QP lanes over the shared ``X`` (tensors on one device, the
    caller's, with one dtype; ``P``/``L``/``U`` per lane, per-lane
    ``gamma``, optional warm starts, the optional Gram bank, the doubled
    ε-SVR operator, soft shrinking, ``cfg.step="conjugate"``).  The lanes
    are dealt over the slabs of ``mesh`` (which must have ``axis``), or of
    a mesh over ``devices`` (default: every CUDA device); each slab runs
    the batched engine on its device (module notes).  Results come back on
    the caller's device in the caller's lane order, pad lanes stripped.
    ``impl`` resolves on each slab's device; ``block_l`` is accepted and
    ignored, as in the batched engine.  ``telemetry`` (a
    :class:`~repro_torch.telemetry.ring.RingConfig`) turns on each slab's
    flight recorder; the rings are gathered like the results and the
    return value is ``(FusedResult, TelemetryRing)``.
    """
    del block_l
    if (alpha0 is None) != (G0 is None):
        raise ValueError("warm starts need the (alpha0, G0) pair")
    if (gram is None) != (gram_idx is None):
        raise ValueError("the Gram bank needs the (gram, gram_idx) pair")
    mesh = resolve_lane_mesh(mesh, devices, axis)
    return _solve_sharded(X, P, L, U, gamma, cfg, mesh, impl, alpha0, G0,
                          gram, gram_idx, doubled, shrinking, check_every,
                          telemetry)


def solve_fused_sharded(X, Y, C, gamma, cfg: SolverConfig = SolverConfig(),
                        *, mesh: LaneMesh | None = None, devices=None,
                        axis: str = "data", impl: str = "auto",
                        block_l: int = 1024, alpha0=None, G0=None,
                        gram=None, gram_idx=None, device=None, dtype=None,
                        shrinking: bool = False,
                        check_every: int = solver_fused.CHECK_EVERY,
                        telemetry: RingConfig | None = None):
    """Lane-sharded classification batch: the ``p = y`` instance of
    :func:`solve_fused_sharded_qp`, as :func:`~repro_torch.core.
    solver_fused.solve_fused_batched` is of the batched engine.

    An entry point: ``X`` (l, d) and ``Y`` (B, l) move to ``device`` (the
    CUDA card by default, raising without one; ``device="cpu"`` for the
    CPU), where the results come back; ``dtype`` defaults to ``Y``'s when
    it is a floating tensor.  ``C`` is a scalar, (B,) per-lane or (B, l)
    per-sample budgets.  The bank moves to ``device`` and ``dtype`` too.
    """
    dev = resolve_device(device)
    if dtype is None and torch.is_tensor(Y) and Y.is_floating_point():
        dtype = Y.dtype
    dtype = resolve_dtype(dtype)
    X = torch.as_tensor(X, dtype=dtype, device=dev).contiguous()
    Y = torch.as_tensor(Y, dtype=dtype, device=dev).contiguous()
    B = Y.shape[0]
    C = torch.as_tensor(C, dtype=dtype, device=dev)
    if C.ndim < 2:
        C = C.broadcast_to((B,))[:, None]
    YC = Y * C
    if gram is not None:
        gram = torch.as_tensor(gram, dtype=dtype, device=dev).contiguous()
    return solve_fused_sharded_qp(
        X, Y, torch.clamp_max(YC, 0.0), torch.clamp_min(YC, 0.0), gamma, cfg,
        mesh=mesh, devices=devices, axis=axis, impl=impl, block_l=block_l,
        alpha0=alpha0, G0=G0, gram=gram, gram_idx=gram_idx,
        shrinking=shrinking, check_every=check_every, telemetry=telemetry)
