"""Dispatch audit: the aten ops of the port's loop bodies, recorded and
checked on the CPU path.

The counterpart of the reference's ``jaxpr_audit``.  A loop body of the
port is Python that issues PyTorch ops, and on the card a CUDA graph
replays whatever ops it issued at capture.  So the audit records the ops
themselves: a :class:`~torch.utils._python_dispatch.TorchDispatchMode`
sees each aten op (its name and output dtypes) of one call of a loop
body, on the CPU path (the plain versions of the kernels), at a tiny size.
The body is taken from the running solver: a stand-in for
:func:`repro_torch.core.solver_fused._drive` keeps the body and the
starting state it is handed, and stops the solve.  The entries of
:data:`MATRIX` follow the reference's (``jaxpr_audit.MATRIX``).  Four
audits:

* **(a) dtype** — with float32 inputs no op of the whole entry-point run
  outputs float64, except where a host driver that carries float64 state
  by design issues it (:data:`F64_DRIVERS`: the chunked driver's exact
  state, the classic compacted grid's alpha/G); and the working-set
  indices a body hands the kernel wrappers of
  :mod:`repro_torch.kernels.ops` are int32 (the Gram bank's lane table is
  int64 by design).
* **(b) host reads** — no op in a body call reads the host
  (:data:`HOST_READ_OPS`, or a copy from the card to the host): a graph
  would freeze the value it read at capture.  The counterpart of the
  reference's ``audit_callbacks``.
* **(c) invariance** — a body's op multiset is the same for B in {2, 3,
  7}, l in {16, 40} and two (C, gamma) value sets: the kernels an
  iteration launches must not scale with the lanes, the rows or the
  values.  The counterpart of the reference's recompile-guard probes of
  values and shapes.
* **(d) census** — :func:`emit_census` writes each entry's op and dtype
  counts and its carried state's shapes as JSON, with
  ``torch.__version__``.

No structural golden is stored.  The reference's four goldens pinned the
jax version they were written on and went red once the installed jax
moved past it; audit (c), which compares a body with itself across shapes
and values, and ``chip_smoke.py``'s kernels an iteration on the card
serve the same purpose without pinning a version.
"""

from __future__ import annotations

import collections
import inspect
import json
import os
import pathlib
import sys

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.report import Finding

AUDIT_B, AUDIT_L, AUDIT_D = 3, 16, 4
# audit (c): the lane counts, example counts and (C, gamma) value sets a
# body must issue the same ops over
SHAPES = tuple((B, l) for B in (2, 3, 7) for l in (16, 40))
VALUES = ((2.0, 0.5), (0.3, 1.7))
MAX_ITER = 200

HOST_READ_OPS = ("aten._local_scalar_dense", "aten.nonzero",
                 "aten.is_nonzero", "aten.equal", "aten.masked_select")
COPY_OPS = ("aten._to_copy", "aten.copy_", "aten._copy_from")
# host drivers whose float64 ops are their state by design: (file under
# src/repro_torch, function); the functions nested in them count too
F64_DRIVERS = (("core/solver_fused.py", "solve_fused_chunked_qp"),
               ("core/grid.py", "_compacted_classic"))
# the solvers, through which a driver's float64 may not pass
SOLVE_FRAMES = ("solve_fused_batched_qp", "_batched_loop", "solve_lanes",
                "_classic_loop", "_make_body", "_drive")
# the kernel wrappers' working-set index arguments (int32 at every kernel
# boundary, kernels/ops.py)
INDEX_ARGS = {"rbf_row_wss": ("i_idx",),
              "rbf_row_wss_batched": ("i_idx",),
              "row_wss_batched_bank": ("i_idx",),
              "update_wss_batched_bank": ("i_idx", "j_idx")}

PORT = pathlib.Path(__file__).resolve().parents[1]      # src/repro_torch
ANALYSIS = pathlib.Path(__file__).resolve().parent


def _port_frames():
    """(file under src/repro_torch, qualified function, line) of every
    port frame outside this package on the stack of the running op,
    innermost first."""
    out, frame = [], sys._getframe(2)
    while frame is not None:
        path = pathlib.Path(frame.f_code.co_filename)
        if PORT in path.parents and ANALYSIS not in path.parents:
            out.append((path.relative_to(PORT).as_posix(),
                        frame.f_code.co_qualname, frame.f_lineno))
        frame = frame.f_back
    return out


def _f64_allowed(frames) -> bool:
    """A float64 op is a host driver's when, going out from where it was
    issued, a driver of :data:`F64_DRIVERS` comes before any solver
    (:data:`SOLVE_FRAMES`): the driver's own work and the helpers it
    calls, not the chunk solves it runs in the caller's dtype."""
    for f, qual, _ in frames:
        if any(f == df and (qual == fn or qual.startswith(fn + "."))
               for df, fn in F64_DRIVERS):
            return True
        if qual.split(".")[0] in SOLVE_FRAMES:
            return False
    return False


class OpRecorder(TorchDispatchMode):
    """Records every aten op as (name, output dtypes) in ``ops``, the
    float64 outputs no host driver issued in ``f64`` (name, site), and the
    host reads in ``host_reads`` (name)."""

    def __init__(self):
        super().__init__()
        self.ops, self.f64, self.host_reads = [], [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        outs = [t for t in pytree.tree_leaves(out) if torch.is_tensor(t)]
        dts = tuple(str(t.dtype).removeprefix("torch.") for t in outs)
        self.ops.append((name, dts))
        if "float64" in dts:
            frames = _port_frames()
            if not _f64_allowed(frames):
                self.f64.append((name, frames[0] if frames else None))
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if torch.is_tensor(t)]
        if name in HOST_READ_OPS or (
                name in COPY_OPS and any(t.is_cuda for t in ins)
                and any(not t.is_cuda for t in outs)):
            self.host_reads.append(name)
        return out


# ---------------------------------------------------------------------------
# the matrix: tiny problems through the port's entry points
# ---------------------------------------------------------------------------


def _problem(B, l, values, dtype, seed=0):
    """X (l, d), labels Y (B, l), the box of C and the lanes' gamma."""
    C, gamma = values
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.normal(size=(l, AUDIT_D)), dtype=dtype)
    Y = torch.as_tensor(np.where(rng.normal(size=(B, l)) > 0, 1.0, -1.0),
                        dtype=dtype)
    YC = Y * C
    gam = torch.full((B,), gamma, dtype=dtype)
    return X, Y, torch.clamp_max(YC, 0.0), torch.clamp_min(YC, 0.0), gam


def _cfg(**kw):
    from repro_torch.core.solver import SolverConfig
    return SolverConfig(eps=1e-3, max_iter=MAX_ITER, **kw)


def _fused(cfg_kw, bank=False, doubled=False, **kw):
    def make(B, l, values, dtype):
        from repro_torch.core import qp as qp_mod
        from repro_torch.core.solver_fused import solve_fused_batched_qp
        from repro_torch.kernels import ops
        X, P, L, U, gam = _problem(B, l, values, dtype)
        if doubled:
            rng = np.random.default_rng(1)
            y = torch.as_tensor(rng.normal(size=(l,)), dtype=dtype)
            qp = qp_mod.svr_qp(y, values[0], 0.1)
            P, L, U = (v.broadcast_to((B, 2 * l)).contiguous()
                       for v in (qp.p, qp.bounds.lower, qp.bounds.upper))
        args = dict(kw)
        if bank:
            args.update(gram=ops.gram_bank(X, [values[1]], impl="torch"),
                        gram_idx=torch.zeros((B,), dtype=torch.int64))
        cfg = _cfg(**cfg_kw)
        return lambda: solve_fused_batched_qp(
            X, P, L, U, gam, cfg, impl="torch", doubled=doubled, **args)
    return make


def _classic(cfg_kw):
    def make(B, l, values, dtype):
        from repro_torch.core import qp as qp_mod
        from repro_torch.core.solver import solve
        from repro_torch.kernels import ops
        X, Y, _, _, _ = _problem(B, l, values, dtype)
        kern = qp_mod.PrecomputedKernel(ops.gram(
            X, X, values[1], impl="torch", device="cpu", dtype=dtype))
        C = torch.tensor(values[0], dtype=dtype)
        cfg = _cfg(**cfg_kw)
        return lambda: solve(kern, Y, C, cfg, device="cpu", dtype=dtype)
    return make


def _chunked(B, l, values, dtype):
    from repro_torch.core.solver_fused import solve_fused_chunked_qp
    X, P, L, U, gam = _problem(B, l, values, dtype)
    cfg = _cfg()
    return lambda: solve_fused_chunked_qp(X, P, L, U, gam, cfg, impl="torch",
                                          chunk=16, shrinking=True)


def _sharded(B, l, values, dtype):
    """The plain fused lanes dealt over two slabs on the CPU: the audit
    sees the first slab's body, which must be the batched engine's."""
    from repro_torch.core.sharded_lanes import solve_fused_sharded_qp
    X, P, L, U, gam = _problem(B, l, values, dtype)
    cfg = _cfg(algorithm="smo")
    return lambda: solve_fused_sharded_qp(X, P, L, U, gam, cfg,
                                          devices=("cpu", "cpu"),
                                          impl="torch")


def _telemetry(B, l, values, dtype):
    from repro_torch.telemetry import RingConfig
    return _fused({}, telemetry=RingConfig(sample_every=8))(B, l, values,
                                                            dtype)


# name -> (make(B, l, (C, gamma), dtype), which builds the problem and
# returns the entry point's call; the refresh flag the body is called with)
MATRIX = {
    "plain": (_fused(dict(algorithm="smo")), False),
    "plain_shrink": (_fused(dict(algorithm="smo"), shrinking=True), True),
    "conjugate": (_fused(dict(algorithm="smo", step="conjugate")), False),
    "pasmo": (_fused(dict(algorithm="pasmo")), False),
    "telemetry": (_telemetry, False),
    "doubled": (_fused(dict(algorithm="smo"), doubled=True), False),
    "bank": (_fused(dict(algorithm="smo"), bank=True), False),
    "classic_smo": (_classic(dict(algorithm="smo")), False),
    "classic_pasmo": (_classic(dict(algorithm="pasmo")), False),
    "chunked": (_chunked, True),
    "sharded_plain": (_sharded, False),
}


def entries(names=None):
    """The matrix entries (every engine of the reference's matrix is
    ported)."""
    return list(names or MATRIX)


class _Stop(Exception):
    pass


def capture_body(name: str, B: int = AUDIT_B, l: int = AUDIT_L,
                 values=VALUES[0], dtype=torch.float64):
    """(body, starting state) of entry ``name``'s first loop: the solver
    runs until it hands them to ``_drive``, and stops there."""
    from repro_torch.core import solver_fused
    got = {}
    orig = solver_fused._drive

    def spy(body, s, *args, **kw):
        got.update(body=body, state=type(s)(*(x.clone() for x in s)))
        raise _Stop

    run = MATRIX[name][0](B, l, values, dtype)
    solver_fused._drive = spy
    try:
        run()
    except _Stop:
        pass
    finally:
        solver_fused._drive = orig
    if not got:
        raise RuntimeError(f"{name}: the solver never reached its loop")
    return got["body"], got["state"]


def record_body(name: str, B: int = AUDIT_B, l: int = AUDIT_L,
                values=VALUES[0], dtype=torch.float64, wrap=None):
    """(recorder, state) of one call of entry ``name``'s body at (B, l,
    values, dtype) under an :class:`OpRecorder`, and the kernel wrappers'
    index arguments (name, argument, dtype) that call passed.  ``wrap``
    replaces the body by ``wrap(body)`` (the planted violations)."""
    from repro_torch.kernels import ops
    body, s = capture_body(name, B, l, values, dtype)
    if wrap is not None:
        body = wrap(body)
    seen, saved = [], {}

    def spy(fn_name, fn):
        sig = inspect.signature(fn)

        def call(*args, **kw):
            bound = sig.bind(*args, **kw)
            for a in INDEX_ARGS[fn_name]:
                seen.append((fn_name, a, bound.arguments[a].dtype))
            return fn(*args, **kw)
        return call

    for fn_name in INDEX_ARGS:
        saved[fn_name] = getattr(ops, fn_name)
        setattr(ops, fn_name, spy(fn_name, saved[fn_name]))
    rec = OpRecorder()
    try:
        with rec:
            body(s, MATRIX[name][1])
    finally:
        for fn_name, fn in saved.items():
            setattr(ops, fn_name, fn)
    rec.index_args = seen
    return rec, s


def audit_dtypes(names=None) -> list[Finding]:
    """(a): each entry's whole run and its body with float32 inputs."""
    findings = []
    for name in entries(names):
        run = MATRIX[name][0](AUDIT_B, AUDIT_L, VALUES[0], torch.float32)
        rec = OpRecorder()
        with rec:
            run()
        body_rec, _ = record_body(name, dtype=torch.float32)
        for op, site in rec.f64 + body_rec.f64:
            where = "an op outside the port" if site is None else \
                f"{site[0]}:{site[2]} ({site[1]})"
            findings.append(Finding(
                "dtype-f64", name,
                f"{op} outputs float64 from float32 inputs at {where}"))
        for fn, arg, dt in body_rec.index_args:
            if dt != torch.int32:
                findings.append(Finding(
                    "dtype-index", name,
                    f"ops.{fn} got its {arg} as {dt}, not int32"))
    return findings


def audit_host_reads(names=None) -> list[Finding]:
    """(b): no op of a body call reads the host."""
    findings = []
    for name in entries(names):
        rec, _ = record_body(name)
        for op in sorted(set(rec.host_reads)):
            findings.append(Finding(
                "host-read", name,
                f"{op} inside the loop body ({rec.host_reads.count(op)} "
                f"time(s)): a CUDA graph freezes the value it reads"))
    return findings


def op_multiset(rec: OpRecorder) -> collections.Counter:
    return collections.Counter(rec.ops)


def audit_invariance(names=None, shapes=SHAPES,
                     values=VALUES) -> list[Finding]:
    """(c): one op multiset over every (B, l) and value set."""
    findings = []
    for name in entries(names):
        base, base_at = None, None
        for B, l in shapes:
            for v in values:
                got = op_multiset(record_body(name, B, l, v)[0])
                if base is None:
                    base, base_at = got, (B, l, v)
                    continue
                if got != base:
                    delta = sorted(f"{op}{list(dt)}: {base[(op, dt)]} -> "
                                   f"{got[(op, dt)]}"
                                   for op, dt in set(base) | set(got)
                                   if base[(op, dt)] != got[(op, dt)])
                    findings.append(Finding(
                        "op-invariance", name,
                        f"the body's ops at B, l, (C, gamma) = {(B, l, v)} "
                        f"differ from those at {base_at}: "
                        + "; ".join(delta[:6])))
    return findings


def audit_all(names=None) -> list[Finding]:
    return (audit_dtypes(names) + audit_host_reads(names)
            + audit_invariance(names))


def census(name: str, dtype=torch.float64) -> dict:
    rec, s = record_body(name, dtype=dtype)
    dts = collections.Counter(d for _, dt in rec.ops for d in dt)
    return {
        "entry": name,
        "torch": torch.__version__,
        "input_dtype": str(dtype).removeprefix("torch."),
        "B": AUDIT_B, "l": AUDIT_L,
        "n_ops": len(rec.ops),
        "ops": dict(sorted(collections.Counter(
            op for op, _ in rec.ops).items())),
        "dtypes": dict(sorted(dts.items())),
        "state": [[list(x.shape), str(x.dtype).removeprefix("torch.")]
                  for x in s],
    }


def emit_census(out_dir: str, names=None) -> list[str]:
    """(d): one ``census_<entry>.json`` a matrix entry; returns the
    paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name in entries(names):
        path = os.path.join(out_dir, f"census_{name}.json")
        with open(path, "w") as fh:
            json.dump(census(name), fh, indent=1, sort_keys=True)
            fh.write("\n")
        paths.append(path)
    return paths


# ---------------------------------------------------------------------------
# planted violations (negative controls)
# ---------------------------------------------------------------------------


def plant_f64() -> list[Finding]:
    """The plain body with a float64 round trip on G: audit (a) must flag
    it."""
    def wrap(body):
        def planted(s, refresh):
            return body(s._replace(G=s.G.double().to(s.G.dtype)), refresh)
        return planted

    rec, _ = record_body("plain", dtype=torch.float32, wrap=wrap)
    return [Finding("dtype-f64", "plant:f64",
                    f"{op} outputs float64 from float32 inputs")
            for op, _ in rec.f64]


def plant_hostread() -> list[Finding]:
    """The plain body reading its largest gap on the host: audit (b) must
    flag it."""
    def wrap(body):
        def planted(s, refresh):
            if float(s.gap.max()) < 0.0:
                return s
            return body(s, refresh)
        return planted

    rec, _ = record_body("plain", wrap=wrap)
    return [Finding("host-read", "plant:hostread",
                    f"{op} inside the loop body")
            for op in rec.host_reads]
