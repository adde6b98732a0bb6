"""Capture guard: exact CUDA-graph capture counts per call site, and one
kernel build per source hash.

The counterpart of the reference's ``recompile_guard``.  The port replays
its loops as CUDA graphs (:func:`repro_torch.core.solver_fused._drive`):
a fit captures one graph per chunk shape (its refresh pattern) that comes
round twice, and a chunked driver keeps its graphs in a per-call cache
(:class:`~repro_torch.core.solver_fused._GraphCache`), one capture per
(cache entry, chunk shape) it visits, however many rounds replay them.  A
regression, such as a driver that captures anew every round, changes no
result; it shows up as time, most of a compacted grid's.  Counts are
exact, not bounds: the guard derives the expected count from the rounds a
run made and the chunk shapes each ran, and a probe that expects 4 and
sees 3 is as wrong as one that sees 5.

The CPU path captures nothing, so on the CPU the probes run through a
stand-in graph (:func:`stand_in_graphs`): the solvers' seam
(``solver_fused._use_graphs``) is turned on and ``solver_fused._capture``
replaced by :func:`fake_capture`, whose replay reruns the captured chunk
of the body on the same state buffers.  A round that did not copy its
inputs into its entry's buffers then gives a wrong result, as it would on
the card, so each probe also holds its results bitwise to the driver
without the cache (a cache that never hits, :func:`_uncached`).  On the
card the real graphs are counted, and a (C, gamma) sweep must build the
kernels at most once per source hash (:func:`probe_builds`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import List

import torch

from repro_torch.analysis.report import Finding

PROBE_L = 48
# every probe lane converges in a few hundred iterations: the budget only
# keeps a broken driver from looping on
PROBE_MAX_ITER = 3000


def chunk_schedule(t_run: int, max_iter: int, check_every: int,
                   period: int) -> list:
    """The refresh tuples of the chunks of a loop that ran ``t_run``
    iterations: chunks of at most ``check_every``, cut at ``max_iter``,
    a chunk holding a refresh (``t % period == period - 1``) ending on
    one."""
    out, t = [], 0
    while t < t_run:
        steps = min(check_every, max_iter - t)
        if period > 0:
            to_next = period - t % period
            if to_next <= steps:
                steps = to_next + (steps - to_next) // period * period
        out.append(tuple(period > 0 and (t + k) % period == period - 1
                         for k in range(steps)))
        t += steps
    return out


class FakeGraph:
    """A stand-in for ``torch.cuda.CUDAGraph``: :meth:`replay` reruns the
    captured chunk of ``body`` on the static state buffers and copies the
    result into them, as a replay of the real graph does."""

    def __init__(self, body, static, refresh):
        self.body, self.static, self.refresh = body, static, refresh

    def replay(self):
        out = self.static
        for r in self.refresh:
            out = self.body(out, r)
        for dst, src in zip(self.static, out):
            if dst is not src:
                dst.copy_(src)

    def pool(self):
        return None


def fake_capture(body, static, refresh, pool=None):
    """``solver_fused._capture`` for CPU tensors: records nothing, runs
    nothing (a capture does not execute), and launches no kernel."""
    return FakeGraph(body, static, refresh), {}


@contextlib.contextmanager
def stand_in_graphs():
    """The solvers' graph path on the CPU, through :class:`FakeGraph`."""
    from repro_torch.core import solver_fused as sf
    saved = sf._use_graphs, sf._capture
    sf._use_graphs = lambda t, impl="cuda": True
    sf._capture = fake_capture
    try:
        yield
    finally:
        sf._use_graphs, sf._capture = saved


class CaptureLog:
    """Counts the captures of the runs made while installed, beside what
    the cache's rule expects of them.

    ``captures``: (round key, refresh tuple) of every capture.
    ``loops``: one (round key, chunk shapes) a loop driven; the key names
    the cache entry as the guard sees it from outside: the lanes' state
    shape, whether a fused round read a Gram bank itself (``bank``, or one
    that ``ops.gram_bank`` built while installed) rather than a slice of
    it, and in a lane-sharded round the slab, its device and the whole
    batch's state shape.  The keys of a solve in
    progress are kept per host thread, since the slabs of the sharded
    engine solve in threads of their own.
    """

    def __init__(self, bank=None):
        self.banks = [] if bank is None else [bank]
        self.captures, self.loops = [], []
        self._local = threading.local()

    def _keys(self) -> list:
        """The calling thread's keys of the solves it has under way."""
        if not hasattr(self._local, "keys"):
            self._local.keys, self._local.slab = [], ()
        return self._local.keys

    def __enter__(self):
        from repro_torch.core import grid, sharded_lanes
        from repro_torch.core import solver_fused as sf
        from repro_torch.kernels import ops
        self._saved = (sf._capture, sf._drive, sf.solve_fused_batched_qp,
                       grid.solve_lanes, ops.gram_bank,
                       sharded_lanes._solve_slab)
        capture, drive, fused, lanes, gram_bank, slab = self._saved

        def capture_spy(body, static, refresh, pool=None):
            keys = self._keys()
            self.captures.append((keys[-1] if keys else None, refresh))
            return capture(body, static, refresh, pool)

        def drive_spy(body, s, max_iter, check_every, graphs, period=0):
            out = drive(body, s, max_iter, check_every, graphs, period)
            keys = self._keys()
            key = keys.pop() if keys else None
            self.loops.append((key, chunk_schedule(out[1], max_iter,
                                                   check_every, period)))
            return out

        def fused_spy(X, P, *args, **kw):
            gram = kw.get("gram")
            self._keys().append((tuple(P.shape),
                                 any(gram is b for b in self.banks))
                                + self._local.slab)
            return fused(X, P, *args, **kw)

        def lanes_spy(kernel, p, *args, **kw):
            self._keys().append((tuple(p.shape),))
            return lanes(kernel, p, *args, **kw)

        def bank_spy(*args, **kw):
            self.banks.append(gram_bank(*args, **kw))
            return self.banks[-1]

        def slab_spy(p, job, *args):
            self._keys()
            self._local.slab = (p, job.device, job.batch)
            try:
                return slab(p, job, *args)
            finally:
                self._local.slab = ()

        sf._capture, sf._drive = capture_spy, drive_spy
        sf.solve_fused_batched_qp, grid.solve_lanes = fused_spy, lanes_spy
        ops.gram_bank = bank_spy
        sharded_lanes._solve_slab = slab_spy
        return self

    def __exit__(self, *exc):
        from repro_torch.core import grid, sharded_lanes
        from repro_torch.core import solver_fused as sf
        from repro_torch.kernels import ops
        (sf._capture, sf._drive, sf.solve_fused_batched_qp,
         grid.solve_lanes, ops.gram_bank,
         sharded_lanes._solve_slab) = self._saved
        self.banks.clear()

    def expected_fit(self) -> int:
        """A fit's loops, each fresh: a graph for every chunk shape that
        came round at least twice in its loop (the first run of a shape
        is eager)."""
        return sum(sum(1 for n in collections.Counter(shapes).values()
                       if n >= 2) for _, shapes in self.loops)

    def expected_chunked(self) -> int:
        """A chunked driver's call: one graph per (entry, chunk shape) it
        visits, captured right after that shape's first, eager, run."""
        return len({(key, shape) for key, shapes in self.loops
                    for shape in shapes})


def _count(name, got: int, want: int, findings: List[Finding]) -> None:
    if got != want:
        findings.append(Finding(
            "capture-count", name,
            f"expected exactly {want} graph capture(s), got {got}"))


def _count_chunked(name, log: CaptureLog, findings: List[Finding]) -> None:
    """A chunked call's captures: the count its rounds expect, none of an
    (entry, chunk shape) twice, and some entry serving two rounds (else
    the probe would test nothing)."""
    _count(name, len(log.captures), log.expected_chunked(), findings)
    again = [c for c, n in collections.Counter(log.captures).items()
             if n > 1]
    if again:
        findings.append(Finding(
            "capture-count", name,
            f"{len(again)} (entry, chunk shape) pair(s) captured more than "
            f"once, e.g. entry {again[0][0]}"))
    if len(log.loops) <= len({k for k, _ in log.loops}):
        findings.append(Finding(
            "capture-probe", name,
            "no entry served two rounds: the probe tests nothing"))


def _same(name, a, b, findings: List[Finding]) -> None:
    """Every field of two results bitwise equal."""
    bad = [f.name for f in dataclasses.fields(a)
           if not torch.equal(getattr(a, f.name), getattr(b, f.name))]
    if bad:
        findings.append(Finding(
            "capture-result", name,
            f"fields {bad} differ from the run without graph reuse"))


def _data(device, dtype=torch.float64, seed=1):
    from repro_torch.svm.data import xor_gaussians
    X, y = xor_gaussians(PROBE_L, seed=seed)
    X = torch.as_tensor(X, dtype=dtype, device=device)
    y = torch.as_tensor(y, dtype=dtype, device=device)
    Y = torch.stack([y, -y])
    return X, Y


def _uncached(run):
    """``run()`` with a cache that never hits, so every round builds its
    loop and buffers anew (on the CPU without graphs: the driver as it
    was before the cache)."""
    from repro_torch.core import solver_fused as sf
    saved, sf._GraphCache = sf._GraphCache, sf._GraphCacheMiss
    try:
        return run()
    finally:
        sf._GraphCache = saved


@contextlib.contextmanager
def _graph_path(device):
    """The graph path: real graphs on the card, stand-ins on the CPU."""
    if torch.device(device).type == "cuda":
        yield
    else:
        with stand_in_graphs():
            yield


def probe_fused_fit(findings, device="cpu") -> None:
    """A fused fit: one graph without shrinking; with soft shrinking
    (``shrink_every=8``, ``check_every=5``) one per chunk shape that
    recurs; results bitwise those of the eager loop."""
    from repro_torch.core.solver import SolverConfig
    from repro_torch.core.solver_fused import solve_fused_batched
    X, Y = _data(device)
    for tag, cfg, kw, want in (
            ("plain", SolverConfig(max_iter=PROBE_MAX_ITER), {}, 1),
            ("shrinking", SolverConfig(shrink_every=8,
                                       max_iter=PROBE_MAX_ITER),
             dict(shrinking=True, check_every=5), None)):
        def fit():
            return solve_fused_batched(X, Y, (100.0, 10.0), 0.5, cfg,
                                       device=device, **kw)
        with _graph_path(device), CaptureLog() as log:
            got = fit()
        _count(f"fused-fit:{tag}", len(log.captures),
               log.expected_fit() if want is None else want, findings)
        if torch.device(device).type == "cpu":
            _same(f"fused-fit:{tag}", got, fit(), findings)


def probe_classic_fit(findings, device="cpu") -> None:
    """A classic fit over a precomputed Gram: one graph."""
    from repro_torch.core import qp as qp_mod
    from repro_torch.core.solver import SolverConfig, solve
    from repro_torch.kernels import ops
    X, Y = _data(device)
    K = qp_mod.PrecomputedKernel(ops.gram(X, X, 0.5, device=device))

    def fit():
        return solve(K, Y, 10.0, SolverConfig(algorithm="smo",
                                              max_iter=PROBE_MAX_ITER),
                     device=device)
    with _graph_path(device), CaptureLog() as log:
        got = fit()
    _count("classic-fit", len(log.captures), 1, findings)
    _count("classic-fit:rule", log.expected_fit(), 1, findings)
    if torch.device(device).type == "cpu":
        _same("classic-fit", got, fit(), findings)


def _sweep_lanes(device):
    """A (C, gamma) sweep's flat lanes: 2 Cs x 2 gammas x 2 heads."""
    X, Y = _data(device)
    Cs = torch.tensor([2.0, 24.0], dtype=X.dtype, device=device)
    Yf = Y.repeat(4, 1)
    Cf = Cs.repeat_interleave(2).repeat(2)
    gam = torch.tensor([0.4, 1.0], dtype=X.dtype,
                       device=device).repeat_interleave(4)
    YC = Yf * Cf[:, None]
    return X, Yf, torch.clamp_max(YC, 0.0), torch.clamp_min(YC, 0.0), gam


def probe_fused_chunked(findings, device="cpu", uncached=False) -> None:
    """``solve_fused_chunked_qp`` over a (C, gamma) sweep's lanes, through
    the bank and the rbf source, with hard shrinking: one capture per
    (entry, chunk shape) visited, results bitwise those of the driver
    without the cache (:func:`_uncached`).  ``uncached`` runs the driver
    with a cache that never hits (the negative control)."""
    from repro_torch.core import solver_fused as sf
    from repro_torch.core.solver import SolverConfig
    from repro_torch.kernels import ops
    X, P, L, U, gam = _sweep_lanes(device)
    bank = ops.gram_bank(X, [0.4, 1.0])
    gidx = torch.tensor([0] * 4 + [1] * 4, device=device)
    # chunks of 8 iterations, every other one ending on a mask refresh
    cfg = SolverConfig(eps=1e-5, shrink_every=16,
                       max_iter=PROBE_MAX_ITER)
    for tag, kw in (("bank", dict(gram=bank, gram_idx=gidx)),
                    ("rbf", {})):
        def run():
            return sf.solve_fused_chunked_qp(
                X, P, L, U, gam, cfg, chunk=32, check_every=8,
                shrinking=True, **kw)
        with _graph_path(device), CaptureLog(bank) as log:
            got = _uncached(run) if uncached else run()
        name = f"{'plant:recapture:' if uncached else ''}fused-chunked:{tag}"
        _count_chunked(name, log, findings)
        if not uncached:
            _same(name, got, _uncached(run), findings)


def probe_sharded_chunked(findings, device="cpu") -> None:
    """``solve_fused_chunked_qp`` lane-sharded over two slabs on
    ``device``, through the bank and the rbf source, with hard shrinking:
    each slab of a round solves in a cache entry of its own, captured
    once per chunk shape it visits; results bitwise those of the sharded
    driver without the cache."""
    from repro_torch.core import solver_fused as sf
    from repro_torch.core.solver import SolverConfig
    from repro_torch.kernels import ops
    X, P, L, U, gam = _sweep_lanes(device)
    bank = ops.gram_bank(X, [0.4, 1.0])
    gidx = torch.tensor([0] * 4 + [1] * 4, device=device)
    cfg = SolverConfig(eps=1e-5, shrink_every=16, max_iter=PROBE_MAX_ITER)
    for tag, kw in (("bank", dict(gram=bank, gram_idx=gidx)),
                    ("rbf", {})):
        def run():
            return sf.solve_fused_chunked_qp(
                X, P, L, U, gam, cfg, chunk=32, check_every=8,
                shrinking=True, devices=(device, device), **kw)
        with _graph_path(device), CaptureLog(bank) as log:
            got = run()
        name = f"sharded-chunked:{tag}"
        _count_chunked(name, log, findings)
        slabs = {k[2] for k, _ in log.loops if k is not None and len(k) > 2}
        if slabs != {0, 1}:
            findings.append(Finding(
                "capture-probe", name,
                f"the rounds solved slabs {sorted(slabs)}, not both"))
        _same(name, got, _uncached(run), findings)


def probe_classic_chunked(findings, device="cpu") -> None:
    """The classic compacted grid (``impl=None``): one capture per (lane
    bucket, chunk shape) visited over every C, results bitwise those of
    the driver without the cache."""
    from repro_torch.core import grid
    from repro_torch.core.solver import SolverConfig
    X, Y = _data(device)

    def run():
        return grid.solve_grid_compacted(X, Y, [2.0, 24.0], [0.4, 1.0],
                                         SolverConfig(eps=1e-5,
                                                      max_iter=PROBE_MAX_ITER),
                                         chunk=64,
                                         device=device)
    with _graph_path(device), CaptureLog() as log:
        got = run()
    _count_chunked("classic-chunked", log, findings)
    _same("classic-chunked", got, _uncached(run), findings)


def probe_builds(findings, device="cuda") -> None:
    """A (C, gamma) sweep of fused fits on the card builds no kernel
    anew: every source hash this process built, it built once
    (``kernels.build.BUILDS``), and the sweep adds no build."""
    from repro_torch.core.solver import SolverConfig
    from repro_torch.core.solver_fused import solve_fused_batched
    from repro_torch.kernels import build
    X, Y = _data(device)
    before = dict(build.BUILDS)
    for C in (0.5, 8.0):
        for gamma in (0.4, 0.9):
            solve_fused_batched(X, Y, C, gamma,
                                SolverConfig(max_iter=PROBE_MAX_ITER),
                                device=device)
    if dict(build.BUILDS) != before:
        findings.append(Finding(
            "build-count", "sweep",
            f"the sweep built the kernels: {before} -> {dict(build.BUILDS)}"))
    for digest, n in build.BUILDS.items():
        if n != 1:
            findings.append(Finding(
                "build-count", digest,
                f"source hash {digest} built {n} times in one process"))
    if not build.library_path().exists():
        findings.append(Finding("build-count", build.source_hash(),
                                "no library for the current sources"))


PROBES = (probe_fused_fit, probe_classic_fit, probe_fused_chunked,
          probe_sharded_chunked, probe_classic_chunked)


def run_probes(device="cpu", probes=PROBES) -> List[Finding]:
    """Every probe on ``device`` (the CPU through stand-in graphs, or the
    card, where the build probe runs too)."""
    findings: List[Finding] = []
    for probe in probes:
        probe(findings, device)
    if torch.device(device).type == "cuda":
        probe_builds(findings, device)
    return findings


def plant_recapture(device="cpu") -> List[Finding]:
    """Negative control: the chunked driver with a cache that never hits
    captures anew every round; the guard must flag it."""
    findings: List[Finding] = []
    probe_fused_chunked(findings, device, uncached=True)
    return [f for f in findings if f.check == "capture-count"]


