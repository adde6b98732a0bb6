"""Fused two-pass PA-SMO solvers (``repro.core.solver_fused``).

:func:`solve_fused_batched_qp` advances B *general* dual QPs over a shared
``X`` in one host loop: per-lane linear term ``P`` (B, n), box ``L``/``U``
(B, n) and RBF width.  Each iteration launches the batched pass A (WSS2
selection) and pass B (both rows + gradient update + stopping scan) and
does O(B) step algebra in between: Alg. 3's B^(t-2) candidate, the
truncated Newton step and, with ``algorithm="pasmo"``, the planning-ahead
step (eq. 8).  Kernel rows are recomputed from ``X`` in the passes (the
rbf row source), or read from a shared Gram bank (``gram``/``gram_idx``,
the bank row source).  ``doubled=True`` runs the ε-SVR operator's 2l
coordinates over the base ``X``.

:func:`solve_fused` is the single-lane classification solver: pass A
stores the row k_i, the O(1) algebra reads ``K_ij`` and planning's
``Q12`` terms from it, and pass B reads it back instead of recomputing it.
When Alg. 3's B^(t-2) candidate wins, the row must be ``qi``'s: pass A is
launched again every planning iteration with the device flag ``take``,
and a false flag turns that launch into a no-op, so the choice costs no
host sync.

Converged lanes are frozen in the passes: their step size is 0, so pass B
leaves their gradient bitwise unchanged and every per-lane state update is
a select on ``active``.  That makes the host loop exact while it checks
``any(~done)`` only every ``check_every`` iterations (one device sync per
check, none inside the body): once every lane is done, further iterations
change nothing that is returned, and each chunk is capped at
``max_iter - t`` so ``max_iter`` stays exact.

``shrinking=True`` turns on LIBSVM-style *soft* active-set shrinking: a
per-lane (B, n) bool mask restricts pass A's j-candidates and pass B's
scans, while pass B updates G on every coordinate, so G stays exact and
unshrinking costs nothing.  The mask is refreshed with
:func:`repro_torch.core.qp.shrink_mask` at the iterations ``t`` (counted
from 0 in each call) with ``t % period == period - 1``, ``period =
cfg.shrink_every`` or :data:`~repro_torch.core.solver.
DEFAULT_SHRINK_EVERY`; a lane is done only when its mask was full at the
scan that gave the gap, and a lane whose masked gap passes with a partial
mask is unshrunk in place (counted in ``n_unshrink``).
:func:`solve_fused_chunked_qp` turns the mask into *hard* compaction:
between chunks it drops converged lanes and gathers the surviving rows.

On the card the loop body is a few hundred small launches, each issued by
Python, and the card waits for them: the loop captures a chunk of
``check_every`` iterations into a CUDA graph and replays it
(:func:`_drive`).  A replay launches the same kernels in the same order
on the same buffers, so it changes no bit of the result.  The host knows
``t`` and ends a chunk that holds a refresh iteration on one, so two
graphs serve any period.

``cfg.step == "conjugate"`` (with ``algorithm="smo"``) runs the
Conjugate-SMO step in the batched loop: each iteration solves the exact
2x2 subproblem on the current pair's direction and the previous one's,
whose Q-product ``u`` pass B returns for free as its row difference
``r = k_i - k_j``.  ``u`` is carried at base width (B, l): the doubled
operator's direction is its base row tiled.  The step is accepted only
with a valid carried direction, a safely positive definite minor, all
four touched coordinates strictly interior and a 2-D gain at least the
1-D one; otherwise the lane takes the plain clipped step.  The direction
resets on a clipped step, a mask refresh and an unshrink, and at the
start of every call (so at every chunk seam of
:func:`solve_fused_chunked_qp`).  Accepted steps count in
``n_planning``.  The single-lane :func:`solve_fused`
refuses the mode, as the reference does.

``telemetry=`` (a :class:`~repro_torch.telemetry.ring.RingConfig`) on the
batched solvers turns on the flight recorder: the ring's buffers and a
device int32 loop counter ride the carried state (:class:`_TelState`),
each iteration writes them in place with masked writes and no host read
(:func:`repro_torch.telemetry.ring.ring_write`), and the solver returns
``(FusedResult, TelemetryRing)``.  With ``telemetry=None`` the carry, the
body and its kernels are those of the ring-free loop.

The port covers the plain and the conjugate step, ``algorithm`` in
``{smo, pasmo}``, both row sources, the doubled operator, warm starts,
shrinking and the flight recorder.  The tile knob ``block_l`` is accepted
and ignored everywhere: the CUDA passes fix their tiles when they are
built (:data:`repro_torch.kernels.build.BLOCK_L`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import gc
import threading
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import qp as qp_mod
from repro_torch.core import step as step_mod
from repro_torch.core.qp import TAU
from repro_torch.core.solver import DEFAULT_SHRINK_EVERY, SolverConfig
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.kernels import ops, row_source
from repro_torch.runtime.fault import StepMonitor
from repro_torch.telemetry import ring as ring_mod
from repro_torch.telemetry import spans
from repro_torch.telemetry.ring import RingConfig, TelemetryRing

# Host-check cadence of the loop: iterations between reads of any(~done).
CHECK_EVERY = 32


@dataclasses.dataclass(frozen=True)
class FusedResult:
    """Per-lane results; every field has a leading lane axis."""

    alpha: torch.Tensor
    b: torch.Tensor
    G: torch.Tensor
    iterations: torch.Tensor     # per lane, until that lane converged
    objective: torch.Tensor
    kkt_gap: torch.Tensor
    converged: torch.Tensor
    n_planning: torch.Tensor
    n_unshrink: torch.Tensor     # unshrink (reactivation) events

    def lane(self, k: int) -> "FusedResult":
        """The result of lane ``k`` alone (leading axis dropped)."""
        return FusedResult(**{f.name: getattr(self, f.name)[k]
                              for f in dataclasses.fields(self)})


# One capture at a time in the process: entering a capture empties the
# allocator's caches on every device, which must not happen while another
# thread (a slab of the lane-sharded engine) captures on its own.
_CAPTURE_LOCK = threading.Lock()
# The side stream of each device's captures (``torch.cuda.graph``'s own
# default is one stream for the process, on whichever device captured
# first).
_CAPTURE_STREAMS: dict = {}


def _capture_stream():
    """The calling thread's current device's capture stream, made on its
    first capture."""
    dev = torch.cuda.current_device()
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[dev]


@contextlib.contextmanager
def _no_collection():
    """Python's cyclic garbage collector off inside: a collection during
    a capture can free an earlier fit's graph, whose destruction is a CUDA
    call that a capture forbids, and the capture fails."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _capture(body, static, refresh, pool=None):
    """Capture one chunk of ``body``, whose iterations refresh the shrink
    mask where ``refresh`` (a tuple of bools, one per iteration) says, into
    a CUDA graph whose replay advances the state buffers ``static`` in
    place.  ``pool`` is another graph's memory pool to draw on.

    Returns (graph, the kernel launches of one replay).  The wrappers
    counted their launches while the graph was captured, which launched
    nothing: those counts, read from the calling thread's own tally (other
    slab threads launch meanwhile), are taken back here and given again at
    every replay (:func:`_drive`).  The capture forbids unsafe CUDA calls
    in this thread only (``thread_local``), so the other slab threads run
    on, and runs with the garbage collector off (:func:`_no_collection`).
    """
    with _CAPTURE_LOCK, _no_collection():
        before = kernels.launches(thread=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=_capture_stream(),
                              capture_error_mode="thread_local"):
            out = static
            for r in refresh:
                out = body(out, r)
            for dst, src in zip(static, out):
                if dst is not src:
                    dst.copy_(src)
        per_replay = {k: n - before[k]
                      for k, n in kernels.launches(thread=True).items()}
    kernels.add_launches(per_replay, -1)
    return graph, per_replay


def _use_graphs(t: torch.Tensor, impl: str = "cuda") -> bool:
    """Whether a loop over ``t``'s device replays CUDA graphs: the CUDA
    kernels on the card.  The capture guard
    (:mod:`repro_torch.analysis.capture_guard`) turns it on for CPU
    tensors, with a stand-in for :func:`_capture`."""
    return impl == "cuda" and t.is_cuda


class _Pool:
    """The memory pool that a set of graphs shares (``None`` until the
    first of them is captured)."""

    def __init__(self):
        self.pool = None


class _Graphs:
    """The CUDA graphs of one loop body, keyed by a chunk's refresh tuple,
    over one set of state buffers (``static``), and the chunk shapes that
    ran eagerly.

    The graphs of one loop share a memory pool (``pool``, which several
    loops may share too), which is safe because each graph copies its
    result into ``static`` and leaves nothing in the pool that another
    reads.  ``reuse`` marks a loop that runs again over the same buffers
    (a chunked driver's cache entry, :class:`_GraphCache`): each chunk
    shape is then captured right after its first, eager, run, so the later
    runs replay from their first chunk.  A loop that runs once captures a
    shape when it comes round the second time.
    """

    def __init__(self, pool: _Pool | None = None):
        self.reuse = pool is not None
        self.pool = _Pool() if pool is None else pool
        self.cache, self.seen, self.static = {}, set(), None

    def hold(self, s, make: bool = False):
        """The state ``s`` in the static buffers, made from ``s`` when
        ``make`` and there are none yet; ``s`` itself without them."""
        if self.static is None:
            if not make:
                return s
            self.static = type(s)(*(x.clone() for x in s))
        for dst, src in zip(self.static, s):
            if dst is not src:
                dst.copy_(src)
        return self.static

    def graph(self, body, refresh):
        """(graph, kernel launches of one replay) of the chunk ``refresh``,
        captured over the static buffers on the first call."""
        if refresh not in self.cache:
            self.cache[refresh] = _capture(body, self.static, refresh,
                                           self.pool.pool)
            self.pool.pool = self.cache[refresh][0].pool()
        return self.cache[refresh]


def _running(s) -> bool:
    """Whether any lane of the state ``s`` runs on: ``any(~done)``, read
    back to the host (the loop's one read of the device a chunk)."""
    return bool(torch.any(~s.done))


def _checked(rec, s) -> bool:
    """:func:`_running` as the span ``loop.check``: the host's time
    blocked on the read."""
    with rec.span("loop.check"):
        run = _running(s)
    rec.count("loop.checks")
    return run


def _graph(rec, held: _Graphs, body, refresh: tuple):
    """:meth:`_Graphs.graph`, a capture timed as the span
    ``loop.capture`` of ``rec`` (when not ``None``)."""
    if rec is None or refresh in held.cache:
        return held.graph(body, refresh)
    with rec.span("loop.capture"):
        out = held.graph(body, refresh)
    rec.count("loop.captures")
    return out


def _drive(body, s, max_iter: int, check_every: int, graphs: bool,
           period: int = 0):
    """Run ``body(state, refresh)`` on the state ``s`` (a NamedTuple with a
    ``done`` field) in chunks of at most ``check_every`` iterations,
    reading ``any(~done)`` between chunks, until every lane is done or
    ``max_iter`` iterations ran.  Iteration ``t`` (from 0) refreshes the
    shrink mask when ``period`` is positive and ``t % period == period -
    1``, and a chunk that holds a refresh ends on one.  A chunk then has
    one of two shapes, whatever ``period`` is: ``check_every`` iterations
    without a refresh, or, ending on a refresh, ``(period - 1) %
    check_every + 1`` iterations when ``period > check_every`` and the
    most whole periods that fit in ``check_every`` otherwise (only a last
    chunk cut short by ``max_iter`` differs).

    With ``graphs`` (the CUDA kernels on the card) a chunk whose shape ran
    once eagerly (which loads and warms every kernel it launches) is one
    replay of a graph captured for that shape: at most two graphs.  When
    ``body`` is the loop of the chunked round being solved
    (:func:`_solving`), the graphs and their state buffers are its cache
    entry's, from the entry's earlier rounds: the state ``s`` is copied
    into those buffers first, and every chunk shape captured there
    replays at once.  Returns (state, iterations run).

    While a recorder is active (:mod:`repro_torch.telemetry.spans`) the
    loop's start ends the fit's ``fit.prep``, and its chunks are spans:
    ``loop.replay`` (host and device) a replay, ``loop.eager`` (host and
    device) an eager chunk, ``loop.capture`` (host) a capture and
    ``loop.check`` (host) a read of ``any(~done)``, with their counters.
    Off, the recorder costs the loop one context-variable read and a test
    a chunk.
    """
    rec = spans.active()
    running = _running if rec is None else functools.partial(_checked, rec)
    if rec is not None:
        rec.end_prep()
    ent = _ROUND.get()
    held = (ent.loop.graphs if ent is not None and ent.loop is not None
            and ent.loop.body is body else _Graphs())
    s = held.hold(s)
    t = 0
    while t < max_iter and running(s):
        steps = min(check_every, max_iter - t)
        if period > 0:
            to_next = period - t % period    # up to the next refresh
            if to_next <= steps:
                steps = to_next + (steps - to_next) // period * period
        refresh = tuple(period > 0 and (t + k) % period == period - 1
                        for k in range(steps))
        if graphs and refresh in held.seen:
            s = held.hold(s, make=True)
            graph, per_replay = _graph(rec, held, body, refresh)
            if rec is None:
                graph.replay()
            else:
                with rec.span("loop.replay", s.done.device):
                    graph.replay()
                rec.count("loop.replays")
                rec.count("loop.replayed_iters", steps)
            kernels.add_launches(per_replay)
        else:
            held.seen.add(refresh)
            # ``s`` is rebound each iteration, so the state before it can
            # be freed at once
            if rec is None:
                for r in refresh:
                    s = body(s, r)
            else:
                with rec.span("loop.eager", s.done.device):
                    for r in refresh:
                        s = body(s, r)
                rec.count("loop.eager_iters", steps)
            s = held.hold(s, make=graphs and held.reuse)
            if graphs and held.reuse:
                _graph(rec, held, body, refresh)  # the next run replays it
        t += steps
    return s, t


class _Entry:
    """One bucket of a chunked driver's :class:`_GraphCache`: the input
    buffers its rounds copy their values into (``bufs``), and the loop
    built over them on the entry's first round (``loop``, holding the body
    and its :class:`_Graphs`).  ``pool`` is the memory pool its graphs
    share with the cache's other entries on its device, ``None`` for an
    entry that serves one round.  A round that shards its lanes
    (:mod:`repro_torch.core.sharded_lanes`) solves each slab in an entry
    of its own, :meth:`slab`, keyed by this entry's key, the slab and its
    device; ``cache`` and ``key`` find it."""

    def __init__(self, bufs, pool: _Pool | None, cache=None, key=None):
        self.bufs, self.pool, self.cache, self.key = bufs, pool, cache, key
        self.loop = self.inputs = None

    def slab(self, p: int, device, make) -> "_Entry":
        """The entry of lane slab ``p`` on ``device``, its buffers
        ``make()`` on its first round."""
        if self.cache is None:
            return _Entry(make(), None)
        return self.cache.entry(self.key + (("slab", p, device),), make,
                                device)


class _GraphCache:
    """The loops, and so the CUDA graphs, of one call of a chunked driver
    (:func:`solve_fused_chunked_qp`, the classic compacted grid), one
    :class:`_Entry` a key.  The key names everything that changes a
    captured body: the lane and row buckets, the dtype, the row source,
    the config and the flags (and a lane slab's index and device).  Rounds
    of the call that share a key replay its graphs on its buffers; the
    cache, and every graph and buffer in it, goes when the call returns.
    ``slice(key, make)`` keeps buffers that several entries share (the
    bank slice of a row bucket).  The graphs of one device share one
    memory pool."""

    def __init__(self):
        self.entries, self.shared, self.pools = {}, {}, {}

    def entry(self, key, make, device=None) -> _Entry:
        """The entry of ``key``, its buffers ``make()`` on its first
        round; its graphs draw on ``device``'s pool (the caller's
        device, ``None``, by default)."""
        if key not in self.entries:
            pool = self.pools.setdefault(device, _Pool())
            self.entries[key] = _Entry(make(), pool, self, key)
        return self.entries[key]

    def slice(self, key, make):
        if key not in self.shared:
            self.shared[key] = make()
        return self.shared[key]


class _GraphCacheMiss(_GraphCache):
    """A cache that never hits: every round builds its loop anew and
    captures its graphs anew, as a plain fit does (the uncached driver,
    which the tests and ``chip_smoke.py`` hold the cache against by
    putting this class in :class:`_GraphCache`'s place)."""

    def entry(self, key, make, device=None) -> _Entry:
        return _Entry(make(), None)

    def slice(self, key, make):
        return make()


# The cache entry whose buffers the running round solves (set by
# :func:`_solving` around a chunked driver's solve call), else None; a
# context variable, so a driver on another thread never sees it.
_ROUND: contextvars.ContextVar = contextvars.ContextVar("_ROUND",
                                                        default=None)


@contextlib.contextmanager
def _solving(entry: _Entry):
    """Solve one chunked round in ``entry``: the solver called inside
    (:func:`solve_fused_batched_qp`, :func:`repro_torch.core.solver.
    solve_lanes`) reuses the entry's loop (:func:`_loop_for`)."""
    token = _ROUND.set(entry)
    try:
        yield entry
    finally:
        _ROUND.reset(token)


def _loop_for(inputs: tuple, build):
    """The loop (a :class:`SimpleNamespace` with ``body`` and
    ``reload``) a solver runs over ``inputs``, the tensors its body reads.

    Outside a chunked round, ``build()`` anew.  In a round
    (:func:`_solving`), the entry's loop, which also holds the entry's
    :class:`_Graphs` (``graphs``, which :func:`_drive` finds there): built
    on the entry's first round, then, since each round copies its values
    into the same buffers (``inputs`` must be those very tensors),
    reloaded (its derived tensors recomputed in place) and reused.
    """
    ent = _ROUND.get()
    if ent is None:
        return build()
    if ent.loop is None:
        ent.loop, ent.inputs = build(), inputs
        ent.loop.graphs = _Graphs(ent.pool)
    elif len(inputs) != len(ent.inputs) or any(
            a is not b for a, b in zip(inputs, ent.inputs)):
        raise RuntimeError("a chunked round solves its cache entry's "
                           "buffers")
    else:
        ent.loop.reload()
    return ent.loop


class _BatchState(NamedTuple):
    alpha: torch.Tensor          # (B, n), updated in place
    G: torch.Tensor              # (B, n)
    i: torch.Tensor              # (B,) int32 next working-set first index
    g_i: torch.Tensor            # (B,) G[i] == max gradient over I_up
    gap: torch.Tensor            # (B,)
    iters: torch.Tensor          # (B,) int32 iterations until convergence
    done: torch.Tensor           # (B,) bool
    pi: torch.Tensor             # (B,) int32 planning history B^(t-1)
    pj: torch.Tensor
    qi: torch.Tensor             # (B,) int32 planning history B^(t-2)
    qj: torch.Tensor
    n_hist: torch.Tensor         # (B,) int32
    p_smo: torch.Tensor          # (B,) bool
    prev_free: torch.Tensor      # (B,) bool
    prev_ratio_ok: torch.Tensor  # (B,) bool
    n_planning: torch.Tensor     # (B,) int32
    act: torch.Tensor            # (B, n) bool active set; (B, 1) unused
    n_unshrink: torch.Tensor     # (B,) int32
    u: torch.Tensor              # (B, l) conjugate direction Q (e_pi -
                                 # e_pj), its base row (tiled over the
                                 # halves); (B, 1) unused (plain step)
    ok: torch.Tensor             # (B,) bool the direction is valid


# The carry with the flight recorder on: the batch state, the loop counter
# ``step`` (device int32, so a replayed graph stamps the live iteration)
# and the ring's buffers (RingBuffers, scratch columns included).
_TelState = NamedTuple("_TelState", [
    (f, torch.Tensor) for f in _BatchState._fields + ("step",) + tuple(
        "ring_" + f for f in ring_mod.FIELDS)])
_N_STATE = len(_BatchState._fields)


def _check_config(cfg: SolverConfig) -> None:
    if cfg.algorithm not in ("smo", "pasmo"):
        raise ValueError(f"the fused engine runs algorithm smo or pasmo, got "
                         f"{cfg.algorithm!r}")
    if cfg.plan_candidates != 1:
        raise ValueError("the fused engine plans one candidate "
                         "(plan_candidates == 1)")
    if cfg.wss != "wss2":
        raise ValueError("the fused passes hardcode WSS2 selection")
    if cfg.record_trace or cfg.record_steps:
        raise ValueError("the fused solver does not record traces/steps")


def _check_cadence(check_every: int) -> None:
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")


def solve_fused(X, y, C, gamma, cfg: SolverConfig = SolverConfig(), *,
                impl: str = "auto", block_l: int = 1024, device=None,
                dtype=None, check_every: int = CHECK_EVERY,
                stats: dict | None = None) -> FusedResult:
    """Solve one RBF classification QP with the single-lane fused passes.

    An entry point: ``X`` (l, d) and the signed labels ``y`` (l,) (arrays
    or tensors) move to ``device``, which defaults to the CUDA card and
    raises without one (``device="cpu"`` runs the plain versions on the
    CPU).  ``dtype`` defaults to ``y``'s when it is a floating tensor, else
    to ``torch.get_default_dtype()``.  ``C`` is a scalar or (l,)
    per-sample budget, ``gamma`` a scalar.

    The host loop reads ``done`` every ``check_every`` iterations; after
    convergence an iteration takes ``mu = 0`` and selects its state on
    ``~done``, so nothing returned depends on the cadence, and
    ``iterations`` counts only the active ones.  Returns a
    :class:`FusedResult` of 0-d tensors (``alpha``/``G`` (l,)).  A dict
    passed as ``stats`` receives ``relaunches``, the conditional pass A
    launches (one per planning iteration), and ``relaunches_ran``, how
    many of them had a true flag (read once, after the loop).
    ``block_l`` is accepted and ignored: the CUDA kernels fix their tiles
    when they are built (:data:`repro_torch.kernels.build.BLOCK_L`).  The
    single-lane loop takes no flight recorder, as the reference's does
    not.
    """
    del block_l
    _check_config(cfg)
    if cfg.step != "plain":
        raise ValueError("step='conjugate' is a lane-batched mode "
                         "(solve_fused_batched_qp)")
    _check_cadence(check_every)
    dev = resolve_device(device)
    if dtype is None and torch.is_tensor(y) and y.is_floating_point():
        dtype = y.dtype
    dtype = resolve_dtype(dtype)
    X = torch.as_tensor(X, dtype=dtype, device=dev).contiguous()
    y = torch.as_tensor(y, dtype=dtype, device=dev).contiguous()
    n = y.shape[0]
    if X.shape[0] != n:
        raise ValueError(f"X has {X.shape[0]} rows, y {n} labels")
    impl = ops.resolve_impl(impl, dev)
    yC = y * torch.as_tensor(C, dtype=dtype, device=dev)
    L, U = torch.clamp_max(yC, 0.0), torch.clamp_min(yC, 0.0)
    sqn = torch.sum(X * X, dim=-1)
    XT = X.T.contiguous()
    gam = torch.as_tensor(gamma, dtype=dtype, device=dev).reshape(1)
    eps, eta = cfg.eps, cfg.eta
    planning = cfg.algorithm == "pasmo"
    no = torch.zeros((1,), dtype=torch.bool, device=dev)
    # the stored row k_i: pass A writes it in place on the card
    k_buf = torch.empty_like(y) if impl == "cuda" else None
    n_ran = torch.zeros((1,), dtype=torch.int32, device=dev)

    def entries(a, b):
        """O(d) RBF entries k(x_a, x_b) at (m,) index vectors."""
        a, b = a.long(), b.long()
        d2 = (sqn.take(a) + sqn.take(b)
              - 2.0 * torch.sum(X.index_select(0, b) * X.index_select(0, a),
                                dim=-1))
        return torch.exp(-gam * torch.clamp_min(d2, 0.0))

    def body(s: _BatchState, refresh: bool) -> _BatchState:
        del refresh                  # one lane, no shrinking
        alpha, G = s.alpha, s.G
        active = ~s.done
        use_exact = (~s.p_smo) & (~s.prev_ratio_ok) if planning else no

        # ---- gathers at the historic indices -----------------------------
        hist = (torch.cat([s.i, s.qi, s.qj, s.pi, s.pj]) if planning
                else s.i).long()
        A, Gh, Lh, Uh = (alpha.take(hist), G.take(hist), L.take(hist),
                         U.take(hist))
        Xq = X.index_select(0, hist[:2])      # rows of i (and qi)

        # ---- pass A: row k_i (stored) + j-selection -----------------------
        k_i, j0, gain0 = ops.rbf_row_wss(
            X, sqn, G, alpha, L, U, Xq[0], A[0:1], Lh[0:1], Uh[0:1], s.g_i,
            s.i, use_exact, gam, impl=impl, XT=XT, k_out=k_buf)
        j0, gain0 = j0.reshape(1), gain0.reshape(1)

        # ---- Alg. 3 extra candidate B^(t-2) (O(d)) -------------------------
        if planning:
            e2 = entries(torch.cat([s.qi, s.pi]), torch.cat([s.qj, s.pj]))
            K_qq, K_pp = e2[0:1], e2[1:2]
            a_qi, G_qi, L_qi, U_qi = A[1:2], Gh[1:2], Lh[1:2], Uh[1:2]
            a_qj, G_qj, L_qj, U_qj = A[2:3], Gh[2:3], Lh[2:3], Uh[2:3]
            l_q = G_qi - G_qj
            q_q = torch.clamp_min(2.0 - 2.0 * K_qq, TAU)
            sb_q = step_mod.step_bounds(a_qi, a_qj, L_qi, U_qi, L_qj, U_qj)
            mu_q = step_mod.clip_step(l_q / q_q, sb_q)
            cg_exact = step_mod.gain_of_step(mu_q, l_q, q_q)
            cg_tilde = 0.5 * l_q * l_q / q_q
            cg = torch.where(use_exact, cg_exact, cg_tilde)
            adm = ((a_qi < U_qi) & (a_qj > L_qj)
                   & (l_q > 0) & (s.qi != s.qj) & (s.n_hist > 1))
            take = (~s.p_smo) & adm & (cg > gain0)
            i_sel = torch.where(take, s.qi, s.i)
            j_sel = torch.where(take, s.qj, j0)
            g_i_sel = torch.where(take, G_qi, s.g_i)
            # the candidate won: the row must be qi's.  The launch is
            # unconditional; a false flag leaves the stored row as it was.
            k_i = ops.rbf_row_wss(
                X, sqn, G, alpha, L, U, Xq[1], a_qi, L_qi, U_qi, G_qi, s.qi,
                use_exact, gam, impl=impl, XT=XT, k_out=k_i, run=take)[0]
            n_ran.add_(take.to(torch.int32))
        else:
            i_sel, j_sel, g_i_sel = s.i, j0, s.g_i

        # ---- O(1) step computation from the stored row ---------------------
        sel = torch.cat([i_sel, j_sel]).long()
        As, Gs, Ls, Us = (alpha.take(sel), G.take(sel), L.take(sel),
                          U.take(sel))
        lw = g_i_sel - Gs[1:2]
        if planning:
            kr = k_i.take(torch.cat([j_sel, s.pi, s.pj]).long())
        else:
            kr = k_i.take(j_sel.long())
        K_ij = kr[0:1]
        q11 = torch.clamp_min(2.0 - 2.0 * K_ij, TAU)
        sb = step_mod.step_bounds(As[0:1], As[1:2], Ls[0:1], Us[0:1],
                                  Ls[1:2], Us[1:2])
        mu_star = lw / q11
        mu_smo, free_smo = step_mod.smo_step(lw, q11, sb)

        do_plan = no
        mu_plan = mu_smo
        ratio_ok = s.prev_ratio_ok
        if planning:
            a_pi, G_pi, L_pi, U_pi = A[3:4], Gh[3:4], Lh[3:4], Uh[3:4]
            a_pj, G_pj, L_pj, U_pj = A[4:5], Gh[4:5], Lh[4:5], Uh[4:5]
            w2 = G_pi - G_pj
            q22 = torch.clamp_min(2.0 - 2.0 * K_pp, TAU)
            e_j = entries(torch.cat([j_sel, j_sel]),
                          torch.cat([s.pi, s.pj]))
            q12 = kr[1:2] - kr[2:3] - e_j[0:1] + e_j[1:2]
            terms = step_mod.PlanningTerms(w1=lw, w2=w2, Q11=q11, Q22=q22,
                                           Q12=q12)
            mu1, okdet = step_mod.planning_step(terms)
            mu2 = step_mod.planned_second_step(mu1, terms)
            interior1 = (sb.lo < mu1) & (mu1 < sb.hi)
            d_pi = ((s.pi == i_sel).to(dtype) - (s.pi == j_sel).to(dtype))
            d_pj = ((s.pj == i_sel).to(dtype) - (s.pj == j_sel).to(dtype))
            sb2 = step_mod.step_bounds(a_pi + mu1 * d_pi, a_pj + mu1 * d_pj,
                                       L_pi, U_pi, L_pj, U_pj)
            interior2 = (sb2.lo < mu2) & (mu2 < sb2.hi)
            feasible = okdet & interior1 & interior2 & (s.n_hist > 0)
            do_plan = s.prev_free & feasible
            mu_plan = torch.where(do_plan, mu1, mu_smo)
            ratio = mu1 / torch.where(torch.abs(mu_star) > 0, mu_star, 1.0)
            ratio_ok = torch.where(
                do_plan, (ratio >= 1.0 - eta) & (ratio <= 1.0 + eta),
                s.prev_ratio_ok)

        # after convergence the step is 0: pass B leaves G bitwise as it
        # was and alpha gains exactly 0
        mu = torch.where(active, torch.where(do_plan, mu_plan, mu_smo), 0.0)
        alpha.index_add_(0, sel, torch.cat([mu, -mu]))

        # ---- pass B: k_j + update with the stored k_i + next i + gap -------
        G_new, i_next, g_i_next, g_dn = ops.rbf_update_wss(
            X, sqn, G, k_i, alpha, L, U, X.index_select(0, sel[1:])[0], mu,
            gam, impl=impl, XT=XT)
        i_next = i_next.reshape(1)
        g_i_next = g_i_next.reshape(1)
        gap_new = qp_mod.finite_gap(g_i_next - g_dn)
        return _BatchState(
            alpha=alpha, G=G_new,
            i=torch.where(active, i_next, s.i),
            g_i=torch.where(active, g_i_next, s.g_i),
            gap=torch.where(active, gap_new, s.gap),
            iters=s.iters + active.to(torch.int32),
            done=s.done | (gap_new <= eps),
            pi=torch.where(active, i_sel, s.pi),
            pj=torch.where(active, j_sel, s.pj),
            qi=torch.where(active, s.pi, s.qi),
            qj=torch.where(active, s.pj, s.qj),
            n_hist=torch.where(active, torch.clamp_max(s.n_hist + 1, 2),
                               s.n_hist),
            p_smo=torch.where(active, ~do_plan, s.p_smo),
            prev_free=torch.where(active, (~do_plan) & free_smo,
                                  s.prev_free),
            prev_ratio_ok=torch.where(active, ratio_ok, s.prev_ratio_ok),
            n_planning=s.n_planning + (do_plan & active).to(torch.int32),
            act=s.act, n_unshrink=s.n_unshrink, u=s.u, ok=s.ok)

    # ---- init: alpha = 0, G = y ------------------------------------------
    alpha0 = torch.zeros_like(y)
    v_up = torch.where(alpha0 < U, y, float("-inf"))
    i0 = torch.argmax(v_up).reshape(1).to(torch.int32)
    g_i0 = v_up.take(i0.long())
    gap0 = qp_mod.finite_gap(
        g_i0 - torch.where(alpha0 > L, y, float("inf")).amin())
    z = torch.zeros((1,), dtype=torch.int32, device=dev)
    s = _BatchState(alpha=alpha0, G=y, i=i0, g_i=g_i0, gap=gap0, iters=z,
                    done=gap0 <= eps, pi=z, pj=z, qi=z, qj=z, n_hist=z,
                    p_smo=~no, prev_free=no, prev_ratio_ok=~no,
                    n_planning=z, act=~no[:, None], n_unshrink=z,
                    u=torch.zeros_like(y)[:1, None], ok=no)

    s, t = _drive(body, s, cfg.max_iter, check_every, _use_graphs(y, impl))
    if stats is not None:
        stats["relaunches"] = t if planning else 0
        stats["relaunches_ran"] = int(n_ran)

    g_up = torch.where(s.alpha < U, s.G, float("-inf")).amax()
    g_dn = torch.where(s.alpha > L, s.G, float("inf")).amin()
    return FusedResult(
        alpha=s.alpha, b=qp_mod.safe_bias(g_up, g_dn), G=s.G,
        iterations=s.iters[0],
        objective=0.5 * (torch.dot(y, s.alpha) + torch.dot(s.G, s.alpha)),
        kkt_gap=s.gap[0], converged=s.done[0], n_planning=s.n_planning[0],
        n_unshrink=s.n_unshrink[0])


def solve_fused_batched_qp(X, P, L, U, gamma,
                           cfg: SolverConfig = SolverConfig(), *,
                           impl: str = "auto", block_l: int = 1024,
                           alpha0=None, G0=None, gram=None, gram_idx=None,
                           doubled: bool = False, shrinking: bool = False,
                           check_every: int = CHECK_EVERY,
                           telemetry: RingConfig | None = None):
    """Solve B general dual QPs over the shared ``X`` in one loop.

    ``X`` (l, d), ``P`` (B, n), ``L``/``U`` (B, n) are tensors on one
    device with one dtype, n = l (or 2l with ``doubled=True``, the ε-SVR
    operator over the base ``X``: coordinate ``k`` takes the base row of
    ``k mod l``); ``gamma`` is a scalar or (B,).  ``impl`` picks the
    passes' backend (:func:`repro_torch.kernels.ops.resolve_impl`).

    Optional (B, n) ``alpha0``/``G0`` warm starts come as a pair (one-class
    lanes need them: alpha = 0 is infeasible there); without them the
    lanes start at alpha = 0, G = P.  ``gram`` (n_stack, n, n) and
    ``gram_idx`` (B,) also come as a pair: with them the passes read their
    rows from the shared (n_stack, l, l) base Gram bank (lanes sharing a
    gamma share an entry) instead of recomputing them from ``X``.
    ``shrinking=True`` turns on soft shrinking, ``cfg.step="conjugate"``
    the Conjugate-SMO step (module notes).

    The loop reads ``any(~done)`` every ``check_every`` iterations; the
    result does not depend on it.  Returns a :class:`FusedResult` whose
    ``iterations`` count per-lane iterations until that lane converged.

    ``telemetry`` (a :class:`~repro_torch.telemetry.ring.RingConfig`)
    turns on the flight recorder: every lane's KKT gap, active-set size
    and unshrink count are sampled every ``telemetry.sample_every``
    iterations and on the iteration the lane converges, and mu/mu* on each
    accepted planning (or conjugate) step; the return value is then
    ``(FusedResult, TelemetryRing)``, and the result is bitwise that of
    the run without it.  ``block_l`` is accepted and ignored (module
    notes).
    """
    del block_l
    _check_config(cfg)
    _check_cadence(check_every)
    if (alpha0 is None) != (G0 is None):
        raise ValueError("warm starts need the (alpha0, G0) pair")
    if (gram is None) != (gram_idx is None):
        raise ValueError("the Gram bank needs the (gram, gram_idx) pair")
    n = P.shape[1]
    if X.shape[0] * (2 if doubled else 1) != n:
        raise ValueError(f"X has {X.shape[0]} rows, the lanes {n} "
                         f"coordinates (doubled={doubled})")
    impl = ops.resolve_impl(impl, P.device)
    loop = _loop_for(
        (X, P, L, U, gamma, gram, gram_idx),
        lambda: _batched_loop(X, P, L, U, gamma, cfg, impl, gram, gram_idx,
                              doubled, shrinking, telemetry))
    s, _ = _drive(loop.body, loop.init(alpha0, G0), cfg.max_iter,
                  check_every, _use_graphs(P, impl), loop.period)
    return loop.finish(s)


def _batched_loop(X, P, L, U, gamma, cfg: SolverConfig, impl: str, gram,
                  gram_idx, doubled: bool, shrinking: bool,
                  telemetry: RingConfig | None) -> SimpleNamespace:
    """The loop of :func:`solve_fused_batched_qp` over its (checked)
    arguments: ``body(state, refresh)``, ``init(alpha0, G0)`` (the starting
    state), ``finish(state)`` (the result), ``period`` (of the mask
    refresh, 0 without shrinking) and ``reload()``, which recomputes in
    place what the body reads and was derived from the inputs (the rbf
    source's ``XT`` and squared norms, the lanes' gammas and bank
    indices), for a chunked round that wrote new values into the same
    input tensors (:func:`_loop_for`)."""
    dtype, device = P.dtype, P.device
    B, n = P.shape
    H = 2 if doubled else 1
    eps, eta = cfg.eps, cfg.eta
    planning = cfg.algorithm == "pasmo"
    conjugate = cfg.step == "conjugate"
    period = cfg.shrink_every if cfg.shrink_every > 0 else DEFAULT_SHRINK_EVERY
    if gram is None:
        src = row_source.rbf_source(X, gamma, B, dup=doubled)
    else:
        src = row_source.bank_source(gram, gram_idx, gamma, dup=doubled)
        if src.base_l * H != n or src.gram_idx.shape[0] != B:
            raise ValueError(f"a bank of {tuple(gram.shape)} and "
                             f"{src.gram_idx.shape[0]} bank indices for "
                             f"{B} lanes of {n} coordinates")

    def reload():
        fresh = (row_source.rbf_source(X, gamma, B, dup=doubled)
                 if gram is None else
                 row_source.bank_source(gram, gram_idx, gamma, dup=doubled))
        for f in ("XT", "sqn", "gammas", "gram_idx"):
            if getattr(src, f) is not None:
                getattr(src, f).copy_(getattr(fresh, f))

    lanes = torch.arange(B, device=device)
    lane_base = lanes * n
    base_l = n // H
    no_lanes = torch.zeros((B,), dtype=torch.bool, device=device)
    collect = telemetry is not None
    if collect:
        ring_bases = ring_mod.flat_bases(telemetry, B, device)
        if not shrinking:
            n_full = torch.full((B,), n, dtype=torch.int32, device=device)

    def take(M, idx):
        """Per-lane gathers at (k, B) or (B,) int indices -> same shape,
        each row contiguous (the passes take per-lane vectors by
        pointer)."""
        return M.take(lane_base + idx.long())

    def body(c, refresh: bool):
        s = _BatchState(*c[:_N_STATE]) if collect else c
        alpha, G = s.alpha, s.G
        active = ~s.done
        use_exact = (~s.p_smo) & (~s.prev_ratio_ok) if planning else no_lanes
        act = s.act if shrinking else None

        # ---- gathers at the historic indices, stacked (k, B) -------------
        if planning:
            hist = torch.stack([s.i, s.qi, s.qj, s.pi, s.pj])
        elif conjugate:
            hist = torch.stack([s.i, s.pi, s.pj])
        else:
            hist = s.i[None]
        A, Gh, Lh, Uh = (take(alpha, hist), take(G, hist), take(L, hist),
                         take(U, hist))
        a_i, L_i, U_i = A[0], Lh[0], Uh[0]

        # ---- pass A: j-selection ------------------------------------------
        j0, gain0 = ops.source_row_wss(src, G, alpha, L, U, s.i, a_i, L_i,
                                       U_i, s.g_i, use_exact, impl=impl,
                                       act=act)
        a_j0, G_j0, L_j0, U_j0 = (take(alpha, j0), take(G, j0),
                                  take(L, j0), take(U, j0))

        # ---- Alg. 3 extra candidate B^(t-2) (O(B d)) -----------------------
        if planning:
            e2 = src.entry_pairs(torch.cat([s.qi, s.pi]),
                                 torch.cat([s.qj, s.pj]), 2)
            K_qq, K_pp = e2[:B], e2[B:]
            a_qi, G_qi, L_qi, U_qi = A[1], Gh[1], Lh[1], Uh[1]
            a_qj, G_qj, L_qj, U_qj = A[2], Gh[2], Lh[2], Uh[2]
            l_q = G_qi - G_qj
            q_q = torch.clamp_min(2.0 - 2.0 * K_qq, TAU)
            sb_q = step_mod.step_bounds(a_qi, a_qj, L_qi, U_qi, L_qj, U_qj)
            mu_q = step_mod.clip_step(l_q / q_q, sb_q)
            cg_exact = step_mod.gain_of_step(mu_q, l_q, q_q)
            cg_tilde = 0.5 * l_q * l_q / q_q
            cg = torch.where(use_exact, cg_exact, cg_tilde)
            adm = ((a_qi < U_qi) & (a_qj > L_qj)
                   & (l_q > 0) & (s.qi != s.qj) & (s.n_hist > 1))
            take_q = (~s.p_smo) & adm & (cg > gain0)
            i_sel = torch.where(take_q, s.qi, s.i)
            j_sel = torch.where(take_q, s.qj, j0)
            g_i_sel = torch.where(take_q, G_qi, s.g_i)
            a_isel = torch.where(take_q, a_qi, a_i)
            L_isel = torch.where(take_q, L_qi, L_i)
            U_isel = torch.where(take_q, U_qi, U_i)
            a_jsel = torch.where(take_q, a_qj, a_j0)
            G_jsel = torch.where(take_q, G_qj, G_j0)
            L_jsel = torch.where(take_q, L_qj, L_j0)
            U_jsel = torch.where(take_q, U_qj, U_j0)
        else:
            i_sel, j_sel, g_i_sel = s.i, j0, s.g_i
            a_isel, L_isel, U_isel = a_i, L_i, U_i
            a_jsel, G_jsel, L_jsel, U_jsel = a_j0, G_j0, L_j0, U_j0

        # ---- O(B) step computation ----------------------------------------
        lw = g_i_sel - G_jsel
        K_ij = src.entry_pairs(i_sel, j_sel, 1)
        q11 = torch.clamp_min(2.0 - 2.0 * K_ij, TAU)
        sb = step_mod.step_bounds(a_isel, a_jsel, L_isel, U_isel,
                                  L_jsel, U_jsel)
        mu_star = lw / q11
        mu_smo, free_smo = step_mod.smo_step(lw, q11, sb)

        do_plan = no_lanes
        mu_plan = mu_smo
        ratio_ok = s.prev_ratio_ok
        if planning:
            a_pi, G_pi, L_pi, U_pi = A[3], Gh[3], Lh[3], Uh[3]
            a_pj, G_pj, L_pj, U_pj = A[4], Gh[4], Lh[4], Uh[4]
            w2 = G_pi - G_pj
            q22 = torch.clamp_min(2.0 - 2.0 * K_pp, TAU)
            e4 = src.entry_pairs(
                torch.cat([i_sel, i_sel, j_sel, j_sel]),
                torch.cat([s.pi, s.pj, s.pi, s.pj]), 4)
            q12 = e4[:B] - e4[B:2 * B] - e4[2 * B:3 * B] + e4[3 * B:]
            terms = step_mod.PlanningTerms(w1=lw, w2=w2, Q11=q11, Q22=q22,
                                           Q12=q12)
            mu1, okdet = step_mod.planning_step(terms)
            mu2 = step_mod.planned_second_step(mu1, terms)
            interior1 = (sb.lo < mu1) & (mu1 < sb.hi)
            d_pi = ((s.pi == i_sel).to(dtype) - (s.pi == j_sel).to(dtype))
            d_pj = ((s.pj == i_sel).to(dtype) - (s.pj == j_sel).to(dtype))
            sb2 = step_mod.step_bounds(a_pi + mu1 * d_pi, a_pj + mu1 * d_pj,
                                       L_pi, U_pi, L_pj, U_pj)
            interior2 = (sb2.lo < mu2) & (mu2 < sb2.hi)
            feasible = okdet & interior1 & interior2 & (s.n_hist > 0)
            do_plan = s.prev_free & feasible
            mu_plan = torch.where(do_plan, mu1, mu_smo)
            ratio = mu1 / torch.where(torch.abs(mu_star) > 0, mu_star, 1.0)
            ratio_ok = torch.where(
                do_plan, (ratio >= 1.0 - eta) & (ratio <= 1.0 + eta),
                s.prev_ratio_ok)

        if conjugate:
            # ---- Conjugate-SMO 2x2 step (O(B), no extra kernel rows) ------
            # directions v1 = e_i - e_j and v2 = e_pi - e_pj; Q v2 is the
            # carried u, so every restriction term is a per-lane gather (a
            # doubled coordinate reads its base column)
            a_pi, G_pi, L_pi, U_pi = A[1], Gh[1], Lh[1], Uh[1]
            a_pj, G_pj, L_pj, U_pj = A[2], Gh[2], Lh[2], Uh[2]
            four = torch.stack([i_sel, j_sel, s.pi, s.pj])
            col = four.long() % base_l if doubled else four.long()
            uh = s.u.take(lanes * base_l + col)
            w2 = G_pi - G_pj
            terms = step_mod.PlanningTerms(w1=lw, w2=w2, Q11=q11,
                                           Q22=uh[2] - uh[3],
                                           Q12=uh[0] - uh[1])
            mu1c, mu2c, okdet = step_mod.conjugate_step(terms)
            # the four touched coordinates' state before the step, and
            # each one's net displacement under m1 v1 + m2 v2 (indicator
            # arithmetic: the pairs may overlap)
            a4 = torch.stack([a_isel, a_jsel, a_pi, a_pj])
            L4 = torch.stack([L_isel, L_jsel, L_pi, L_pj])
            U4 = torch.stack([U_isel, U_jsel, U_pi, U_pj])

            def moved(m1, m2):
                return (m1 * ((four == i_sel).to(dtype)
                              - (four == j_sel).to(dtype))
                        + m2 * ((four == s.pi).to(dtype)
                                - (four == s.pj).to(dtype)))

            a_try = a4 + moved(mu1c, mu2c)
            inter = ((L4 < a_try) & (a_try < U4)).all(dim=0)
            # the exact 2-D gain dominates the 1-D Newton gain for a PD
            # minor: the comparison guards near-degenerate numerics only
            g2 = 0.5 * (lw * mu1c + w2 * mu2c)
            g1 = step_mod.gain_newton(lw, q11)
            do_plan = (s.ok & (s.n_hist >= 1) & okdet & inter
                       & (g2 + TAU >= g1))
            mu_plan = torch.where(do_plan, mu1c, mu_smo)

        # lane freeze: converged lanes take a zero step, so pass B leaves
        # their G bitwise unchanged and alpha gains exactly 0.  The isfinite
        # guard also freezes a lane for one repair iteration when an
        # unshrink left it with a -inf g_i (an empty masked I_up).
        live = active & torch.isfinite(lw)
        mu = torch.where(live, torch.where(do_plan, mu_plan, mu_smo), 0.0)
        conj_kw = {}
        if conjugate:
            # the second direction's step, 0 on rejected and frozen lanes.
            # Each touched coordinate gets its net displacement, summed in
            # a fixed order, through a plain scatter: coordinates that
            # repeat receive equal values, so the update is deterministic
            # on the card (an accumulating scatter runs atomics there)
            mu2v = torch.where(live & do_plan, mu2c, 0.0)
            alpha.view(-1).index_put_(
                ((lane_base + four.long()).reshape(-1),),
                (a4 + moved(mu, mu2v)).reshape(-1))
            conj_kw = dict(dirv=s.u, mu2=mu2v)
        else:
            # both working-set coordinates through one accumulating
            # scatter, in place on the carried alpha
            alpha.view(-1).index_add_(
                0, torch.cat([lane_base + i_sel.long(),
                              lane_base + j_sel.long()]),
                torch.cat([mu, -mu]))

        # ---- pass B: k_i/k_j + update + next i + gap -----------------------
        out = ops.source_update_wss(src, G, alpha, L, U, i_sel, j_sel, mu,
                                    impl=impl, act=act, **conj_kw)
        G_new, i_next, g_i_next, g_dn = out[:4]
        gap_new = qp_mod.finite_gap(g_i_next - g_dn)
        if shrinking:
            # a lane is done only when its mask was full at the scan that
            # gave the gap; a partial-mask "solved" lane is unshrunk in
            # place and goes on (G is exact on every coordinate)
            full_now = s.act.all(dim=1)
            locally_done = gap_new <= eps
            unshrink = active & locally_done & ~full_now
            done = s.done | (active & locally_done & full_now)
            act2 = (qp_mod.shrink_mask(G_new, alpha, L, U) if refresh
                    else s.act)
            act_new = torch.where((active & ~done)[:, None],
                                  act2 | unshrink[:, None], s.act)
            n_unshrink = s.n_unshrink + unshrink.to(torch.int32)
        else:
            done = s.done | (gap_new <= eps)
            act_new, n_unshrink = s.act, s.n_unshrink
        u_new, ok_new = s.u, s.ok
        if conjugate:
            # the next direction is pass B's row difference; it is valid
            # after an accepted or a free step, and resets on a clipped
            # step, a mask refresh and an unshrink
            u_new = torch.where(active[:, None], out[4], s.u)
            c_ok = do_plan | free_smo
            if shrinking:
                c_ok = torch.zeros_like(c_ok) if refresh else c_ok & ~unshrink
            ok_new = torch.where(active, c_ok, s.ok)
        new_s = _BatchState(
            alpha=alpha, G=G_new,
            i=torch.where(active, i_next, s.i),
            g_i=torch.where(active, g_i_next, s.g_i),
            gap=torch.where(active, gap_new, s.gap),
            iters=s.iters + active.to(torch.int32),
            done=done,
            pi=torch.where(active, i_sel, s.pi),
            pj=torch.where(active, j_sel, s.pj),
            qi=torch.where(active, s.pi, s.qi),
            qj=torch.where(active, s.pj, s.qj),
            n_hist=torch.where(active, torch.clamp_max(s.n_hist + 1, 2),
                               s.n_hist),
            p_smo=torch.where(active, ~do_plan, s.p_smo),
            prev_free=torch.where(active, (~do_plan) & free_smo,
                                  s.prev_free),
            prev_ratio_ok=torch.where(active, ratio_ok, s.prev_ratio_ok),
            n_planning=s.n_planning + (do_plan & active).to(torch.int32),
            act=act_new, n_unshrink=n_unshrink, u=u_new, ok=ok_new)
        if not collect:
            return new_s

        # ---- flight recorder: O(B) masked writes, no host read ------------
        plan_kw = {}
        if planning or conjugate:
            # conjugate steps ride the planning channel (the modes exclude
            # each other): mu1/mu* of each accepted step
            if conjugate:
                ratio = mu1c / torch.where(torch.abs(mu_star) > 0, mu_star,
                                           1.0)
            plan_kw = dict(plan_event=do_plan, ratio=ratio)
        # the write rule masks both with ``active``: ``done`` there is the
        # lanes that froze on this iteration, ``do_plan`` the accepted
        # steps (one kernel each saved)
        bufs = ring_mod.RingBuffers(*c[_N_STATE + 1:])
        ring_mod.ring_write(
            bufs, telemetry, t=c.step, active=active, newly_done=done,
            gap=new_s.gap,
            n_active=(act_new.sum(dim=1, dtype=torch.int32) if shrinking
                      else n_full),
            n_unshrink=n_unshrink, bases=ring_bases, **plan_kw)
        c.step.add_(1)
        return _TelState(*new_s, c.step, *bufs)

    def init(alpha0, G0):
        """The starting state: alpha = 0, G = P unless warm-started."""
        if alpha0 is None:
            alpha0, G0 = torch.zeros_like(P), P
        else:
            # alpha is updated in place: the caller's tensor stays untouched
            alpha0 = torch.as_tensor(alpha0, dtype=dtype,
                                     device=device).clone()
            G0 = torch.as_tensor(G0, dtype=dtype, device=device)
            if alpha0.shape != P.shape or G0.shape != P.shape:
                raise ValueError(f"alpha0 {tuple(alpha0.shape)} and G0 "
                                 f"{tuple(G0.shape)} must match P "
                                 f"{tuple(P.shape)}")
        v_up = torch.where(alpha0 < U, G0, float("-inf"))
        i0 = torch.argmax(v_up, dim=1).to(torch.int32)
        g_i0 = take(v_up, i0)
        gap0 = qp_mod.finite_gap(
            g_i0 - torch.where(alpha0 > L, G0, float("inf")).amin(dim=1))
        zB = torch.zeros((B,), dtype=torch.int32, device=device)
        act0 = torch.ones((B, n) if shrinking else (B, 1), dtype=torch.bool,
                          device=device)
        # the conjugate carry starts empty in every call (a chunk seam too)
        u0 = torch.zeros((B, base_l) if conjugate else (B, 1), dtype=dtype,
                         device=device)
        s = _BatchState(alpha=alpha0, G=G0, i=i0, g_i=g_i0, gap=gap0,
                        iters=zB, done=gap0 <= eps, pi=zB, pj=zB, qi=zB,
                        qj=zB, n_hist=zB, p_smo=~no_lanes,
                        prev_free=no_lanes, prev_ratio_ok=~no_lanes,
                        n_planning=zB, act=act0, n_unshrink=zB, u=u0,
                        ok=no_lanes)
        if collect:
            s = _TelState(*s, torch.zeros((), dtype=torch.int32,
                                          device=device),
                          *ring_mod.ring_buffers(ring_mod.ring_init(
                              telemetry, B, dtype, device)))
        return s

    def finish(s):
        """The result of the final state ``s``."""
        up = s.alpha < U
        dn = s.alpha > L
        g_up = torch.where(up, s.G, float("-inf")).amax(dim=1)
        g_dn = torch.where(dn, s.G, float("inf")).amin(dim=1)
        res = FusedResult(
            alpha=s.alpha, b=qp_mod.safe_bias(g_up, g_dn), G=s.G,
            iterations=s.iters,
            objective=0.5 * (torch.sum(P * s.alpha, dim=1)
                             + torch.sum(s.G * s.alpha, dim=1)),
            kkt_gap=s.gap, converged=s.done, n_planning=s.n_planning,
            n_unshrink=s.n_unshrink)
        if not collect:
            return res
        return res, ring_mod.ring_view(
            ring_mod.RingBuffers(*s[_N_STATE + 1:]))

    return SimpleNamespace(body=body, init=init, finish=finish,
                           reload=reload,
                           period=period if shrinking else 0)


def solve_fused_batched(X, Y, C, gamma, cfg: SolverConfig = SolverConfig(),
                        *, impl: str = "auto", block_l: int = 1024,
                        alpha0=None, G0=None, gram=None, gram_idx=None,
                        device=None, dtype=None, shrinking: bool = False,
                        check_every: int = CHECK_EVERY,
                        telemetry: RingConfig | None = None):
    """Solve B RBF *classification* QPs over the shared ``X`` in one loop —
    the ``p = y`` instance of :func:`solve_fused_batched_qp`.

    An entry point: ``X`` (l, d) and ``Y`` (B, l) signed labels (arrays or
    tensors) move to ``device``, which defaults to the CUDA card and
    raises without one (``device="cpu"`` runs the plain versions on the
    CPU).  ``dtype`` defaults to ``Y``'s when it is a floating tensor, else
    to ``torch.get_default_dtype()``.  ``C`` is a scalar, (B,) per-lane or
    (B, l) per-sample budgets (class-weighted SVC); ``gamma`` a scalar or
    (B,).  The warm start ``alpha0``/``G0``, the Gram bank
    ``gram``/``gram_idx``, ``shrinking``, ``telemetry`` (the return value
    is then ``(FusedResult, TelemetryRing)``) and the ignored ``block_l``
    are as in :func:`solve_fused_batched_qp`; the bank moves to ``device``
    and ``dtype`` too.
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
    return solve_fused_batched_qp(
        X, Y, torch.clamp_max(YC, 0.0), torch.clamp_min(YC, 0.0), gamma, cfg,
        impl=impl, block_l=block_l, alpha0=alpha0, G0=G0, gram=gram,
        gram_idx=gram_idx, shrinking=shrinking, check_every=check_every,
        telemetry=telemetry)


# ---------------------------------------------------------------------------
# Chunked host driver: hard row compaction + lane compaction
# ---------------------------------------------------------------------------


def _pow2(n: int) -> int:
    """Smallest power of two >= n: the lane and row buckets."""
    b = 1
    while b < n:
        b *= 2
    return b


def _merge_chunk_ring(rc: RingConfig, ring: TelemetryRing, live, it_off,
                      un_off, tel: dict) -> None:
    """Fold one chunk's ring into the run's host buffers ``tel``.

    A chunk's ring stamps chunk-local iterations and unshrink counts;
    ``it_off``/``un_off`` (per live lane, before this chunk was added)
    rebase them to the run's.  Slots follow the device rule (oldest kept,
    the last slot the newest), so a chunked run keeps the samples one
    unchunked ring would.  The chunk's ring is read to the host once.
    """
    m_live = len(live)
    r = {k: getattr(ring, k)[:m_live].cpu().numpy() for k in ring_mod.FIELDS}
    for k, lane in enumerate(live):
        ns = int(min(r["n_samples"][k], rc.cap))
        if ns:
            # repeated last slots resolve to the newest write
            slots = np.minimum(tel["n_samples"][lane] + np.arange(ns),
                               rc.cap - 1)
            tel["t"][lane, slots] = r["t"][k, :ns] + it_off[k]
            tel["gap"][lane, slots] = r["gap"][k, :ns]
            tel["n_active"][lane, slots] = r["n_active"][k, :ns]
            tel["n_unshrink"][lane, slots] = (r["n_unshrink"][k, :ns]
                                              + un_off[k])
            tel["n_samples"][lane] += int(r["n_samples"][k])
        nr = int(min(r["n_ratio"][k], rc.ratio_cap))
        if nr:
            slots = np.minimum(tel["n_ratio"][lane] + np.arange(nr),
                               rc.ratio_cap - 1)
            tel["ratio"][lane, slots] = r["ratio"][k, :nr]
            tel["ratio_t"][lane, slots] = r["ratio_t"][k, :nr] + it_off[k]
            tel["n_ratio"][lane] += int(r["n_ratio"][k])


def _chunk_buffers(cache: _GraphCache, X, gram, dtype, bsz: int, rb: int,
                   doubled: bool, whole: bool) -> SimpleNamespace:
    """The input buffers of a chunked driver's cache entry (lane bucket
    ``bsz``, row bucket ``rb``): ``X`` (rb, d), ``P``, ``L``, ``U`` (bsz,
    rb or 2 rb) and ``gam`` (bsz,) in ``dtype``, and with a bank ``gram``
    (``None`` for the rbf source) the lanes' entries ``gidx`` (bsz,) and
    the rows' source: the bank itself when ``whole``, else the (n_stack,
    rb, rb) slice of the row bucket, which the entries of one row bucket
    share."""
    n = rb * (2 if doubled else 1)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=X.device)

    out = SimpleNamespace(X=X.new_zeros((rb, X.shape[1])), P=zeros(bsz, n),
                          L=zeros(bsz, n), U=zeros(bsz, n), gam=zeros(bsz))
    if gram is not None:
        out.gidx = torch.zeros((bsz,), dtype=torch.int64, device=X.device)
        out.gram = gram if whole else cache.slice(
            ("bank", rb), lambda: gram.new_zeros((gram.shape[0], rb, rb)))
    return out


def solve_fused_chunked_qp(X, P, L, U, gamma,
                           cfg: SolverConfig = SolverConfig(), *,
                           impl: str = "auto", block_l: int = 1024,
                           chunk: int = 96, shrinking: bool = False,
                           doubled: bool = False, alpha0=None, G0=None,
                           gram=None, gram_idx=None, mesh=None, devices=None,
                           diagnostics=None, check_every: int = CHECK_EVERY):
    """:func:`solve_fused_batched_qp` in chunks of ``chunk`` iterations,
    with HARD compaction of both axes between chunks.

    * **lanes** — a lane whose chunk converged retires after a full-set
      KKT check, so later chunks launch over the live lanes only;
    * **rows** — with ``shrinking=True`` the shrink rule
      (:func:`repro_torch.core.qp.shrink_mask`, the union over live lanes,
      the doubled halves folded onto the base axis) keeps the base rows
      some live lane still needs, and the next chunk runs at that width.
      The row set only shrinks, until an unshrink resets it.

    Lanes and rows are bucketed to powers of two; padded coordinates have
    ``L = U = 0`` and are never selected.  With doubled lanes a chunk's
    state is ``[sub, pad, sub2, pad]``: the half offset is the bucketed
    width.  The bank row source is sliced to the kept rows into an
    (n_stack, rb, rb) buffer (the bank itself while every row is kept and
    l is a power of two).

    The state carried across chunks (alpha, G, and the problem P, L, U)
    stays in float64 on the device and is cast to the run's dtype per
    chunk.  G is stale on dropped rows, so a lane is never retired from
    the shrunken problem alone: its G is rebuilt exactly (``P - Q alpha``
    through :meth:`~repro_torch.kernels.row_source.RowSource.matvec`) and
    the full-set gap checked; a failed check counts an unshrink, rebuilds
    every live lane's G and resets the rows to the full set.

    Arguments are those of :func:`solve_fused_batched_qp`, plus ``chunk``,
    the iterations of one sub-solve; ``block_l`` is accepted and ignored.
    ``mesh``/``devices`` lane-shard every chunk
    (:func:`repro_torch.core.sharded_lanes.solve_fused_sharded_qp` is then
    the chunk solver): lane compaction stays on the host between chunks,
    so sharding and compaction stack, and each slab of a round solves in a
    cache entry of its own (:meth:`_Entry.slab`), captured once per chunk
    shape however many rounds it serves.

    While a recorder is active (``diagnostics``, a
    :class:`repro_torch.telemetry.Diagnostics`, or
    :func:`repro_torch.telemetry.recording`), the phases of a round are its
    spans (:mod:`repro_torch.telemetry.spans`):
    ``chunked.slice`` (the gathers and the bank slice), ``chunked.solve``
    (the chunk solve), ``chunked.rebuild`` (the matvec rebuilds) and
    ``chunked.checks`` (the host's checks and row shrink); each chunk
    solve emits a ``chunk_solve`` ``phase`` event (its seconds: the
    device's time between the span's CUDA events, read once the round's
    checks have read the card back, or the host's off the card; the
    round, live lanes and kept rows), and a
    :class:`~repro_torch.runtime.fault.StepMonitor` over those times
    emits ``straggler_warning`` events.  The driver adds no
    synchronisation.  With ``diagnostics.ring_config`` the chunks' rings
    are rebased to run-wide stamps and merged per lane, and the return
    value is ``(FusedResult, TelemetryRing)``.  Returns a lane-flat
    :class:`FusedResult` whose
    ``iterations``/``n_planning``/``n_unshrink`` add up over chunks and
    whose ``G`` is exact on every coordinate.
    """
    del block_l
    _check_config(cfg)
    _check_cadence(check_every)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if (alpha0 is None) != (G0 is None):
        raise ValueError("warm starts need the (alpha0, G0) pair")
    if (gram is None) != (gram_idx is None):
        raise ValueError("the Gram bank needs the (gram, gram_idx) pair")
    # sharded_lanes imports this module
    from repro_torch.core import sharded_lanes
    chunk_solver = sharded_lanes.lane_solver(
        None if mesh is None and devices is None
        else sharded_lanes.resolve_lane_mesh(mesh, devices))
    dtype, dev = P.dtype, P.device
    f64 = torch.float64
    B, n = P.shape
    lb, d = X.shape
    if lb * (2 if doubled else 1) != n:
        raise ValueError(f"X has {lb} rows, the lanes {n} coordinates "
                         f"(doubled={doubled})")
    bank = gram is not None
    P64 = P.to(f64)
    L64 = L.to(f64).broadcast_to((B, n))
    U64 = U.to(f64).broadcast_to((B, n))
    gam = torch.as_tensor(gamma, dtype=dtype, device=dev).reshape(-1)
    gam = gam.broadcast_to((B,)).contiguous()
    if bank:
        gidx = torch.as_tensor(gram_idx, dtype=torch.int64, device=dev)
    eps = float(cfg.eps)
    ccfg = dataclasses.replace(cfg, max_iter=min(chunk, cfg.max_iter))

    if alpha0 is None:
        alpha = torch.zeros((B, n), dtype=f64, device=dev)
        G = P64.clone()
    else:
        alpha = torch.as_tensor(alpha0, device=dev).to(f64).clone()
        G = torch.as_tensor(G0, device=dev).to(f64).clone()

    out_b = torch.zeros(B, dtype=f64, device=dev)
    out_gap = torch.zeros(B, dtype=f64, device=dev)
    out_obj = torch.zeros(B, dtype=f64, device=dev)
    out_conv = torch.zeros(B, dtype=torch.bool, device=dev)
    out_iter = np.zeros(B, np.int64)
    out_plan = np.zeros(B, np.int64)
    out_unshrink = np.zeros(B, np.int64)

    # ---- flight recorder: no work while no recorder is active ------------
    rc = None if diagnostics is None else diagnostics.ring_config
    rec = spans.recorder(diagnostics)
    if rec is not None:
        monitor = StepMonitor(warmup_steps=1)
    if rc is not None:
        empty = ring_mod.ring_init(rc, B, torch.float64)
        tel = {k: getattr(empty, k).numpy() for k in ring_mod.FIELDS}

    def span(name):
        """The round's phase ``name``: a span of the recorder, or
        nothing."""
        return spans._NULL if rec is None else rec.span(name, dev)

    def reconstruct(idx):
        """Exact full-width G = P - Q alpha for the lanes ``idx``."""
        with span("chunked.rebuild"):
            idx_t = torch.as_tensor(idx, device=dev)
            if bank:
                src = row_source.bank_source(gram, gidx[idx_t], dup=doubled)
            else:
                src = row_source.rbf_source(X, gam[idx_t], len(idx),
                                            dup=doubled)
            mv = src.matvec(alpha[idx_t].to(dtype))
            G[idx_t] = P64[idx_t] - mv.to(f64)

    def finalize(idx):
        """Full-set (b, kkt_gap, objective) of the lanes ``idx`` from the
        exact float64 state, written into the outputs."""
        idx_t = torch.as_tensor(idx, device=dev)
        a, g = alpha[idx_t], G[idx_t]
        g_up = torch.where(a < U64[idx_t], g, float("-inf")).amax(dim=1)
        g_dn = torch.where(a > L64[idx_t], g, float("inf")).amin(dim=1)
        gap = qp_mod.finite_gap(g_up - g_dn)
        out_b[idx_t] = qp_mod.safe_bias(g_up, g_dn)
        out_gap[idx_t] = gap
        out_obj[idx_t] = 0.5 * torch.sum((P64[idx_t] + g) * a, dim=1)
        return gap

    live = np.arange(B)
    keep = torch.arange(lb, device=dev)
    max_rounds = 4 * max(1, -(-cfg.max_iter // chunk)) + 16
    cache = _GraphCache()
    for rnd in range(max_rounds):
        if len(live) == 0:
            break
        m, m_live = keep.numel(), len(live)
        bsz, rb = _pow2(m_live), _pow2(m)
        # the bank itself serves a round that keeps every row of a
        # power-of-two l; any other reads a slice of it
        whole = bank and m == lb == rb
        ent = cache.entry(
            (bsz, rb, dtype, doubled, shrinking, bank, whole, ccfg, rc,
             check_every),
            lambda: _chunk_buffers(cache, X, gram if bank else None, dtype,
                                   bsz, rb, doubled, whole))
        b = ent.bufs
        if rec is not None:
            rec.end_prep()
        with span("chunked.slice"):
            lanes = torch.as_tensor(np.concatenate(
                [live, np.repeat(live[:1], bsz - m_live)]), device=dev)
            cols = torch.cat([keep, keep + lb]) if doubled else keep

            def gather(A):
                """Kept-coordinate lane state in the run's dtype, padded
                to the row bucket with inert coordinates."""
                sub = A.index_select(0, lanes).index_select(1, cols)
                z = sub.new_zeros((bsz, rb - m))
                parts = ([sub[:, :m], z, sub[:, m:], z] if doubled
                         else [sub, z])
                return torch.cat(parts, dim=1).to(dtype)

            # the round's values, written into the entry's buffers, which
            # its captured graphs read
            b.X.copy_(torch.cat([X.index_select(0, keep),
                                 X.new_zeros((rb - m, d))]))
            for buf, A in zip((b.P, b.L, b.U), (P64, L64, U64)):
                buf.copy_(gather(A))
            b.gam.copy_(gam[lanes])
            bank_kw = {}
            if bank:
                b.gidx.copy_(gidx[lanes])
                if not whole:
                    for g in range(gram.shape[0]):
                        b.gram[g, :m, :m] = gram[g].index_select(
                            0, keep).index_select(1, keep)
                    b.gram[:, m:].zero_()
                    b.gram[:, :m, m:].zero_()
                bank_kw = dict(gram=b.gram, gram_idx=b.gidx)
            args = [gather(A) for A in (alpha, G)]
        with span("chunked.solve") as solved, _solving(ent):
            res = chunk_solver(
                b.X, b.P, b.L, b.U, b.gam, ccfg, impl=impl, alpha0=args[0],
                G0=args[1], doubled=doubled, shrinking=shrinking,
                check_every=check_every, telemetry=rc, **bank_kw)
        del bank_kw, args
        if rc is not None:
            res, ring = res
            _merge_chunk_ring(rc, ring, live, out_iter[live],
                              out_unshrink[live], tel)
            del ring

        with span("chunked.checks"):
            live_t = lanes[:m_live]
            ra = res.alpha[:m_live].to(f64)
            rg = res.G[:m_live].to(f64)
            sel = [(keep, slice(0, m))]
            if doubled:
                sel.append((keep + lb, slice(rb, rb + m)))
            for c, part in sel:
                alpha[live_t[:, None], c[None, :]] = ra[:, part]
                G[live_t[:, None], c[None, :]] = rg[:, part]
            out_iter[live] += res.iterations[:m_live].cpu().numpy()
            out_plan[live] += res.n_planning[:m_live].cpu().numpy()
            out_unshrink[live] += res.n_unshrink[:m_live].cpu().numpy()
            conv = res.converged[:m_live].cpu().numpy()
        del res
        if rec is not None:
            # the reads above waited for the chunk: its events are done
            ms = rec.resolve(solved)
            dt = (solved.host_ms if ms is None else ms) / 1e3
            if rec.sink is not None:
                rec.sink.emit("phase", name="chunk_solve", seconds=dt,
                              round=rnd, lanes=m_live, rows=m)
            # the EWMA deadline over the chunks' times
            if monitor.record(dt) and rec.sink is not None:
                rec.sink.emit(
                    "straggler_warning", round=rnd, seconds=dt,
                    deadline=monitor.deadline, lanes=live.tolist(), rows=m)

        # ---- retire converged lanes (full KKT check when rows dropped) ----
        need_unshrink = False
        retired = np.zeros(m_live, bool)
        cand = live[conv]
        if len(cand):
            if m < lb:
                reconstruct(cand)
            with span("chunked.checks"):
                ok = (finalize(cand) <= eps).cpu().numpy()
            out_conv[torch.as_tensor(cand[ok], device=dev)] = True
            failed = cand[~ok]
            if len(failed):
                out_unshrink[failed] += 1
                need_unshrink = True
            retired[np.nonzero(conv)[0][ok]] = True

        # ---- retire exhausted lanes (budget spent, unconverged) -----------
        exh_pos = np.nonzero((~retired) & (out_iter[live] >= cfg.max_iter))[0]
        if len(exh_pos):
            exh = live[exh_pos]
            if m < lb:
                reconstruct(exh)
            with span("chunked.checks"):
                gap_e = finalize(exh)
                out_conv[torch.as_tensor(exh, device=dev)] = gap_e <= eps
            retired[exh_pos] = True

        live = live[~retired]
        if len(live) == 0:
            break

        if need_unshrink:
            # the stored G is stale on dropped rows for every live lane
            if m < lb:
                reconstruct(live)
            keep = torch.arange(lb, device=dev)
        elif shrinking and m > 1:
            # monotone row shrink from the exact kept-coordinate state: a
            # base row stays if any live lane still needs it
            with span("chunked.checks"):
                live_t = torch.as_tensor(live, device=dev)
                cols = torch.cat([keep, keep + lb]) if doubled else keep
                part = [A.index_select(0, live_t).index_select(1, cols)
                        for A in (G, alpha, L64, U64)]
                union = qp_mod.shrink_mask(*part).any(dim=0)
                if doubled:
                    union = union[:m] | union[m:]
                if bool(union.any()) and not bool(union.all()):
                    keep = keep[union]

    if len(live):
        # the round bound was hit: finalize the stragglers from exact state
        if keep.numel() < lb:
            reconstruct(live)
        gap_l = finalize(live)
        out_conv[torch.as_tensor(live, device=dev)] = gap_l <= eps

    def as_i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    result = FusedResult(
        alpha=alpha.to(dtype), b=out_b.to(dtype), G=G.to(dtype),
        iterations=as_i32(out_iter), objective=out_obj.to(dtype),
        kkt_gap=out_gap.to(dtype), converged=out_conv,
        n_planning=as_i32(out_plan), n_unshrink=as_i32(out_unshrink))
    if rc is None:
        return result
    return result, TelemetryRing(**{
        k: torch.as_tensor(v, device=dev).to(
            dtype if v.dtype == np.float64 else torch.int32)
        for k, v in tel.items()})
