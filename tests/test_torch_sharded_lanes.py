"""The port's lane-sharded engine (``repro_torch.core.sharded_lanes``)
against ``repro.core.sharded_lanes`` and the reference's batched engine,
on the CPU.

One slab is bitwise the port's batched engine (alpha, iterations, every
field), as the reference holds its one-device mesh; each case is also held
against the reference (objectives to 1e-6).  Several slabs are several
``"cpu"`` entries of ``devices`` in this process (the reference respawns
with forced host devices): the pads are stripped, the lanes come back in
the caller's order and the objectives hold the reference's batched
engine (``impl="jnp"``) to 1e-6, the reference's own promise for its
sharded engine.  Last, the repairs that let slabs run in host threads:
launch tallies, the capture's counts and garbage collection, the build
lock, the kernels' per-device flags and a round's entry in a slab
thread.
"""

import collections
import contextlib
import dataclasses
import gc
import pathlib
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as jgrid
from repro.core.sharded_lanes import lane_schedule as j_lane_schedule
from repro.core.solver import SolverConfig as JConfig
from repro.core.solver_fused import solve_fused_batched as j_batched
from repro.svm import SVC as JSVC
from repro_torch import kernels
from repro_torch.analysis import capture_guard
from repro_torch.core import grid, sharded_lanes, solver_fused
from repro_torch.core import multiclass as mc
from repro_torch.core.sharded_lanes import (lane_schedule, pad_lanes,
                                            resolve_lane_mesh,
                                            solve_fused_sharded,
                                            solve_fused_sharded_qp)
from repro_torch.core.solver import SolverConfig
from repro_torch.core.solver_fused import solve_fused_batched
from repro_torch.kernels import build, ops
from repro_torch.launch.mesh import LaneMesh, make_lane_mesh
from repro_torch.svm import SVC, data

F64 = dict(device="cpu", dtype=torch.float64)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _same(a, b):
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def _problem(l=120, k=3, seed=0):
    X, y = data.multiclass_blobs(l, seed=seed, k=k)
    Y = mc.ovr_labels(mc.class_index(y)[1], k, torch.float64).numpy()
    return X, y, Y


def _close(got, want, atol=1e-6):
    """Objectives of several slabs at eps = 1e-5 against the reference's
    batched engine, as the reference holds its own sharded engine."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _agree(got, want):
    """Objectives against the reference at eps = 1e-3: rtol 1e-6."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# scheduling, padding, the mesh
# ---------------------------------------------------------------------------

def test_lane_schedule_round_robin_deal():
    cost = np.array([3.0, 8.0, 1.0, 5.0, 7.0, 2.0, 6.0, 4.0])
    order, inv = lane_schedule(torch.as_tensor(cost), 4)
    assert order.dtype == inv.dtype == torch.int64
    slabs = cost[order.numpy()].reshape(4, 2)
    assert np.all(slabs[:, 0] == [8.0, 7.0, 6.0, 5.0])
    assert np.all(slabs[:, 1] == [4.0, 3.0, 2.0, 1.0])
    assert np.array_equal(order.numpy()[inv.numpy()], np.arange(8))
    j_order, j_inv = j_lane_schedule(jnp.asarray(cost), 4)
    assert np.array_equal(order.numpy(), np.asarray(j_order))
    assert np.array_equal(inv.numpy(), np.asarray(j_inv))
    # equal costs keep the caller's order
    order, _ = lane_schedule(torch.ones(6), 2)
    assert order.tolist() == [0, 2, 4, 1, 3, 5]


def test_lane_schedule_requires_divisibility():
    with pytest.raises(ValueError, match="pad"):
        lane_schedule(torch.ones(10), 4)


def test_pad_lanes():
    A = torch.arange(6.0).reshape(3, 2)
    P = pad_lanes(A, 2)
    assert P.shape == (5, 2) and bool((P[3:] == 0.0).all())
    assert torch.equal(P[:3], A)
    assert float(pad_lanes(torch.ones(3), 1, value=7.0)[3]) == 7.0
    assert pad_lanes(A, 0) is A


def test_resolve_lane_mesh_validation(monkeypatch):
    with pytest.raises(ValueError, match="no 'data' axis"):
        resolve_lane_mesh(LaneMesh(("cpu",), axis="model"))
    good = make_lane_mesh(("cpu",) * 4)
    assert good.shape == {"data": 4}
    assert good.devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="not both"):
        resolve_lane_mesh(good, devices=("cpu",))
    assert resolve_lane_mesh(good) is good
    assert resolve_lane_mesh(None, ("cpu", "cpu")).shape["data"] == 2
    with pytest.raises(ValueError, match="at least one"):
        make_lane_mesh(())
    # the default is every CUDA device, and none is here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_lane_mesh(None, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_lane_mesh(("cuda:0",))


def test_slab_groups_run_one_thread_a_device():
    cpu, gpu = torch.device("cpu"), torch.device("cuda", 0)
    assert sharded_lanes._group([cpu, gpu, cpu, gpu]) == [[0, 2], [1, 3]]
    assert sharded_lanes._group([cpu] * 3) == [[0, 1, 2]]


# ---------------------------------------------------------------------------
# one slab == the batched engine, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precompute", [False, True], ids=["rbf", "bank"])
def test_one_slab_grid_is_bitwise_the_fused_grid(precompute):
    X, _, Y = _problem()
    cfg = SolverConfig(eps=1e-3)
    Cs, gammas = [0.5, 8.0], [0.2, 1.0]
    r0 = grid.solve_grid(X, Y, Cs, gammas, cfg, impl="auto",
                         precompute=precompute, **F64)
    r1 = grid.solve_grid(X, Y, Cs, gammas, cfg, impl="auto",
                         precompute=precompute, devices=("cpu",), **F64)
    _same(r1, r0)
    assert bool(r1.converged.all())
    rj = jgrid.solve_grid(jnp.asarray(X), jnp.asarray(Y), Cs, gammas,
                          JConfig(eps=1e-3), impl="jnp",
                          precompute=precompute)
    _agree(r1.objective, rj.objective)


def test_one_slab_qp_layer_is_bitwise_the_batched_engine():
    X, _, Y = _problem(l=80)
    cfg = SolverConfig(eps=1e-3)
    C = [1.0, 4.0, 16.0]
    r0 = solve_fused_batched(X, Y, C, 0.5, cfg, **F64)
    r1 = solve_fused_sharded(X, Y, C, 0.5, cfg, devices=("cpu",), **F64)
    _same(r1, r0)
    rj = j_batched(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(C), 0.5,
                   JConfig(eps=1e-3), impl="jnp")
    _agree(r1.objective, rj.objective)


def test_one_slab_svr_and_oneclass_grids_are_bitwise():
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, size=(90, 1))
    y = np.sinc(X[:, 0])
    cfg, jcfg = SolverConfig(eps=1e-3), JConfig(eps=1e-3)
    s0 = grid.solve_grid_svr(X, y, [1.0, 8.0], [0.1], [0.5], cfg, **F64)
    s1 = grid.solve_grid_svr(X, y, [1.0, 8.0], [0.1], [0.5], cfg,
                             devices=("cpu",), **F64)
    _same(s1, s0)
    sj = jgrid.solve_grid_svr(jnp.asarray(X), jnp.asarray(y), [1.0, 8.0],
                              [0.1], [0.5], jcfg, impl="jnp")
    _agree(s1.objective, sj.objective)
    # the deal puts the small-nu lanes first: a permutation of the lanes
    o0 = grid.solve_grid_oneclass(X, [0.5, 0.2], [0.5, 2.0], cfg, **F64)
    o1 = grid.solve_grid_oneclass(X, [0.5, 0.2], [0.5, 2.0], cfg,
                                  devices=("cpu",), **F64)
    _same(o1, o0)
    oj = jgrid.solve_grid_oneclass(jnp.asarray(X), [0.5, 0.2], [0.5, 2.0],
                                   jcfg, impl="jnp")
    _agree(o1.objective, oj.objective)


def test_one_slab_compacted_grid_is_bitwise():
    X, _, Y = _problem(l=90)
    cfg = SolverConfig(eps=1e-4)
    for pre in (True, False):
        kw = dict(chunk=32, impl="auto", precompute=pre, shrinking=True,
                  **F64)
        r0 = grid.solve_grid_compacted(X, Y, [4.0, 0.5], [0.2, 1.0], cfg,
                                       **kw)
        r1 = grid.solve_grid_compacted(X, Y, [4.0, 0.5], [0.2, 1.0], cfg,
                                       devices=("cpu",), **kw)
        _same(r1, r0)


def test_svc_sharded_engine_is_bitwise_the_fused_engine():
    X, y, _ = _problem()
    kw = dict(C=10.0, gamma=0.5)
    clf = SVC(engine="sharded", **kw, **F64).fit(X, y)
    ref = SVC(engine="fused", **kw, **F64).fit(X, y)
    assert clf.engine_ == "sharded" and ref.engine_ == "fused"
    _same(clf.fit_result_, ref.fit_result_)
    jclf = JSVC(engine="sharded", impl="jnp", **kw).fit(X, y)
    assert clf.score(X, y) == ref.score(X, y) == jclf.score(X, y)
    # a binary fit is one lane
    yb = (y == y[0]).astype(int)
    b = SVC(engine="sharded", devices=("cpu",), **kw, **F64).fit(X, yb)
    b0 = SVC(engine="fused", **kw, **F64).fit(X, yb)
    _same(b.fit_result_, b0.fit_result_)


def test_fused_engine_only_takes_the_mesh():
    X, _, Y = _problem(l=40)
    with pytest.raises(ValueError, match="fused engine"):
        grid.solve_grid(X, Y, [1.0], [0.5], devices=("cpu",), **F64)
    with pytest.raises(ValueError, match="fused engine"):
        grid.solve_grid_compacted(X, Y, [1.0], [0.5], devices=("cpu",),
                                  **F64)


# ---------------------------------------------------------------------------
# facade engine selection
# ---------------------------------------------------------------------------

def test_facade_engine_validation():
    with pytest.raises(ValueError, match="sharded"):
        SVC(C=1.0, engine="fused", devices=("cpu",), **F64)
    with pytest.raises(ValueError, match="sharded"):
        SVC(C=1.0, engine="batched", mesh=make_lane_mesh(("cpu",)), **F64)
    with pytest.raises(ValueError, match="auto|fused|batched|sharded"):
        SVC(C=1.0, engine="warp", **F64)
    X, y, _ = _problem(l=40)
    with pytest.raises(ValueError, match="fused engine"):
        SVC(C=1.0, engine="sharded", algorithm="overshoot", **F64).fit(X, y)
    # auto shards only when asked to by mesh/devices
    assert SVC(C=1.0, **F64)._resolve_engine() == "fused"
    assert SVC(C=1.0, devices=("cpu",), **F64)._resolve_engine() == "sharded"
    assert SVC(C=1.0, mesh=make_lane_mesh(("cpu",)),
               **F64)._resolve_engine() == "sharded"
    assert SVC(C=1.0, algorithm="overshoot", devices=("cpu",),
               **F64)._resolve_engine() == "batched"
    clf = SVC(C=1.0, devices=("cpu", "cpu"), **F64).fit(X, y)
    assert clf.engine_ == "sharded"


def test_auto_shards_several_lanes_over_several_cards(monkeypatch):
    """``"auto"`` shards over several cards only when they are named
    (``mesh``/``devices``): attached cards alone leave it on the fused
    engine (a slab's iterations cost the whole batch's on the card).
    ``engine="sharded"`` without mesh/devices deals over every card, or
    the CPU alone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert SVC(C=1.0)._resolve_engine() == "fused"
    assert SVC(C=1.0, device="cpu")._resolve_engine() == "fused"
    cards = (torch.device("cuda", 0), torch.device("cuda", 1))
    assert SVC(C=1.0, devices=cards)._resolve_engine() == "sharded"
    est = SVC(C=1.0, engine="sharded")
    est.engine_ = est._resolve_engine()
    assert est._lane_mesh(cards[0]).devices == cards
    est = SVC(C=1.0, engine="sharded", device="cpu")
    est.engine_ = est._resolve_engine()
    assert est._lane_mesh(torch.device("cpu")).devices == (
        torch.device("cpu"),)
    est = SVC(C=1.0, devices=cards[1:])
    est.engine_ = est._resolve_engine()
    assert est._lane_mesh(cards[0]).devices == cards[1:]
    est = SVC(C=1.0)
    est.engine_ = est._resolve_engine()
    assert est._lane_mesh(cards[0]) is None


def test_lane_solver_is_the_batched_engine_without_a_mesh():
    assert sharded_lanes.lane_solver(None) is (
        solver_fused.solve_fused_batched_qp)
    mesh = make_lane_mesh(("cpu",) * 2)
    solve = sharded_lanes.lane_solver(mesh)
    assert solve.func is sharded_lanes.solve_fused_sharded_qp
    assert solve.keywords == dict(mesh=mesh)
    cpu = torch.device("cpu")
    assert sharded_lanes.resolve_lane_mesh(home=cpu).devices == (cpu,)
    assert sharded_lanes.resolve_lane_mesh(
        devices=("cpu",) * 3, home=cpu).devices == (cpu,) * 3


def test_every_facade_deals_its_lanes_over_the_slabs(monkeypatch):
    """``engine="sharded"`` reaches the sharded engine from each facade,
    the default mesh included (a sharded SVC must not fall back to the
    batched engine when no devices are named)."""
    calls = []
    real = sharded_lanes._solve_sharded

    def spy(*args):
        calls.append(args[6].devices)
        return real(*args)

    monkeypatch.setattr(sharded_lanes, "_solve_sharded", spy)
    X, y, _ = _problem(l=40)
    SVC(C=1.0, gamma=0.5, engine="sharded", **F64).fit(X, y)
    SVC(C=1.0, gamma=0.5, engine="sharded", **F64).fit(X, (y == 0) * 1)
    from repro_torch.svm import SVR, OneClassSVM
    SVR(C=1.0, gamma=0.5, engine="sharded", **F64).fit(X, X[:, 0])
    OneClassSVM(nu=0.3, gamma=0.5, engine="sharded", **F64).fit(X)
    assert calls == [(torch.device("cpu"),)] * 4


# ---------------------------------------------------------------------------
# several slabs, held against the reference's batched engine
# ---------------------------------------------------------------------------

CS, GAMMAS = [0.5, 2.0, 8.0], [0.2, 0.5, 1.0]
EIGHT = ("cpu",) * 8


@pytest.fixture(scope="module")
def blobs():
    X, y = data.multiclass_blobs(150, seed=1, k=3)
    Y = mc.ovr_labels(mc.class_index(y)[1], 3, torch.float64).numpy()
    return X, y, Y


def _j_grid(X, Y, **kw):
    return jgrid.solve_grid(jnp.asarray(X), jnp.asarray(Y), CS, GAMMAS,
                            JConfig(eps=1e-5), impl="jnp", **kw)


@pytest.mark.parametrize("shrinking", [False, True],
                         ids=["full", "shrinking"])
def test_uneven_lanes_over_eight_slabs(blobs, shrinking):
    # 3 gammas x 3 classes x 3 Cs = 27 lanes pad to 32 over 8 slabs; a
    # reorder would show: neighbouring lanes differ in C or gamma
    X, _, Y = blobs
    cfg = SolverConfig(eps=1e-5)
    r = grid.solve_grid(X, Y, CS, GAMMAS, cfg, impl="auto",
                        shrinking=shrinking, devices=EIGHT, **F64)
    rj = _j_grid(X, Y, shrinking=shrinking)
    assert tuple(r.alpha.shape) == np.shape(rj.alpha)
    _close(r.objective, rj.objective)
    assert bool(r.converged.all())
    assert float(r.kkt_gap.max()) <= 1e-5


def test_compacted_chunks_over_eight_slabs(blobs):
    X, _, Y = blobs
    r = grid.solve_grid_compacted(X, Y, CS, GAMMAS, SolverConfig(eps=1e-5),
                                  chunk=64, impl="auto", devices=EIGHT,
                                  **F64)
    rj = jgrid.solve_grid_compacted(jnp.asarray(X), jnp.asarray(Y), CS,
                                    GAMMAS, JConfig(eps=1e-5), chunk=64,
                                    impl="jnp")
    _close(r.objective, rj.objective)
    assert bool(r.converged.all())


def test_doubled_svr_lanes_over_eight_slabs(blobs):
    X, _, _ = blobs
    Xr = X[:, :1]
    yr = np.sin(Xr[:, 0])
    s = grid.solve_grid_svr(Xr, yr, CS, [0.1], GAMMAS,
                            SolverConfig(eps=1e-5), devices=EIGHT, **F64)
    sj = jgrid.solve_grid_svr(jnp.asarray(Xr), jnp.asarray(yr), CS, [0.1],
                              GAMMAS, JConfig(eps=1e-5), impl="jnp")
    _close(s.objective, sj.objective)
    assert float(s.alpha.sum(-1).abs().max()) <= 1e-8


def test_twelve_lanes_over_two_slabs_keep_iterations(blobs):
    # 3-class 2 x 2 grid = 12 lanes, 6 a slab: the same iterations as the
    # port's batched engine, lane for lane
    X, _, Y = blobs
    cfg = SolverConfig(eps=1e-3)
    Cs, gammas = [0.5, 8.0], [0.2, 1.0]
    r0 = grid.solve_grid(X, Y, Cs, gammas, cfg, impl="auto", **F64)
    r1 = grid.solve_grid(X, Y, Cs, gammas, cfg, impl="auto",
                         devices=("cpu", "cpu"), **F64)
    assert torch.equal(r1.iterations, r0.iterations)
    rj = jgrid.solve_grid(jnp.asarray(X), jnp.asarray(Y), Cs, gammas,
                          JConfig(eps=1e-3), impl="jnp")
    _agree(r1.objective, rj.objective)


def test_bank_and_warm_started_lanes_over_three_slabs(blobs):
    X, _, Y = blobs
    cfg, jcfg = SolverConfig(eps=1e-5), JConfig(eps=1e-5)
    r = grid.solve_grid(X, Y, CS, GAMMAS, cfg, impl="auto", precompute=True,
                        devices=("cpu",) * 3, **F64)
    _close(r.objective, _j_grid(X, Y, precompute=True).objective)
    nus = [0.1, 0.3, 0.5]
    o = grid.solve_grid_oneclass(X, nus, GAMMAS, cfg, devices=("cpu",) * 3,
                                 **F64)
    oj = jgrid.solve_grid_oneclass(jnp.asarray(X), nus, GAMMAS, jcfg,
                                   impl="jnp")
    _close(o.objective, oj.objective)
    _close(o.alpha.sum(-1), np.ones((3, 3)), atol=1e-9)


def test_a_slab_that_fails_raises():
    X, _, Y = _problem(l=40)
    with pytest.raises(ValueError, match="impl='cuda'"):
        solve_fused_sharded(X, Y, 1.0, 0.5, impl="cuda", devices=("cpu",),
                            **F64)


# ---------------------------------------------------------------------------
# slabs in host threads: the repairs
# ---------------------------------------------------------------------------

@pytest.fixture
def switchy():
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(saved)


def _in_threads(fns, timeout=60.0):
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


def test_launch_tallies_are_exact_across_threads(switchy):
    w = kernels.WRAPPERS["rbf_row_wss_batched"]
    kernels.reset_launches()
    mine = {}

    def worker(k, n):
        def run():
            before = kernels.launches(thread=True)["rbf_row_wss_batched"]
            for _ in range(n):
                kernels.tally.count(w)
            mine[k] = (kernels.launches(thread=True)["rbf_row_wss_batched"]
                       - before)
        return run

    _in_threads([worker(k, 2000 + k) for k in range(8)])
    assert mine == {k: 2000 + k for k in range(8)}
    assert w.launches == sum(mine.values())
    kernels.reset_launches()
    assert w.launches == 0


def test_a_capture_counts_its_own_thread_only(monkeypatch, switchy):
    """``_capture``'s per-replay counts come from the capturing thread's
    tally while another thread launches, and the global tally keeps the
    other thread's launches and none of the capture's."""
    w = kernels.WRAPPERS["update_wss_batched_rows"]

    class Graph:
        def pool(self):
            return None

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, pool=None, stream=None,
                        capture_error_mode=None: contextlib.nullcontext())
    monkeypatch.setattr(solver_fused, "_capture_stream", lambda: None)
    started = threading.Event()

    def body(s, refresh):
        started.set()
        for _ in range(3):
            kernels.tally.count(w)
            time.sleep(0)
        return s

    out = {}
    kernels.reset_launches()

    def capture():
        out["cap"] = solver_fused._capture(body, (torch.zeros(1),),
                                           (False,) * 50)

    def launch():
        started.wait(10)
        for _ in range(500):
            kernels.tally.count(w)

    _in_threads([capture, launch])
    _, per_replay = out["cap"]
    assert per_replay["update_wss_batched_rows"] == 150
    assert sum(per_replay.values()) == 150
    assert w.launches == 500


def test_no_garbage_collection_inside_a_capture(monkeypatch):
    """A capture runs with the cyclic garbage collector off (a collection
    there can destroy an earlier graph, a CUDA call that invalidates the
    capture), in ``thread_local`` mode on its device's own side stream,
    and leaves the collector as it found it."""
    seen = {}

    class Graph:
        pass

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode=None):
        seen.update(stream=stream, mode=capture_error_mode,
                    collecting=gc.isenabled())
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(solver_fused, "_capture_stream", lambda: "side")
    assert gc.isenabled()
    solver_fused._capture(lambda s, r: s, (torch.zeros(1),), (False,))
    assert seen == dict(stream="side", mode="thread_local", collecting=False)
    assert gc.isenabled()
    gc.disable()
    try:
        solver_fused._capture(lambda s, r: s, (torch.zeros(1),), (False,))
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_the_build_runs_once_across_threads(monkeypatch):
    calls = []

    def slow_load():
        calls.append(threading.get_ident())
        time.sleep(0.05)
        return object()

    monkeypatch.setattr(build, "_load", slow_load)
    monkeypatch.setattr(build, "_LIB", [])
    got = []
    _in_threads([lambda: got.append(build.load()) for _ in range(6)])
    assert len(calls) == 1
    assert len(got) == 6 and all(g is got[0] for g in got)


def test_per_device_ready_flags_are_atomic():
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    decls = [line.strip() for f in sorted(csrc.iterdir())
             for line in f.read_text().splitlines()
             if "ready[" in line and "static" in line]
    assert len(decls) == 5
    assert all(d.startswith("static std::atomic<bool> ready[")
               for d in decls), decls
    tile = (csrc / "rbf_tile.cuh").read_text()
    assert "#include <atomic>" in tile
    assert "std::atomic<bool> (&done)[kMaxDevices]" in tile


def _sweep(seed=5):
    from repro_torch.svm.data import xor_gaussians
    X, y = xor_gaussians(48, seed=seed)
    X = torch.as_tensor(X, dtype=torch.float64)
    y = torch.as_tensor(y, dtype=torch.float64)
    Y = torch.stack([y, -y]).repeat(4, 1)
    C = torch.tensor([2.0, 24.0], dtype=torch.float64)
    C = C.repeat_interleave(2).repeat(2)
    gam = torch.tensor([0.4, 1.0], dtype=torch.float64).repeat_interleave(4)
    YC = Y * C[:, None]
    return X, Y, torch.clamp_max(YC, 0.0), torch.clamp_min(YC, 0.0), gam


def _card_dispatch(m, counts):
    """The wrappers routed as on the card: ``impl`` resolves to "cuda",
    the wrappers run their plain per-block versions on CPU tensors, and a
    shim counts each call as a launch in the calling thread's tally."""
    from repro_torch.kernels import rbf_row_wss, rbf_update_wss
    lock = threading.Lock()
    m.setattr(ops, "resolve_impl",
              lambda impl, device: "torch" if impl == "torch" else "cuda")
    for name, w in kernels.WRAPPERS.items():
        mod = next(md for md in (rbf_row_wss, rbf_update_wss)
                   if getattr(md, w.__name__, None) is w) \
            if name != "gram_block" else None
        if mod is None:
            continue

        def shim(*a, _w=w, **kw):
            with lock:
                counts[threading.get_ident()] += 1
            kernels.tally.count(_w)
            return _w(*a, **kw)
        m.setattr(mod, w.__name__, shim)


def test_slab_threads_keep_tallies_and_captures_exact(monkeypatch, switchy):
    """Two slabs of a sharded chunked solve in two host threads (one a
    slab, as distinct devices run), through the stand-in graphs: each
    slab's round solves in its own cache entry, entered in its thread, the
    captures are one per (entry, chunk shape), the result is bitwise the
    one-thread run's, and the tallies equal the one-thread run's and the
    sum of the threads' own."""
    X, P, L, U, gam = _sweep()
    cfg = SolverConfig(eps=1e-5, shrink_every=16, max_iter=3000)

    def run():
        return solver_fused.solve_fused_chunked_qp(
            X, P, L, U, gam, cfg, chunk=32, check_every=8, shrinking=True,
            devices=("cpu", "cpu"))

    def tallied(threads):
        counts = collections.Counter()
        with monkeypatch.context() as m:
            _card_dispatch(m, counts)
            if threads:
                m.setattr(sharded_lanes, "_group",
                          lambda devs: [[p] for p in range(len(devs))])
            kernels.reset_launches()
            with capture_guard.stand_in_graphs(), \
                    capture_guard.CaptureLog() as log:
                res = run()
            return res, kernels.launches(), counts, log

    r1, t1, c1, log1 = tallied(False)
    r2, t2, c2, log2 = tallied(True)
    _same(r2, r1)
    assert t2 == t1 and sum(t2.values()) > 0
    # one thread: the caller's; two slabs in threads: never the caller's
    # (each round's pool has its own threads)
    me = threading.get_ident()
    assert set(c1) == {me} and me not in c2 and len(c2) >= 2
    assert sum(c2.values()) == sum(c1.values()) == sum(t2.values())
    for log in (log1, log2):
        assert len(log.captures) == log.expected_chunked() > 0
        assert len(set(log.captures)) == len(log.captures)
        assert {k[2] for k, _ in log.loops} == {0, 1}
    assert sorted(log2.captures, key=repr) == sorted(log1.captures, key=repr)
    kernels.reset_launches()


def test_sharded_tallies_are_the_sum_of_the_slabs(monkeypatch):
    """A sharded solve's launches (through the card's dispatch) are the
    launches of its slabs, each solved alone by the batched engine."""
    X, P, L, U, gam = _sweep()
    cfg = SolverConfig(eps=1e-5, max_iter=3000)
    order, _ = lane_schedule((U - L).amax(dim=1), 2)
    counts = collections.Counter()
    with monkeypatch.context() as m:
        _card_dispatch(m, counts)
        m.setattr(sharded_lanes, "_group",
                  lambda devs: [[p] for p in range(len(devs))])
        kernels.reset_launches()
        res = solve_fused_sharded_qp(X, P, L, U, gam, cfg,
                                     devices=("cpu", "cpu"))
        got = kernels.launches()
        slabs = collections.Counter()
        for s in (order[:4], order[4:]):
            kernels.reset_launches()
            r = solver_fused.solve_fused_batched_qp(
                X, P[s], L[s], U[s], gam[s], cfg)
            assert torch.equal(r.alpha, res.alpha[s])
            slabs.update(kernels.launches())
    assert got == dict(slabs) and sum(got.values()) > 0
    kernels.reset_launches()
