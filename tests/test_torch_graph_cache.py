"""The chunked drivers' per-call CUDA-graph cache, on the CPU through the
capture guard's stand-in graph.

``solve_fused_chunked_qp`` and the classic compacted grid
(``solve_grid_compacted(impl=None)``) keep one cache entry per lane and
row bucket (``solver_fused._GraphCache``): each round copies its values
into the entry's buffers and replays the entry's graphs.  With the graph
path turned on for CPU tensors (``capture_guard.stand_in_graphs``, whose
replay reruns the captured chunk of the body on the entry's state
buffers), every case below is bitwise the uncached driver (the cache's
factory swapped for ``solver_fused._GraphCacheMiss``, which never hits)
and the driver without graphs, field by field, ring and events included;
the captures of a call are exactly one per (entry, chunk shape) visited,
and no entry outlives the call.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.analysis import capture_guard
from repro_torch.core import grid
from repro_torch.core import qp as tqp
from repro_torch.core import solver_fused as tsf
from repro_torch.core.solver import SolverConfig
from repro_torch.svm.data import xor_gaussians
from repro_torch.telemetry import Diagnostics, RingConfig

F64 = dict(dtype=torch.float64)
# every lane here converges in a few hundred iterations: the budget only
# keeps a broken driver from looping on
MAX_ITER = 3000


def _lanes(l=48, seed=5):
    """A (C, gamma) sweep's flat lanes over xor: 2 Cs x 2 gammas x 2
    heads, and the (2, l, l) bank of the two gammas."""
    X, y = xor_gaussians(l, seed=seed)
    X = torch.as_tensor(X, **F64)
    y = torch.as_tensor(y, **F64)
    Y = torch.stack([y, -y]).repeat(4, 1)
    C = torch.tensor([2.0, 24.0], **F64).repeat_interleave(2).repeat(2)
    gam = torch.tensor([0.4, 1.0], **F64).repeat_interleave(4)
    YC = Y * C[:, None]
    sq = (X * X).sum(-1)
    d2 = torch.clamp_min(sq[:, None] + sq[None] - 2.0 * X @ X.T, 0.0)
    bank = torch.stack([torch.exp(-g * d2) for g in (0.4, 1.0)])
    gidx = torch.tensor([0] * 4 + [1] * 4)
    return (X, Y, torch.clamp_max(YC, 0.0), torch.clamp_min(YC, 0.0), gam,
            bank, gidx)


def _svr_lanes(l=40, seed=3):
    """Doubled ε-SVR lanes (2l coordinates): 2 Cs x 2 gammas."""
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.uniform(-3.0, 3.0, size=(l, 2)), **F64)
    y = torch.sinc(X[:, 0]) + 0.1 * torch.as_tensor(
        rng.normal(size=l), **F64)
    qps = [tqp.svr_qp(y, C, 0.1) for C in (1.0, 16.0)] * 2
    P, L, U = (torch.stack([getattr(q, f) if f == "p" else
                            getattr(q.bounds, f) for q in qps])
               for f in ("p", "lower", "upper"))
    gam = torch.tensor([0.5, 0.5, 2.0, 2.0], **F64)
    return X, P, L, U, gam


def _fields_equal(a, b, tag):
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), \
            (tag, f.name)


def _three_ways(run, bank=None):
    """(cached run and its capture log, uncached run, run without
    graphs)."""
    with capture_guard.stand_in_graphs(), \
            capture_guard.CaptureLog(bank) as log:
        cached = run()
    with capture_guard.stand_in_graphs(), \
            pytest.MonkeyPatch.context() as m:
        m.setattr(tsf, "_GraphCache", tsf._GraphCacheMiss)
        uncached = run()
    return cached, log, uncached, run()


def _fused_case(name):
    X, Y, L, U, gam, bank, gidx = _lanes()
    cfg = SolverConfig(eps=1e-5, shrink_every=16, max_iter=MAX_ITER)
    kw = dict(chunk=32, check_every=8)
    if name.startswith("bank"):
        kw.update(gram=bank, gram_idx=gidx)
    kw["shrinking"] = name.endswith("shrinking")
    if name == "conjugate":
        cfg = SolverConfig(algorithm="smo", step="conjugate", eps=1e-5,
                           shrink_every=16, max_iter=MAX_ITER)
        kw.update(gram=bank, gram_idx=gidx, shrinking=True)
    if name == "doubled":
        X, P, L, U, gam = _svr_lanes()
        kw["shrinking"] = True
        return (lambda: tsf.solve_fused_chunked_qp(
            X, P, L, U, gam, cfg, doubled=True, **kw)), None
    return (lambda: tsf.solve_fused_chunked_qp(X, Y, L, U, gam, cfg, **kw)), \
        kw.get("gram")


FUSED_CASES = ["bank", "bank_shrinking", "rbf", "rbf_shrinking", "doubled",
               "conjugate"]


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_chunked_cache_is_bitwise_the_uncached_driver(case):
    run, bank = _fused_case(case)
    cached, log, uncached, eager = _three_ways(run, bank)
    _fields_equal(cached, uncached, "uncached")
    _fields_equal(cached, eager, "without graphs")
    # one capture per (entry, chunk shape) visited, none twice, and some
    # entry served two rounds (its later rounds replayed only)
    assert len(log.captures) == log.expected_chunked() > 0
    assert len(set(log.captures)) == len(log.captures)
    assert len(log.loops) > len({k for k, _ in log.loops})


@pytest.mark.parametrize("shrinking", [False, True])
def test_classic_compacted_cache_is_bitwise_the_uncached_driver(shrinking):
    X, y = xor_gaussians(48, seed=5)
    Y = np.stack([y, -y])
    cfg = SolverConfig(algorithm="pasmo", eps=1e-5, max_iter=MAX_ITER)

    def run():
        return grid.solve_grid_compacted(X, Y, [2.0, 24.0], [0.4, 1.0], cfg,
                                         chunk=32, shrinking=shrinking,
                                         device="cpu", **F64)
    cached, log, uncached, eager = _three_ways(run)
    _fields_equal(cached, uncached, "uncached")
    _fields_equal(cached, eager, "without graphs")
    assert len(log.captures) == log.expected_chunked() > 0
    assert len(set(log.captures)) == len(log.captures)
    # the lane buckets of both Cs share entries
    assert len(log.loops) > len({k for k, _ in log.loops})


def test_ring_and_chunk_events_are_bitwise_the_uncached_driver():
    """The merged ring and the ``chunk_solve`` events (their wall times
    aside) of a cached run equal the uncached run's."""
    X, Y, L, U, gam, bank, gidx = _lanes()
    cfg = SolverConfig(eps=1e-5, shrink_every=16, max_iter=MAX_ITER)
    diags = []

    def run():
        diags.append(Diagnostics(ring=RingConfig(sample_every=4, cap=64)))
        return tsf.solve_fused_chunked_qp(
            X, Y, L, U, gam, cfg, chunk=32, check_every=8, shrinking=True,
            gram=bank, gram_idx=gidx, diagnostics=diags[-1])
    (res_c, ring_c), _, (res_u, ring_u), (res_e, ring_e) = _three_ways(run)
    for res, ring in ((res_u, ring_u), (res_e, ring_e)):
        _fields_equal(res_c, res, "result")
        for f in dataclasses.fields(ring_c):
            assert torch.equal(getattr(ring_c, f.name),
                               getattr(ring, f.name)), f.name

    def events(diag):
        return [{k: v for k, v in e.items()
                 if k not in ("ts", "seconds", "deadline")}
                for e in diag.sink.events if e["event"] != "straggler_warning"]
    rounds = [e for e in events(diags[0]) if e.get("name") == "chunk_solve"]
    assert len(rounds) >= 3
    assert events(diags[0]) == events(diags[1]) == events(diags[2])


def test_buckets_fall_mid_run():
    """The rbf sweep's rounds move from the 64-row bucket to the 32-row
    one and from 8 lanes to fewer, each move a new entry, each bitwise."""
    run, _ = _fused_case("rbf_shrinking")
    cached, log, uncached, _ = _three_ways(run)
    _fields_equal(cached, uncached, "uncached")
    shapes = [k[0] for k, _ in log.loops]
    rows = [n for _, n in shapes]
    lanes = [b for b, _ in shapes]
    assert rows[0] == 64 and 32 in rows and rows == sorted(rows, reverse=True)
    assert lanes[0] == 8 and min(lanes) < 8
    assert len(log.captures) == log.expected_chunked()


def test_uncached_driver_captures_again_every_round():
    """The negative control: a cache that never hits captures an (entry,
    chunk shape) more than once, and the guard flags it."""
    run, _ = _fused_case("rbf_shrinking")
    with capture_guard.stand_in_graphs(), \
            capture_guard.CaptureLog() as log, \
            pytest.MonkeyPatch.context() as m:
        m.setattr(tsf, "_GraphCache", tsf._GraphCacheMiss)
        run()
    assert len(set(log.captures)) < len(log.captures)
    assert capture_guard.plant_recapture()


def test_no_entry_outlives_the_call(monkeypatch):
    caches = []
    make = tsf._GraphCache

    def spy():
        caches.append(make())
        return caches[-1]

    monkeypatch.setattr(tsf, "_GraphCache", spy)
    run, _ = _fused_case("bank_shrinking")
    with capture_guard.stand_in_graphs():
        run()
    X, y = xor_gaussians(48, seed=5)
    with capture_guard.stand_in_graphs():
        grid.solve_grid_compacted(X, np.stack([y, -y]), [2.0], [0.4],
                                  SolverConfig(eps=1e-5, max_iter=MAX_ITER),
                                  chunk=32,
                                  device="cpu", **F64)
    assert len(caches) == 2 and all(c.entries for c in caches)
    refs = [weakref.ref(e) for c in caches for e in c.entries.values()]
    refs += [weakref.ref(c) for c in caches]
    caches.clear()
    gc.collect()
    assert all(r() is None for r in refs)
    assert tsf._ROUND.get() is None


def test_a_round_must_solve_its_entrys_buffers():
    """A solve inside a round that is not handed the entry's buffers is
    refused, not silently rebuilt (which would capture again)."""
    X, Y, L, U, gam, _, _ = _lanes()
    cache = tsf._GraphCache()
    ent = cache.entry("k", lambda: None)
    cfg = SolverConfig(eps=1e-5, max_iter=8)
    with tsf._solving(ent):
        tsf.solve_fused_batched_qp(X, Y, L, U, gam, cfg)
    with tsf._solving(ent), pytest.raises(RuntimeError, match="buffers"):
        tsf.solve_fused_batched_qp(X, Y.clone(), L, U, gam, cfg)
