"""The port's flight recorder (``repro_torch.telemetry``) against the
reference's (``repro.telemetry``), and its own invariants, on the CPU.

Across packages: the ring's update rule leaf for leaf and exactly on the
same inputs, and the fused loop's ring on the reference's own tie-free
telemetry problems (equal iteration counts first; then the integer
channels exactly, ``gap``/``ratio`` to rtol 1e-9).  Within the port: the
recorder changes no bit of a solve, its ring does not depend on the host
loop's cadence, the fused ratio channel equals the classic engine's Fig. 3
``record_trace``, and the drivers, facades, sink and report carry the
events the reference's do (the JSONL format is shared: the reference's
report renders the port's file)."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solver import SolverConfig as JConfig
from repro.core.solver_fused import solve_fused_batched_qp as j_qp
from repro.core.solver_fused import solve_fused_chunked_qp as j_chunked
from repro.launch import telemetry_report as j_report
from repro.telemetry import RingConfig as JRing
from repro.telemetry import ring_init as j_ring_init
from repro.telemetry import ring_update as j_ring_update
from repro_torch.core import grid, multiclass, qp, solver, solver_fused
from repro_torch.core.solver import SolverConfig
from repro_torch.launch import telemetry_report as report
from repro_torch.runtime.fault import StepMonitor
from repro_torch.svm import SVC, SVR, OneClassSVM
from repro_torch.telemetry import (Diagnostics, JsonlSink, RingConfig,
                                   TelemetryRing, env_fingerprint,
                                   fingerprint_diff, phase_scope, read_jsonl,
                                   ring_init, ring_slice, ring_update)
from repro_torch.telemetry import ring as ring_mod
from repro_torch.telemetry import spans

F64 = torch.float64
FIELDS = ring_mod.FIELDS
INT_FIELDS = ("t", "n_active", "n_unshrink", "n_samples", "ratio_t",
              "n_ratio")
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _leaves(ring):
    return {f: np.asarray(getattr(ring, f)) for f in FIELDS}


# ---------------------------------------------------------------------------
# ring semantics against the reference's ring_update
# ---------------------------------------------------------------------------

def _ring_script(case):
    """(RingConfig kwargs, B, steps): each step the (t, active,
    newly_done, gap, n_active, n_unshrink, plan_event, ratio) fed to both
    rings."""
    rng = np.random.default_rng(7)
    if case == "overflow":
        # cap 4, 7 samples: the last slot takes the newest, counts run on
        steps = [(t, [True, True], [False, False], [10.0 - t] * 2, [5, 5],
                  [0, 0], [True, False], [1.0 + t] * 2) for t in range(7)]
        return dict(sample_every=1, cap=4, ratio_cap=3), 2, steps
    if case == "freeze_early":
        # lane 1 freezes at t = 1: a forced sample, then nothing
        steps = [(t, [True, t < 2], [False, t == 1], [float(t)] * 2, [9, 9],
                  [0, 0], [False, t == 0], [0.5, 1.5]) for t in range(9)]
        return dict(sample_every=4, cap=8, ratio_cap=4), 2, steps
    if case == "sample_every":
        B, steps = 3, []
        for t in range(23):
            steps.append((t, list(rng.uniform(size=B) < 0.8),
                          list(rng.uniform(size=B) < 0.2),
                          list(rng.normal(size=B)),
                          list(rng.integers(1, 40, B)),
                          list(rng.integers(0, 3, B)),
                          list(rng.uniform(size=B) < 0.4),
                          list(rng.normal(size=B))))
        return dict(sample_every=3, cap=5, ratio_cap=4), B, steps
    assert case == "no_events"
    steps = [(t, [True, True, True], [False, False, t == 4],
              list(rng.normal(size=3)), [7, 7, 7], [t, 0, 1],
              [False] * 3, [9.0] * 3) for t in range(6)]
    return dict(sample_every=2, cap=3, ratio_cap=2), 3, steps


@pytest.mark.parametrize("case", ["overflow", "freeze_early",
                                  "sample_every", "no_events"])
def test_ring_update_matches_reference(case):
    kw, B, steps = _ring_script(case)
    j_cfg, cfg = JRing(**kw), RingConfig(**kw)
    jr = j_ring_init(j_cfg, B, jnp.float64)
    tr = ring_init(cfg, B, F64)
    for t, act, done, gap, na, nu, ev, ratio in steps:
        jr = j_ring_update(
            jr, j_cfg, t=jnp.asarray(t), active=jnp.asarray(act),
            newly_done=jnp.asarray(done), gap=jnp.asarray(gap),
            n_active=jnp.asarray(na, jnp.int32),
            n_unshrink=jnp.asarray(nu, jnp.int32),
            plan_event=jnp.asarray(ev), ratio=jnp.asarray(ratio))
        tr = ring_update(
            tr, cfg, t=torch.tensor(t), active=torch.tensor(act),
            newly_done=torch.tensor(done), gap=torch.tensor(gap, dtype=F64),
            n_active=torch.tensor(na, dtype=torch.int32),
            n_unshrink=torch.tensor(nu, dtype=torch.int32),
            plan_event=torch.tensor(ev), ratio=torch.tensor(ratio,
                                                            dtype=F64))
    want, got = _leaves(jr), _leaves(tr)
    for f in FIELDS:
        assert got[f].shape == want[f].shape, f
        assert got[f].dtype == want[f].dtype, f
        assert np.array_equal(got[f], want[f]), f
    if case == "overflow":
        assert got["t"][0].tolist() == [0, 1, 2, 6]
        assert got["n_samples"].tolist() == [7, 7]
        assert got["n_ratio"].tolist() == [7, 0]


def test_ring_update_leaves_its_argument_and_slices_lanes():
    cfg = RingConfig(sample_every=1, cap=2, ratio_cap=2)
    r0 = ring_init(cfg, 3, F64)
    on = torch.ones(3, dtype=torch.bool)
    r1 = ring_update(r0, cfg, t=0, active=on, newly_done=~on,
                     gap=torch.ones(3, dtype=F64),
                     n_active=torch.full((3,), 4, dtype=torch.int32),
                     n_unshrink=torch.zeros(3, dtype=torch.int32),
                     plan_event=on, ratio=torch.arange(3, dtype=F64))
    assert int(r0.n_samples.sum()) == 0 and int(r1.n_samples.sum()) == 3
    assert r1.t.shape == (3, 2) and r1.ratio.shape == (3, 2)
    sub = ring_slice(r1, torch.tensor([2, 0]))
    assert sub.ratio[:, 0].tolist() == [2.0, 0.0]
    assert sub.n_ratio.tolist() == [1, 1]


# ---------------------------------------------------------------------------
# the fused loop: the recorder changes nothing, whatever the cadence
# ---------------------------------------------------------------------------

def _rbf_problem(B=3, l=16, d=4, seed=0):
    """The reference's telemetry problem (``tests/test_telemetry.py``)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(l, d))
    Y = np.sign(rng.normal(size=(B, l)))
    YC = Y * 2.0
    return X, Y, np.minimum(0.0, YC), np.maximum(0.0, YC), \
        rng.uniform(0.3, 1.0, B)


def _grid_problem(l=24, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(l, 3))
    y = np.sign(rng.normal(size=l))
    y[y == 0] = 1
    return X, np.stack([y, -y])


def _bank(X, gammas):
    sq = (X * X).sum(-1)
    D2 = np.maximum(sq[:, None] + sq[None] - 2.0 * X @ X.T, 0.0)
    return np.exp(-np.asarray(gammas)[:, None, None] * D2)


def _port_qp(X, P, L, U, gam, cfg, source="rbf", **kw):
    T = [torch.as_tensor(a, dtype=F64) for a in (X, P, L, U)]
    if source == "bank":
        kw.update(gram=torch.as_tensor(_bank(X, gam), dtype=F64),
                  gram_idx=torch.arange(len(gam)))
    return solver_fused.solve_fused_batched_qp(
        *T, torch.as_tensor(gam, dtype=F64), cfg, impl="torch", **kw)


STEPS = {"pasmo": dict(algorithm="pasmo"),
         "conjugate": dict(algorithm="smo", step="conjugate")}


@pytest.mark.parametrize("step", ["pasmo", "conjugate"])
@pytest.mark.parametrize("shrinking", [False, True], ids=["full", "shrink"])
@pytest.mark.parametrize("source", ["rbf", "bank"])
def test_ring_changes_no_bit_of_the_solve(source, shrinking, step):
    X, P, L, U, gam = _rbf_problem(l=32, seed=2)
    cfg = SolverConfig(eps=1e-3, max_iter=500, shrink_every=8,
                       **STEPS[step])
    kw = dict(source=source, shrinking=shrinking)
    base = _port_qp(X, P, L, U, gam, cfg, **kw)
    res, ring = _port_qp(X, P, L, U, gam, cfg,
                         telemetry=RingConfig(sample_every=8), **kw)
    assert isinstance(base, solver_fused.FusedResult)
    for f in dataclasses.fields(base):
        assert torch.equal(getattr(res, f.name), getattr(base, f.name)), \
            f.name
    assert bool(base.converged.all())
    # every lane ends on a forced sample stamped at its last iteration
    ns = ring.n_samples.numpy()
    for b in range(len(gam)):
        assert int(ring.t[b, min(ns[b], 128) - 1]) == \
            int(res.iterations[b]) - 1
    assert torch.equal(ring.n_ratio, res.n_planning)
    assert bool((ring.n_ratio > 0).all())
    if shrinking:
        # the active-set channel saw the mask shrink below the full width
        assert int(ring.n_active.max()) == P.shape[1]
        assert bool((ring.n_active[ring.n_active > 0] < P.shape[1]).any())


def test_ring_off_runs_the_ring_free_loop(monkeypatch):
    """``telemetry=None``: no ring write, no counter, a bare result."""
    def boom(*a, **k):
        raise AssertionError("ring_write ran with telemetry=None")

    monkeypatch.setattr(ring_mod, "ring_write", boom)
    X, P, L, U, gam = _rbf_problem()
    res = _port_qp(X, P, L, U, gam, SolverConfig(eps=1e-3, max_iter=500),
                   shrinking=True)
    assert isinstance(res, solver_fused.FusedResult)
    with pytest.raises(AssertionError, match="ring_write"):
        _port_qp(X, P, L, U, gam, SolverConfig(eps=1e-3, max_iter=500),
                 telemetry=RingConfig())


@pytest.mark.parametrize("step", ["pasmo", "conjugate"])
def test_ring_does_not_depend_on_the_cadence(step):
    """``check_every`` 1, 5 and 32 with a shrink period of 8: the host
    loop's chunking differs, the ring does not (on the card the same
    chunks replay as CUDA graphs, checked by ``chip_smoke.py``)."""
    X, P, L, U, gam = _rbf_problem(l=48, seed=4)
    cfg = SolverConfig(eps=1e-4, max_iter=600, shrink_every=8,
                       **STEPS[step])
    rc = RingConfig(sample_every=3, cap=16, ratio_cap=16)
    runs = [_port_qp(X, P, L, U, gam, cfg, shrinking=True, telemetry=rc,
                     check_every=ce) for ce in (1, 5, 32)]
    (r0, g0) = runs[0]
    assert int(r0.iterations.max()) > 40
    for r, g in runs[1:]:
        assert torch.equal(r.iterations, r0.iterations)
        assert torch.equal(r.alpha, r0.alpha)
        for f in FIELDS:
            assert torch.equal(getattr(g, f), getattr(g0, f)), f


# ---------------------------------------------------------------------------
# parity with the reference's ring
# ---------------------------------------------------------------------------

def _parity_case(case):
    """(X, P, L, U, gamma, config kwargs, solve kwargs) of a tie-free
    problem from the reference's telemetry tests.  The grid problem's
    seed 0 is tie-free through the bank but not through rbf rows: there
    the reference's lane 1 (``-y``) leaves the port's path at a rounding
    tie after 16 iterations (XLA contracts the row arithmetic), so the rbf
    cases take seed 3, on which both paths agree."""
    if case.startswith("grid"):
        X, Y = _grid_problem(seed=0 if case.endswith("bank") else 3)
        YC = Y * 1.0
        args = (X, Y, np.minimum(0.0, YC), np.maximum(0.0, YC),
                np.array([0.8, 0.8]))
    else:
        args = _rbf_problem()
    cfg = dict(eps=1e-3, max_iter=500)
    kw = {}
    if case.endswith("smo"):
        cfg.update(algorithm="smo")
    if case.endswith("shrink"):
        kw.update(shrinking=True)
        cfg.update(shrink_every=8)
    if case.endswith("bank"):
        kw.update(bank=True)
    return args, cfg, kw


@pytest.mark.parametrize("case", ["rbf", "rbf_shrink", "rbf_smo", "grid",
                                  "grid_bank", "grid_smo"])
def test_fused_ring_matches_reference(case):
    (X, P, L, U, gam), cfg, kw = _parity_case(case)
    rc = dict(sample_every=8, cap=16, ratio_cap=64)
    jkw, tkw = {}, {}
    if kw.pop("bank", False):
        jkw.update(gram=jnp.asarray(_bank(X, gam[:1])),
                   gram_idx=jnp.zeros(len(gam), jnp.int32))
        tkw.update(gram=torch.as_tensor(_bank(X, gam[:1])),
                   gram_idx=torch.zeros(len(gam), dtype=torch.int64))
    jres, jring = j_qp(jnp.asarray(X), jnp.asarray(P), jnp.asarray(L),
                       jnp.asarray(U), jnp.asarray(gam), JConfig(**cfg),
                       impl="jnp", telemetry=JRing(**rc), **kw, **jkw)
    T = [torch.as_tensor(a, dtype=F64) for a in (X, P, L, U, gam)]
    tres, tring = solver_fused.solve_fused_batched_qp(
        *T, SolverConfig(**cfg), impl="torch", telemetry=RingConfig(**rc),
        **kw, **tkw)
    assert np.array_equal(tres.iterations.numpy(),
                          np.asarray(jres.iterations))
    assert bool(tres.converged.all())
    want, got = _leaves(jring), _leaves(tring)
    for f in INT_FIELDS:
        assert np.array_equal(got[f], want[f]), f
    for f in ("gap", "ratio"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-9, atol=0)
    if "smo" in case:
        assert int(tring.n_ratio.sum()) == 0
    else:
        assert bool((tring.n_ratio > 0).all())


def test_chunked_ring_matches_reference():
    """The chunked driver's merged ring: chunk-local stamps rebased as the
    reference rebases them, samples kept by the same slot rule."""
    X, Y = _grid_problem(l=32, seed=1)
    Cs = np.array([0.5, 2.0])
    P = np.repeat(Y, 2, axis=0)
    YC = P * np.tile(Cs, 2)[:, None]
    L, U = np.minimum(0.0, YC), np.maximum(0.0, YC)
    gam = np.array([0.5, 0.5, 1.0, 1.0])
    cfg = dict(eps=1e-3, max_iter=400)
    rc = dict(sample_every=4, cap=8, ratio_cap=8)
    from repro.telemetry import Diagnostics as JDiag
    jres, jring = j_chunked(X, P, L, U, gam, JConfig(**cfg), impl="jnp",
                            chunk=16, shrinking=True,
                            diagnostics=JDiag(ring=JRing(**rc)))
    T = [torch.as_tensor(a, dtype=F64) for a in (X, P, L, U, gam)]
    diag = Diagnostics(ring=RingConfig(**rc))
    tres, tring = solver_fused.solve_fused_chunked_qp(
        *T, SolverConfig(**cfg), chunk=16, shrinking=True, diagnostics=diag)
    assert np.array_equal(tres.iterations.numpy(),
                          np.asarray(jres.iterations))
    want, got = _leaves(jring), _leaves(tring)
    for f in INT_FIELDS:
        assert np.array_equal(got[f], want[f]), f
    np.testing.assert_allclose(got["ratio"], want["ratio"], rtol=1e-9,
                               atol=0)
    # a lane retired by the host's full-set check can end on a gap of 0 in
    # one package and one rounding unit of its O(1) gradient (1.1e-16) in
    # the other: the gaps are held to rtol 1e-9 above 1e-12
    np.testing.assert_allclose(got["gap"], want["gap"], rtol=1e-9,
                               atol=1e-12)
    assert int(tring.n_samples.max()) > rc["cap"]       # overflow merged


# ---------------------------------------------------------------------------
# Fig. 3 parity inside the port: fused ratio channel == classic record_trace
# ---------------------------------------------------------------------------

def test_fig3_ratio_parity_with_classic_record_trace():
    rng = np.random.default_rng(3)
    l, d, gamma, C = 24, 3, 0.8, 2.0
    X = rng.normal(size=(l, d))
    y = np.where(rng.normal(size=l) >= 0, 1.0, -1.0)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    K = torch.exp(-gamma * grid.sqdist(Xt))
    classic = solver.solve(qp.PrecomputedKernel(K), yt, C,
                           SolverConfig(eps=1e-4, max_iter=1000,
                                        record_trace=True, trace_cap=256),
                           device="cpu")
    res, ring = solver_fused.solve_fused_batched(
        X, y[None], C, gamma, SolverConfig(eps=1e-4, max_iter=1000),
        impl="torch", device="cpu", dtype=F64,
        telemetry=RingConfig(ratio_cap=256))
    assert int(res.iterations[0]) == int(classic.iterations)
    n = int(classic.n_trace)
    assert n > 0
    assert int(ring.n_ratio[0]) == n == int(classic.n_planning)
    np.testing.assert_allclose(ring.ratio[0, :n].numpy(),
                               classic.trace[:n].numpy(), rtol=1e-9, atol=0)
    # the grid driver's trace fields carry the same channel
    diag = Diagnostics(ring=RingConfig(ratio_cap=256))
    gres = grid.solve_grid(X, y[None], np.array([C]), np.array([gamma]),
                           SolverConfig(eps=1e-4, max_iter=1000),
                           impl="torch", block_l=128, diagnostics=diag,
                           device="cpu", dtype=F64)
    assert int(gres.n_trace[0, 0, 0]) == n
    np.testing.assert_allclose(gres.trace[0, 0, 0, :n].numpy(),
                               classic.trace[:n].numpy(), rtol=1e-9, atol=0)
    assert diag.lanes[0]["ratio"]["value"] == gres.trace[0, 0, 0, :n].tolist()


# ---------------------------------------------------------------------------
# drivers: grid drain, C order, chunked merge, straggler events
# ---------------------------------------------------------------------------

def _cpu(**kw):
    return dict(impl="torch", device="cpu", dtype=F64, **kw)


def test_solve_grid_drains_lanes_in_caller_order():
    X, Y = _grid_problem()
    gammas = np.array([0.5, 1.0])
    Cs = np.array([2.0, 0.5, 1.0])        # unsorted: the C permutation
    cfg = SolverConfig(eps=1e-3, max_iter=300)
    diag = Diagnostics(ring=RingConfig(sample_every=8))
    res = grid.solve_grid(X, Y, Cs, gammas, cfg, diagnostics=diag, **_cpu())
    ref = grid.solve_grid(X, Y, Cs, gammas, cfg, **_cpu())
    for f in dataclasses.fields(ref):
        if f.name not in ("trace", "n_trace"):
            assert torch.equal(getattr(res, f.name), getattr(ref, f.name))
    assert len(diag.lanes) == 2 * 2 * 3
    it = res.iterations.numpy()
    for lane, rec in enumerate(diag.lanes):
        gi, rem = divmod(lane, 2 * 3)
        ci, Ci = divmod(rem, 3)
        assert rec["gamma"] == gammas[gi]
        assert rec["label"] == ci
        assert rec["C"] == Cs[Ci]
        assert rec["iterations"] == int(it[gi, ci, Ci])
        assert rec["n_ratio"] == rec["n_planning"] == \
            int(res.n_trace[gi, ci, Ci])
        assert rec["samples"]["t"][-1] == rec["iterations"] - 1
    s = diag.summary(top_k=3)
    assert s["n_lanes"] == 12 and s["n_converged"] == 12
    assert len(s["stragglers"]) == 3
    assert s["stragglers"][0]["iterations"] == int(it.max())
    assert [e["name"] for e in diag.sink.events
            if e["event"] == "phase"] == ["solve_grid_fused"]


def test_chunked_driver_merges_and_rebases_rings():
    X, Y = _grid_problem(l=32, seed=1)
    gammas = np.array([0.5, 1.0])
    Cs = np.array([0.5, 2.0])
    cfg = SolverConfig(eps=1e-3, max_iter=400)
    diag = Diagnostics(ring=RingConfig(sample_every=4, cap=64))
    res = grid.solve_grid_compacted(X, Y, Cs, gammas, cfg, chunk=16,
                                    diagnostics=diag, **_cpu())
    ref = grid.solve_grid_compacted(X, Y, Cs, gammas, cfg, chunk=16,
                                    **_cpu())
    assert torch.equal(res.iterations, ref.iterations)
    assert torch.equal(res.alpha, ref.alpha)
    it = res.iterations.reshape(-1).numpy()
    assert len(diag.lanes) == it.size
    for lane, rec in enumerate(diag.lanes):
        assert rec["iterations"] == int(it[lane])
        ts = rec["samples"]["t"]
        # chunk-local stamps rebased to a strictly increasing run-wide
        # sequence that ends on the lane's last iteration
        assert all(a < b for a, b in zip(ts, ts[1:]))
        assert ts[-1] == rec["iterations"] - 1
        assert rec["n_ratio"] == rec["n_planning"]
        assert "total_unshrink" in rec
    rounds = [e for e in diag.sink.events
              if e["event"] == "phase" and e.get("name") == "chunk_solve"]
    assert len(rounds) >= 2          # chunk=16 forces several rounds
    assert all(e["seconds"] > 0 for e in rounds)
    assert [e["round"] for e in rounds] == list(range(len(rounds)))
    assert rounds[0]["lanes"] == 8 and rounds[0]["rows"] == 32
    assert torch.equal(res.n_trace.reshape(-1),
                       torch.tensor([r["n_ratio"] for r in diag.lanes],
                                    dtype=torch.int32))


def test_step_monitor_flags_a_slow_step():
    m = StepMonitor(warmup_steps=1)
    assert [m.record(dt) for dt in (5.0, 1.0, 1.1, 0.9)] == [False] * 4
    assert m.deadline == pytest.approx(3.0 * m.ewma)
    assert m.record(10.0) and m.slow_steps == 1
    assert not m.record(1.0)


class _Clock:
    """A stand-in for the span recorder's clock (``spans._clock``, in ns):
    time moves only inside the chunk solves, ``durations[k]`` seconds in
    the k-th (:meth:`around` wraps the chunk solver)."""

    def __init__(self, durations):
        self.durations, self.now, self.calls = list(durations), 0, 0

    def __call__(self):
        return self.now

    def around(self, solve):
        def timed(*args, **kw):
            out = solve(*args, **kw)
            k = min(self.calls, len(self.durations) - 1)
            self.now += int(self.durations[k] * 1e9)
            self.calls += 1
            return out
        return timed


def test_chunked_driver_emits_straggler_warnings(monkeypatch):
    X, Y = _grid_problem(l=32, seed=1)
    clock = _Clock([4.0, 1.0, 1.0, 1.0, 20.0, 1.0])
    monkeypatch.setattr(spans, "_clock", clock)
    monkeypatch.setattr(solver_fused, "solve_fused_batched_qp",
                        clock.around(solver_fused.solve_fused_batched_qp))
    diag = Diagnostics(ring=None)
    res = grid.solve_grid_compacted(X, Y, [0.5, 2.0], [0.5, 1.0],
                                    SolverConfig(eps=1e-3, max_iter=400),
                                    chunk=8, diagnostics=diag, **_cpu())
    assert isinstance(res, solver.SolveResult)
    rounds = [e for e in diag.sink.events if e.get("name") == "chunk_solve"]
    assert len(rounds) >= 6
    assert [e["seconds"] for e in rounds[:6]] == [4.0, 1.0, 1.0, 1.0, 20.0,
                                                  1.0]
    warn = [e for e in diag.sink.events if e["event"] == "straggler_warning"]
    assert [w["round"] for w in warn] == [4]
    assert warn[0]["seconds"] == 20.0
    # the EWMA (1.0) moved to 1.1 with the slow round before the event
    assert warn[0]["deadline"] == pytest.approx(3.3)
    assert warn[0]["lanes"] and warn[0]["rows"] >= 1
    assert diag.lanes == []                 # ring=None: phases only


def test_svr_and_oneclass_grid_drains():
    X, _ = _grid_problem(l=28, seed=2)
    rng = np.random.default_rng(2)
    y = np.sin(X[:, 0]) + 0.1 * rng.normal(size=28)
    cfg = SolverConfig(eps=1e-3, max_iter=400)
    diag = Diagnostics(ring=RingConfig(sample_every=8))
    out = grid.solve_grid_svr(X, y, np.array([0.5, 2.0]),
                              np.array([0.05, 0.1]), np.array([0.5, 1.0]),
                              cfg, diagnostics=diag, **_cpu())
    ref = grid.solve_grid_svr(X, y, np.array([0.5, 2.0]),
                              np.array([0.05, 0.1]), np.array([0.5, 1.0]),
                              cfg, **_cpu())
    assert torch.equal(out.alpha, ref.alpha)
    assert len(diag.lanes) == 8
    it = out.iterations.reshape(-1).tolist()
    assert [r["iterations"] for r in diag.lanes] == it
    assert [(r["gamma"], r["epsilon"], r["C"]) for r in diag.lanes] == [
        (g, e, c) for g in (0.5, 1.0) for e in (0.05, 0.1)
        for c in (0.5, 2.0)]
    assert any(e.get("name") == "solve_grid_svr" for e in diag.sink.events)

    diag2 = Diagnostics(ring=RingConfig(sample_every=8))
    out2 = grid.solve_grid_oneclass(X, np.array([0.2, 0.5]),
                                    np.array([0.5, 1.0]), cfg,
                                    diagnostics=diag2, **_cpu())
    assert len(diag2.lanes) == 4
    assert [r["iterations"] for r in diag2.lanes] == \
        out2.iterations.reshape(-1).tolist()
    assert [(r["gamma"], r["nu"]) for r in diag2.lanes] == [
        (0.5, 0.2), (0.5, 0.5), (1.0, 0.2), (1.0, 0.5)]


@pytest.mark.parametrize("driver", ["solve_grid", "solve_grid_compacted"])
def test_classic_grids_refuse_diagnostics(driver):
    X, Y = _grid_problem()
    with pytest.raises(ValueError, match="diagnostics"):
        getattr(grid, driver)(X, Y, np.array([1.0]), np.array([0.5]),
                              SolverConfig(), diagnostics=Diagnostics(),
                              device="cpu", dtype=F64)


def test_ovr_fused_passes_the_ring_through():
    X, Y = _grid_problem()
    cfg = SolverConfig(eps=1e-3, max_iter=300)
    base = multiclass.solve_ovr_fused(X, Y, 1.0, 0.7, cfg, device="cpu",
                                      dtype=F64)
    res, ring = multiclass.solve_ovr_fused(X, Y, 1.0, 0.7, cfg,
                                           device="cpu", dtype=F64,
                                           telemetry=RingConfig())
    assert torch.equal(res.alpha, base.alpha)
    assert ring.n_samples.shape == (2,)
    assert torch.equal(ring.n_ratio, res.n_planning)


# ---------------------------------------------------------------------------
# facades
# ---------------------------------------------------------------------------

def test_facades_drain_diagnostics():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(40, 3))
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    yr = np.sin(X[:, 0])
    rc = RingConfig(sample_every=8)
    kw = dict(device="cpu", dtype=F64)

    d = Diagnostics(ring=rc)
    clf = SVC(C=2.0, gamma=0.7, diagnostics=d, **kw).fit(X, y)
    ref = SVC(C=2.0, gamma=0.7, **kw).fit(X, y)
    assert torch.equal(clf.alpha_, ref.alpha_)
    assert len(d.lanes) == 1
    assert d.lanes[0]["C"] == 2.0 and d.lanes[0]["label"] == 1
    assert d.lanes[0]["iterations"] == int(clf.fit_result_.iterations)
    assert [e["name"] for e in d.sink.events if e["event"] == "phase"] == [
        "svc_fit"]

    d_ovr = Diagnostics(ring=rc)
    y3 = np.digitize(X[:, 0], [-0.5, 0.5])
    SVC(C=[1.0, 2.0, 4.0], gamma=0.7, diagnostics=d_ovr, **kw).fit(X, y3)
    assert [(r["label"], r["C"]) for r in d_ovr.lanes] == [
        (0, 1.0), (1, 2.0), (2, 4.0)]

    d2 = Diagnostics(ring=rc)
    reg = SVR(C=2.0, epsilon=0.1, gamma=0.7, diagnostics=d2, **kw).fit(X, yr)
    assert torch.equal(reg.alpha_, SVR(C=2.0, epsilon=0.1, gamma=0.7,
                                       **kw).fit(X, yr).alpha_)
    assert len(d2.lanes) == 1
    assert d2.lanes[0]["epsilon"] == 0.1
    assert d2.lanes[0]["iterations"] == int(reg.fit_result_.iterations)

    d3 = Diagnostics(ring=rc)
    oc = OneClassSVM(nu=0.3, gamma=0.7, diagnostics=d3, **kw).fit(X)
    assert len(d3.lanes) == 1
    assert d3.lanes[0]["nu"] == 0.3
    assert d3.lanes[0]["iterations"] == int(oc.fit_result_.iterations)

    # host-only diagnostics on the classic engine: phases, no lanes
    d4 = Diagnostics(ring=None)
    SVC(C=1.0, gamma=0.7, plan_candidates=2, diagnostics=d4, **kw).fit(X, y)
    assert d4.lanes == []
    assert [e["engine"] for e in d4.sink.events
            if e["event"] == "phase"] == ["batched"]
    d5 = Diagnostics(ring=rc)
    SVR(C=2.0, gamma=0.7, engine="batched", diagnostics=d5, **kw).fit(X, yr)
    OneClassSVM(nu=0.3, gamma=0.7, engine="batched", diagnostics=d5,
                **kw).fit(X)
    assert d5.lanes == []
    assert [e["name"] for e in d5.sink.events if e["event"] == "phase"] == [
        "svr_fit", "oneclass_fit"]


# ---------------------------------------------------------------------------
# sink, fingerprint, report
# ---------------------------------------------------------------------------

def test_env_fingerprint_and_diff():
    fp = env_fingerprint()
    for key in ("torch_version", "cuda_version", "backend", "device_kind",
                "device_count", "cpu_count", "host", "python", "machine"):
        assert key in fp
    assert fp["torch_version"] == torch.__version__
    assert fp["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert isinstance(fp["device_kind"], str) and fp["device_kind"]
    assert fp["device_count"] >= 1
    assert len(fp["host"]) == 12          # hashed, not the raw hostname
    int(fp["host"], 16)
    assert fingerprint_diff(fp, fp) == []
    lines = fingerprint_diff(fp, dict(fp, backend="other", device_count=8))
    assert any("backend" in ln for ln in lines)
    assert any("device_count" in ln for ln in lines)
    assert fingerprint_diff(None, fp)


def test_jsonl_sink_roundtrip(tmp_path):
    path = tmp_path / "events.jsonl"
    with JsonlSink(path) as sink:
        sink.emit("fingerprint", **env_fingerprint())
        with phase_scope("unit_phase", sink, tag=1):
            pass
        sink.emit("lane", lane=0, gap=torch.tensor(0.5, dtype=F64),
                  ts=torch.arange(3, dtype=torch.int32),
                  nested={"v": np.arange(2)})
    events = read_jsonl(path)
    assert [e["event"] for e in events] == ["fingerprint", "phase", "lane"]
    assert events[1]["name"] == "unit_phase" and events[1]["tag"] == 1
    assert events[1]["seconds"] >= 0.0
    assert events[2]["gap"] == 0.5        # torch coerced to plain
    assert events[2]["ts"] == [0, 1, 2]
    assert events[2]["nested"] == {"v": [0, 1]}


def _report_file(tmp_path):
    X, Y = _grid_problem()
    path = tmp_path / "run.jsonl"
    diag = Diagnostics(path, ring=RingConfig(sample_every=8))
    grid.solve_grid(X, Y, np.array([0.5, 2.0]), np.array([0.5, 1.0]),
                    SolverConfig(eps=1e-3, max_iter=300), diagnostics=diag,
                    **_cpu())
    diag.event("straggler_warning", round=3, seconds=9.5, deadline=3.0,
               lanes=[0, 7], rows=24)
    summary = diag.finalize()
    assert summary["n_lanes"] == 8
    return path


SECTIONS = ("## environment", "## host phases", "## convergence",
            "## stragglers", "## iteration histogram",
            "## planning trace (Fig. 3), lane 0", "## summary")


def test_telemetry_report_renders_every_section(tmp_path, capsys):
    path = _report_file(tmp_path)
    assert report.main([str(path), "--trace-lane", "0", "--hist"]) == 0
    out = capsys.readouterr().out
    for section in SECTIONS:
        assert section in out
    assert f"torch_version | {torch.__version__}" in out
    assert "backend | " in out
    assert out.count("g=0.5") >= 4 and "C=2" in out
    assert "accepted planning steps" in out
    assert "% of all iterations" in out
    assert "chunk deadline breached: round 3" in out
    assert "solve_grid_fused" in out


def test_report_cli_subprocess_entrypoint(tmp_path):
    path = _report_file(tmp_path)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.telemetry_report",
         str(path), "--top-k", "3", "--trace-lane", "1"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "## convergence" in proc.stdout
    assert "top 3 of 8 lanes" in proc.stdout
    empty = path.parent / "empty.jsonl"
    empty.write_text("")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.telemetry_report",
         str(empty)], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 1 and "no events" in proc.stderr


def test_reference_report_renders_the_port_file(tmp_path):
    """The JSONL format is shared: the reference's report reads the port's
    artifact (its environment table lists the fields it knows)."""
    path = _report_file(tmp_path)
    text = j_report.render_report(j_report.load_events(str(path)),
                                  trace_lane=0, hist=True)
    for section in SECTIONS:
        assert section in text
    assert "backend | " in text

    def sections(t):
        return {sec.split("\n", 1)[0]: sec for sec in t.split("## ")[1:]}

    theirs = sections(text)
    ours = sections(report.render_report(report.load_events(str(path)),
                                         trace_lane=0, hist=True))
    # the port's phase table adds a device-ms column to the reference's,
    # and its span section is its own; every other section is the same
    assert set(ours) == set(theirs) | {"spans"}
    for name, body in theirs.items():
        if name == "environment":
            continue
        if name != "host phases":
            assert ours[name] == body
            continue
        mine = [ln for ln in ours[name].splitlines() if ln.startswith("|")]
        rows = [ln for ln in body.splitlines() if ln.startswith("|")]
        assert len(mine) == len(rows)
        for a, b in zip(mine[2:], rows[2:]):
            assert a.startswith(b[:-1]) and a.count("|") == b.count("|") + 1


def test_drain_reads_tensors_and_keeps_the_caps():
    cfg = RingConfig(sample_every=1, cap=2, ratio_cap=2)
    ring = ring_init(cfg, 1, F64)
    on = torch.ones(1, dtype=torch.bool)
    for t in range(5):
        ring = ring_update(ring, cfg, t=t, active=on, newly_done=~on,
                           gap=torch.full((1,), float(t), dtype=F64),
                           n_active=torch.full((1,), 3, dtype=torch.int32),
                           n_unshrink=torch.full((1,), t,
                                                 dtype=torch.int32),
                           plan_event=on, ratio=torch.full((1,), 1.0 + t,
                                                           dtype=F64))
    diag = Diagnostics(ring=cfg)
    (rec,) = diag.drain_ring(ring, [{"gamma": torch.tensor(0.5)}])
    assert rec["n_samples"] == 5 and rec["samples"]["t"] == [0, 4]
    assert rec["ratio"]["value"] == [1.0, 5.0]
    assert rec["gamma"] == 0.5 and rec["total_unshrink"] == 4
    assert isinstance(ring, TelemetryRing)
    assert Diagnostics(ring=None).drain_ring(ring) == []


# ---------------------------------------------------------------------------
# the lane-sharded engine: rings gathered back in the caller's lane order
# ---------------------------------------------------------------------------

def test_sharded_ring_matches_batched_one_slab():
    """One slab's ring is bitwise the batched engine's, and holds the
    reference's one-device sharded ring on a tie-free problem."""
    from repro.core.sharded_lanes import solve_fused_sharded as j_sharded
    from repro_torch.core.sharded_lanes import solve_fused_sharded
    X, Y = _grid_problem(seed=3)
    cfg = SolverConfig(eps=1e-3, max_iter=300)
    rc = RingConfig(sample_every=8)
    kw = dict(device="cpu", dtype=F64, telemetry=rc)
    rs, ring_s = solve_fused_sharded(X, Y, 1.0, 0.8, cfg, devices=("cpu",),
                                     **kw)
    rb, ring_b = solver_fused.solve_fused_batched(X, Y, 1.0, 0.8, cfg, **kw)
    assert torch.equal(rs.iterations, rb.iterations)
    for f in FIELDS:
        assert torch.equal(getattr(ring_s, f), getattr(ring_b, f)), f
    jres, jring = j_sharded(jnp.asarray(X), jnp.asarray(Y), 1.0, 0.8,
                            JConfig(eps=1e-3, max_iter=300), impl="jnp",
                            telemetry=JRing(sample_every=8))
    assert np.array_equal(rs.iterations.numpy(), np.asarray(jres.iterations))
    want, got = _leaves(jring), _leaves(ring_s)
    for f in INT_FIELDS:
        assert np.array_equal(got[f], want[f]), f
    for f in ("gap", "ratio"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-9, atol=0)


def test_sharded_ring_gathers_back_in_caller_order():
    """Heterogeneous lanes over four slabs of two: the deal permutes the
    lanes across slabs, and every ring row comes back in the caller's
    order (the integer channels exactly, the rest to 1e-12 of the batched
    engine's); the objectives hold the reference's batched engine.  (A
    slab of one lane is left out: its plain product of one query row
    rounds apart from a batch's, as ``sharded_lanes`` notes.)"""
    from repro_torch.core.sharded_lanes import solve_fused_sharded
    rng = np.random.default_rng(0)
    X = rng.normal(size=(24, 3))
    y = np.where(rng.normal(size=24) >= 0, 1.0, -1.0)
    Y = np.stack([y, -y, y, -y] * 2)
    gam = np.array([0.3, 0.6, 1.0, 1.5, 0.4, 0.8, 1.2, 0.5])
    C = np.array([8.0, 0.5, 2.0, 1.0, 4.0, 0.25, 16.0, 3.0])
    cfg = SolverConfig(eps=1e-3, max_iter=500)
    kw = dict(device="cpu", dtype=F64, telemetry=RingConfig(sample_every=8))
    rs, ring_s = solve_fused_sharded(X, Y, C, gam, cfg,
                                     devices=("cpu",) * 4, **kw)
    rb, ring_b = solver_fused.solve_fused_batched(X, Y, C, gam, cfg, **kw)
    assert torch.equal(rs.iterations, rb.iterations)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ring_s, f).numpy(),
                                   getattr(ring_b, f).numpy(), rtol=1e-12,
                                   atol=0)
    for f in INT_FIELDS:
        assert torch.equal(getattr(ring_s, f), getattr(ring_b, f)), f
    assert int(ring_s.n_samples.min()) > 0
    jres = j_qp(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(
        np.minimum(0.0, Y * C[:, None])), jnp.asarray(
        np.maximum(0.0, Y * C[:, None])), jnp.asarray(gam),
        JConfig(eps=1e-3, max_iter=500), impl="jnp")
    np.testing.assert_allclose(rs.objective.numpy(),
                               np.asarray(jres.objective), rtol=1e-6)
