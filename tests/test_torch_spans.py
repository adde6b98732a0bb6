"""The span recorder (``repro_torch.telemetry.spans``) on the solve path:
off by default and then free of events, ranges and synchronisations; on,
every span and counter of a fit, grid call and decision with its nesting,
counters that agree with the loop's chunk schedule, results bitwise those
of the run without it, host stamps on the profiler's clock, and the same
spans from ``diagnostics=`` as from ``telemetry.recording``."""

import collections
import contextlib
import json
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.analysis import capture_guard
from repro_torch.core import grid, solver_fused
from repro_torch.core.solver import SolverConfig
from repro_torch.launch import telemetry_report as report
from repro_torch.svm import SVC, SVR
from repro_torch.telemetry import Diagnostics, recording, spans

F64 = torch.float64
CFG = SolverConfig(eps=1e-3, max_iter=3000)
LOOP = ("loop.eager", "loop.capture", "loop.replay", "loop.check")
CHUNKED = ("chunked.slice", "chunked.solve", "chunked.rebuild",
           "chunked.checks")


def _problem(l=60, k=3, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(l, 4))
    y = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.4, 0.4])[:, None]
    y = y[:, 0] % k
    return X, y


def _svc(**kw):
    return SVC(C=4.0, gamma="scale", eps=CFG.eps, max_iter=CFG.max_iter,
               device="cpu", dtype=F64, **kw)


def _grid_call(shrinking=False):
    X, y = _problem(l=48, k=2, seed=5)
    Y = np.where(y == 1, 1.0, -1.0)[None, :]
    cfg = SolverConfig(eps=1e-3, max_iter=3000, shrink_every=40)
    res = grid.solve_grid(X, Y, [0.5, 4.0], [0.3, 1.0], cfg, impl="auto",
                          precompute=True, shrinking=shrinking, device="cpu",
                          dtype=F64)
    dec = grid.grid_decision(X[:7], X, [0.3, 1.0], res.alpha, res.b)
    return res, dec


def _tree(rec) -> list:
    """(name, parent's name) of every span, in the order they began."""
    return [(s.name, rec.spans[s.parent].name if s.parent >= 0 else None)
            for s in rec.spans]


def _expected(loops, max_iter) -> dict:
    """The counters a fit's fresh loops give, from their chunk schedules
    (the capture guard's): a shape's first chunk runs eagerly, the later
    ones replay the graph captured for it on its second."""
    out = collections.Counter()
    for _, shapes in loops:
        seen = set()
        for shape in shapes:
            if shape in seen:
                out["loop.replays"] += 1
                out["loop.replayed_iters"] += len(shape)
            else:
                out["loop.eager_iters"] += len(shape)
                seen.add(shape)
        out["loop.captures"] += sum(
            1 for n in collections.Counter(shapes).values() if n >= 2)
        t = sum(len(s) for s in shapes)
        out["loop.checks"] += len(shapes) + (t < max_iter)
    return out


class _Spies:
    """Counts CUDA events made, profiler ranges entered and
    synchronisations asked for while installed."""

    def __init__(self, monkeypatch):
        self.n = collections.Counter()
        spies = self

        class Event:
            def __init__(self, *a, **kw):
                spies.n["event"] += 1

            def record(self, *a, **kw):
                pass

        enter = torch.autograd.profiler.record_function.__enter__

        def entered(rf):
            spies.n["range"] += 1
            return enter(rf)

        def synced(*a, **kw):
            spies.n["sync"] += 1

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.autograd.profiler.record_function,
                            "__enter__", entered)
        monkeypatch.setattr(torch.cuda, "synchronize", synced)


# ---------------------------------------------------------------------------
# (a) off: nothing on the solve path
# ---------------------------------------------------------------------------

def test_off_makes_no_event_range_or_sync(monkeypatch):
    X, y = _problem()
    spies = _Spies(monkeypatch)
    with capture_guard.stand_in_graphs():
        clf = _svc().fit(X, y)
        clf.decision_function(X[:5])
        _grid_call(shrinking=True)
    assert spies.n == {}
    assert spans.active() is None
    # the same calls with the recorder on enter ranges while a profiler
    # records (the control), and none without one
    with capture_guard.stand_in_graphs(), \
            recording(Diagnostics(ring=None)):
        _svc().fit(X, y).decision_function(X[:5])
    assert spies.n == {}
    with capture_guard.stand_in_graphs(), \
            profile(activities=[ProfilerActivity.CPU]), \
            recording(Diagnostics(ring=None)):
        _svc().fit(X, y).decision_function(X[:5])
    assert spies.n["range"] > 0 and spies.n["sync"] == 0


# ---------------------------------------------------------------------------
# (b) on: every span and counter, nested, and the counters of the schedule
# ---------------------------------------------------------------------------

def test_fit_spans_nest_and_count_the_schedule():
    X, y = _problem()
    diag = Diagnostics(ring=None)
    with capture_guard.stand_in_graphs(), capture_guard.CaptureLog() as log:
        clf = _svc(diagnostics=diag).fit(X, y)
        clf.predict(X[:5])
    rec = diag.spans
    tree = _tree(rec)
    assert tree[0] == ("fit", None) and tree[1] == ("fit.prep", "fit")
    # the loop's spans hang off the fit once its preparation ended
    assert {p for n, p in tree if n in LOOP} == {"fit"}
    assert {n for n, _ in tree} == {"fit", "fit.prep", "decide", *LOOP}
    # predict's decision_function is inside predict's one decide
    assert [t for t in tree if t[0] == "decide"] == [("decide", None)]
    want = _expected(log.loops, CFG.max_iter)
    assert all(want[k] > 0 for k in ("loop.replays", "loop.captures"))
    got = {k: v for k, v in rec.counters.items() if k.startswith("loop.")}
    assert got == dict(want)
    assert len(log.captures) == rec.counters["loop.captures"]
    # the loop's iterations: those of its chunks, up to a chunk past the
    # last lane's
    t = rec.counters["loop.eager_iters"] + rec.counters["loop.replayed_iters"]
    assert t == sum(len(s) for _, shapes in log.loops for s in shapes)
    most = int(clf.fit_result_.iterations.max())
    assert most <= t < most + solver_fused.CHECK_EVERY
    # a CPU copy of X is no copy
    assert rec.counters["fit.host_copy_bytes"] == 0
    counts = {k: v["count"] for k, v in diag.span_summary()["spans"].items()}
    assert counts["loop.replay"] == rec.counters["loop.replays"]
    assert counts["loop.check"] == rec.counters["loop.checks"]
    assert counts["loop.capture"] == rec.counters["loop.captures"]
    # the fit's phase event carries its notes
    phase = [e for e in diag.sink.events if e["event"] == "phase"]
    assert [(e["name"], e["span"], e["engine"], e["n_class"])
            for e in phase] == [("svc_fit", "fit", "fused", 3)]


def test_grid_spans_bank_under_prep_and_shrinking_schedule():
    diag = Diagnostics(ring=None)
    with capture_guard.stand_in_graphs(), capture_guard.CaptureLog() as log, \
            recording(diag):
        _grid_call(shrinking=True)
    rec = diag.spans
    tree = _tree(rec)
    assert ("grid.bank", "fit.prep") in tree
    assert ("decide", None) in tree
    assert {n for n, _ in tree} == {"fit", "fit.prep", "grid.bank",
                                    "decide", *LOOP}
    # shrinking every 40 iterations: chunks of 32 and of 8 ending on a
    # refresh, a graph each
    assert len({s for _, shapes in log.loops for s in shapes}) == 2
    got = {k: v for k, v in rec.counters.items() if k.startswith("loop.")}
    assert got == dict(_expected(log.loops, 3000))
    assert [e["name"] for e in diag.sink.events
            if e["event"] == "phase"] == ["solve_grid_fused"]


def test_chunked_and_facade_spans_and_counters():
    X, y = _problem(l=40, k=2, seed=6)
    Y = np.where(y == 1, 1.0, -1.0)[None, :]
    diag = Diagnostics(ring=None)
    with recording(diag):
        grid.solve_grid_compacted(X, Y, [0.5, 2.0], [0.5, 1.0],
                                  SolverConfig(eps=1e-3, max_iter=400),
                                  chunk=8, impl="auto", precompute=True,
                                  shrinking=True, device="cpu", dtype=F64)
        SVR(C=1.0, epsilon=0.1, gamma="scale", device="cpu",
            dtype=F64).fit(X, X[:, 0]).predict(X[:4])
    tree = _tree(diag.spans)
    names = {n for n, _ in tree}
    assert set(CHUNKED) <= names
    assert {p for n, p in tree if n in CHUNKED} == {"fit"}
    # the chunk solves' loops run inside chunked.solve
    assert {p for n, p in tree if n == "loop.eager"} == {"chunked.solve",
                                                         "fit"}
    # eager loops on the CPU: no graph is captured or replayed
    assert set(diag.spans.counters) == {"fit.host_copy_bytes",
                                        "loop.eager_iters", "loop.checks"}
    rounds = [e for e in diag.sink.events if e.get("name") == "chunk_solve"]
    assert rounds and all(e["seconds"] > 0 for e in rounds)
    assert [e["name"] for e in diag.sink.events if e["event"] == "phase"
            and e["name"] != "chunk_solve"] == ["solve_grid_compacted",
                                                "svr_fit"]


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_loop_frees_each_state_as_it_goes(on, monkeypatch):
    """A chunk rebinds the loop's state every iteration, so the state an
    iteration read is freed when the next begins (the device's memory
    peak holds no state of the past)."""
    X, y = _problem()
    dead = []
    drive = solver_fused._drive

    def spy(body, s, *args, **kw):
        refs = []

        def watched(st, r):
            refs.append(weakref.ref(st.G))
            if len(refs) > 2:
                dead.append(refs[-2]() is None)
            return body(st, r)
        return drive(watched, s, *args, **kw)

    monkeypatch.setattr(solver_fused, "_drive", spy)
    with (recording(Diagnostics(ring=None)) if on
          else contextlib.nullcontext()):
        _svc().fit(X, y)
    assert len(dead) > 32 and all(dead)


# ---------------------------------------------------------------------------
# (c) results bitwise with the recorder on and off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graphs", [False, True])
def test_results_bitwise_on_and_off(graphs):
    X, y = _problem()

    def run():
        clf = _svc().fit(X, y)
        res, dec = _grid_call(shrinking=True)
        return (clf.alpha_, clf.b_, clf.fit_result_.iterations,
                clf.decision_function(X[:9]), res.alpha, res.iterations, dec)

    with (capture_guard.stand_in_graphs() if graphs
          else contextlib.nullcontext()):
        off = run()
        with recording(Diagnostics(ring=None)):
            on = run()
    for a, b in zip(off, on):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (d) host stamps on the profiler's clock
# ---------------------------------------------------------------------------

def test_span_stamps_match_the_profiler_events():
    X, y = _problem()
    diag = Diagnostics(ring=None)
    with capture_guard.stand_in_graphs(), \
            profile(activities=[ProfilerActivity.CPU]) as prof, \
            recording(diag):
        _svc().fit(X, y).decision_function(X[:5])
    names = {s.name for s in diag.spans.spans}
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            events[e.name()].append((e.start_ns(),
                                     e.start_ns() + e.duration_ns()))
    by_name = collections.defaultdict(list)
    for s in diag.spans.spans:
        by_name[s.name].append((s.start_ns, s.end_ns))
    assert set(by_name) == set(events)
    for name, stamps in by_name.items():
        prof_ev = sorted(events[name])
        assert len(prof_ev) == len(stamps), name
        for (a, b), (pa, pb) in zip(sorted(stamps), prof_ev):
            assert abs(a - pa) < 1_000_000 and abs(b - pb) < 1_000_000, name


# ---------------------------------------------------------------------------
# (e) diagnostics= and recording() record the same spans
# ---------------------------------------------------------------------------

def test_diagnostics_argument_and_recording_agree():
    X, y = _problem()
    d1, d2 = Diagnostics(ring=None), Diagnostics(ring=None)
    with capture_guard.stand_in_graphs():
        _svc(diagnostics=d1).fit(X, y).decision_function(X[:5])
        with recording(d2):
            _svc().fit(X, y).decision_function(X[:5])
    assert _tree(d1.spans) == _tree(d2.spans)
    assert d1.spans.counters == d2.spans.counters
    assert spans.active() is None

    def phases(d):
        return [{k: v for k, v in e.items() if k != "ts"}
                for e in d.sink.events if e["event"] == "phase"]
    assert [{k: v for k, v in e.items() if k != "seconds"}
            for e in phases(d1)] == [
        {k: v for k, v in e.items() if k != "seconds"} for e in phases(d2)]


# ---------------------------------------------------------------------------
# the device window's arithmetic, the events and the report
# ---------------------------------------------------------------------------

def _span(name, index, parent, t0, t1, dev):
    s = spans.Span(name, index, parent, None, None)
    s.start_ns, s.end_ns = 0, 1
    s.device, s.t0_ms, s.t1_ms, s.device_ms = dev, t0, t1, t1 - t0
    return s


def test_idle_gaps_and_share_from_the_leaves():
    cuda = torch.device("cuda", 0)
    made = [("fit", -1, 10.0, 40.0), ("grid.bank", 0, 12.0, 20.0),
            ("loop.eager", 0, 21.0, 25.0), ("loop.replay", 0, 26.0, 30.0),
            ("loop.replay", 0, 31.0, 35.0), ("decide", -1, 41.0, 44.0)]
    got = spans._device_window(
        [_span(n, i, p, a, b, cuda) for i, (n, p, a, b) in enumerate(made)])
    assert got["window_ms"] == 34.0
    # the fit holds the others: the leaves cover 8 + 4 + 4 + 4 + 3 ms
    assert got["busy_ms"] == 23.0
    assert got["gaps"] == {"fit→grid.bank": 2.0, "grid.bank→loop.eager": 1.0,
                           "loop.eager→loop.replay": 1.0,
                           "loop.replay→loop.replay": 1.0,
                           "loop.replay→decide": 6.0}
    assert got["idle_share"] == pytest.approx(100.0 * 11.0 / 34.0)
    assert got["timeline"][0] == ["fit", 0.0, 30.0]
    assert got["timeline"][-1] == ["decide", 31.0, 34.0]
    # host-only spans (no device time) give no window
    host = spans.Span("fit", 0, -1, None, None)
    assert spans._device_window([host]) == {}


def test_finalize_emits_spans_and_the_report_renders_them(tmp_path):
    X, y = _problem()
    path = tmp_path / "run.jsonl"
    diag = Diagnostics(path, ring=None)
    with capture_guard.stand_in_graphs():
        _svc(diagnostics=diag).fit(X, y)
    diag.finalize()
    events = [json.loads(ln) for ln in path.read_text().splitlines()]
    rows = {(e["name"], e.get("phase")): e for e in events
            if e["event"] == "span"}
    assert rows[("fit", "svc_fit")]["count"] == 1
    assert rows[("loop.replay", None)]["count"] == \
        diag.spans.counters["loop.replays"]
    summary = [e for e in events if e["event"] == "span_summary"]
    assert summary[0]["counters"] == diag.spans.counters
    text = report.render_report(events)
    body = text.split("## spans")[1]
    assert "| loop.replay |" in body and "loop.checks=" in body
    phase_rows = [ln for ln in text.split("## host phases")[1].splitlines()
                  if ln.startswith("| svc_fit")]
    assert len(phase_rows) == 1 and phase_rows[0].endswith("| - |")
