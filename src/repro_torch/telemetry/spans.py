"""Spans and counters along the solve path, owned by a
:class:`~repro_torch.telemetry.Diagnostics` (its ``spans``).

A span is a named, nested interval of the solve: its host start and end
in Unix-epoch nanoseconds (the clock ``torch.profiler`` stamps its events
with), and, for a span that enqueues work on a CUDA device, a pair of
CUDA timing events recorded on the current stream at its ends.  While a
``torch.profiler`` records, each span is also a ``record_function`` range
of the same name, so the profiler's trace holds it on the same clock.
Counters are named integers.

The recorder is off unless a ``Diagnostics`` is active: the ``diagnostics=``
argument of a facade or grid driver, or ``with telemetry.recording(diag):``
around any call.  Both set one context variable (:func:`active`), which
the entry points (a fit, a grid call, :func:`~repro_torch.core.
solver_fused._drive`) read once; off, they take no event, enter no range
and allocate nothing.  The recorder never synchronises: a span's events
are resolved (:meth:`SpanRecorder.resolve`, :meth:`SpanRecorder.summary`)
after the caller's own synchronise, and nothing is recorded on the device
inside a CUDA-graph capture.

Spans of the solve path (one ``fit`` a facade fit or grid call):

* ``fit`` (host and device) and ``fit.prep`` (host: from the fit's entry
  to its loop's first chunk), ``grid.bank`` (the Gram bank's build),
  ``decide`` (the decision values);
* ``loop.eager``, ``loop.capture``, ``loop.replay`` and ``loop.check``
  (the fused loop's chunks, :func:`~repro_torch.core.solver_fused._drive`);
* ``chunked.slice``, ``chunked.solve``, ``chunked.rebuild`` and
  ``chunked.checks`` (the chunked driver's rounds);

and the counters ``fit.host_copy_bytes``, ``loop.eager_iters``,
``loop.captures``, ``loop.replays``, ``loop.replayed_iters`` and
``loop.checks``.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time

import torch
from torch.autograd.profiler import record_function

# the recorder of the calls under way (None: off)
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_spans", default=None)
# a host clock in nanoseconds; tests put a stand-in here
_clock = time.perf_counter_ns
# the context of an entry point with nothing to record
_NULL = contextlib.nullcontext()


def active() -> "SpanRecorder | None":
    """The recorder of the calls under way, or ``None`` (off)."""
    return _ACTIVE.get()


def recorder(diagnostics=None) -> "SpanRecorder | None":
    """The recorder a call records into: that of its ``diagnostics=``
    when given, else the active one."""
    if diagnostics is not None:
        return diagnostics.spans
    return _ACTIVE.get()


class Span:
    """One recorded span: ``parent`` is the index of the enclosing span
    (-1 for none), ``start_ns``/``end_ns`` host Unix-epoch nanoseconds,
    ``device_ms`` the device's time between its events (``None`` before
    they are resolved, or for a host-only span), ``t0_ms``/``t1_ms`` its
    events on the device clock, ms from the first event the recorder took
    on that device.  ``phase`` and ``meta`` are the sink's label and
    notes."""

    __slots__ = ("name", "index", "parent", "phase", "meta", "start_ns",
                 "end_ns", "device", "range", "events", "device_ms",
                 "t0_ms", "t1_ms")

    def __init__(self, name, index, parent, phase, meta):
        self.name, self.index, self.parent = name, index, parent
        self.phase, self.meta = phase, meta
        self.start_ns = self.end_ns = self.device = None
        self.range = self.events = None
        self.device_ms = self.t0_ms = self.t1_ms = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Open:
    """The context of one span: the recorder made active, the span begun
    on entry and ended on exit (with ``prep``, ``fit.prep`` inside it)."""

    __slots__ = ("rec", "name", "device", "phase", "meta", "prep", "span",
                 "token")

    def __init__(self, rec, name, device, phase, meta, prep=False):
        self.rec, self.name, self.device = rec, name, device
        self.phase, self.meta, self.prep = phase, meta, prep
        self.span = self.token = None

    def __enter__(self) -> Span:
        rec = self.rec
        if _ACTIVE.get() is not rec:
            self.token = _ACTIVE.set(rec)
        self.span = rec._begin(self.name, self.device, self.phase, self.meta)
        if self.prep:
            rec._begin("fit.prep", None, None, None)
        return self.span

    def __exit__(self, *exc):
        rec = self.rec
        if self.prep:
            rec.end_prep()
        rec._end(self.span)
        if self.token is not None:
            _ACTIVE.reset(self.token)
        return False


class SpanRecorder:
    """The spans and counters of the calls recorded into it.

    ``sink`` (a :class:`~repro_torch.telemetry.sink.JsonlSink`, optional)
    receives a ``phase`` event when a span with a phase label ends (its
    host seconds and the span's notes), and the events of :meth:`emit`.
    """

    def __init__(self, sink=None):
        self.sink = sink
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        # the host clock anchored once to the Unix epoch
        self._unix0, self._clk0 = time.time_ns(), _clock()
        self._local = threading.local()
        # the first event taken on each device: the zero of its clock
        self._anchors: dict = {}

    # -- recording ---------------------------------------------------------

    def now_ns(self) -> int:
        """Host Unix-epoch nanoseconds on the recorder's clock."""
        return self._unix0 + (_clock() - self._clk0)

    def _stack(self) -> list:
        """The indices of the spans open on the calling thread."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _begin(self, name, device, phase, meta) -> Span:
        st = self._stack()
        sp = Span(name, len(self.spans), st[-1] if st else -1, phase, meta)
        st.append(sp.index)
        self.spans.append(sp)
        if torch._C._autograd._profiler_enabled():
            # a range is work only a profiler reads
            sp.range = record_function(name)
            sp.range.__enter__()
        if (device is not None and device.type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            self._anchors.setdefault(device, ev)
            sp.device, sp.events = device, (ev,)
        sp.start_ns = self.now_ns()
        return sp

    def _end(self, sp: Span) -> None:
        sp.end_ns = self.now_ns()
        if sp.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(sp.device))
            sp.events = (sp.events[0], ev)
        if sp.range is not None:
            sp.range.__exit__(None, None, None)
            sp.range = None
        st = self._stack()
        if st and st[-1] == sp.index:
            st.pop()
        else:
            st.remove(sp.index)
        if sp.phase is not None and self.sink is not None:
            self.sink.emit("phase", name=sp.phase, span=sp.name,
                           seconds=sp.host_ms / 1e3, **(sp.meta or {}))

    def span(self, name: str, device=None, *, phase: str | None = None,
             **meta) -> _Open:
        """The context of a span ``name``; with a CUDA ``device`` it also
        takes the device's time on its current stream.  ``phase`` labels
        it for the sink's ``phase`` event (``meta`` rides along)."""
        return _Open(self, name, device, phase, meta)

    def outer(self, name: str, device=None, *, phase: str | None = None,
              prep: bool = False, **meta):
        """:meth:`span` unless a span ``name`` is already open on this
        thread (a facade's ``predict`` around its ``decision_function``):
        then nothing.  ``prep`` opens ``fit.prep`` inside it, which the
        fused loop's first chunk (:meth:`end_prep`) or the span's end
        closes."""
        spans = self.spans
        if any(spans[i].name == name for i in self._stack()):
            return _NULL
        return _Open(self, name, device, phase, meta, prep)

    def end_prep(self) -> None:
        """Close ``fit.prep`` if it is the innermost open span."""
        st = self._stack()
        if st and self.spans[st[-1]].name == "fit.prep":
            self._end(self.spans[st[-1]])

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    # -- reading out -------------------------------------------------------

    def resolve(self, sp: Span | None = None):
        """Turn the CUDA events of ``sp`` (of every ended span when
        ``None``) into device times; returns ``sp``'s device ms.  Call it
        after a synchronise: an event still pending is waited for."""
        for s in ([sp] if sp is not None else self.spans):
            if s.events is None or len(s.events) < 2:
                continue
            e0, e1 = s.events
            if not e1.query():
                e1.synchronize()
            anchor = self._anchors[s.device]
            s.t0_ms = anchor.elapsed_time(e0)
            s.t1_ms = anchor.elapsed_time(e1)
            s.device_ms = s.t1_ms - s.t0_ms
            s.events = None
        return None if sp is None else sp.device_ms

    def summary(self) -> dict:
        """Every span name's count, host ms and device ms; the counters;
        the device-clock timeline of the first ``fit``'s device (each
        device span's [start, end], ms from that fit's start event); and
        the idle gaps between the innermost device spans on it, labelled
        ``<previous>→<next>``, in the window from the first ``fit``'s
        start event to the last ``decide``'s end (the fit's end without
        one), with the window's and the spans' union's ms and the idle
        share in %."""
        self.resolve()
        names: dict = {}
        for s in self.spans:
            if s.end_ns is None:
                continue
            row = names.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                            "device_ms": None})
            row["count"] += 1
            row["host_ms"] += s.host_ms
            if s.device_ms is not None:
                row["device_ms"] = (row["device_ms"] or 0.0) + s.device_ms
        out = {"spans": names, "counters": dict(self.counters)}
        out.update(_device_window(self.spans))
        return out

    def emit(self) -> dict:
        """:meth:`summary`, with a ``span`` event a (name, phase) and one
        ``span_summary`` event (counters, gaps, window) sent to the
        sink."""
        s = self.summary()
        if self.sink is None:
            return s
        groups: dict = {}
        for sp in self.spans:
            if sp.end_ns is None:
                continue
            g = groups.setdefault((sp.name, sp.phase), [0, 0.0, None])
            g[0] += 1
            g[1] += sp.host_ms
            if sp.device_ms is not None:
                g[2] = (g[2] or 0.0) + sp.device_ms
        for (name, phase), (n, host, dev) in groups.items():
            extra = {} if phase is None else {"phase": phase}
            self.sink.emit("span", name=name, count=n, host_ms=host,
                           device_ms=dev, **extra)
        self.sink.emit("span_summary", **{k: v for k, v in s.items()
                                          if k not in ("spans", "timeline")})
        return s


def _device_window(spans: list) -> dict:
    """The timeline, gaps and idle share of :meth:`SpanRecorder.summary`
    (empty without a device ``fit``)."""
    fit = next((s for s in spans if s.name == "fit"
                and s.device_ms is not None), None)
    if fit is None:
        return {}
    dev = [(i, s) for i, s in enumerate(spans)
           if s.device_ms is not None and s.device == fit.device]
    # a device span holding another is not a leaf: the idle time is what
    # lies between the leaves
    inner = set()
    for i, s in dev:
        p = s.parent
        while p >= 0 and spans[p].device_ms is None:
            p = spans[p].parent
        if p >= 0:
            inner.add(p)
    t0 = fit.t0_ms
    decides = [s.t1_ms for _, s in dev if s.name == "decide"
               and s.t1_ms >= t0]
    t1 = max(decides) if decides else fit.t1_ms
    timeline = [[s.name, s.t0_ms - t0, s.t1_ms - t0]
                for _, s in sorted(dev, key=lambda p: p[1].t0_ms)
                if s.t1_ms >= t0]
    leaves = sorted((s.t0_ms, s.t1_ms, s.name) for i, s in dev
                    if i not in inner and s.t1_ms > t0 and s.t0_ms < t1)
    gaps: dict = {}
    busy, at, prev = 0.0, t0, "fit"
    for a, b, name in leaves:
        a, b = max(a, t0), min(b, t1)
        if a > at:
            key = f"{prev}→{name}"
            gaps[key] = gaps.get(key, 0.0) + (a - at)
        if b > at:
            busy += b - max(a, at)
            at = b
        prev = name
    if t1 > at:
        key = f"{prev}→end"
        gaps[key] = gaps.get(key, 0.0) + (t1 - at)
    window = t1 - t0
    return {"timeline": timeline, "gaps": gaps, "window_ms": window,
            "busy_ms": busy,
            "idle_share": 100.0 * (1.0 - busy / window) if window > 0
            else None}


@contextlib.contextmanager
def recording(diagnostics):
    """Record the calls made inside into ``diagnostics`` (its
    :class:`SpanRecorder`), as their ``diagnostics=`` argument would."""
    token = _ACTIVE.set(diagnostics.spans)
    try:
        yield diagnostics
    finally:
        _ACTIVE.reset(token)


def fit_span(diagnostics, phase: str, device, **meta):
    """The span ``fit`` of a facade fit or grid call on ``device`` (host
    and device; with ``fit.prep`` inside, from here to its loop's first
    chunk), recorded into ``diagnostics`` or else the active recorder,
    whose end emits the ``phase`` event ``phase`` with ``meta`` (and what
    is added to the span's ``meta`` meanwhile); nothing when no recorder
    records or a fit is already open on this thread."""
    rec = recorder(diagnostics)
    if rec is None:
        return _NULL
    return rec.outer("fit", device, phase=phase, prep=True, **meta)


def decide_span(diagnostics, device):
    """The span ``decide`` of the decision values on ``device`` (host and
    device), as :func:`fit_span` records; nothing when no recorder records
    or a ``decide`` is already open on this thread."""
    rec = recorder(diagnostics)
    if rec is None:
        return _NULL
    return rec.outer("decide", device)
