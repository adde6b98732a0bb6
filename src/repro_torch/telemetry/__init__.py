"""Solver observability: the flight recorder of the fused PA-SMO loop
(``repro.telemetry``).

Three tiers:

* **device**: :class:`~repro_torch.telemetry.ring.TelemetryRing`, bounded
  per-lane ring buffers carried through the fused loop (masked writes
  that a CUDA graph replays; :mod:`repro_torch.telemetry.ring`);
* **host**: the JSONL event sink and the environment fingerprint
  (:mod:`repro_torch.telemetry.sink`), and the spans and counters of the
  solve path (:mod:`repro_torch.telemetry.spans`): host and CUDA-event
  times, each span a profiler range while a profiler records;
* **report**: ``python -m repro_torch.launch.telemetry_report`` renders
  convergence tables and a straggler diagnosis from the JSONL artifact.

:class:`Diagnostics` is the user's handle, passed as ``diagnostics=`` to
the grid drivers, the chunked driver and the ``SVC``/``SVR``/
``OneClassSVM`` facades.  The batched engines take its
:class:`~repro_torch.telemetry.ring.RingConfig` as ``telemetry=`` and
return their rings, which the drivers drain into the handle's sink.
``with recording(diag):`` records the spans of any call made inside into
``diag``, as its ``diagnostics=`` argument would.
"""

from __future__ import annotations

import numpy as np

from repro_torch.telemetry.ring import (RingConfig, TelemetryRing, ring_init,
                                        ring_slice, ring_update)
from repro_torch.telemetry.sink import (JsonlSink, _to_plain,
                                        env_fingerprint, fingerprint_diff,
                                        phase_scope, read_jsonl)
from repro_torch.telemetry.spans import SpanRecorder, recording

__all__ = [
    "Diagnostics", "RingConfig", "TelemetryRing", "ring_init",
    "ring_update", "ring_slice", "JsonlSink", "env_fingerprint",
    "fingerprint_diff", "phase_scope", "read_jsonl", "SpanRecorder",
    "recording",
]

_RING_FIELDS = ("t", "gap", "n_active", "n_unshrink", "n_samples", "ratio",
                "ratio_t", "n_ratio")


def _host(v) -> np.ndarray:
    """A tensor or array as a host numpy array (one copy off the card)."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class Diagnostics:
    """Host-side flight-recorder handle for one or more solver runs.

    Parameters
    ----------
    path : optional JSONL output path (``None`` keeps the events in
        memory: ``diag.sink.events``).
    ring : the device tier's sampling geometry, or ``None`` to record
        spans only (the engines then run their ring-free loop).

    ``spans`` is the handle's :class:`~repro_torch.telemetry.spans.
    SpanRecorder`, which the calls it is passed to (or that run inside
    :func:`recording`) record their spans and counters into.
    """

    def __init__(self, path=None, *, ring: RingConfig | None = RingConfig(),
                 sink: JsonlSink | None = None):
        self.ring_config = ring
        self.sink = sink if sink is not None else JsonlSink(path)
        self.spans = SpanRecorder(self.sink)
        self.lanes: list[dict] = []
        self.sink.emit("fingerprint", **env_fingerprint())

    # -- host tier ---------------------------------------------------------

    def span_summary(self) -> dict:
        """:meth:`~repro_torch.telemetry.spans.SpanRecorder.summary`:
        each span's count, host and device ms, the counters, the device
        timeline, its idle gaps and idle share.  Call it after the card
        was synchronised."""
        return self.spans.summary()

    def event(self, event: str, **payload):
        return self.sink.emit(event, **payload)

    # -- device tier drain -------------------------------------------------

    def drain_ring(self, ring: TelemetryRing, meta=None, result=None):
        """Turn a returned ring into per-lane ``lane`` events.

        ``meta`` is an optional per-lane list of dicts (gamma, C, label:
        what the straggler report keys on); ``result`` an optional
        :class:`~repro_torch.core.solver_fused.FusedResult` of the same
        lanes, which contributes the final values.  Each buffer is copied
        to the host whole, once.
        """
        if ring is None or self.ring_config is None:
            return []
        cfg = self.ring_config
        r = {k: _host(getattr(ring, k)) for k in _RING_FIELDS}
        B = r["n_samples"].shape[0]
        res = {}
        if result is not None:
            # a result without n_unshrink (a SolveResult) falls back to the
            # ring's last sample
            for key in ("iterations", "kkt_gap", "converged", "n_planning",
                        "n_unshrink"):
                v = getattr(result, key, None)
                if v is not None:
                    res[key] = _host(v).reshape(-1)
        out = []
        for lane in range(B):
            ns = int(min(r["n_samples"][lane], cfg.cap))
            nr = int(min(r["n_ratio"][lane], cfg.ratio_cap))
            rec = {
                "lane": len(self.lanes),
                "n_samples": int(r["n_samples"][lane]),
                "n_ratio": int(r["n_ratio"][lane]),
                "samples": {
                    "t": r["t"][lane, :ns].tolist(),
                    "gap": r["gap"][lane, :ns].tolist(),
                    "n_active": r["n_active"][lane, :ns].tolist(),
                    "n_unshrink": r["n_unshrink"][lane, :ns].tolist(),
                },
                "ratio": {
                    "t": r["ratio_t"][lane, :nr].tolist(),
                    "value": r["ratio"][lane, :nr].tolist(),
                },
            }
            if meta is not None:
                rec.update({k: _to_plain(v) for k, v in meta[lane].items()})
            if "iterations" in res:
                rec["iterations"] = int(res["iterations"][lane])
            if "kkt_gap" in res:
                rec["kkt_gap"] = float(res["kkt_gap"][lane])
            if "converged" in res:
                rec["converged"] = bool(res["converged"][lane])
            if "n_planning" in res:
                rec["n_planning"] = int(res["n_planning"][lane])
                if rec.get("iterations"):
                    # the share of iterations whose two-direction step was
                    # accepted: planning under algorithm="pasmo", conjugate
                    # steps under step="conjugate" (one channel; the modes
                    # exclude each other)
                    rec["accepted_step_share"] = (
                        rec["n_planning"] / rec["iterations"])
            if "n_unshrink" in res:
                rec["total_unshrink"] = int(res["n_unshrink"][lane])
            elif ns:
                rec["total_unshrink"] = int(r["n_unshrink"][lane, ns - 1])
            self.lanes.append(rec)
            out.append(self.sink.emit_plain("lane", rec))
        return out

    # -- summary -----------------------------------------------------------

    def summary(self, top_k: int = 5) -> dict:
        """Aggregate view: iteration histogram, straggler top-k, totals."""
        iters = np.asarray(
            [rec.get("iterations", 0) for rec in self.lanes], np.int64)
        s = {"n_lanes": len(self.lanes),
             "total_planning": int(sum(rec.get("n_planning", 0)
                                       for rec in self.lanes)),
             "total_unshrink": int(sum(rec.get("total_unshrink", 0)
                                       for rec in self.lanes)),
             "n_converged": int(sum(bool(rec.get("converged", False))
                                    for rec in self.lanes))}
        if len(iters):
            edges = np.histogram_bin_edges(iters, bins=min(8, max(
                1, len(iters))))
            hist, _ = np.histogram(iters, bins=edges)
            order = np.argsort(iters)[::-1][:top_k]
            total = max(1, int(iters.sum()))
            s["iteration_histogram"] = {
                "edges": [float(e) for e in edges],
                "counts": [int(c) for c in hist]}
            s["stragglers"] = [{
                "lane": int(k),
                "iterations": int(iters[k]),
                "iter_share": float(iters[k] / total),
                **{key: self.lanes[k][key] for key in ("gamma", "C", "label")
                   if key in self.lanes[k]},
            } for k in order]
            s["total_iterations"] = int(iters.sum())
            s["max_iterations"] = int(iters.max())
        return s

    def finalize(self, top_k: int = 5) -> dict:
        """Emit the spans' events (:meth:`~repro_torch.telemetry.spans.
        SpanRecorder.emit`) and the ``summary`` event, and close the
        sink's file."""
        self.spans.emit()
        s = self.summary(top_k)
        self.sink.emit("summary", **s)
        self.sink.close()
        return s
