"""Render the fused loop's flight-recorder JSONL as a human report
(``repro.launch.telemetry_report``).

    python -m repro_torch.launch.telemetry_report run.jsonl [--top-k 5]
                                                  [--trace-lane 3] [--hist]

Input is the artifact written by :class:`repro_torch.telemetry.Diagnostics`
(``fingerprint`` / ``phase`` / ``lane`` / ``straggler_warning`` /
``span`` / ``span_summary`` / ``summary`` events, one JSON object per
line).  Output sections:

* environment fingerprint (what machine/backend produced the run);
* host phase table (wall-clock per named phase, and the device ms of the
  spans that carry the phase's label);
* spans (from ``Diagnostics.finalize``): each span's count, host ms and
  device ms, the counters, and the device's idle gaps between spans;
* per-lane convergence table — iterations, KKT gap, planning-step and
  unshrink totals, keyed by the lane's hyper-parameters;
* straggler diagnosis: which (gamma, C) cells dominate the wall-clock
  (iteration share), plus any chunk-deadline warnings from the
  EWMA monitor;
* optionally (``--trace-lane``) the lane's Fig. 3 planning trace — the
  mu/mu* ratio per accepted planning step — and its sampled KKT-gap
  trajectory.

Pure stdlib on purpose: the report renders anywhere the JSONL can be
copied to, with no torch (or even numpy) installed.
"""

from __future__ import annotations

import argparse
import json
import sys

FINGERPRINT_ORDER = ("torch_version", "cuda_version", "backend",
                     "device_kind", "device_count", "cpu_count", "host",
                     "python", "machine")


def load_events(path: str) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def split_events(events):
    """Bucket a raw event stream by type (unknown types are ignored)."""
    by = {"fingerprint": [], "phase": [], "lane": [],
          "straggler_warning": [], "span": [], "span_summary": [],
          "summary": []}
    for e in events:
        by.get(e.get("event"), []).append(e)
    return by


def _lane_key(rec: dict) -> str:
    """Human label for a lane from whichever hyper-params it carries."""
    parts = []
    for key, fmt in (("gamma", "g={:g}"), ("label", "y={}"),
                     ("C", "C={:g}"), ("epsilon", "eps={:g}"),
                     ("nu", "nu={:g}")):
        if key in rec:
            parts.append(fmt.format(rec[key]))
    return " ".join(parts) if parts else f"lane {rec.get('lane', '?')}"


def _table(header: list[str], rows: list[list[str]]) -> str:
    out = ["| " + " | ".join(header) + " |",
           "|" + "|".join("---" for _ in header) + "|"]
    out += ["| " + " | ".join(row) + " |" for row in rows]
    return "\n".join(out)


def fingerprint_section(fps: list[dict]) -> str:
    if not fps:
        return "(no fingerprint event in stream)"
    fp = fps[0]
    rows = [[k, str(fp[k])] for k in FINGERPRINT_ORDER if k in fp]
    return _table(["field", "value"], rows)


def _ms(v) -> str:
    return "-" if v is None else f"{v:.3f}"


def phase_section(phases: list[dict], spans: list[dict] = ()) -> str:
    if not phases:
        return "(no phase events)"
    agg: dict[str, list[float]] = {}
    for e in phases:
        agg.setdefault(e.get("name", "?"), []).append(
            float(e.get("seconds", 0.0)))
    # the device ms of the spans labelled with each phase
    dev: dict = {}
    for e in spans:
        if e.get("phase") is not None and e.get("device_ms") is not None:
            dev[e["phase"]] = dev.get(e["phase"], 0.0) + e["device_ms"]
    rows = [[name, str(len(ts)), f"{sum(ts):.4f}",
             f"{sum(ts) / len(ts):.4f}", f"{max(ts):.4f}",
             _ms(dev.get(name))]
            for name, ts in sorted(agg.items(),
                                   key=lambda kv: -sum(kv[1]))]
    return _table(["phase", "calls", "total s", "mean s", "max s",
                   "device ms"], rows)


def span_section(spans: list[dict], summaries: list[dict]) -> str:
    if not spans:
        return "(no span events: spans are emitted by Diagnostics.finalize)"
    agg: dict = {}
    for e in spans:
        row = agg.setdefault(e.get("name", "?"), [0, 0.0, None])
        row[0] += int(e.get("count", 0))
        row[1] += float(e.get("host_ms", 0.0))
        if e.get("device_ms") is not None:
            row[2] = (row[2] or 0.0) + e["device_ms"]
    out = [_table(["span", "count", "host ms", "device ms"],
                  [[k, str(n), f"{h:.3f}", _ms(d)]
                   for k, (n, h, d) in agg.items()])]
    if summaries:
        s = summaries[-1]
        counters = s.get("counters", {})
        if counters:
            out.append("\ncounters: " + ", ".join(
                f"{k}={v}" for k, v in counters.items()))
        gaps = s.get("gaps", {})
        if gaps:
            out.append("\n" + _table(
                ["device idle gap", "ms"],
                [[k, f"{v:.3f}"] for k, v in sorted(
                    gaps.items(), key=lambda kv: -kv[1])]))
        if s.get("idle_share") is not None:
            out.append(f"\ndevice window {s['window_ms']:.3f} ms, busy "
                       f"{s['busy_ms']:.3f} ms, idle "
                       f"{s['idle_share']:.2f}%")
    return "\n".join(out)


def convergence_section(lanes: list[dict]) -> str:
    if not lanes:
        return "(no lane events — device-tier telemetry was off)"
    rows = []
    for rec in lanes:
        gap = rec.get("kkt_gap")
        rows.append([
            str(rec.get("lane", "?")), _lane_key(rec),
            str(rec.get("iterations", "?")),
            {True: "yes", False: "NO"}.get(rec.get("converged"), "?"),
            "?" if gap is None else f"{gap:.2e}",
            str(rec.get("n_planning", "?")),
            str(rec.get("total_unshrink", "?")),
            str(rec.get("n_samples", 0)),
        ])
    return _table(["lane", "cell", "iters", "conv", "kkt gap",
                   "plan", "unshrink", "samples"], rows)


def straggler_section(lanes: list[dict], warnings: list[dict],
                      top_k: int = 5) -> str:
    if not lanes:
        return "(no lane events)"
    iters = [int(rec.get("iterations", 0)) for rec in lanes]
    total = max(1, sum(iters))
    order = sorted(range(len(lanes)), key=lambda i: -iters[i])[:top_k]
    rows = [[str(lanes[i].get("lane", i)), _lane_key(lanes[i]),
             str(iters[i]), f"{100.0 * iters[i] / total:.1f}%"]
            for i in order]
    out = [_table(["lane", "cell", "iters", "iter share"], rows)]
    share = sum(iters[i] for i in order) / total
    out.append(f"\ntop {len(order)} of {len(lanes)} lanes carry "
               f"{100.0 * share:.1f}% of all iterations.")
    for w in warnings:
        out.append(f"chunk deadline breached: round {w.get('round')} took "
                   f"{w.get('seconds', 0.0):.3f}s "
                   f"(EWMA deadline {w.get('deadline', 0.0):.3f}s, "
                   f"{len(w.get('lanes', []))} live lanes)")
    return "\n".join(out)


def iteration_histogram(lanes: list[dict], width: int = 40) -> str:
    iters = [int(rec.get("iterations", 0)) for rec in lanes]
    if not iters:
        return "(no lane events)"
    lo, hi = min(iters), max(iters)
    nbins = min(8, max(1, len(set(iters))))
    span = max(1e-12, float(hi - lo))
    counts = [0] * nbins
    for v in iters:
        counts[min(nbins - 1, int((v - lo) / span * nbins))] += 1
    peak = max(counts)
    out = []
    for b, c in enumerate(counts):
        a = lo + span * b / nbins
        z = lo + span * (b + 1) / nbins
        bar = "#" * max(0, round(width * c / peak))
        out.append(f"  [{a:8.1f}, {z:8.1f})  {c:4d}  {bar}")
    return "\n".join(out)


def trace_section(lanes: list[dict], lane: int, width: int = 52) -> str:
    """The classic Fig. 3 rendering: mu/mu* per accepted planning step."""
    rec = next((r for r in lanes if r.get("lane") == lane), None)
    if rec is None:
        return f"(lane {lane} not found)"
    tr = rec.get("ratio", {})
    ts, vals = tr.get("t", []), tr.get("value", [])
    out = [f"lane {lane} ({_lane_key(rec)}): {rec.get('n_ratio', 0)} "
           f"accepted planning steps"]
    if vals:
        lo, hi = min(vals), max(vals)
        span = max(1e-12, hi - lo)
        for t, v in zip(ts, vals):
            pos = round((v - lo) / span * (width - 1))
            out.append(f"  t={t:6d}  mu/mu*={v:10.4f}  "
                       + "." * pos + "*")
    samples = rec.get("samples", {})
    st, sg = samples.get("t", []), samples.get("gap", [])
    if st:
        out.append("sampled KKT-gap trajectory:")
        out.append("  " + "  ".join(f"t={t}:{g:.2e}"
                                    for t, g in zip(st, sg)))
    return "\n".join(out)


def render_report(events: list[dict], *, top_k: int = 5,
                  trace_lane: int | None = None,
                  hist: bool = False) -> str:
    by = split_events(events)
    sections = [
        ("environment", fingerprint_section(by["fingerprint"])),
        ("host phases", phase_section(by["phase"], by["span"])),
        ("spans", span_section(by["span"], by["span_summary"])),
        ("convergence", convergence_section(by["lane"])),
        ("stragglers", straggler_section(by["lane"],
                                         by["straggler_warning"], top_k)),
    ]
    if hist:
        sections.append(("iteration histogram",
                         iteration_histogram(by["lane"])))
    if trace_lane is not None:
        sections.append((f"planning trace (Fig. 3), lane {trace_lane}",
                         trace_section(by["lane"], trace_lane)))
    if by["summary"]:
        s = by["summary"][-1]
        keys = ("n_lanes", "n_converged", "total_iterations",
                "max_iterations", "total_planning", "total_unshrink")
        sections.append(("summary", ", ".join(
            f"{k}={s[k]}" for k in keys if k in s)))
    return "\n\n".join(f"## {title}\n\n{body}" for title, body in sections)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.telemetry_report",
        description="Render a Diagnostics JSONL artifact as a report.")
    ap.add_argument("path", help="telemetry JSONL file")
    ap.add_argument("--top-k", type=int, default=5,
                    help="straggler table size")
    ap.add_argument("--trace-lane", type=int, default=None,
                    help="render this lane's Fig. 3 planning trace")
    ap.add_argument("--hist", action="store_true",
                    help="include the iteration histogram")
    args = ap.parse_args(argv)
    events = load_events(args.path)
    if not events:
        print(f"no events in {args.path}", file=sys.stderr)
        return 1
    print(render_report(events, top_k=args.top_k,
                        trace_lane=args.trace_lane, hist=args.hist))
    return 0


if __name__ == "__main__":
    sys.exit(main())
