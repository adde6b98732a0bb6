#!/usr/bin/env python3
"""Whole solves of the benchmark's cells (``portbench/``) with the span
recorder of ``repro_torch.telemetry`` on, on one CUDA card.

    python3 benchmarks/torch_spans.py --cells msd-svr.svr mnist-ovr.svc \
        --seeds 3000000011 3000000012 --out chiprun_out/spans.json \
        [--profile]

from the root of a checkout.  For each cell and seed: the cell's inputs
made from the seed, one solve capped at 64 iterations (the benchmark's
warm-up), then two whole solves, one with the recorder off and one inside
``telemetry.recording`` (the order alternates with the seed), each a
``fit`` and ``decide`` ending in a synchronise, as the benchmark's solve
is.  Per spanned solve it reads:

* ``loop.replay_ms``: the device ms of the ``loop.replay`` spans over
  ``loop.replayed_iters``, the card's own time an iteration;
* ``solve.idle_share``: 100 (1 - the union of the innermost device spans
  over the device window from ``fit``'s start event to ``decide``'s end
  event), in %; the eager chunk counts as busy;
* ``loop.capture_ms``: host ms of the ``loop.capture`` spans;
* ``facade.prep_ms``: host ms of ``fit.prep``;

and the mean ``loop.replay→loop.replay`` gap, the counters, each span's
count, host and device ms, and the gaps.  ``solve_s`` of both solves
gives the recorder's cost, and :func:`span_cost` its host cost a span.
``--profile`` adds, per cell, one solve
capped at 4096 iterations under ``torch.profiler`` with the recorder on,
whose device idle time is put under the innermost program span open on
the host at each gap's middle.  Prints the tables to standard error and
writes every number to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRACE_ITERS = 4096


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def span_cost(device, n: int = 4000) -> dict:
    """Host microseconds of one span with its counter, with CUDA events
    on ``device`` and without (no profiler recording), on a fresh
    recorder: what each of a solve's chunks pays."""
    import torch
    from repro_torch.telemetry import Diagnostics
    out = {}
    for key, dev in (("device_span_us", device), ("host_span_us", None)):
        rec = Diagnostics(ring=None).spans
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(n):
            with rec.span("loop.replay", dev):
                pass
            rec.count("loop.replays")
        out[key] = (time.perf_counter() - t0) / n * 1e6
    return out


def readings(summary: dict) -> dict:
    """The four per-layer numbers and their parts from a span summary."""
    sp, c = summary["spans"], summary["counters"]

    def ms(name, kind):
        return (sp.get(name) or {}).get(kind) or 0.0

    replays = c.get("loop.replays", 0)
    gaps = summary.get("gaps", {})
    return {
        "loop.replay_ms": (ms("loop.replay", "device_ms")
                           / c["loop.replayed_iters"]
                           if c.get("loop.replayed_iters") else None),
        "solve.idle_share": summary.get("idle_share"),
        "loop.capture_ms": ms("loop.capture", "host_ms"),
        "facade.prep_ms": ms("fit.prep", "host_ms"),
        "replay_gap_ms": (gaps.get("loop.replay→loop.replay", 0.0)
                          / (replays - 1) if replays > 1 else None),
        "loop_iterations": (c.get("loop.eager_iters", 0)
                            + c.get("loop.replayed_iters", 0)),
        "window_ms": summary.get("window_ms"),
        "busy_ms": summary.get("busy_ms"),
    }


def span_gaps(prof, names) -> dict:
    """{innermost program span at the gap's middle: device idle s} of a
    profiler window, between its first and last device event."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append((s, s + e.duration_ns()))
        elif e.name() in names:
            host.append((s, s + e.duration_ns(), e.name()))
    dev.sort()
    host.sort(key=lambda h: (h[0], -h[1]))
    out, stack, i, t = {}, [], 0, dev[0][0]
    for s, e in dev:
        if s > t:
            mid = (s + t) // 2
            while i < len(host) and host[i][0] <= mid:
                while stack and stack[-1][1] < host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "outside"
            out[name] = out.get(name, 0.0) + (s - t) / 1e9
        t = max(t, e)
    return out


def run_cell(name: str, seeds: list, profile: bool, device=None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    from portbench import harness, spec
    from repro_torch.telemetry import Diagnostics, recording
    device = torch.device("cuda", 0) if device is None else device
    cell = spec.cell(name)
    conf = spec.config(cell["config"])
    gen = spec.module("data", conf["generator"])
    drv = spec.module("solves", cell["solve"])
    dtype = getattr(torch, conf["dtype"])
    rows = []
    for k, seed in enumerate(seeds):
        ctx = drv.prepare(conf, cell, gen.make(conf, seed, device, dtype),
                          device)
        harness.solve_once(drv, ctx, harness.WARM_ITERS, device)
        row = {"seed": seed}
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            diag = Diagnostics(ring=None) if on else None
            t0 = time.perf_counter()
            if on:
                with recording(diag):
                    out = harness.solve_once(drv, ctx, None, device)
            else:
                out = harness.solve_once(drv, ctx, None, device)
            row["on_s" if on else "off_s"] = time.perf_counter() - t0
            row["iterations" + ("_on" if on else "_off")] = int(
                out["iterations"].max())
            if on:
                s = diag.span_summary()
                row.update(readings(s))
                row["spans"] = s["spans"]
                row["counters"] = s["counters"]
                row["gaps"] = s.get("gaps", {})
                if k == 0:
                    row["timeline_head"] = s.get("timeline", [])[:12]
        rows.append(row)
        print(f"[spans] {name} seed {seed}: off {row['off_s']:.4f} s, on "
              f"{row['on_s']:.4f} s, iterations {row['iterations_off']}; "
              f"loop.replay_ms {row['loop.replay_ms']}, solve.idle_share "
              f"{row['solve.idle_share']}, loop.capture_ms "
              f"{row['loop.capture_ms']}, facade.prep_ms "
              f"{row['facade.prep_ms']}, replay gap ms "
              f"{row['replay_gap_ms']}", file=sys.stderr, flush=True)
        del ctx, out
    res = {"cell": name, "rows": rows}
    first = rows[0]
    print(f"[spans] {name} spans of seed {seeds[0]} (count, host ms, "
          f"device ms):", file=sys.stderr)
    for key, v in first["spans"].items():
        print(f"    {key:16s} {v['count']:7d} {v['host_ms']:12.3f} "
              f"{v['device_ms'] if v['device_ms'] is None else round(v['device_ms'], 3)}",
              file=sys.stderr)
    print(f"[spans] {name} counters {first['counters']}", file=sys.stderr)
    for key, v in sorted(first["gaps"].items(), key=lambda kv: -kv[1]):
        print(f"    gap {key:40s} {v:12.3f} ms", file=sys.stderr)
    on = [r["on_s"] for r in rows]
    off = [r["off_s"] for r in rows]
    res["median_on_s"], res["median_off_s"] = (statistics.median(on),
                                               statistics.median(off))
    print(f"[spans] {name} solve_s median on {res['median_on_s']:.4f}, off "
          f"{res['median_off_s']:.4f} (on/off "
          f"{res['median_on_s'] / res['median_off_s']:.4f})",
          file=sys.stderr, flush=True)
    if profile:
        ctx = drv.prepare(conf, cell, gen.make(conf, seeds[0], device,
                                               dtype), device)
        harness.solve_once(drv, ctx, harness.WARM_ITERS, device)
        diag = Diagnostics(ring=None)
        with profiler(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof, \
                recording(diag):
            harness.solve_once(drv, ctx, TRACE_ITERS, device)
        names = {s.name for s in diag.spans.spans} | {harness.FIT,
                                                      harness.DECIDE}
        res["profiled_gaps_s"] = span_gaps(prof, names)
        res["profiled_spans"] = diag.span_summary()["spans"]
        print(f"[spans] {name} profiled solve, device idle s by innermost "
              f"span: {res['profiled_gaps_s']}", file=sys.stderr, flush=True)
        del prof, ctx
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", nargs="+", required=True)
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--profile", action="store_true")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from repro_torch.kernels import build
    build.load()
    out = {"card": card(), "torch": torch.__version__, "cells": [],
           "span_cost": span_cost(torch.device("cuda", 0))}
    print(f"[spans] card {out['card']}; a span and its counter cost "
          f"{out['span_cost']} on the host", file=sys.stderr, flush=True)
    for name in args.cells:
        out["cells"].append(run_cell(name, args.seeds, args.profile))
        pathlib.Path(args.out).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
