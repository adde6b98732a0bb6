"""One run of one cell: set-up, the measured window, the traced window, the
check against the plain reference, and the result line.

A solve is what a user runs: the solve driver's ``fit`` (a facade's fit
or a grid call) and ``decide`` (the decision values on the held-out
points), its results copied to the host, ending in a synchronise.  Each
solve builds its loop and captures its CUDA graphs anew, as a user's fit
does.

* Set-up (``setup_s``): from the start of ``run.py`` to the first timed
  solve: the interpreter's imports, CUDA's start, the kernel library's
  load (its ``nvcc`` build on a checkout's first run), the inputs made on
  the device from ``--seed``, and one solve capped at
  :data:`WARM_ITERS` iterations, which runs the eager first chunk,
  captures the graphs and replays one: every shape the window uses.
* The window: solves back to back until ``--seconds`` have passed; the
  solve in progress then finishes and counts.  ``solve_s`` is all the
  window's time over its solves.
* The traced window (``--trace 1`` only, after the measured one): one
  solve capped at :data:`TRACE_ITERS` loop iterations under
  ``torch.profiler``, so the profiler's cost touches only the metrics it
  feeds (it slows the host's graph launches many
  times over, not the device's operations).
* The check: every solve of the window, judged by
  :mod:`portbench.reference` once the window has closed and the memory
  peak has been read.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import reference, spec, trace

# the benchmark's own ranges around the calls into the program; the
# traced window's idle gaps are labelled by them
FIT, DECIDE = "pb.fit", "pb.decide"
# the warm-up solve's cap: the fused loop's eager first chunk of 32
# iterations, then a captured chunk and its first replay
WARM_ITERS = 64
# the traced solve's cap: its eager chunk and 127 graph replays, the bank
# build and the decisions; reading the trace of a whole solve of millions
# of kernels would take minutes
TRACE_ITERS = 4096


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict:
    """The port's launch counters: {wrapper: launches}, and the Gram's
    symmetric launches under ``gram_block:symmetric``."""
    from repro_torch import kernels
    from repro_torch.kernels import gram_block
    out = dict(kernels.launches())
    out["gram_block:symmetric"] = gram_block.gram_cross.symmetric_launches
    return out


def _reset_launches() -> None:
    from repro_torch import kernels
    kernels.reset_launches()


def solve_once(drv, ctx, max_iter, device) -> dict:
    """One solve: ``fit`` then ``decide``, results on the host."""
    with record_function(FIT):
        fitted = drv.fit(ctx, max_iter)
    with record_function(DECIDE):
        out = drv.decide(ctx, fitted)
    _sync(device)
    return out


def run(name: str, seed: int, seconds: float, trace_on: bool, device,
        t_start: float, base=spec.HERE) -> tuple:
    """Load the cell ``name`` by its files and run it (:func:`run_cell`)."""
    bench = spec.benchmark(base)
    cell = spec.cell(name, base)
    conf = spec.config(cell["config"], base)
    return run_cell(bench, name, cell, conf, seed, seconds, trace_on,
                    device, t_start, base)


def run_cell(bench, name, cell, conf, seed, seconds, trace_on, device,
             t_start, base=spec.HERE) -> tuple:
    """(result, check, info): the result line's object, the numbers the
    check compared, {name: (value, limit)}, and what a reader of the run's
    log wants beside them: each solve's seconds and loop iterations."""
    device = torch.device(device)
    part = "per_layer" if trace_on else "end_to_end"
    wanted = spec.metrics_for(bench, name, part)
    readers = {m["name"]: spec.module("metrics", m["name"], base)
               for m in wanted}
    gen = spec.module("data", conf["generator"], base)
    drv = spec.module("solves", cell["solve"], base)
    dtype = getattr(torch, conf["dtype"])

    if device.type == "cuda":
        from repro_torch.kernels import build
        build.load()
    inputs = gen.make(conf, seed, device, dtype)
    ctx = drv.prepare(conf, cell, inputs, device)
    solve_once(drv, ctx, WARM_ITERS, device)
    setup_s = time.perf_counter() - t_start

    cuda = device.type == "cuda"
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    outs, ends = [], []
    t0 = time.perf_counter()
    while True:
        outs.append(solve_once(drv, ctx, None, device))
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    window_s = ends[-1] - t0
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    needs = [drv.need_s(ctx, o) for o in outs]

    traced = None
    if trace_on:
        _reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = solve_once(drv, ctx, TRACE_ITERS, device)
        traced = trace.read(prof)
        if traced is not None:
            traced.launches = _launches()
            traced.loop_iterations = int(out["iterations"].max())
        del prof, out
    peak = max(peak_setup, peak_window,
               torch.cuda.max_memory_allocated(device) if cuda else 0)
    launch_work = drv.launch_work(ctx)
    del ctx
    if cuda:
        torch.cuda.empty_cache()

    check = reference.judge_all(conf, cell, inputs, outs)
    failed = sum(not ok for ok in check.pop("_each"))
    correct = failed == 0 and all(v <= lim for v, lim in check.values())

    view = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, n_solves=len(outs),
        loop_iterations=[int(o["iterations"].max()) for o in outs],
        need_s=needs, peak_window_bytes=peak_window,
        launch_work=launch_work, trace=traced, dtype=conf["dtype"])
    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(view)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(outs), "failed": failed,
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        result["breakdown"] = {
            "device_ops": _top({k: t for k, (c, t) in
                                traced.kernels.items()}),
            "idle_gaps": _top(traced.idle)}
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in check.items()}
    info = {"solve_s": [b - a for a, b in zip([t0] + ends, ends)],
            "loop_iterations": view.loop_iterations}
    if traced is not None:
        info["traced"] = {"window_s": traced.window_s,
                          "busy_s": traced.busy_s,
                          "loop_iterations": traced.loop_iterations,
                          "kernel_launches": traced.kernel_launches}
    return result, check, info


def _top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
