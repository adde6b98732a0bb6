#!/usr/bin/env python3
"""The port's sharded engines across every attached card, against one card.

    python3 benchmarks/torch_sharded_cards.py

from the root of a checkout, on a host with two or more CUDA cards (the
timings mean something only there).  Builds the kernels, then on
``chip_smoke.py``'s data (l = 16384, d = 128, f64):

* the cards' peer access, and the time of a 1 GiB copy from ``cuda:0``
  to ``cuda:1``;
* ``SVC`` (10 one-vs-rest lanes, rbf passes) fused on ``cuda:0`` and
  with ``engine="sharded"`` over every card, each with the loop's host
  read of ``done`` as it is (``solver_fused._running``, a blocking
  ``bool(any(~done))``) and through pinned memory and a CUDA event's
  wait, in an order that alternates both;
* the 90-lane (C, gamma) grid through the Gram bank on one card and with
  ``devices`` every card (the bank copied from ``cuda:0`` to the
  others), with either host read, in alternating orders, and over every
  card with each other card building its own bank with the Gram kernel
  instead, and once with the interpreter's thread switch interval at
  0.2 ms (default 5 ms);
* ``solve_sharded`` on one binary head over 1 and n NCCL ranks.

Each run reports where its time went: the host reads of ``done`` (the
seconds each thread spent in them, and the share of that waiting in
which two or more threads waited at once), the set-up of the slabs'
inputs (copies, with every card synchronised), each slab's span on the
host clock, each card's busy time inside graph replays (CUDA events
around every replay), the host time of the replays and of the captures.
Objectives are held against the one-card run (max relative difference
printed, 1e-6 asserted).  Prints one line a run.
"""

from __future__ import annotations

import collections
import datetime
import os
import pathlib
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import chip_smoke as cs  # noqa: E402


class SlabWatch:
    """Where a sharded run's time goes, while installed: the slab set-up
    (``_jobs``, every card synchronised after it), each slab's span, the
    host time of graph replays and captures by thread, and each card's
    busy time inside replays (events around every replay)."""

    def __init__(self, sharded_lanes, solver_fused):
        self.sl, self.sf = sharded_lanes, solver_fused

    def __enter__(self):
        sl, sf = self.sl, self.sf
        self.orig = (sl._jobs, sl._solve_slab, sf._capture,
                     torch.cuda.CUDAGraph.replay, sf._running)
        self.t0 = time.perf_counter()
        self.setup, self.spans = 0.0, []
        self.replay_host = collections.Counter()
        self.replays = collections.Counter()
        self.capture_host = collections.Counter()
        self.events = collections.defaultdict(list)
        self.reads = []
        lock = threading.Lock()
        jobs, slab, capture, replay, running = self.orig

        def running_spy(st):
            t1 = time.perf_counter()
            out = running(st)
            t2 = time.perf_counter()
            with lock:
                self.reads.append((threading.get_ident(), t1, t2))
            return out

        def jobs_spy(*a, **k):
            t1 = time.perf_counter()
            out = jobs(*a, **k)
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
            self.setup += time.perf_counter() - t1
            return out

        def slab_spy(p, job, *a):
            t1 = time.perf_counter() - self.t0
            out = slab(p, job, *a)
            torch.cuda.synchronize(job.device)
            with lock:
                self.spans.append((p, job.device.index, t1,
                                   time.perf_counter() - self.t0))
            return out

        def capture_spy(*a, **k):
            t1 = time.perf_counter()
            out = capture(*a, **k)
            with lock:
                self.capture_host[threading.get_ident()] += \
                    time.perf_counter() - t1
            return out

        def replay_spy(graph):
            dev = torch.cuda.current_device()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            e0.record()
            replay(graph)
            e1.record()
            with lock:
                tid = threading.get_ident()
                self.replay_host[tid] += time.perf_counter() - t1
                self.replays[tid] += 1
                self.events[dev].append((e0, e1))

        sl._jobs, sl._solve_slab, sf._capture = jobs_spy, slab_spy, \
            capture_spy
        sf._running = running_spy
        torch.cuda.CUDAGraph.replay = replay_spy
        return self

    def __exit__(self, *exc):
        (self.sl._jobs, self.sl._solve_slab, self.sf._capture,
         torch.cuda.CUDAGraph.replay, self.sf._running) = self.orig

    def text(self) -> str:
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        busy = {d: sum(a.elapsed_time(b) for a, b in ev) / 1e3
                for d, ev in sorted(self.events.items())}
        spans = [(p, d, round(a, 3), round(b, 3))
                 for p, d, a, b in sorted(self.spans)]
        r = lambda c: [round(v, 3) for v in c.values()]  # noqa: E731
        inside = collections.Counter()
        for tid, a, b in self.reads:
            inside[tid] += b - a
        # the share of the time some thread waits on its card in which
        # another waits too (0 when the waits run one after another)
        marks = sorted([(a, 1) for _, a, _ in self.reads]
                       + [(b, -1) for _, _, b in self.reads])
        depth, last, any_t, two_t = 0, None, 0.0, 0.0
        for t, d in marks:
            if last is not None and depth >= 1:
                any_t += t - last
                two_t += (t - last) if depth >= 2 else 0.0
            depth, last = depth + d, t
        return (f"host reads of done: s by thread {r(inside)}, share of "
                f"waiting time shared by two or more threads "
                f"{two_t / any_t if any_t else 0.0:.3f}; "
                f"set-up {self.setup:.3f} s; slab spans (slab, card, start, "
                f"end s) {spans}; busy s in replays by card "
                f"{ {d: round(v, 3) for d, v in busy.items()} }; replays by "
                f"thread {list(self.replays.values())}, their host s "
                f"{r(self.replay_host)}; capture host s by thread "
                f"{r(self.capture_host)}")


def peaks(devs) -> str:
    return ", ".join(f"{d.index}: {torch.cuda.max_memory_allocated(d) / 1e9:.3f}"
                     for d in devs)


def reset(devs):
    for d in devs:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)


def max_rel(a, b) -> float:
    return float(((a - b).abs() / b.abs()).max())


def peer_copy(devs):
    access = {(i, j): torch.cuda.can_device_access_peer(i, j)
              for i in range(len(devs)) for j in range(len(devs)) if i != j}
    x = torch.ones(2**27, dtype=torch.float64, device=devs[0])
    times = []
    for _ in range(3):
        torch.cuda.synchronize(devs[0])
        torch.cuda.synchronize(devs[1])
        t0 = time.perf_counter()
        y = x.to(devs[1])
        torch.cuda.synchronize(devs[0])
        torch.cuda.synchronize(devs[1])
        times.append(time.perf_counter() - t0)
    del y
    cs.say(f"[cards] peer access {sorted(k for k, v in access.items() if v)}"
           f" of {len(access)} pairs; 1 GiB cuda:0 -> cuda:1 copy s "
           f"{[round(t, 4) for t in times]} ({2**30 / min(times) / 1e9:.1f}"
           f" GB/s)")


def rank_main(rank, world, store, X, y0, gamma, out):
    from repro_torch.core.sharded import solve_sharded
    from repro_torch.core.solver import SolverConfig
    torch.cuda.set_device(rank)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    dev = torch.device("cuda", rank)
    solve_sharded(X, y0, 1.0, gamma, None,
                  SolverConfig(algorithm="pasmo", eps=1e-3, max_iter=64),
                  device=dev, dtype=torch.float64)
    torch.cuda.synchronize(dev)
    dist.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    r = solve_sharded(X, y0, 1.0, gamma, None,
                      SolverConfig(algorithm="pasmo", eps=1e-3),
                      device=dev, dtype=torch.float64)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if rank == 0:
        torch.save(dict(objective=float(r.objective),
                        iterations=int(r.iterations),
                        kkt_gap=float(r.kkt_gap), wall=wall,
                        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9),
                   out)
    dist.destroy_process_group()


def main():
    from repro_torch.core import grid, multiclass as mc
    from repro_torch.core import sharded_lanes, solver_fused
    from repro_torch.core.solver import SolverConfig
    from repro_torch.core.solver_fused import CHECK_EVERY
    from repro_torch.kernels import build, ops
    from repro_torch.svm import SVC, data
    t_start = time.perf_counter()
    smi = cs.phase_env()
    t0 = time.perf_counter()
    build.build()
    build.load()
    cs.say(f"[build] {time.perf_counter() - t0:.1f} s")
    n = torch.cuda.device_count()
    assert n >= 2, "this benchmark needs two or more cards"
    devs = [torch.device("cuda", i) for i in range(n)]
    dev = devs[0]
    f64 = dict(device=dev, dtype=torch.float64)
    peer_copy(devs)

    X, y = data.multiclass_blobs(cs.N_TRAIN + cs.N_TEST, seed=0, k=cs.K,
                                 d=cs.D, sep=12.0)
    Xtr, ytr = X[:cs.N_TRAIN], y[:cs.N_TRAIN]
    # every card loads its kernels and warms up on a small sharded fit
    SVC(C=1.0, gamma="scale", engine="sharded", **f64).fit(
        Xtr[:512], ytr[:512])

    item_read = solver_fused._running
    flags = threading.local()

    def event_read(s):
        """The host read through pinned memory and a CUDA event's wait."""
        host = getattr(flags, "host", None)
        if host is None:
            host = flags.host = torch.empty((), dtype=torch.bool,
                                            pin_memory=True)
        host.copy_(torch.any(~s.done), non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        ready.synchronize()
        return bool(host)

    svc = {}
    for engine, read in (("fused", "event"), ("fused", "item"),
                         ("sharded", "item"), ("sharded", "event"),
                         ("sharded", "event"), ("sharded", "item"),
                         ("fused", "item"), ("fused", "event")):
        reset(devs)
        clf = SVC(C=1.0, gamma="scale", algorithm="pasmo", eps=1e-3,
                  engine=engine, **f64)
        solver_fused._running = event_read if read == "event" else item_read
        watch = SlabWatch(sharded_lanes, solver_fused)
        try:
            with watch:
                _, _, wall = cs.counted(lambda: clf.fit(Xtr, ytr),
                                        tally=False)
        finally:
            solver_fused._running = item_read
        r = clf.fit_result_
        t = cs.loop_iterations(r.iterations, CHECK_EVERY, clf.max_iter)
        svc.setdefault(engine, r)
        cs.say(f"[svc] {engine} on {1 if engine == 'fused' else n} card(s), "
               f"{read} read: wall {wall:.3f} s, {t} loop iterations, "
               f"{wall / t * 1e3:.4f} ms a loop iteration; peak GB "
               f"{peaks(devs)}; {watch.text()}")
    cs.say(f"[svc] sharded against fused: objective max rel "
           f"{max_rel(svc['sharded'].objective, svc['fused'].objective):.3e}"
           f", iterations equal "
           f"{torch.equal(svc['sharded'].iterations, svc['fused'].iterations)}")
    assert max_rel(svc["sharded"].objective, svc["fused"].objective) <= 1e-6

    gammas = [1.0 / (cs.D * float(Xtr.var())) * f
              for f in cs.GRID_GAMMA_FACTORS]
    Y = mc.ovr_labels(mc.class_index(ytr)[1], cs.K, torch.float64, dev)
    cfg = SolverConfig(algorithm="pasmo", eps=1e-3)
    real_replica = sharded_lanes._Replicas.__call__

    def built_replica(self, name, t, d):
        """The bank of another card built there by the Gram kernel."""
        if name != "gram" or t is None or d == self.home:
            return real_replica(self, name, t, d)
        if (name, d) not in self.made:
            self.made[(name, d)] = ops.gram_bank(self.made[("X", d)],
                                                 gammas, impl="cuda")
        return self.made[(name, d)]
    Xg = torch.as_tensor(Xtr, **f64)
    ref = None
    cards = dict(devices=devs)
    for tag, kw in (("1 card, event read", {}), ("1 card, item read", {}),
                    (f"{n} cards, item read", cards),
                    (f"{n} cards, event read", cards),
                    (f"{n} cards, event read", cards),
                    (f"{n} cards, item read", cards),
                    ("1 card, item read", {}), ("1 card, event read", {}),
                    (f"{n} cards, item read, banks built on each card",
                     cards),
                    (f"{n} cards, item read, interpreter switch interval "
                     f"0.2 ms", cards)):
        reset(devs)
        if "event read" in tag:
            solver_fused._running = event_read
        if "built" in tag:
            sharded_lanes._Replicas.__call__ = built_replica
        switch = sys.getswitchinterval()
        if "switch" in tag:
            sys.setswitchinterval(2e-4)
        watch = SlabWatch(sharded_lanes, solver_fused)
        try:
            with watch:
                r, counts, wall = cs.counted(lambda: grid.solve_grid(
                    Xg, Y, cs.GRID_CS, gammas, cfg, impl="auto",
                    precompute=True, **f64, **kw), tally=False)
        finally:
            sharded_lanes._Replicas.__call__ = real_replica
            sys.setswitchinterval(switch)
            solver_fused._running = item_read
        ref = r if ref is None else ref
        loops = counts["row_wss_batched_rows"]
        cs.say(f"[grid] bank, 90 lanes, {tag}: wall {wall:.3f} s, loop "
               f"iterations summed over slabs {loops}, objective max rel "
               f"{max_rel(r.objective, ref.objective):.3e}; peak GB "
               f"{peaks(devs)}; {watch.text()}")
        assert max_rel(r.objective, ref.objective) <= 1e-6

    # the row-sharded solver, one binary head, on 1 and on every card
    gamma = gammas[1]
    y0 = Y[0].cpu()
    Xc = torch.as_tensor(Xtr, dtype=torch.float64)
    for world in (1, n):
        with tempfile.TemporaryDirectory() as tmp:
            outp = os.path.join(tmp, "r0.pt")
            mp.start_processes(rank_main, args=(world, os.path.join(
                tmp, "store"), Xc, y0, gamma, outp), nprocs=world,
                join=True, start_method="spawn")
            r = torch.load(outp)
        loop = -(-r["iterations"] // CHECK_EVERY) * CHECK_EVERY
        cs.say(f"[rows] solve_sharded on {world} NCCL rank(s): {r}; "
               f"{r['wall'] / loop * 1e3:.4f} ms a loop iteration")
    cs.say(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}")


if __name__ == "__main__":
    main()
