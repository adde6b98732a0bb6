#!/usr/bin/env python3
"""Main-path fits of the port timed in two checkouts on one card.

    python3 benchmarks/torch_phase_ab.py --against OTHER_CHECKOUT

from the root of a checkout, on a CUDA card.  Runs the same fits in one
process per (checkout, turn), in the order other, this, this, other, so
that a drift of the card or the host over the call falls on both alike;
each process imports ``repro_torch`` from its own checkout's ``src`` and
builds its kernels there (set-up, not timed).  The fits, on
``chip_smoke.py``'s data and settings:

* ``small``: the binary and 3-class ``SVC`` fits of ``chip_smoke.py``'s
  small runs (400 points, d = 8, smo and pasmo, CUDA kernels and plain
  versions), host-bound, each fit capturing its own graphs;
* ``svc``: ``SVC`` on 10 one-vs-rest lanes, l = 16384, f64 (rbf passes);
* ``single``: ``solve_fused`` on that fit's first lane;
* ``classic``: the same ``SVC`` on the classic engine
  (``engine="batched"``).

Each is run twice in a process and the second wall time kept.  Prints
one JSON line a process and a table of the medians by checkout.
``--run`` is one process's part (``--root`` names its checkout).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve()
ROOT = HERE.parents[1]


def run(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from repro_torch.core.solver import SolverConfig
    from repro_torch.core.solver_fused import solve_fused
    from repro_torch.core import multiclass as mc
    from repro_torch.kernels import build
    from repro_torch.svm import SVC, data
    assert pathlib.Path(build.__file__).is_relative_to(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    build.load()
    dev = torch.device("cuda", 0)
    f64 = dict(device=dev, dtype=torch.float64)

    def small():
        for k in (2, 3):
            X, y = (data.gaussian_blobs(600, seed=1, d=8, sep=2.0) if k == 2
                    else data.multiclass_blobs(600, seed=1, k=3, d=8,
                                               sep=4.0))
            for alg in ("smo", "pasmo"):
                for impl in ("auto", "torch"):
                    SVC(C=1.0, gamma="scale", algorithm=alg, eps=1e-6,
                        impl=impl, **f64).fit(X[:400], y[:400])

    X, y = data.multiclass_blobs(20480, seed=0, k=10, d=128, sep=12.0)
    Xtr, ytr = X[:16384], y[:16384]
    Y = mc.ovr_labels(mc.class_index(ytr)[1], 10, torch.float64, dev)
    gamma = 1.0 / (128 * float(np.var(np.asarray(Xtr))))
    cfg = SolverConfig(algorithm="pasmo", eps=1e-3)
    fits = {
        "small": small,
        "svc": lambda: SVC(C=1.0, gamma="scale", algorithm="pasmo",
                           eps=1e-3, **f64).fit(Xtr, ytr),
        "single": lambda: solve_fused(Xtr, Y[0], 1.0, gamma, cfg, **f64),
        "classic": lambda: SVC(C=1.0, gamma="scale", algorithm="pasmo",
                               eps=1e-3, engine="batched", **f64).fit(
                                   Xtr, ytr),
    }
    out = {}
    for name, fit in fits.items():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit()
            torch.cuda.synchronize()
            out[name] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=pathlib.Path)
    ap.add_argument("--run", action="store_true")
    ap.add_argument("--root", type=pathlib.Path, default=ROOT)
    args = ap.parse_args(argv)
    if args.run:
        print(json.dumps(run(args.root.resolve())), flush=True)
        return 0
    if args.against is None:
        ap.error("--against OTHER_CHECKOUT is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    other = args.against.resolve()
    times = {"other": [], "this": []}
    for tag, root in (("other", other), ("this", ROOT), ("this", ROOT),
                      ("other", other)):
        p = subprocess.run([sys.executable, str(HERE), "--run", "--root",
                            str(root)], capture_output=True, text=True,
                           timeout=900)
        if p.returncode:
            print(p.stdout[-4000:], p.stderr[-8000:], sep="\n")
            return 1
        t = json.loads(p.stdout.strip().splitlines()[-1])
        times[tag].append(t)
        print(f"[{tag}] {root}: " + ", ".join(
            f"{k} {v:.4f} s" for k, v in t.items()), flush=True)
    for name in times["this"][0]:
        a = statistics.median(t[name] for t in times["other"])
        b = statistics.median(t[name] for t in times["this"])
        print(f"[ab] {name}: other {a:.4f} s, this {b:.4f} s, this/other "
              f"{b / a:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
