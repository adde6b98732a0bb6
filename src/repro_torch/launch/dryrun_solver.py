"""Dry-run of the distributed PA-SMO solver on the production mesh: the
paper's own workload at pod scale (beside the LM cells).

The port of ``repro.launch.dryrun_solver``.  It traces one iteration of
:func:`repro_torch.core.sharded.solve_sharded` (its body,
:func:`repro_torch.core.sharded.sharded_iteration`) with the example
dimension l sharded over every rank of a fake process group of the
mesh's size (256, or 512 for ``--mesh multi``), on fake tensors, under
:class:`repro_torch.launch.cost_analysis.CostMode`, and reports the
per-iteration compute, memory and collective microseconds at the H100's
published peaks (:mod:`repro_torch.launch.roofline`; reckoned, not
measured).  The point of the reference's check holds here too: SMO's
working set of two makes the per-iteration collective payload O(d), so
at pod scale an iteration is bound by the local kernel rows, not the
network.  Fake tensors trace on ``cuda`` in a CUDA build, else on
``cpu``.

    python -m repro_torch.launch.dryrun_solver --l 1048576 --d 256
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from repro_torch.core.sharded import sharded_iteration
from repro_torch.core.solver import SolverConfig
from repro_torch.launch import roofline as rf
from repro_torch.launch.cost_analysis import CostMode
from repro_torch.launch.dryrun import (OUT, _mesh_dims, make_mesh_by_name,
                                       trace_device)


def run(l: int, d: int, mesh_name: str = "single", device=None) -> dict:
    """The per-iteration record of one traced iteration."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    device = device or trace_device()
    make_mesh_by_name(mesh_name, device)      # starts the fake group
    chips = math.prod(_mesh_dims(mesh_name)[0])
    cfg = SolverConfig(algorithm="pasmo", eps=1e-3)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        X = torch.empty((l, d), dtype=torch.float32, device=device)
        y = torch.empty((l,), dtype=torch.float32, device=device)
        body, c, _ = sharded_iteration(X, y, 10.0, 0.5, None, cfg,
                                       device=device, dtype=torch.float32)
        t0 = time.monotonic()
        with CostMode(fake) as cm:
            body(c, False)
        t_trace = time.monotonic() - t0
    cost = cm.cost
    return {
        "arch": "pasmo-solver", "shape": f"l{l}-d{d}", "mesh": mesh_name,
        "chips": chips, "ok": True, "device": device,
        "time_compile_s": t_trace,
        "per_iteration": {
            "flops_per_device": cost.flops,
            "bytes_per_device": cost.bytes,
            "collective_bytes_per_device": cost.collective_bytes,
            "compute_us": cost.flops / rf.PEAK_FLOPS * 1e6,
            "memory_us": cost.bytes / rf.HBM_BW * 1e6,
            "collective_us": cost.collective_bytes / rf.LINK_BW * 1e6,
        },
        "collectives": {**cost.collectives,
                        "counts": cost.collective_counts},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--l", type=int, default=1_048_576)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    rec = run(args.l, args.d, args.mesh, args.device)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out,
                        f"{args.mesh}__pasmo-solver__l{args.l}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    p = rec["per_iteration"]
    print(f"[OK] pasmo-solver l={args.l} d={args.d} mesh={args.mesh} "
          f"({rec['time_compile_s']:.1f}s trace)")
    print(f"per-iteration/device: compute {p['compute_us']:.3f}us  "
          f"memory {p['memory_us']:.3f}us  "
          f"collective {p['collective_us']:.3f}us")
    dom = max(("compute", "memory", "collective"),
              key=lambda k: p[k + "_us"])
    print(f"dominant: {dom}; artifact: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
