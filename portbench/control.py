"""Readings that the check's limits are set from, at a cell's own size on
the CUDA card: the program as the configuration states it on many seeds
(the lower readings), and the control, the program's own path in the next
lower precision (float32 for a float64 configuration), on a few (the
upper readings).  One full solve a seed, judged as a run judges it.

    python3 portbench/control.py --workload mnist-ovr.grid-bank \
        --seeds 3000000001 ... --control-seeds 3000000101 ... \
        --out chiprun_out/control.jsonl

Each solve prints one JSON line, {"workload", "seed", "dtype",
"iterations", "solve_s", "numbers"}, also appended to ``--out``.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOWER = {"float64": "float32"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", type=pathlib.Path)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import spec
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.cell(args.workload)
    conf = spec.config(cell["config"])
    gen = spec.module("data", conf["generator"])
    drv = spec.module("solves", cell["solve"])
    build.load()
    runs = ([(s, conf["dtype"]) for s in args.seeds]
            + [(s, LOWER[conf["dtype"]]) for s in args.control_seeds])
    for seed, dtype in runs:
        rec = dict(workload=args.workload,
                   **readings(conf, cell, gen, drv, seed, device, dtype))
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with args.out.open("a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


def readings(conf, cell, gen, drv, seed, device, dtype: str) -> dict:
    """One full solve of the cell's inputs for ``seed``, given to the
    program in ``dtype``, judged against the inputs in the configuration's
    dtype: {"seed", "dtype", "iterations", "solve_s", "numbers"}."""
    import torch

    from portbench import harness, reference
    inputs = gen.make(conf, seed, device, getattr(torch, conf["dtype"]))
    given = {k: v.to(getattr(torch, dtype)) if v.is_floating_point() else v
             for k, v in inputs.items()}
    ctx = drv.prepare(conf, cell, given, device)
    t = time.perf_counter()
    out = harness.solve_once(drv, ctx, None, device)
    solve_s = time.perf_counter() - t
    del ctx, given
    return {"seed": seed, "dtype": dtype,
            "iterations": int(out["iterations"].max()), "solve_s": solve_s,
            "numbers": reference.judge(conf[cell["hyper"]], inputs, out)}


if __name__ == "__main__":
    sys.exit(main())
