"""Run one cell of the port's benchmark on this machine's CUDA card.

    python3 portbench/run.py --workload mnist-ovr.grid-bank --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout.  The last line of standard output is the
result: one JSON object with ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``, each number the check compared beside its limit.  Those
numbers are also the last lines of standard error.  Without a CUDA card,
or with fewer than the cell asks for, it prints no result and exits 2;
if JAX or the JAX package was loaded, it prints no result and exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the JAX side's top-level modules: none may be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="the cell's name")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True,
                   help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import harness, spec
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < \
            cell["chips"]:
        print(f"run.py: the cell {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, check, info = harness.run(args.workload, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0),
                                T_START)
    found = forbidden_modules()
    if found:
        print(f"run.py: JAX-side modules were loaded: {found}",
              file=sys.stderr)
        return 3
    print(f"window: {len(info['solve_s'])} solves, seconds "
          f"{info['solve_s']}, loop iterations {info['loop_iterations']}",
          file=sys.stderr)
    if "traced" in info:
        print(f"traced solve: {info['traced']}", file=sys.stderr)
    for name, (value, limit) in check.items():
        ok = "ok" if value <= limit else "FAIL"
        print(f"check {name} {value!r} limit {limit!r} {ok}",
              file=sys.stderr)
    result["check"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                       for k, v in result["check"].items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
