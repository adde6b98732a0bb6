"""Render the dry-run tables from the port's dry-run records.

    python -m repro_torch.launch.report [--dir artifacts/dryrun_torch] \\
        [--mesh single] [--kind roofline|dryrun]

The port of ``repro.launch.report``: the same two tables, from the
cell records :mod:`repro_torch.launch.dryrun` writes (a
``dryrun_solver`` record in the same folder is left out).  The "compile s" column
is the trace's time (the port traces; it does not compile), and the
HLO columns are the per-device counts at dispatch.
"""

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import OUT


def load(d, mesh=None):
    rows = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if "kind" not in r or (mesh and r.get("mesh") != mesh):
            continue            # the solver's record is not a cell
        rows.append(r)
    return rows


def roofline_table(rows):
    out = ["| arch | shape | compute_s | memory_s | collective_s | "
           "dominant | MODEL/HLO | roofline frac |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("skipped"):
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"skipped | — | ({r['skip_reason']}) |")
            continue
        if not r.get("ok"):
            out.append(f"| {r['arch']} | {r['shape']} | FAILED | | | | | |")
            continue
        ro = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {ro['compute_s']:.3e} "
            f"| {ro['memory_s']:.3e} | {ro['collective_s']:.3e} "
            f"| {ro['dominant']} | {ro['useful_flops_ratio']:.3f} "
            f"| {ro['roofline_fraction']:.3f} |")
    return "\n".join(out)


def dryrun_table(rows):
    out = ["| arch | shape | mesh | status | compile s | HLO GFLOP/dev | "
           "HLO GB/dev | coll GB/dev | input GB/dev |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("skipped"):
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                       f"| SKIP ({r['skip_reason'][:40]}) | | | | | |")
            continue
        if not r.get("ok"):
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                       f"| **FAIL** | | | | | |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | OK "
            f"| {r['time_compile_s']:.1f} "
            f"| {r['hlo_flops'] / 1e9:.1f} | {r['hlo_bytes'] / 1e9:.1f} "
            f"| {r['collectives']['total'] / 1e9:.1f} "
            f"| {r['input_bytes_per_device'] / 1e9:.2f} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--kind", default="roofline",
                    choices=["roofline", "dryrun"])
    args = ap.parse_args(argv)
    rows = load(args.dir, args.mesh)
    print(roofline_table(rows) if args.kind == "roofline"
          else dryrun_table(rows))


if __name__ == "__main__":
    main()
