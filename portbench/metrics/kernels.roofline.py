"""``kernels.roofline``: over the port's kernel launches in the traced
window, their least time at the data-sheet peaks (bytes and operations
from ``portbench/work/``, each launch bound by the larger) over their
device time in the trace, in %.

Each family's launches are counted by the port's counters in that window
(graph replays included); its least time per launch is their mean over
the family's variants, times the launches the trace holds.  Nothing when
the trace holds no kernel of the port, or a counted launch has no work
count.
"""

import sys

from portbench.work import (gram_block, peaks, rbf_row_wss, rbf_row_wss_batched,
                            rbf_update_wss, rbf_update_wss_batched,
                            row_wss_batched_rows, update_wss_batched_rows)

FAMILIES = (rbf_row_wss_batched, rbf_update_wss_batched, gram_block,
            row_wss_batched_rows, update_wss_batched_rows, rbf_row_wss,
            rbf_update_wss)


def _counts(launches: dict) -> dict:
    """{counter: launches}, the Gram's split into cross and symmetric."""
    out = {k: v for k, v in launches.items() if ":" not in k and v}
    sym = launches.get("gram_block:symmetric", 0)
    if sym:
        out["gram_block:symmetric"] = sym
        out["gram_block"] = out.get("gram_block", 0) - sym
        if not out["gram_block"]:
            del out["gram_block"]
    return out


def read(run):
    if run.trace is None:
        return None
    counts = _counts(run.trace.launches)
    need = busy = 0.0
    for fam in FAMILIES:
        n_trace, t = run.trace.kernels.get(fam.KERNEL, (0, 0.0))
        mine = {k: v for k, v in counts.items()
                if k.split(":")[0] in fam.WRAPPERS}
        if not n_trace or not mine:
            continue
        per = []
        for k, v in mine.items():
            if k not in run.launch_work:
                print(f"kernels.roofline: no work count for {k}",
                      file=sys.stderr)
                return None
            per.append(v * peaks.bound_s(*run.launch_work[k], run.dtype)[0])
        need += sum(per) / sum(mine.values()) * n_trace
        busy += t
    return 100.0 * need / busy if busy else None
