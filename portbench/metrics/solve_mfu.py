"""``solve_mfu``: the least time the window's solves need at the
data-sheet peaks (``portbench/work/solve.py``: the algorithm's bytes and
operations, whatever kernels carry them) over their measured time, in %.
"""


def read(run):
    return 100.0 * sum(run.need_s) / run.window_s
