"""``loop.iterations``: loop iterations a solve (the most over its lanes,
from the result's ``iterations``), the mean over the window's solves."""


def read(run):
    return sum(run.loop_iterations) / len(run.loop_iterations)
