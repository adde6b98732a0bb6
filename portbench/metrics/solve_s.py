"""``solve_s``: all the wall time of the window's solves over their number
(host clock): the time to an eps-accurate model and its held-out
decisions."""


def read(run):
    return run.window_s / run.n_solves
