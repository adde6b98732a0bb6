"""``loop.iter_ms``: all of the window's solve time over all its loop
iterations, in ms (host clock)."""


def read(run):
    its = sum(run.loop_iterations)
    return 1e3 * run.window_s / its if its else None
