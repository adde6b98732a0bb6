"""``setup_s``: seconds from the start of ``run.py`` to the first timed
solve (host clock)."""


def read(run):
    return run.setup_s
