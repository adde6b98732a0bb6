"""Cells at a size that a CPU test holds: the benchmark's own cell and
configuration files with fewer points and features.  ``CELLS`` holds
every cell file, ``msd-svr.grid-bank`` too, which ``BENCHMARK.json`` does
not list yet."""

import copy

from portbench import spec

CELLS = ("mnist-ovr.grid-bank", "msd-svr.svr", "mnist-ovr.svc",
         "msd-svr.grid-bank")


def cell_and_config(name: str, base=spec.HERE):
    cell = spec.cell(name, base)
    conf = copy.deepcopy(spec.config(cell["config"], base))
    conf.update(n_train=96, n_test=32, n_features=12)
    return cell, conf
