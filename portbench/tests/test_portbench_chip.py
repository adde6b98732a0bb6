"""Each cell at its own size on the CUDA card: one solve passes the check,
and the control (the program's float32 path) fails it.  Skips without a
card (decided inside the test).  On the card:
``python3 -m pytest -q -m chip portbench/tests/test_portbench_chip.py``
(several minutes)."""

import time

import pytest
import torch

from portbench import control, harness, spec
from portbench.tests import tiny

SEED = 3_000_000_901


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.chip
@pytest.mark.parametrize("name", tiny.CELLS)
def test_cell_is_correct_on_the_card(name):
    device = _card()
    result, check, _ = harness.run(name, SEED, 0.0, False, device,
                                   time.perf_counter())
    assert result["correct"], check


@pytest.mark.chip
@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_fails_on_the_card(name):
    device = _card()
    cell = spec.cell(name)
    conf = spec.config(cell["config"])
    rec = control.readings(conf, cell, spec.module("data", conf["generator"]),
                           spec.module("solves", cell["solve"]), SEED,
                           device, control.LOWER[conf["dtype"]])
    assert any(not rec["numbers"][k] <= lim
               for k, lim in cell["limits"].items()), rec["numbers"]
