"""The check that decides ``correct``, at a size a CPU run holds: a sound
run passes; the control (the program's float32 path) and each fault a
solve can have, planted in the timed path, fail.  These drive the whole
run (inputs, set-up, window, check) past the look for a card."""

import time

import pytest
import torch

import repro_torch.core.solver_fused as solver_fused
import repro_torch.kernels.ops as ops
from portbench import control, harness, solving, spec
from portbench.tests import tiny

BENCH = spec.benchmark()
SEED = 3_000_000_007


def _run(name):
    cell, conf = tiny.cell_and_config(name)
    result, check, _ = harness.run_cell(BENCH, name, cell, conf, SEED,
                                        0.0, False, "cpu",
                                        time.perf_counter())
    return result, check


def _capped(monkeypatch, cap=400):
    """A faulty loop may never converge: cap its iterations."""
    real = solving.solver_config
    monkeypatch.setattr(solving, "solver_config",
                        lambda conf, max_iter=None: real(conf,
                                                         max_iter or cap))


@pytest.mark.parametrize("name", tiny.CELLS)
def test_sound_run_is_correct(name):
    result, check = _run(name)
    assert result["correct"], check
    assert result["failed"] == 0


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_float32_fails(name):
    cell, conf = tiny.cell_and_config(name)
    gen = spec.module("data", conf["generator"])
    drv = spec.module("solves", cell["solve"])
    rec = control.readings(conf, cell, gen, drv, SEED, torch.device("cpu"),
                           control.LOWER[conf["dtype"]])
    over = [k for k, lim in cell["limits"].items()
            if not rec["numbers"][k] <= lim]
    assert over, rec["numbers"]


@pytest.mark.parametrize("name", tiny.CELLS)
def test_state_left_unchanged_fails(name, monkeypatch):
    # the loop returns the state it was given
    calls = []

    def unchanged(body, s, *a, **k):
        calls.append(1)
        return s, 0

    monkeypatch.setattr(solver_fused, "_drive", unchanged)
    result, check = _run(name)
    assert calls
    assert not result["correct"]
    assert check["kkt_gap"][0] > check["kkt_gap"][1]


@pytest.mark.parametrize("name", tiny.CELLS)
def test_half_the_coordinates_left_out_fails(name, monkeypatch):
    # pass B updates G on the first half of each lane's coordinates only
    real = ops.source_update_wss
    calls = []

    def half(src, G, *a, **k):
        calls.append(1)
        out = real(src, G, *a, **k)
        G_new = out[0].clone()
        n = G.shape[1]
        G_new[:, n // 2:] = G[:, n // 2:]
        return (G_new,) + tuple(out[1:])

    monkeypatch.setattr(ops, "source_update_wss", half)
    _capped(monkeypatch)
    result, _ = _run(name)
    assert calls
    assert not result["correct"]


@pytest.mark.parametrize("name", tiny.CELLS)
def test_answer_altered_fails(name, monkeypatch):
    # one held-out decision value altered where the solve produces it
    drv = spec.module("solves", spec.cell(name)["solve"])
    real = drv.decide

    def altered(ctx, fitted):
        out = real(ctx, fitted)
        out["decision"][0, 0] += 1e-3
        return out

    monkeypatch.setattr(drv, "decide", altered)
    result, check = _run(name)
    assert not result["correct"]
    assert check["decision"][0] > check["decision"][1]
