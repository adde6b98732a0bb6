"""The benchmark's files against the contract: found by name and valid,
a cell added as new files runs without an edit, the result line's keys,
and no result without a card or without the program."""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness, spec
from portbench.tests import tiny

ROOT = spec.HERE.parent
BENCH = spec.benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "check"]


def test_benchmark_is_valid():
    spec.check_benchmark(BENCH)
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "solves", "data",
                                  "metrics"])
def test_every_file_is_named_by_a_name(kind):
    files = [p for p in (spec.HERE / kind).iterdir()
             if p.suffix in (".json", ".py")]
    assert files
    for p in files:
        spec.check_name(p.stem, kind)


@pytest.mark.parametrize("part", ["end_to_end", "per_layer"])
def test_metrics_have_units_and_readers(part):
    for m in BENCH[part]:
        spec.check_metric(m, part)
        assert len(m["unit"]) <= 16
        assert callable(spec.module("metrics", m["name"]).read)


def test_why_layer_and_source_fit_on_a_line():
    texts = ([w["why"] for w in BENCH["workloads"]]
             + [c["why"] for c in BENCH["configs"]]
             + [c["source"] for c in BENCH["configs"]]
             + [m["layer"] for m in BENCH["per_layer"]])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


@pytest.mark.parametrize("name", tiny.CELLS)
def test_cell_files_agree_with_benchmark(name):
    cell = spec.cell(name)
    conf = spec.config(cell["config"])
    assert cell["limits"]["kkt_gap"] == conf["solver"]["eps"]
    assert cell["limits"]["unconverged"] == 0
    for key in conf[cell["hyper"]]:
        assert key in ("gamma_factors", "Cs", "epsilons")


def _copy(tmp_path) -> pathlib.Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path / "portbench"


def test_new_cell_as_new_files_runs(tmp_path):
    base = _copy(tmp_path)
    conf = json.loads((base / "configs" / "mnist-ovr.json").read_text())
    conf.update(name="blobs-small", n_train=64, n_test=16, n_features=10,
                n_classes=3)
    (base / "configs" / "blobs-small.json").write_text(json.dumps(conf))
    cell = json.loads((base / "workloads" / "mnist-ovr.svc.json")
                      .read_text())
    cell["config"] = "blobs-small"
    (base / "workloads" / "blobs-small.svc.json").write_text(
        json.dumps(cell))
    result, _, _ = harness.run("blobs-small.svc", 5, 0.0, False, "cpu",
                               time.perf_counter(), base)
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "solve_s"}


@pytest.mark.parametrize("trace_on", [False, True])
def test_result_line_has_the_contract_keys(trace_on):
    cell, conf = tiny.cell_and_config("mnist-ovr.svc")
    result, check, _ = harness.run_cell(BENCH, "mnist-ovr.svc", cell,
                                        conf, 2**31 + 11, 0.0, trace_on,
                                        "cpu", time.perf_counter())
    assert list(result) == RESULT_KEYS
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert list(result["check"]) == list(cell["limits"])
    assert all(set(v) == {"value", "limit"}
               for v in result["check"].values())
    part = "per_layer" if trace_on else "end_to_end"
    assert set(result["metrics"]) <= {m["name"] for m in BENCH[part]}
    json.dumps(result, allow_nan=False)


def _run(cwd, *extra_env):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mnist-ovr.grid-bank", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    p = _run(ROOT)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_benchmark_files_alone_no_result(tmp_path):
    _copy(tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0
    assert "{" not in p.stdout
