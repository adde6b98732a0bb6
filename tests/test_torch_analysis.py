"""The port's static analysis (``repro_torch.analysis``), the counterpart
of ``tests/test_analysis.py``.

Negative controls show that each pass catches what it claims to (a planted
float64 round trip, a planted host read, a driver that captures anew every
round, one lint fixture per rule); positive controls show the head is
clean.  The dispatch audit's matrix runs entry by entry.
"""

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.analysis import lint_rules as ref_lint
from repro_torch.analysis import capture_guard, dispatch_audit, lint_rules
from repro_torch.core.solver import SolveResult
from repro_torch.core.solver_fused import FusedResult

REPO = pathlib.Path(__file__).resolve().parents[1]
ENTRIES = dispatch_audit.entries()


def _cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)


def _render(findings):
    return "\n".join(f.render() for f in findings)


# ---------------------------------------------------------------------------
# dispatch audit
# ---------------------------------------------------------------------------


def test_planted_f64_cast_is_caught():
    finds = dispatch_audit.plant_f64()
    assert finds and all(f.check == "dtype-f64" for f in finds)


def test_planted_host_read_is_caught():
    finds = dispatch_audit.plant_hostread()
    assert [f.message for f in finds] == [
        "aten._local_scalar_dense inside the loop body"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_dtype_audit_clean_on_head(entry):
    finds = dispatch_audit.audit_dtypes([entry])
    assert finds == [], _render(finds)


@pytest.mark.parametrize("entry", ENTRIES)
def test_host_read_audit_clean_on_head(entry):
    finds = dispatch_audit.audit_host_reads([entry])
    assert finds == [], _render(finds)


@pytest.mark.parametrize("entry", ENTRIES)
def test_body_ops_do_not_scale_with_lanes_rows_or_values(entry):
    finds = dispatch_audit.audit_invariance([entry])
    assert finds == [], _render(finds)


def test_invariance_audit_sees_a_shape_dependent_body():
    """The negative control of audit (c): a body that issues one op per
    lane differs across lane counts."""
    base = dispatch_audit.record_body("plain", B=2)[0]

    def wrap(body):
        def planted(s, refresh):
            for k in range(s.done.shape[0]):
                s.gap[k:k + 1].add_(0.0)
            return body(s, refresh)
        return planted

    got = [dispatch_audit.op_multiset(dispatch_audit.record_body(
        "plain", B=B, wrap=wrap)[0]) for B in (2, 3)]
    assert got[0] != got[1]
    assert dispatch_audit.op_multiset(base) != got[0]


def test_index_arguments_reach_the_kernels_as_int32():
    rec, _ = dispatch_audit.record_body("bank", dtype=torch.float32)
    assert {(f, a) for f, a, _ in rec.index_args} == {
        ("row_wss_batched_bank", "i_idx"),
        ("update_wss_batched_bank", "i_idx"),
        ("update_wss_batched_bank", "j_idx")}
    assert {dt for _, _, dt in rec.index_args} == {torch.int32}


def test_census_artifact_schema(tmp_path):
    paths = dispatch_audit.emit_census(str(tmp_path), names=["plain"])
    assert len(paths) == 1
    with open(paths[0]) as fh:
        payload = json.load(fh)
    assert payload["entry"] == "plain"
    assert payload["torch"] == torch.__version__
    assert sum(payload["ops"].values()) == payload["n_ops"] > 0
    assert payload["dtypes"] and payload["state"]
    # the body's two passes, on the CPU their plain versions
    assert payload["ops"].get("aten.exp", 0) >= 2


def test_matrix_follows_the_reference():
    assert set(dispatch_audit.MATRIX) == {
        "plain", "plain_shrink", "conjugate", "pasmo", "telemetry",
        "doubled", "bank", "classic_smo", "classic_pasmo", "chunked",
        "sharded_plain"}
    # every engine is ported: no entry waits for a slice
    assert dispatch_audit.entries() == list(dispatch_audit.MATRIX)
    assert not hasattr(dispatch_audit, "WAITING")


def test_sharded_slab_body_is_the_batched_body():
    """The lane-sharded engine's slab runs the batched engine's body: the
    same aten-op multiset, with the same dtypes."""
    sharded, _ = dispatch_audit.record_body("sharded_plain")
    plain, _ = dispatch_audit.record_body("plain")
    got = dispatch_audit.op_multiset(sharded)
    assert got == dispatch_audit.op_multiset(plain) and sum(got.values())


# ---------------------------------------------------------------------------
# capture guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("probe", capture_guard.PROBES,
                         ids=lambda p: p.__name__)
def test_capture_counts_exact(probe):
    findings = []
    probe(findings)
    assert findings == [], _render(findings)


def test_capture_guard_catches_recapture():
    finds = capture_guard.plant_recapture()
    assert finds and {f.check for f in finds} == {"capture-count"}


def test_chunk_schedule_matches_the_driver():
    """The guard's schedule of chunk shapes is the loop's own."""
    from repro_torch.core import solver_fused as tsf

    class Probe(tuple):
        done = torch.zeros(1, dtype=torch.bool)

    for period, check_every, max_iter in ((8, 5, 43), (64, 32, 96),
                                          (3, 7, 20), (0, 32, 70)):
        ran = []

        def body(s, refresh):
            ran.append(refresh)
            return s

        _, t = tsf._drive(body, Probe(), max_iter, check_every, False,
                          period)
        shapes = capture_guard.chunk_schedule(t, max_iter, check_every,
                                              period)
        assert [r for shape in shapes for r in shape] == ran


# ---------------------------------------------------------------------------
# linter
# ---------------------------------------------------------------------------


def test_lint_clean_on_port():
    finds = lint_rules.run_lint()
    assert finds == [], _render(finds)


def test_lint_fixtures_trigger_each_rule_once():
    finds = lint_rules.run_fixtures()
    assert sorted(f.check for f in finds) == ["TA001", "TA002", "TA003"], \
        _render(finds)


@pytest.mark.parametrize("read", ["float(s.gap.max())", "s.gap.max().item()",
                                  "s.done.cpu()"])
def test_lint_finds_a_host_read_planted_in_the_fused_body(read):
    """TA002 reads the real loop body: a host read planted into its first
    line (in memory, the file untouched) is the one finding."""
    rel = "src/repro_torch/core/solver_fused.py"
    src = (REPO / rel).read_text()
    anchor = "        s = _BatchState(*c[:_N_STATE]) if collect else c\n"
    assert anchor in src
    planted = src.replace(anchor, anchor + f"        _ = {read}\n")
    finds = lint_rules.lint_source(planted, rel)
    assert [f.check for f in finds] == ["TA002"], _render(finds)


def test_lint_sees_every_loop_body():
    bodies = {}
    for rel in ("src/repro_torch/core/solver_fused.py",
                "src/repro_torch/core/solver.py"):
        tree = ast.parse((REPO / rel).read_text())
        bodies[rel] = len(list(lint_rules._loop_bodies(tree)))
    assert bodies == {"src/repro_torch/core/solver_fused.py": 2,
                      "src/repro_torch/core/solver.py": 1}


def test_result_pins_match_the_reference_and_the_source():
    assert lint_rules.RESULT_PINS == ref_lint.RESULT_PINS
    assert tuple(f.name for f in dataclasses.fields(SolveResult)) == \
        lint_rules.RESULT_PINS["SolveResult"]
    assert tuple(f.name for f in dataclasses.fields(FusedResult)) == \
        lint_rules.RESULT_PINS["FusedResult"]


def test_isolation_scan_covers_the_analysis_package():
    import test_torch_isolation as iso
    names = {p.relative_to(REPO).as_posix() for p in iso.PORT_FILES}
    for mod in ("__init__", "__main__", "report", "lint_rules",
                "dispatch_audit", "capture_guard"):
        assert f"src/repro_torch/analysis/{mod}.py" in names


# ---------------------------------------------------------------------------
# CLI exit codes
# ---------------------------------------------------------------------------


def test_cli_lint_exits_zero_on_head():
    proc = _cli("--lint")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lint: OK" in proc.stdout


@pytest.mark.parametrize("plant", ["lint", "hostread"])
def test_cli_plant_exits_nonzero(plant):
    proc = _cli("--plant", plant)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert f"plant:{plant}:" in proc.stdout
