"""Nothing a run reaches imports JAX, the JAX package (``repro``) or the
repository's ``benchmarks/``, and the reference imports none of those nor
the program (``repro_torch``).  Top-level names are compared whole:
``repro_torch`` is not ``repro``."""

import ast
import json
import subprocess
import sys

import pytest

from portbench import spec

ROOT = spec.HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}

# every module a run of any cell reaches, loaded as run.py loads them
REACH = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench import control, harness, reference, spec, trace
import portbench.run
bench = spec.benchmark()
for w in bench["workloads"]:
    cell = spec.cell(w["name"])
    conf = spec.config(cell["config"])
    spec.module("solves", cell["solve"])
    spec.module("data", conf["generator"])
for part in ("end_to_end", "per_layer"):
    for m in bench[part]:
        spec.module("metrics", m["name"])
import repro_torch.kernels.build
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
import portbench.reference, portbench.reference.judge
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(script: str) -> set:
    p = subprocess.run([sys.executable, "-c", script.format(
        root=str(ROOT), src=str(ROOT / "src"))], capture_output=True,
        text=True, timeout=300, check=True)
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_run_reaches_nothing_of_jax():
    names = _top_level(REACH)
    assert "repro_torch" in names and "portbench" in names
    assert not names & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert not names & (FORBIDDEN | {"repro_torch"})


@pytest.mark.parametrize("path", sorted(
    (spec.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_only_torch(path):
    tree = ast.parse(path.read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    tops = {m.split(".")[0] for m in mods}
    assert tops <= {"__future__", "math", "types", "torch", "portbench"}
    assert all(m.startswith("portbench.reference") for m in mods
               if m.split(".")[0] == "portbench")


def test_forbidden_names_compare_whole():
    sys.path.insert(0, str(spec.HERE))
    try:
        import run
    finally:
        sys.path.remove(str(spec.HERE))
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_like"] = object()
        sys.modules.pop("repro", None)
        assert "repro_torch_like" not in run.forbidden_modules()
        sys.modules["repro.core"] = object()
        assert run.forbidden_modules() == ["repro.core"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
