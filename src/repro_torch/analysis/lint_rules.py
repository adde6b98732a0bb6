"""Port-invariant linter: AST rules over ``src/repro_torch``.

The counterpart of the reference's ``lint_rules`` (RA001-RA003) for the
port.  Pure ``ast``: it imports nothing it lints.  Rules:

``TA001`` *f64 in device code* — no ``torch.float64``, ``.double()`` or
    ``np.float64`` in ``src/repro_torch/{core,kernels}`` outside
    function-signature defaults (a caller-facing dtype default is API).
    The host drivers that carry float64 state by design are allowlisted:
    ``torch.float64``/``.double()`` inside the functions of
    :data:`HOST_F64_FUNCS` (the chunked driver's exact state, the classic
    compacted grid's alpha/G), ``np.float64`` (host arrays) in the core
    files of :data:`HOST_F64_CORE`.  Suppress a deliberate use with a
    ``# static-ok: f64`` line comment.

``TA002`` *host read in a loop body* — inside a function named ``body``,
    or defined in ``_make_body``, no ``.item()``, ``.cpu()``,
    ``.tolist()`` or ``.numpy()``, no ``bool``/``int``/``float`` of a
    non-literal, and no Python ``if``/``while``/conditional expression
    whose test reads the carry (the body's first parameter) or a name
    bound from it.  A CUDA graph freezes such a read at capture.

``TA003`` *result pins* — ``FusedResult`` and ``SolveResult`` keep the
    reference's field lists (:data:`RESULT_PINS`, copied from
    ``repro.analysis.lint_rules.RESULT_PINS``): new per-iteration outputs
    go through the flight recorder, not the records every caller unpacks.

The reference's ``RA004`` (deterministic tests) already walks
``tests/``, the port's tests included, so it is not repeated here.
"""

from __future__ import annotations

import ast
import pathlib
from typing import List, Optional

from repro_torch.analysis.report import Finding

SUPPRESS_F64 = "static-ok: f64"

DEVICE_PREFIXES = ("src/repro_torch/core/", "src/repro_torch/kernels/")
# host drivers whose float64 tensors are their state by design
HOST_F64_FUNCS = {
    "src/repro_torch/core/solver_fused.py": ("solve_fused_chunked_qp",),
    "src/repro_torch/core/grid.py": ("_compacted_classic",),
}
# core files whose numpy float64 arrays stay on the host
HOST_F64_CORE = ("src/repro_torch/core/grid.py",
                 "src/repro_torch/core/solver_fused.py")
F64_CHAINS = ("torch.float64", "np.float64", "numpy.float64")
# the reference's result fields (repro.analysis.lint_rules.RESULT_PINS)
RESULT_PINS = {
    "SolveResult": (
        "alpha", "b", "G", "iterations", "objective", "kkt_gap",
        "converged", "n_planning", "n_free", "n_clipped", "n_reverted",
        "n_free_sv", "trace", "n_trace", "steps_i", "steps_j", "steps_mu"),
    "FusedResult": (
        "alpha", "b", "G", "iterations", "objective", "kkt_gap",
        "converged", "n_planning", "n_unshrink"),
}
HOST_READ_METHODS = ("item", "cpu", "tolist", "numpy")
HOST_READ_CASTS = ("bool", "int", "float")


def repo_root() -> pathlib.Path:
    p = pathlib.Path(__file__).resolve()
    for parent in p.parents:
        if (parent / "pyproject.toml").exists():
            return parent
    raise RuntimeError("pyproject.toml not found above " + str(p))


def _attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted name of an attribute chain (``torch.float64``), else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _signature_default_nodes(tree: ast.AST) -> set:
    """ids of every node inside a function-signature default expression."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defaults = list(node.args.defaults)
            defaults += [d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                for sub in ast.walk(d):
                    out.add(id(sub))
    return out


def _outer_function(tree: ast.AST) -> dict:
    """id(node) -> the name of the module-level function (or method) it
    lies in, for every node inside one."""
    out = {}
    for top in ast.walk(tree):
        if isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(top):
                out.setdefault(id(sub), top.name)
    return out


def _suppressed(lines: List[str], lineno: int) -> bool:
    return 0 < lineno <= len(lines) and SUPPRESS_F64 in lines[lineno - 1]


def _rule_f64(tree, rel: str, lines, findings: List[Finding]) -> None:
    if not rel.startswith(DEVICE_PREFIXES):
        return
    defaults = _signature_default_nodes(tree)
    outer = _outer_function(tree)
    host_funcs = HOST_F64_FUNCS.get(rel, ())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr == "double" and not node.args:
            what = ".double()"
        else:
            what = _attr_chain(node)
            if what not in F64_CHAINS:
                continue
        if _suppressed(lines, node.lineno) or id(node) in defaults:
            continue
        if what.startswith(("np.", "numpy.")):
            if rel in HOST_F64_CORE:
                continue                     # a host array
        elif outer.get(id(node)) in host_funcs:
            continue                         # a host driver's f64 state
        findings.append(Finding(
            "TA001", f"{rel}:{node.lineno}",
            f"{what} in device code (the loops take their dtype from the "
            "inputs; host drivers are allowlisted; suppress a deliberate "
            f"use with '# {SUPPRESS_F64}')"))


def _references(node: ast.AST, names: set) -> bool:
    return any(isinstance(sub, ast.Name) and sub.id in names
               for sub in ast.walk(node))


def _bound_names(target: ast.AST) -> set:
    return {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}


def _carry_names(fn: ast.FunctionDef) -> set:
    """The carry (the first parameter) and every name the function binds
    from an expression that reads it, to a fixed point."""
    names = {fn.args.args[0].arg}
    while True:
        grown = set(names)
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)) \
                    and node.value is not None \
                    and _references(node.value, names):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    grown |= _bound_names(t)
            elif isinstance(node, ast.NamedExpr) \
                    and _references(node.value, names):
                grown.add(node.target.id)
        if grown == names:
            return names
        names = grown


def _loop_bodies(tree: ast.AST):
    """Functions that run inside a captured loop: every function named
    ``body`` and every function defined directly in ``_make_body``."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        if node.name == "body" and node.args.args:
            yield node
        elif node.name == "_make_body":
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and sub.name != "body" \
                        and sub.args.args:
                    yield sub


def _rule_host_read(tree, rel: str, findings: List[Finding]) -> None:
    if not rel.startswith("src/repro_torch/"):
        return
    for fn in _loop_bodies(tree):
        carry = _carry_names(fn)
        where = f"inside {fn.name}()"
        for node in ast.walk(fn):
            msg = None
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in HOST_READ_METHODS:
                    msg = f".{node.func.attr}() reads the host"
                elif isinstance(node.func, ast.Name) \
                        and node.func.id in HOST_READ_CASTS \
                        and node.args \
                        and not isinstance(node.args[0], ast.Constant):
                    msg = f"{node.func.id}() of a value reads the host"
            elif isinstance(node, (ast.If, ast.While, ast.IfExp)) \
                    and _references(node.test, carry):
                msg = "a Python branch on the carried state reads the host"
            if msg is not None:
                findings.append(Finding(
                    "TA002", f"{rel}:{node.lineno}",
                    f"{msg} {where}: a CUDA graph freezes it at capture "
                    "(select with torch.where)"))


def _rule_result_pin(tree, rel: str, findings: List[Finding]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        pin = RESULT_PINS.get(node.name)
        if pin is None:
            continue
        fields = tuple(t.target.id for t in node.body
                       if isinstance(t, ast.AnnAssign)
                       and isinstance(t.target, ast.Name))
        if fields != pin:
            extra = sorted(set(fields) - set(pin))
            missing = sorted(set(pin) - set(fields))
            findings.append(Finding(
                "TA003", f"{rel}:{node.lineno}",
                f"{node.name} fields changed (added {extra or '[]'}, "
                f"removed {missing or '[]'}): new per-iteration outputs "
                "go through the flight recorder, not the result record"))


def lint_source(source: str, rel: str) -> List[Finding]:
    """Every rule over one file's text; ``rel`` is the repo-relative
    posix path that decides which rules apply (the fixtures are linted as
    files of ``src/repro_torch/core``)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("TA000", f"{rel}:{e.lineno}", "syntax error")]
    findings: List[Finding] = []
    _rule_f64(tree, rel, source.splitlines(), findings)
    _rule_host_read(tree, rel, findings)
    _rule_result_pin(tree, rel, findings)
    return findings


# Planted-violation fixtures: file -> the repo-relative path it is linted
# as.  Each must trigger its rule exactly once.
FIXTURES = {
    "ta001_f64_device.py": "src/repro_torch/core/__planted__.py",
    "ta002_host_read.py": "src/repro_torch/core/__planted__.py",
    "ta003_widened_result.py": "src/repro_torch/core/__planted__.py",
}


def run_fixtures(fixture_dir: Optional[pathlib.Path] = None
                 ) -> List[Finding]:
    """Lint the planted fixtures (the negative control: one finding a
    fixture)."""
    d = fixture_dir or repo_root() / "tests" / "fixtures" / "lint_torch"
    findings: List[Finding] = []
    for fname, rel in FIXTURES.items():
        findings.extend(lint_source((d / fname).read_text(), rel))
    return findings


def run_lint(root: Optional[pathlib.Path] = None) -> List[Finding]:
    """Every rule over every file of ``src/repro_torch``."""
    root = root or repo_root()
    findings: List[Finding] = []
    for path in sorted((root / "src" / "repro_torch").rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        findings.extend(lint_source(path.read_text(), rel))
    return findings
