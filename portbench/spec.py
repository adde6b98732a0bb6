"""Find and check the benchmark's files by name.

A cell ``<config>.<traffic>`` is ``workloads/<cell>.json``; it names its
configuration (``configs/<config>.json``) and its solve driver
(``solves/<solve>.py``); a configuration names its data generator
(``data/<generator>.py``); every metric that ``BENCHMARK.json`` lists is
read by ``metrics/<metric>.py``.  A metric applies to a cell that its
``workloads`` key names, or to every cell without that key, so a cell
added as new files runs without an edit to a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
import sys

HERE = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
CELL_KEYS = {"config", "traffic", "solve", "hyper", "chips", "why", "limits"}


class SpecError(ValueError):
    """A benchmark file that is missing or breaks a rule."""


def check_name(name, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise SpecError(f"{what} {name!r} is not a name: 1 to 64 letters, "
                        f"digits, '_', '.' and '-', starting with a letter, "
                        f"a digit or '_'")
    return name


def _json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise SpecError(f"no file {path}")
    return json.loads(path.read_text())


def benchmark(base: pathlib.Path = HERE) -> dict:
    """``BENCHMARK.json`` beside the benchmark's folder."""
    return _json(base.parent / "BENCHMARK.json")


def cell(name: str, base: pathlib.Path = HERE) -> dict:
    """The cell file ``workloads/<name>.json``, checked."""
    check_name(name, "cell")
    c = _json(base / "workloads" / f"{name}.json")
    extra = set(c) - CELL_KEYS
    if extra:
        raise SpecError(f"cell {name}: unknown keys {sorted(extra)}")
    for key in ("config", "traffic", "solve"):
        check_name(c.get(key), f"cell {name}'s {key}")
    if name != f"{c['config']}.{c['traffic']}":
        raise SpecError(f"cell {name} is not <config>.<traffic> "
                        f"({c['config']}.{c['traffic']})")
    if c.get("chips") not in (1, 4):
        raise SpecError(f"cell {name}: chips must be 1 or 4")
    if not isinstance(c.get("limits"), dict) or not c["limits"]:
        raise SpecError(f"cell {name}: no limits for its check")
    return c


def config(name: str, base: pathlib.Path = HERE) -> dict:
    """The configuration file ``configs/<name>.json``, checked."""
    check_name(name, "config")
    c = _json(base / "configs" / f"{name}.json")
    for key in ("source", "dtype", "generator", "solver", "reduced",
                "assumed"):
        if key not in c:
            raise SpecError(f"config {name}: no {key!r}")
    if c["dtype"] != "float64":
        raise SpecError(f"config {name}: dtype {c['dtype']!r}")
    check_name(c["generator"], f"config {name}'s generator")
    for key in c["reduced"]:
        check_name(key, f"config {name}'s reduced key")
    return c


def module(kind: str, name: str, base: pathlib.Path = HERE):
    """The Python file ``<kind>/<name>.py`` (a solve driver, a data
    generator or a metric reader), loaded by path: a name may hold dots."""
    check_name(name, kind)
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no file {path}")
    key = f"portbench._{kind}.{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, cell_name: str, part: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that apply to a cell."""
    return [m for m in bench[part]
            if "workloads" not in m or cell_name in m["workloads"]]


def check_metric(m: dict, part: str) -> None:
    keys = ({"name", "unit", "better", "bound", "source"} if part ==
            "end_to_end" else {"name", "unit", "better", "source", "layer",
                               "moves"})
    name = check_name(m.get("name"), "metric")
    if not keys <= set(m) <= keys | {"workloads"}:
        raise SpecError(f"metric {name}: keys {sorted(m)}, want "
                        f"{sorted(keys)} and maybe 'workloads'")
    if not UNIT.match(str(m["unit"])):
        raise SpecError(f"metric {name}: unit {m['unit']!r}")
    if m["better"] not in ("lower", "higher"):
        raise SpecError(f"metric {name}: better {m['better']!r}")
    allowed = (("host_clock", "device_trace") if part == "end_to_end"
               else SOURCES)
    if m["source"] not in allowed:
        raise SpecError(f"metric {name}: source {m['source']!r}")
    if part == "end_to_end" and not 0.01 <= m["bound"] <= 0.25:
        raise SpecError(f"metric {name}: bound {m['bound']}")


def check_benchmark(bench: dict, base: pathlib.Path = HERE) -> None:
    """Every rule of the contract that the files can show: names, units,
    each entry's files found, configs and cells consistent with them."""
    parts = ("end_to_end", "per_layer")
    names = [m["name"] for p in parts for m in bench[p]]
    if len(set(names)) != len(names):
        raise SpecError("two metrics share a name")
    for p in parts:
        for m in bench[p]:
            check_metric(m, p)
            module("metrics", m["name"], base)
    e2e = {m["name"] for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        raise SpecError("no setup_s")
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            raise SpecError(f"metric {m['name']} moves {m['moves']!r}")
    configs = {}
    for c in bench["configs"]:
        conf = config(c["name"], base)
        if c["source"] != conf["source"]:
            raise SpecError(f"config {c['name']}: source differs from its "
                            f"file")
        if sorted(c["reduced"]) != sorted(conf["reduced"]):
            raise SpecError(f"config {c['name']}: reduced differs from its "
                            f"file")
        if c["file"] != f"portbench/configs/{c['name']}.json":
            raise SpecError(f"config {c['name']}: file {c['file']}")
        module("data", conf["generator"], base)
        configs[c["name"]] = conf
    pairs = set()
    for w in bench["workloads"]:
        c = cell(w["name"], base)
        for key in ("config", "traffic", "chips"):
            if w[key] != c[key]:
                raise SpecError(f"cell {w['name']}: {key} differs from its "
                                f"file")
        if w["config"] not in configs:
            raise SpecError(f"cell {w['name']}: unknown config")
        if (w["config"], w["traffic"]) in pairs:
            raise SpecError(f"cell {w['name']}: pair seen before")
        pairs.add((w["config"], w["traffic"]))
        module("solves", c["solve"], base)
        for p in parts:
            if p == "per_layer" and not metrics_for(bench, w["name"], p):
                raise SpecError(f"cell {w['name']}: no per-layer metric")
    used = {w["config"] for w in bench["workloads"]}
    if used != set(configs):
        raise SpecError(f"configs used by no cell: {set(configs) - used}")
