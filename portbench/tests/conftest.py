"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of the repository (CPU).  Tests that need a CUDA card carry the
``chip`` marker and decide inside the test whether one is there."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")
