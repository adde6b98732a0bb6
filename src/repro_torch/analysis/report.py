"""The finding record and its text form, shared by the analysis passes.

The port's own copy of ``repro.analysis.report`` (same fields, same
rendering): the analysis package imports nothing of the reference.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation reported by an analysis pass.

    ``check`` is the stable rule identifier (e.g. ``dtype-f64``,
    ``host-read``, ``capture-count``, ``TA001``); ``where`` locates it (a
    matrix entry, a probe, or ``file:line``); ``message`` is the human
    sentence.
    """

    check: str
    where: str
    message: str

    def render(self) -> str:
        return f"[{self.check}] {self.where}: {self.message}"


def print_findings(pass_name: str, findings: list[Finding]) -> None:
    if not findings:
        print(f"{pass_name}: OK")
        return
    print(f"{pass_name}: {len(findings)} finding(s)")
    for f in findings:
        print("  " + f.render())
