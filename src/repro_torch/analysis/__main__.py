"""CLI of the port's static analysis.

With no flags every pass runs, and the exit code is non-zero on any
finding::

    PYTHONPATH=src python -m repro_torch.analysis

Pass selection: ``--audit`` (the dispatch audit's dtype, host-read and
invariance checks), ``--capture`` (exact capture counts; ``--device
cuda`` counts real graphs and kernel builds on the card), ``--lint``
(TA001-TA003).  ``--census DIR`` also writes each matrix entry's op
census.  ``--plant {f64,hostread,recapture,lint}`` runs one planted
violation instead: the negative control exits non-zero when the pass
catches it (1), and 2 when it slips through.
"""

from __future__ import annotations

import argparse
import sys

PLANTS = ("f64", "hostread", "recapture", "lint")


def _run_plant(kind: str, device: str) -> list:
    if kind == "lint":
        from repro_torch.analysis import lint_rules
        return lint_rules.run_fixtures()
    if kind == "recapture":
        from repro_torch.analysis import capture_guard
        return capture_guard.plant_recapture(device)
    from repro_torch.analysis import dispatch_audit
    return (dispatch_audit.plant_f64() if kind == "f64"
            else dispatch_audit.plant_hostread())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="dispatch audit, capture guard and linter of the port")
    ap.add_argument("--audit", action="store_true",
                    help="the dispatch audit only (dtype, host reads, "
                         "invariance)")
    ap.add_argument("--capture", action="store_true",
                    help="the capture guard only")
    ap.add_argument("--lint", action="store_true",
                    help="the AST rules only")
    ap.add_argument("--census", metavar="DIR",
                    help="also write each matrix entry's op census to DIR")
    ap.add_argument("--device", default="cpu",
                    help="where the capture guard runs: cpu (stand-in "
                         "graphs, the default) or cuda (the card)")
    ap.add_argument("--plant", choices=PLANTS,
                    help="run one planted violation (negative control; "
                         "exits non-zero when it is caught)")
    args = ap.parse_args(argv)

    from repro_torch.analysis.report import print_findings

    if args.plant:
        findings = _run_plant(args.plant, args.device)
        print_findings(f"plant:{args.plant}", findings)
        if not findings:
            print(f"plant:{args.plant}: NOT DETECTED (the planted violation "
                  "slipped through)", file=sys.stderr)
            return 2
        return 1

    run_all = not (args.audit or args.capture or args.lint)
    failed = False
    if run_all or args.lint:
        from repro_torch.analysis import lint_rules
        findings = lint_rules.run_lint()
        print_findings("lint", findings)
        failed |= bool(findings)
    if run_all or args.audit:
        from repro_torch.analysis import dispatch_audit
        findings = dispatch_audit.audit_all()
        print_findings("dispatch-audit", findings)
        failed |= bool(findings)
    if args.census:
        from repro_torch.analysis import dispatch_audit
        paths = dispatch_audit.emit_census(args.census)
        print(f"census: wrote {len(paths)} file(s) to {args.census}")
    if run_all or args.capture:
        from repro_torch.analysis import capture_guard
        findings = capture_guard.run_probes(args.device)
        print_findings("capture-guard", findings)
        failed |= bool(findings)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
