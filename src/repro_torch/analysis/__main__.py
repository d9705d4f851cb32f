"""CLI for the static-analysis passes: ``python -m repro_torch.analysis``.

Runs the repo lint (stdlib-only, instant) and then the plan auditor (runs
the whole spec lattice on rank 0 of a fake process group, on the CPU, at
small sizes: a few seconds). Host-only: it needs no card and uses none.
``--strict`` turns any NEW finding (not in the lint baseline; the auditor
has no baseline) into a nonzero exit.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static plan auditor + repo lint.")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any new lint finding or audit finding")
    ap.add_argument("--min-specs", type=int, default=0, metavar="N",
                    help="fail if the audited lattice has fewer specs")
    ap.add_argument("--lint-only", action="store_true",
                    help="skip the plan audit (no torch import)")
    ap.add_argument("--audit-only", action="store_true",
                    help="skip the repo lint")
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the fake process group the audit's mesh "
                         "lattice is built over (default 8)")
    args = ap.parse_args(argv)
    failed = False

    if not args.audit_only:
        from repro_torch.analysis import lint
        new, old = lint.split_baseline(lint.lint_tree(),
                                       lint.load_baseline())
        for f in new:
            print(f"LINT NEW  {f}")
        print(f"lint: {len(new)} new finding(s), "
              f"{len(old)} grandfathered")
        failed |= bool(new)

    if not args.lint_only:
        from repro_torch.analysis import audit
        with audit.fake_meshes(args.devices) as meshes:
            specs = audit.lattice(meshes)
            if len(specs) < args.min_specs:
                print(f"audit: lattice has {len(specs)} specs "
                      f"< --min-specs {args.min_specs}")
                failed = True
            report = audit.audit_specs(specs, strict=False)
        for f in report.findings:
            print(f"AUDIT  [{f.tag}] {f.check}: {f.detail}")
        fam = report.by_family()
        fams = " ".join(f"{k}={len(v)}" for k, v in sorted(fam.items()))
        print(f"audit: {report.specs} specs, {len(report.cells)} cells "
              f"({fams}), {len(report.findings)} finding(s)")
        failed |= bool(report.findings)

    if failed and args.strict:
        return 1
    if failed:
        print("(findings reported; rerun with --strict to fail)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
