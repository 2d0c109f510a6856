"""CLI: ``python -m repro_torch.lint [--format=text|json] [--device D] [paths...]``.

Port of ``python -m repro.lint``.  Exit status: 0 when every finding is
baselined or suppressed, 1 otherwise, 2 on a usage error.  The default paths
are ``src/repro_torch`` and ``chip_smoke.py`` of the checkout that holds
this package.  The contract checks (engine 2) run on ``--device``: the card
unless ``--device cpu`` is given, and without a card the CLI raises;
``--no-contracts`` runs engine 1 alone, which reads source only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.lint.framework import (
    _PACKAGE_ROOT,
    Finding,
    all_rules,
    apply_baseline,
    build_project,
    load_baseline,
    run_rules,
    write_baseline,
)

DEFAULT_PATHS = (os.path.join(_PACKAGE_ROOT, "src", "repro_torch"),
                 os.path.join(_PACKAGE_ROOT, "chip_smoke.py"))
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: src/repro_torch and "
                         "chip_smoke.py)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline fingerprint file (default: the committed "
                         "src/repro_torch/lint/baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from the current findings "
                         "and exit 0")
    ap.add_argument("--no-contracts", action="store_true",
                    help="skip engine 2 (the contract checks)")
    ap.add_argument("--rules", default=None,
                    help="comma list of engine-1 rules to run (default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device of the contract checks; default: the "
                         "card (raises without one)")
    args = ap.parse_args(argv)

    paths = args.paths or [p for p in DEFAULT_PATHS if os.path.exists(p)]
    if not paths:
        print("repro_torch.lint: no lintable paths (pass paths)", file=sys.stderr)
        return 2

    rule_names = ([r.strip().upper() for r in args.rules.split(",")]
                  if args.rules else None)
    unknown = set(rule_names or ()) - set(all_rules())
    if unknown:
        print(f"repro_torch.lint: unknown rules {sorted(unknown)}", file=sys.stderr)
        return 2

    project = build_project(paths)
    findings: List[Finding] = run_rules(project, rule_names)
    if not args.no_contracts:
        from repro_torch.lint.contracts import run_contracts
        from repro_torch.utils.device import resolve_device
        findings.extend(run_contracts(resolve_device(args.device)))

    if args.write_baseline:
        write_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} fingerprint(s) to {args.baseline}")
        return 0

    fresh, n_baselined = apply_baseline(findings, load_baseline(args.baseline))

    if args.format == "json":
        json.dump({
            "findings": [f.to_json() for f in fresh],
            "baselined": n_baselined,
            "checked_files": len(project.files),
            "paths": paths,
            "baseline": args.baseline,
        }, sys.stdout, indent=1)
        sys.stdout.write("\n")
    else:
        for f in fresh:
            print(f.format())
        tail = f" ({n_baselined} baselined)" if n_baselined else ""
        print(f"repro_torch.lint: {len(fresh)} finding(s) in "
              f"{len(project.files)} file(s){tail}")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
