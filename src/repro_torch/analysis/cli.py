"""reprolint CLI of the port: ``python -m repro_torch.analysis [paths]``
(a copy of ``repro/analysis/cli.py``).

Exit code 1 on any error-severity finding; warnings exit 0 unless
``--strict``. Stdlib-only: it runs without torch or jax.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import rules as _rules  # noqa: F401  (registers rules)
from repro_torch.analysis.framework import ERROR, RULES, run


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint for the port: static checks of its "
                    "timing, seeding and spec contracts")
    parser.add_argument("paths", nargs="*", default=["src/repro_torch", "chip_smoke.py"],
                        help="files or directories to lint "
                             "(default: src/repro_torch chip_smoke.py)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit findings as a JSON array")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 on warnings too, not just errors")
    parser.add_argument("--select", metavar="CODES",
                        help="comma-separated rule codes to run "
                             "(default: all)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalogue and exit")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for code, rule in sorted(RULES.items()):
            print(f"{code}  {rule.name:<28} [{rule.severity}] "
                  f"{rule.description}")
        return 0

    selected = None
    if args.select:
        codes = {c.strip() for c in args.select.split(",") if c.strip()}
        unknown = codes - RULES.keys()
        if unknown:
            print(f"unknown rule code(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        selected = [RULES[c] for c in sorted(codes)]

    findings, n_files = run(args.paths, rules=selected)

    if args.as_json:
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.format())
        errors = sum(f.severity == ERROR for f in findings)
        warnings = len(findings) - errors
        print(f"reprolint: {n_files} file(s) checked, "
              f"{errors} error(s), {warnings} warning(s)")

    if any(f.severity == ERROR for f in findings):
        return 1
    if args.strict and findings:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
