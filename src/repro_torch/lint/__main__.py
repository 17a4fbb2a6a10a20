"""``python -m repro_torch.lint`` — run the port's dcomlint over source
trees.

Exit codes: 0 clean, 1 findings, 2 usage error.  ``--json`` writes the
machine-readable report atomically; the human summary goes to stdout
either way.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import (all_rules, dump_report, render_human, report_json,
               run_paths)


def _split(ids: Optional[str]) -> Optional[List[str]]:
    return [s.strip() for s in ids.split(",") if s.strip()] if ids else None


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="dcomlint over the port: determinism, family dispatch, "
                    "host-sync, observability and kernel-launch checks")
    ap.add_argument("paths", nargs="*",
                    default=["src/repro_torch", "chip_smoke.py"],
                    help="files or directories to lint (default: "
                         "src/repro_torch chip_smoke.py)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the JSON report here")
    ap.add_argument("--select", metavar="IDS", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--ignore", metavar="IDS", default=None,
                    help="comma-separated rule ids to skip")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id}  {rule.name}  [{rule.severity}]")
            for line in rule.doc().splitlines():
                print(f"    {line}")
            print()
        return 0

    try:
        findings, suppressed, nfiles = run_paths(
            args.paths, select=_split(args.select),
            ignore=_split(args.ignore))
    except (ValueError, OSError) as e:
        print(f"dcomlint: error: {e}", file=sys.stderr)
        return 2

    report = report_json(findings, suppressed, nfiles)
    if args.json:
        dump_report(args.json, report)
    print(render_human(findings, suppressed, nfiles))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
