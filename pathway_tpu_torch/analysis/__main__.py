"""``python -m pathway_tpu_torch.analysis`` — the graft-lint CLI over the port.

    python -m pathway_tpu_torch.analysis check                 # text, exit 1 on findings
    python -m pathway_tpu_torch.analysis check --format json   # machine output
    python -m pathway_tpu_torch.analysis check --update-baseline
    python -m pathway_tpu_torch.analysis check --rules GL201,GL401
    python -m pathway_tpu_torch.analysis --list-rules          # README rule table

Exit status: 0 when every finding is baselined (or none), 1 otherwise —
``tests/test_torch_analysis.py`` runs the same :func:`core.check` +
baseline split in-process, so CI and the CLI cannot disagree.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from pathway_tpu_torch.analysis import core


def _repo_root() -> str:
    # package lives at <root>/pathway_tpu_torch/analysis/
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pathway_tpu_torch.analysis",
        description="graft-lint: static checks for this repo's invariants",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule table (markdown) and exit",
    )
    sub = parser.add_subparsers(dest="cmd")
    chk = sub.add_parser("check", help="run all passes over the port")
    chk.add_argument("--root", default=None,
                     help="repo root (default: auto-detected)")
    chk.add_argument("--format", choices=("text", "json"), default="text")
    chk.add_argument("--baseline", default=None,
                     help="baseline file (default: analysis/baseline.json)")
    chk.add_argument("--update-baseline", action="store_true",
                     help="rewrite the baseline with current findings")
    chk.add_argument("--rules", default=None,
                     help="comma-separated rule ids to run (default: all)")
    args = parser.parse_args(argv)

    if args.list_rules:
        print(core.render_rules_table())
        return 0
    if args.cmd != "check":
        parser.print_help()
        return 2

    rules = None
    if args.rules:
        rules = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = rules - set(core.RULES)
        if unknown:
            print(f"unknown rules: {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2

    root = args.root or _repo_root()
    findings = core.check(root, rules)

    if args.update_baseline:
        path = core.save_baseline(findings, args.baseline)
        print(f"baseline updated: {path} ({len(findings)} finding(s))")
        return 0

    baseline = core.load_baseline(args.baseline)
    new, old = core.split_baselined(findings, baseline)

    if args.format == "json":
        print(json.dumps(
            {
                "findings": [f.to_dict() for f in new],
                "baselined": [f.to_dict() for f in old],
                "ok": not new,
            },
            indent=2,
        ))
    else:
        for f in new:
            print(f.render())
        if old:
            print(f"({len(old)} baselined finding(s) suppressed)")
        if new:
            print(f"{len(new)} finding(s).")
        else:
            print("clean.")
    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())
