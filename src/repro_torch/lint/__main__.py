"""CLI: ``python -m repro_torch.lint [paths...] [--baseline FILE]``.

Exit status is 0 when every finding is accounted for by an inline
suppression or the baseline, 1 when NEW findings exist (the gate), 2 on
usage errors.  ``--write-baseline`` rewrites the baseline from the
current findings (for adopting the linter on a tree with legacy debt —
``src/repro_torch`` needs none: fix or suppress-with-comment instead).
Counterpart of ``repro/lint/__main__.py``; loads no ``torch``.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch import lint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="static analysis for the port's eager PyTorch training/serving "
                    "stack (rules RL001-RL004)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: src/repro_torch)")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON; only NEW findings fail the run")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite --baseline from the current findings")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset (e.g. RL001,RL002)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    rules = lint.ALL_RULES
    if args.rules:
        rules = tuple(r.strip().upper() for r in args.rules.split(","))
        for rule in rules:
            if rule in lint.NO_COUNTERPART:
                ap.error(lint.NO_COUNTERPART[rule])
        unknown = set(rules) - set(lint.ALL_RULES)
        if unknown:
            ap.error(f"unknown rules: {sorted(unknown)}")

    paths = args.paths or ["src/repro_torch"]
    findings, suppressed = lint.lint_paths(paths, rules)

    if args.write_baseline:
        if not args.baseline:
            ap.error("--write-baseline requires --baseline PATH")
        lint.write_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    baseline = lint.load_baseline(args.baseline)
    fresh = lint.new_findings(findings, baseline)

    if args.format == "json":
        print(json.dumps({
            "findings": [vars(f) for f in fresh],
            "baselined": len(findings) - len(fresh),
            "suppressed": suppressed,
        }, indent=2))
    else:
        for f in fresh:
            print(f.render())
        print(f"repro_torch.lint: {len(fresh)} new finding(s), "
              f"{len(findings) - len(fresh)} baselined, "
              f"{suppressed} suppressed inline "
              f"({', '.join(rules)} over {', '.join(paths)})")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
