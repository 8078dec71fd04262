"""``python -m repro_torch.analysis`` — run the port's invariant checker (exit-code
contract: 0 clean, 1 new findings / stale baseline / self-check failure,
2 usage or internal error)."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import ALL_RULES
from repro_torch.analysis.engine import (
    BaselineError,
    analyze_tree,
    apply_baseline,
    load_baseline,
)
from repro_torch.analysis.selfcheck import run_self_check


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Repo-invariant static checker: determinism (DET), "
                    "spec-hash coverage (HASH), launch-shape discipline "
                    "(SHAPE), lock consistency (LOCK), error taxonomy "
                    "(ERR), over the port's Python and CUDA sources. "
                    "See DESIGN.md §15.")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--baseline", default=None,
                    help="JSON baseline of justified pre-existing findings; "
                         "stale entries (fixed findings) fail the run")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--root", default=None,
                    help="package root to analyze (default: the repro_torch "
                         "package this module ships in)")
    ap.add_argument("--self-check", action="store_true",
                    help="run every rule against its seeded fixture and "
                         "fail on any delta (guards the checker itself)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.name:6} {rule.description}")
        return 0

    if args.self_check:
        problems = run_self_check()
        for p in problems:
            print(p)
        print(f"self-check: {len(problems)} problem(s) across "
              f"{len(ALL_RULES)} rules")
        return 1 if problems else 0

    rules = list(ALL_RULES)
    if args.rules:
        want = {tok.strip().upper() for tok in args.rules.split(",")
                if tok.strip()}
        known = {r.name for r in ALL_RULES}
        if want - known:
            print(f"error: unknown rule(s) {sorted(want - known)} "
                  f"(known: {sorted(known)})", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.name in want]

    root = (Path(args.root) if args.root
            else Path(__file__).resolve().parent.parent)
    if not root.is_dir():
        print(f"error: --root {root} is not a directory", file=sys.stderr)
        return 2

    try:
        report = analyze_tree(root, rules)
    except SyntaxError as e:
        print(f"error: cannot parse {e.filename}:{e.lineno}: {e.msg}",
              file=sys.stderr)
        return 2

    entries: list[dict] = []
    if args.baseline:
        try:
            entries = load_baseline(Path(args.baseline))
        except BaselineError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    new, baselined, stale = apply_baseline(report.findings, entries)

    if args.as_json:
        print(json.dumps({
            "files": report.files,
            "rules": [r.name for r in rules],
            "new": [f.to_dict() for f in new],
            "baselined": [f.to_dict() for f in baselined],
            "stale_baseline": stale,
            "suppressed_inline": report.suppressed,
        }, indent=1))
    else:
        for f in new:
            print(f.render())
        for e in stale:
            print(f"stale baseline entry: [{e['rule']}] {e['path']}: "
                  f"{e['snippet']!r} — the finding is gone; remove the "
                  "entry (or re-justify it if the line merely changed)")
        print(f"{len(new)} new finding(s) over {report.files} files "
              f"({len(baselined)} baselined, {report.suppressed} "
              f"suppressed inline, {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'})")
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
