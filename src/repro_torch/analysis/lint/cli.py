"""CLI: ``python -m repro_torch.analysis.lint [paths] [--select ...] ...``.

Exit codes: 0 = clean (possibly via suppressions/baseline), 1 = at
least one unsuppressed diagnostic, 2 = usage error.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Sequence

from .registry import all_rules
from .runner import run_paths, write_baseline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="AST-based invariant checker for the repro engine "
                    "(state-mutation, determinism, f64 dtype, jit "
                    "purity).")
    p.add_argument("paths", nargs="*", default=["src"],
                   help="files or directories to lint (default: src)")
    p.add_argument("--select", default=None, metavar="RULE,...",
                   help="only run rules matching these codes/prefixes "
                        "(e.g. RPR1,RPR203)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="JSON baseline of accepted findings to ignore")
    p.add_argument("--write-baseline", default=None, metavar="FILE",
                   help="write the current finding set as a baseline "
                        "and exit 0")
    p.add_argument("--summary-json", default=None, metavar="FILE",
                   help="dump the run summary (counts per rule) as JSON")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="summary only, no per-finding lines")
    return p


def main(argv: Sequence[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for r in all_rules():
            print(f"{r.code}  {r.name:32s} {r.summary}")
        return 0

    select = args.select.split(",") if args.select else None
    result = run_paths(args.paths, select=select, baseline=args.baseline)

    if args.write_baseline:
        write_baseline(result, args.write_baseline)
        print(f"repro-lint: wrote baseline "
              f"({len(result.new_fingerprints)} fingerprints) to "
              f"{args.write_baseline}")
        return 0

    if not args.quiet:
        for d in result.diagnostics:
            print(d.format())
    s = result.summary()
    if args.summary_json:
        with open(args.summary_json, "w", encoding="utf-8") as fh:
            json.dump(s, fh, indent=2)
            fh.write("\n")
    print(f"repro-lint: {s['diagnostics']} diagnostic(s), "
          f"{s['suppressed']} suppressed, {s['baselined']} baselined "
          f"— {s['files_checked']} file(s) checked", file=sys.stderr)
    return result.exit_code


if __name__ == "__main__":     # pragma: no cover
    raise SystemExit(main())
