"""``python -m repro_torch.analysis`` — run the schedlint suite.

Exit status: 0 when clean (no findings, or every finding matched the
baseline), 1 when there are new findings (or any findings at all when
no ``--baseline`` is given), 2 on usage errors.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import default_passes, run_analysis
from repro_torch.analysis.baseline import DEFAULT_BASELINE, Baseline
from repro_torch.analysis.reporters import render_human, summarize, write_json

#: default scan root: the repro_torch package this file lives in
DEFAULT_ROOT = Path(__file__).resolve().parents[1]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="schedlint: determinism & torch hot-path static "
                    "analysis (docs/ANALYSIS.md)")
    p.add_argument("paths", nargs="*", type=Path,
                   help=f"files/dirs to scan (default: {DEFAULT_ROOT})")
    p.add_argument("--baseline", nargs="?", const=DEFAULT_BASELINE,
                   default=None, metavar="FILE",
                   help="gate against this accepted-findings file "
                        f"(default name: {DEFAULT_BASELINE}); only NEW "
                        "findings fail the run")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline to cover this run's "
                        "findings (keeps existing reasons, stamps TODO "
                        "on new entries) and exit 0")
    p.add_argument("--json", type=Path, default=None, metavar="FILE",
                   help="also write the full report as JSON")
    p.add_argument("--select", action="append", default=None,
                   metavar="PASS",
                   help="run only these passes (repeatable; names from "
                        "--list-rules)")
    p.add_argument("--list-rules", action="store_true",
                   help="print every pass and rule, then exit")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="print only the summary line")
    return p


def _list_rules(passes) -> str:
    lines = []
    for p in passes:
        lines.append(f"{p.name}:")
        for r in p.rules:
            lines.append(f"  {r.id:<14} [{r.severity}] {r.summary}")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    passes = default_passes()
    if args.select:
        known = {p.name for p in passes}
        bad = sorted(set(args.select) - known)
        if bad:
            print(f"schedlint: unknown pass(es) {', '.join(bad)}; "
                  f"known: {', '.join(sorted(known))}", file=sys.stderr)
            return 2
        passes = [p for p in passes if p.name in args.select]
    if args.list_rules:
        print(_list_rules(passes))
        return 0
    if args.update_baseline and args.baseline is None:
        args.baseline = DEFAULT_BASELINE

    paths = args.paths or [DEFAULT_ROOT]
    findings, suppressed = run_analysis(paths, passes)

    new = matched = stale = None
    if args.baseline is not None:
        baseline = Baseline.load(args.baseline)
        if args.update_baseline:
            root = Path.cwd()
            baseline.updated(findings, root=root).save(args.baseline)
            print(f"schedlint: wrote {args.baseline} with "
                  f"{len(findings)} entr{'y' if len(findings) == 1 else 'ies'}")
            return 0
        new, matched, stale = baseline.compare(findings)

    if args.json is not None:
        write_json(args.json, findings, suppressed, new, matched, stale)
    if args.quiet:
        s = summarize(findings, suppressed, new, matched, stale)
        report = "schedlint: " + ", ".join(
            [f"{s['total']} finding(s)"]
            + ([f"{s['new']} NEW"] if new is not None else []))
    else:
        report = render_human(findings, suppressed, new, matched, stale)
    print(report)

    failing = new if new is not None else findings
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
