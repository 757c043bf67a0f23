"""CLI: ``python -m repro_torch.analysis [paths...] [--ci] [--baseline F] ...``

``repro.analysis``'s flags and exit status: 0 when every finding is
grandfathered in the baseline (or there are none), 1 when new findings
exist, 2 on usage errors. ``--ci`` also warns about stale baseline entries.
With no paths it checks the port's package and ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .lint import (
    Baseline,
    DEFAULT_TARGETS,
    RULES,
    analyze_paths,
    default_baseline_path,
)


def _repo_default_targets() -> list[str]:
    """:data:`DEFAULT_TARGETS` relative to the repo root (the directory
    holding this package's ``src`` parent), falling back to cwd."""
    here = os.path.dirname(os.path.abspath(__file__))
    # .../<root>/src/repro_torch/analysis -> <root>
    root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    targets = [os.path.join(root, t) for t in DEFAULT_TARGETS
               if os.path.exists(os.path.join(root, t))]
    return targets or [os.getcwd()]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's static checks. Rules: "
                    + "; ".join(f"{k} {v}" for k, v in RULES.items()))
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to check (default: src/repro_torch/ and chip_smoke.py)")
    parser.add_argument(
        "--ci", action="store_true",
        help="CI mode: fail on non-baseline findings, warn on stale entries")
    parser.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="baseline file (default: the committed analysis/baseline.json)")
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline: report and fail on every finding")
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="write all current findings to the baseline file "
             "(justifications must then be filled in by hand) and exit 0")
    parser.add_argument(
        "--rules", default=None, metavar="R1,R2,...",
        help="comma-separated subset of rules to run")
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit findings as a JSON array instead of text")
    args = parser.parse_args(argv)

    paths = args.paths or _repo_default_targets()
    for p in paths:
        if not os.path.exists(p):
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2
    rules = [r.strip() for r in args.rules.split(",")] if args.rules else None

    try:
        findings = analyze_paths(paths, rules=rules)
    except ValueError as e:  # unknown rule id
        print(f"error: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or default_baseline_path()
    baseline = Baseline({}, path=baseline_path) if args.no_baseline \
        else Baseline.load(baseline_path)

    if args.write_baseline:
        merged = dict(baseline.entries)
        for f in findings:
            merged.setdefault(f.fingerprint, f"TODO justify: {f.message}")
        merged = {fp: j for fp, j in merged.items()
                  if fp in {f.fingerprint for f in findings}}
        Baseline(merged, path=baseline_path).save(baseline_path)
        print(f"wrote {len(merged)} finding(s) to {baseline_path}")
        return 0

    new, grandfathered, stale = baseline.split(findings)

    if args.as_json:
        print(json.dumps([{
            "rule": f.rule, "path": f.path, "line": f.line,
            "symbol": f.symbol, "detail": f.detail, "message": f.message,
            "fingerprint": f.fingerprint,
            "grandfathered": f.fingerprint in baseline.entries,
        } for f in findings], indent=2))
    else:
        for f in new:
            print(f.render())
        if grandfathered:
            print(f"# {len(grandfathered)} grandfathered finding(s) "
                  f"suppressed by {os.path.basename(baseline_path)}")
        if args.ci and stale:
            for fp in stale:
                print(f"# stale baseline entry (fix landed? remove it): {fp}")

    n_files = len({f.path for f in findings}) if findings else 0
    if new:
        print(f"repro_torch.analysis: {len(new)} new finding(s) in "
              f"{n_files} file(s) — fix or justify in the baseline",
              file=sys.stderr)
        return 1
    print(f"repro_torch.analysis: clean "
          f"({len(grandfathered)} grandfathered, {len(stale)} stale)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
