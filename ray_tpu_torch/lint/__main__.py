"""CLI: `python -m ray_tpu_torch.lint [paths...]`.

Exit codes: 0 clean (vs baseline), 1 new findings (or parse errors),
2 usage error.  `--write-baseline` regenerates the port's
`ray_tpu_torch/lint/lint_baseline.json` from the current findings
(review the diff: it should only shrink).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from ray_tpu_torch.lint.framework import (
    _REPO_ROOT,
    compare_to_baseline,
    default_baseline_path,
    lint_paths,
    load_baseline,
    render_baseline,
    rule_catalog,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.lint",
        description="rtlint: ray_tpu_torch invariant checks (see docs/lint.md)",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        help="files/directories to lint (default: ray_tpu_torch and "
        "tests/test_torch_*.py)",
    )
    ap.add_argument("--baseline", default=None, help="baseline json path")
    ap.add_argument(
        "--no-baseline",
        action="store_true",
        help="report every finding; exit 1 if any",
    )
    ap.add_argument(
        "--write-baseline",
        action="store_true",
        help="regenerate the baseline from current findings",
    )
    ap.add_argument(
        "--select", default=None, help="comma-separated rule ids to run"
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    ap.add_argument(
        "--stats",
        action="store_true",
        help="print per-rule finding counts and wall time",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, name, desc in rule_catalog():
            print(f"{rule}  {name}\n       {desc}")
        return 0

    paths = args.paths or [
        os.path.join(_REPO_ROOT, "ray_tpu_torch"),
        *sorted(glob.glob(os.path.join(_REPO_ROOT, "tests",
                                       "test_torch_*.py"))),
    ]
    for p in paths:
        if not os.path.exists(p):
            print(f"rtlint: no such path: {p}", file=sys.stderr)
            return 2
    select = (
        {s.strip() for s in args.select.split(",") if s.strip()}
        if args.select
        else None
    )
    stats: dict = {}
    findings = lint_paths(paths, select=select, stats=stats)
    if args.stats:
        total = stats.pop("_total", {"findings": 0.0, "seconds": 0.0})
        print(f"{'rule':<8}{'findings':>10}{'seconds':>10}")
        for rule in sorted(stats):
            row = stats[rule]
            print(
                f"{rule:<8}{int(row['findings']):>10}"
                f"{row['seconds']:>10.3f}"
            )
        print(
            f"{'total':<8}{int(total['findings']):>10}"
            f"{total['seconds']:>10.3f}"
        )

    baseline_path = args.baseline or default_baseline_path()
    if args.write_baseline:
        with open(baseline_path, "w", encoding="utf-8") as fh:
            fh.write(render_baseline(findings))
        print(
            f"rtlint: wrote {len(findings)} grandfathered finding(s) "
            f"to {baseline_path}"
        )
        return 0

    if args.no_baseline or not os.path.exists(baseline_path):
        for f in findings:
            print(f)
        print(f"rtlint: {len(findings)} finding(s)")
        return 1 if findings else 0

    baseline = load_baseline(baseline_path)
    new, shrunk = compare_to_baseline(findings, baseline)
    for f in new:
        print(f)
    if shrunk:
        keys = ", ".join(sorted(shrunk))
        print(
            f"rtlint: note: {len(shrunk)} baseline bucket(s) shrank "
            f"({keys}) — run --write-baseline to lock in the progress"
        )
    grandfathered = len(findings) - len(new)
    if new:
        print(
            f"rtlint: {len(new)} NEW finding(s) "
            f"({grandfathered} grandfathered in baseline)"
        )
        return 1
    print(f"rtlint: clean ({grandfathered} grandfathered finding(s))")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `... --list-rules | head`
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
