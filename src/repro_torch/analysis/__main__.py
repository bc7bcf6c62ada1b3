"""CLI: `python -m repro_torch.analysis [paths...]`.

Runs both pass families by default: `sec` (seclint secrecy-taint +
field-arithmetic rules) and `comm` (commlint choreography + comm-cost
rules); `--pass` narrows to one.  Exit status 0 = clean (every finding
waived with a reason); 1 = unwaived findings (or, under --strict, ANY
findings/waivers).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from .cache import FindingsCache
from .engine import analyze_paths
from .registry import RULES
from .report import render_budget, render_json, render_text

_PASSES = {"sec": ("sec",), "comm": ("comm",), "all": ("sec", "comm")}


def _changed_files():
    """Absolute paths of .py files changed vs HEAD (plus untracked).

    Returns None when git is unavailable -- the caller falls back to a
    full run, which is always sound."""
    changed = set()
    for cmd in (["git", "diff", "--name-only", "HEAD"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=30, check=True).stdout
        except (OSError, subprocess.SubprocessError):
            return None
        changed |= {os.path.abspath(line) for line in out.splitlines()
                    if line.endswith(".py")}
    return changed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis",
        description="static analyzers for the COPML hot path: seclint "
                    "(secrecy taint + field arithmetic) and commlint "
                    "(protocol choreography + comm cost)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or trees to analyze "
                         "(default: src/repro_torch)")
    ap.add_argument("--pass", dest="passes", choices=sorted(_PASSES),
                    default="all",
                    help="which rule family to run (default: all)")
    ap.add_argument("--package", default="",
                    help="dotted package context for explicitly-listed "
                         "files (resolves their relative imports), e.g. "
                         "--package repro_torch.core")
    ap.add_argument("--strict", action="store_true",
                    help="treat every waiver (used or unused) as an error")
    ap.add_argument("--changed-only", action="store_true",
                    help="only analyze files changed vs git HEAD "
                         "(everything is still indexed; commlint still "
                         "sees whole worker/session groups)")
    ap.add_argument("--cache", metavar="PATH", default="",
                    help="memoize per-file sec findings in a JSON cache "
                         "keyed on file/dep mtimes")
    ap.add_argument("--json", metavar="PATH", default="",
                    help="write the full findings report as JSON")
    ap.add_argument("--budget-report", metavar="PATH", default="",
                    help="write the waiver-budget report to PATH "
                         "('-' for stdout)")
    ap.add_argument("--no-scope", action="store_true",
                    help="ignore the legacy-module scope config and "
                         "analyze everything")
    ap.add_argument("--show-waived", action="store_true",
                    help="also print waived findings")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULES):
            print(f"{rid}  {RULES[rid]}")
        return 0

    only_files = None
    if args.changed_only:
        only_files = _changed_files()
        if only_files is None:
            print("analysis: --changed-only needs git; running full set",
                  file=sys.stderr)

    cache = FindingsCache(args.cache) if args.cache else None

    paths = args.paths or ["src/repro_torch"]
    passes = _PASSES[args.passes]
    t0 = time.monotonic()
    res = analyze_paths(paths, package=args.package, strict=args.strict,
                        apply_scope=not args.no_scope, passes=passes,
                        only_files=only_files, cache=cache)
    elapsed = time.monotonic() - t0
    if cache is not None:
        cache.save()

    text = render_text(res.findings, show_waived=args.show_waived
                       or args.strict)
    if text:
        print(text)

    if args.json:
        payload = render_json(res.findings, meta={
            "files": len(res.files), "passes": list(passes),
            "seconds": round(elapsed, 3)})
        with open(args.json, "w", encoding="utf-8") as fh:
            fh.write(payload + "\n")

    budget = render_budget(res.findings, res.waiver_maps)
    if args.budget_report == "-":
        print(budget)
    elif args.budget_report:
        with open(args.budget_report, "w", encoding="utf-8") as fh:
            fh.write(budget + "\n")

    active = res.active
    waived = res.waived
    cache_note = (f", cache {cache.hits}/{cache.hits + cache.misses} hit"
                  if cache is not None else "")
    print(f"analysis[{'+'.join(passes)}]: {len(res.files)} files, "
          f"{len(active)} finding(s), {len(waived)} waived, "
          f"{len(res.unused_waivers)} unused waiver(s) "
          f"[{elapsed:.2f}s{cache_note}]")

    if args.strict:
        return 1 if (active or waived or res.unused_waivers) else 0
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
