"""Inline waiver pragmas.

Grammar (one per line, same line as the finding or a standalone comment
line directly above it), written after a comment marker::

    <hash> seclint: allow[SEC001] reason=<free text to end of line>
    <hash> seclint: allow[FLD001,FLD002] reason=<...>

(spelled with a literal ``#``; this docstring avoids the token so the
scanner -- which matches raw source lines -- does not parse its own
documentation as a pragma).  A reason is mandatory -- a pragma without one is itself a finding
(WVR001), as is an unparseable rule list.  `--strict` additionally turns
every waiver (and every unused waiver, WVR002) into an error so
suppressions cannot accumulate silently.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from .registry import RULES
from .report import Finding

_PRAGMA_RE = re.compile(r"#\s*seclint:\s*(?P<body>.*)$")
_ALLOW_RE = re.compile(
    r"^allow\[(?P<rules>[A-Za-z0-9_,\s]+)\]\s*"
    r"(?:reason\s*=\s*(?P<reason>\S.*))?$"
)


@dataclass
class Waiver:
    rules: tuple
    reason: str
    line: int          # line the pragma text sits on
    applies_to: tuple  # line numbers this waiver covers
    used: bool = False
    consumed_rules: set = field(default_factory=set)


def scan_file(path: str, source: str):
    """Return ({covered_line: Waiver}, [malformed-pragma Findings])."""
    waivers: dict[int, Waiver] = {}
    problems: list[Finding] = []
    lines = source.splitlines()
    for idx, text in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        body = m.group("body").strip()
        am = _ALLOW_RE.match(body)
        if not am:
            problems.append(Finding(
                "WVR001", f"malformed seclint pragma: {body!r} "
                "(expected `allow[RULE,...] reason=<text>`)", path, idx))
            continue
        rules = tuple(r.strip() for r in am.group("rules").split(",")
                      if r.strip())
        unknown = [r for r in rules if r not in RULES]
        reason = (am.group("reason") or "").strip()
        if not rules or unknown or not reason:
            what = (f"unknown rule ids {unknown}" if unknown
                    else "missing reason=" if not reason else "empty rules")
            problems.append(Finding(
                "WVR001", f"malformed seclint pragma ({what}): {body!r}",
                path, idx))
            continue
        # a pragma on a comment-only line covers the next line; a trailing
        # pragma covers its own line
        own_line = text[:m.start()].strip() != ""
        covered = idx if own_line else idx + 1
        waivers[covered] = Waiver(rules, reason, idx, (covered,))
    return waivers, problems


def apply(findings, waiver_maps):
    """Mark findings waived in place; waiver_maps is {path: {line: Waiver}}."""
    for f in findings:
        per_file = waiver_maps.get(f.path)
        if not per_file:
            continue
        w = per_file.get(f.line)
        if w and f.rule in w.rules:
            f.waived = True
            f.waiver_reason = w.reason
            w.used = True
            w.consumed_rules.add(f.rule)
    return findings


def unused_findings(waiver_maps):
    """WVR002 findings for waivers that never suppressed anything."""
    out = []
    for path in sorted(waiver_maps):
        for line, w in sorted(waiver_maps[path].items()):
            if not w.used:
                out.append(Finding(
                    "WVR002",
                    f"waiver allow[{','.join(w.rules)}] never matched a "
                    "finding", path, w.line))
    return out
