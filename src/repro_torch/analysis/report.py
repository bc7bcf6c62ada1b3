"""Findings, text/JSON rendering, and the waiver-budget report."""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from .registry import RULES


@dataclass
class Finding:
    rule: str
    message: str
    path: str
    line: int
    col: int = 0
    trace: tuple = field(default_factory=tuple)
    waived: bool = False
    waiver_reason: str = ""

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "message": self.message,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "trace": list(self.trace),
            "waived": self.waived,
            "waiver_reason": self.waiver_reason,
        }


def render_text(findings, *, show_waived: bool = False) -> str:
    """One finding per block: location, rule, message, taint trace."""
    lines = []
    for f in findings:
        if f.waived and not show_waived:
            continue
        tag = " (waived: %s)" % f.waiver_reason if f.waived else ""
        lines.append(f"{f.location} {f.rule} {f.message}{tag}")
        for step in f.trace:
            lines.append(f"    trace: {step}")
    return "\n".join(lines)


def render_json(findings, *, meta: dict | None = None) -> str:
    active = [f for f in findings if not f.waived]
    payload = {
        "tool": "seclint",
        "rules": RULES,
        "counts": _counts(findings),
        "findings": [f.to_dict() for f in findings],
        "active": len(active),
    }
    if meta:
        payload.update(meta)
    return json.dumps(payload, indent=2, sort_keys=True)


def _counts(findings) -> dict:
    out: dict = {"active": {}, "waived": {}}
    for f in findings:
        bucket = out["waived" if f.waived else "active"]
        bucket[f.rule] = bucket.get(f.rule, 0) + 1
    return out


def render_budget(findings, waiver_index) -> str:
    """The suppression budget: every waiver in the tree, visible in one place.

    `waiver_index` is {path: {line: Waiver}} as built by waivers.scan_file.
    """
    lines = ["# seclint waiver budget", ""]
    per_rule: dict = {}
    rows = []
    for path in sorted(waiver_index):
        for line in sorted(waiver_index[path]):
            w = waiver_index[path][line]
            for rule in w.rules:
                per_rule[rule] = per_rule.get(rule, 0) + 1
            state = "used" if w.used else "UNUSED"
            rows.append(f"{path}:{line} allow[{','.join(w.rules)}] "
                        f"[{state}] reason: {w.reason}")
    total = sum(per_rule.values())
    lines.append(f"total waivers: {total}")
    for rule in sorted(per_rule):
        lines.append(f"  {rule}: {per_rule[rule]}")
    lines.append("")
    lines.extend(rows if rows else ["(no waivers)"])
    waived = [f for f in findings if f.waived]
    lines.append("")
    lines.append(f"findings suppressed by waivers: {len(waived)}")
    return "\n".join(lines)
