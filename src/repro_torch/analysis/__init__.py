"""Static analyzers for the COPML hot path: seclint + commlint.

Two pass families share one engine, waiver grammar, report format, and
CLI (`python -m repro_torch.analysis src/repro_torch`):

  * **sec** (seclint, SEC/FLD/WVR rules): secrecy-taint + field
    arithmetic analysis of the MPC compute path.
  * **comm** (commlint, COM rules): choreography + comm-cost analysis of
    the multi-process protocol -- call sites of the proc-engine runtime
    diffed against the declarative round spec in `choreography.py`, plus
    the static frame budget cross-checked against `core/cost_model.py`.

`--pass {sec,comm,all}` selects a family; `--changed-only` restricts to
git-dirty files; `--cache PATH` memoizes per-file sec findings.  The
rules, the taint model, the choreography grammar and the waiver grammar
are the JAX package's analyzer's (docs/ANALYSIS.md), retargeted at this
package: torch's host escapes are `.numpy()`, `.item()`, `.tolist()`,
`bytes(...)`, `print`, `pickle.*` and `numpy.asarray`; `.cpu()` and
`.to(device)` move a value within the party that holds it.

Public API:
    analyze_paths(paths, ...) -> AnalysisResult (.findings / .active /
                                 .waived / .unused_waivers)
    RULES                     -- {rule_id: one-line description}
"""

from __future__ import annotations

from .engine import analyze_paths
from .registry import RULES
from .report import Finding, render_budget, render_json, render_text

__all__ = [
    "analyze_paths",
    "Finding",
    "RULES",
    "render_text",
    "render_json",
    "render_budget",
]
