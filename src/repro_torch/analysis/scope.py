"""Analysis scope: which files under the tree seclint actually checks.

The LM-era modules (`models/`, the LM entries of `configs/`) never touch
shares or field arrays.  They are excluded here explicitly, as in the
JAX package's analyzer (docs/ANALYSIS.md), so the gate's signal stays
about the MPC hot path.  Everything else under src/repro_torch is in
scope; in particular the secure-serving package `serve/` (which holds
live model shares) is fully analyzed.
"""

from __future__ import annotations

import os

#: path fragments (relative to the `repro_torch` package root) excluded from
#: analysis.  Directories end with "/".
EXCLUDED = (
    "models/",
)

#: configs/ is excluded except the protocol-era entries
CONFIGS_KEEP = ("__init__.py", "copml_logreg.py", "registry.py")


def _package_rel(path: str) -> str:
    """Path relative to the innermost `repro_torch` package dir, '' if
    not inside."""
    norm = os.path.abspath(path).replace("\\", "/")
    marker = "/repro_torch/"
    pos = norm.rfind(marker)
    if pos < 0:
        return ""
    return norm[pos + len(marker):]


def in_scope(path: str) -> bool:
    rel = _package_rel(path)
    if not rel:
        return True  # non-package files (fixtures, tmp copies): analyze
    for ex in EXCLUDED:
        if ex.endswith("/"):
            if rel.startswith(ex):
                return False
        elif rel == ex:
            return False
    if rel.startswith("configs/"):
        return os.path.basename(rel) in CONFIGS_KEEP
    return True
