"""Per-file findings cache for the sec pass (``--cache PATH``).

The seclint pass is per-file and depends only on (a) the file itself,
(b) the modules it imports (their annotations and labeled dataclass
fields feed cross-module resolution), and (c) the analyzer code + rule
catalog.  The cache memoizes each analyzed file's pre-waiver findings
keyed on exactly those three inputs:

  * the file's own ``(mtime_ns, size)``,
  * the ``(mtime_ns, size)`` of every one-hop import that resolves to an
    indexed module (annotation changes in a dependency invalidate the
    dependent, which is the only cross-module channel the sec pass has),
  * a global fingerprint over ``src/repro_torch/analysis/*.py`` stats
    and the rule-id catalog (upgrading the analyzer invalidates everything).

Waiver scanning and the comm pass are NOT cached: waiver maps are needed
for `apply()` on every run (and are a cheap regex scan), and commlint is
one AST walk over at most a handful of runtime groups.

The store is a plain JSON file; a missing, corrupt, or stale-format file
degrades to an empty cache.  `save()` is explicit so pure read runs
never touch disk.
"""

from __future__ import annotations

import json
import os

from . import registry
from .report import Finding

_FORMAT = 1


def _stat(path):
    try:
        st = os.stat(path)
    except OSError:
        return None
    return [st.st_mtime_ns, st.st_size]


def _analyzer_fingerprint():
    parts = [f"format={_FORMAT}", "rules=" + ",".join(sorted(registry.RULES))]
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    try:
        names = sorted(fn for fn in os.listdir(pkg_dir)
                       if fn.endswith(".py"))
    except OSError:
        names = []
    for fn in names:
        parts.append(f"{fn}:{_stat(os.path.join(pkg_dir, fn))}")
    return "|".join(parts)


def _dep_paths(mi, index):
    """Paths of the one-hop imports that resolve inside the index."""
    dotted = set(mi.imports.values())
    for full in mi.symbols.values():
        dotted.add(full)
        dotted.add(full.rsplit(".", 1)[0])
    out = set()
    for name in dotted:
        dep = index.modules.get(name)
        if dep is not None and dep.path != mi.path:
            out.add(os.path.abspath(dep.path))
    return sorted(out)


class FindingsCache:
    """Findings memo for `analyze_paths(..., cache=...)`."""

    def __init__(self, path):
        self.path = path
        self.hits = 0
        self.misses = 0
        self._dirty = False
        self._files = {}
        fingerprint = _analyzer_fingerprint()
        try:
            with open(path, "r", encoding="utf-8") as fh:
                data = json.load(fh)
            if data.get("fingerprint") == fingerprint:
                self._files = data.get("files", {})
        except (OSError, ValueError):
            pass
        self._fingerprint = fingerprint

    def get(self, mi, index):
        """Cached pre-waiver findings for `mi`, or None on any mismatch."""
        key = os.path.abspath(mi.path)
        entry = self._files.get(key)
        if entry is None or entry.get("stat") != _stat(key):
            self.misses += 1
            return None
        deps = _dep_paths(mi, index)
        if entry.get("deps") != {d: _stat(d) for d in deps}:
            self.misses += 1
            return None
        self.hits += 1
        return [Finding(**d) for d in entry["findings"]]

    def put(self, mi, index, findings):
        key = os.path.abspath(mi.path)
        self._files[key] = {
            "stat": _stat(key),
            "deps": {d: _stat(d) for d in _dep_paths(mi, index)},
            "findings": [
                {"rule": f.rule, "message": f.message, "path": f.path,
                 "line": f.line, "col": f.col} for f in findings],
        }
        self._dirty = True

    def save(self):
        if not self._dirty:
            return
        payload = {"fingerprint": self._fingerprint, "files": self._files}
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)
        os.replace(tmp, self.path)
