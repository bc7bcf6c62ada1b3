"""The import guard: the benchmark measures the PyTorch port alone.

A loaded module is refused when its top-level name (the part before the
first dot), compared whole, is one of FORBIDDEN -- JAX, its libraries and
the JAX package `repro`; the port `repro_torch` begins with `repro` but is
another name -- or when its file lies under the repository's
`benchmarks/` folder, which measured the JAX package.
"""

from __future__ import annotations

import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def offending(modules=None, checkout: Path | None = None) -> list:
    """Names of loaded modules the benchmark may not load, sorted."""
    modules = sys.modules if modules is None else modules
    old_bench = None if checkout is None else \
        (Path(checkout) / "benchmarks").resolve()
    found = []
    for name, mod in list(modules.items()):
        if name.split(".")[0] in FORBIDDEN:
            found.append(name)
            continue
        path = getattr(mod, "__file__", None)
        if old_bench is not None and path and "benchmarks" in path:
            try:
                Path(path).resolve().relative_to(old_bench)
            except ValueError:
                continue
            found.append(name)
    return sorted(found)
