"""Find everything a cell needs by the names in BENCHMARK.json.

A cell names a configuration and a traffic mix; a metric is named in the
cell's lists.  Each is a file of its own under the benchmark's folder:

  configs/<config>.json      the configuration as it is run
  traffic/<traffic>.json     the mix's parameters, naming its driver
  drivers/<driver>.py        a general generator for one kind of mix
  systems/<system>.py        how one kind of configuration builds the
                             program under test (named by the config)
  reference/<reference>.py   the plain reference (named by the config)
  metrics/<metric>.py        one reader a metric, `read(ctx)`

so a later change adds a configuration, a mix or a metric by adding files
and entries, without editing a file that is already there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _checked(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    return json.loads(path.read_text())


def load_spec(path: Path) -> dict:
    return _json(Path(path))


def cell(spec: dict, name: str) -> dict:
    for entry in spec["workloads"]:
        if entry["name"] == name:
            return entry
    known = ", ".join(w["name"] for w in spec["workloads"])
    raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has: {known}")


def cell_metrics(spec: dict, cell_name: str, kind: str) -> list:
    """The entries of spec[kind] ("end_to_end" or "per_layer") that the cell
    reports: those that list it under "workloads"; a per-layer metric
    without the key, in every cell that reports the metric it moves; an
    end-to-end metric without the key, in every cell."""
    e2e = [m["name"] for m in spec["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    out = []
    for m in spec[kind]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def config(name: str, root: Path = BENCH) -> dict:
    cfg = _json(Path(root) / "configs" / f"{_checked(name)}.json")
    cfg.setdefault("name", name)
    return cfg


def traffic(name: str, root: Path = BENCH) -> dict:
    mix = _json(Path(root) / "traffic" / f"{_checked(name)}.json")
    mix.setdefault("name", name)
    return mix


def _module(kind: str, name: str, root: Path):
    path = Path(root) / kind / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark module: {path}")
    mod_name = f"bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = BENCH):
    return _module("drivers", name, root)


def system(name: str, root: Path = BENCH):
    return _module("systems", name, root)


def reference(name: str, root: Path = BENCH):
    return _module("reference", name, root)


def metric_reader(name: str, root: Path = BENCH):
    """The metric's `read(ctx)`: a number, or None where the run has
    nothing for it to read."""
    return _module("metrics", name, root).read
