#!/usr/bin/env python3
"""Run a cell's control: the plain reference in the program's place, at the
nearest precision below the configuration's (systems/control_copml_logreg),
through the benchmark's own drivers and checks, which must judge it not
correct.  The benchmark's own runs never run it.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 5

prints one JSON line a seed with `correct` and each compared number beside
its limit.  On a machine without a card, --device cpu runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run as bench_run  # noqa: E402

CONTROL = {"system": "control_copml_logreg"}


def control_runs(workload: str, seeds, seconds: float, device,
                 spec=None, root=None) -> list:
    from yardstick import registry
    spec = spec or registry.load_spec(bench_run.ROOT / "BENCHMARK.json")
    out = []
    for seed in seeds:
        res = bench_run.run_cell(spec, workload, seed, seconds, False, device,
                                 root or bench_run.BENCH, overrides=CONTROL)
        out.append(dict(seed=seed, correct=res["correct"],
                        limits=res["limits"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench_run._prepare_environment()
    import torch
    for row in control_runs(args.workload,
                            [int(s) for s in args.seeds.split(",")],
                            args.seconds, torch.device(args.device)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
