#!/usr/bin/env python3
"""Find the knee of an open-loop serving cell: the highest offered rate at
which the backlog does not grow over a window.

    python3 bench/sweep.py --workload <serving cell> --seed <n> \
        --seconds <s> --rates 5000,10000,20000 [--json out.json]

One process: the cell's set-up once (model trained, server built, warm),
then the cell's open loop at each rate in turn, each for `seconds`.  For
each rate it prints the offered and completed queries a second, p50 and p95
latency, how far the generator ran late, and the backlog's growth: the
mean latency of the last fifth of the queries minus that of the first
fifth (a queue that keeps up shows none), and the queries still waiting
when the last one was due.  The knee it prints last is the highest rate
below which every rate swept completed 99% of its offer with at most
GROWTH_MS of growth; a cell's rate is then set at about four fifths of it,
in its traffic file.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run as bench_run  # noqa: E402

GROWTH_MS = 1.0


def sweep_rate(h, st, rate: float, seconds: float, seed: int) -> dict:
    import numpy as np
    loop_mod = h.driver
    due, index = loop_mod.schedule(rate, seconds, seed, len(st["pool"]))
    loop = loop_mod.serve_loop(st["sysm"], st["srv"], st["pool"], due, index,
                               h.mix)
    lat = np.where(loop["answered"], loop["done"] - loop["due"], np.inf)
    fifth = max(1, len(lat) // 5)
    last_due = loop["due"][-1]
    waiting = int(((loop["submit"] <= last_due)
                   & ~(loop["done"] <= last_due)).sum())
    span = np.nanmax(loop["done"]) - loop["due"][0]
    return dict(rate_qps=rate, queries=len(due),
                completed_qps=float(loop["answered"].sum() / span),
                p50_ms=float(np.percentile(lat, 50)) * 1e3,
                p95_ms=float(np.percentile(lat, 95)) * 1e3,
                growth_ms=float(lat[-fifth:].mean() - lat[:fifth].mean())
                * 1e3,
                waiting_at_last_due=waiting,
                late_p95_ms=float(np.percentile(
                    loop["submit"] - loop["due"], 95)) * 1e3,
                windows=len(loop["windows"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rates", required=True,
                    help="comma-separated queries a second")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    bench_run._prepare_environment()
    import torch
    from yardstick import registry
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    spec = registry.load_spec(bench_run.ROOT / "BENCHMARK.json")
    cell = registry.cell(spec, args.workload)
    h = bench_run.Harness(spec, cell, args.seed, args.seconds, False,
                          torch.device("cuda"), bench_run.BENCH)
    st = h.driver.setup(h)
    rows = []
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        row = sweep_rate(h, st, rate, args.seconds, args.seed + i)
        rows.append(row)
        print(json.dumps(row), flush=True)
    knee = None
    for r in sorted(rows, key=lambda r: r["rate_qps"]):
        if r["growth_ms"] > GROWTH_MS \
                or r["completed_qps"] < 0.99 * r["rate_qps"]:
            break
        knee = r["rate_qps"]
    print(json.dumps(dict(knee_qps=knee, four_fifths_qps=None if knee is None
                          else 0.8 * knee)), flush=True)
    out = dict(workload=args.workload, device=torch.cuda.get_device_name(),
               seconds=args.seconds, rows=rows, knee_qps=knee)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
