#!/usr/bin/env python3
"""Straggler jobs against fault-free jobs of the same keys, on a CUDA card.

    python3 scripts/straggler_bits.py --config cifar10_case2 --seed 7 --jobs 3

builds a benchmark configuration's program (bench/systems), trains each
job's key twice -- fault-free, and under the straggler mix's plan for that
key (bench/drivers/train_stragglers.py) -- and checks that the two open
the same models bit for bit, step by step.  Prints one JSON line a job
(the plan's distinct stragglers, the faulty job's `setup.faults` seconds
and its gradient counts) and exits 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1] / "bench"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="cifar10_case2")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--jobs", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH.parent / "src"), str(BENCH)]
    import numpy as np
    import torch
    from drivers import train_stragglers
    from yardstick import data, registry

    if not torch.cuda.is_available():
        print("straggler_bits: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = registry.config(args.config)
    system = registry.system(cfg["system"])
    plain = system.System(cfg, dev)
    plain.build_kernels()
    faulty = train_stragglers.straggling(system.System, args.seed, 1)(cfg,
                                                                      dev)
    x, y = data.planted_rows(cfg["m"], cfg["d"], cfg["data"]["margin"],
                             args.seed, dev)
    cx, cy = plain.split(x, y)
    ok = True
    for j in range(args.jobs):
        key = data.program_key(args.seed, j)
        a = plain.job(key, cx, cy)
        b = faulty.job(key, cx, cy)
        same = bool(np.array_equal(a["w"], b["w"])
                    and np.array_equal(a["hist"], b["hist"]))
        ok &= same
        steps = train_stragglers.straggler_steps(
            args.seed, key, cfg["n_clients"], cfg["iters"], 1)
        print(json.dumps(dict(
            config=args.config, seed=args.seed, job=j, bit_equal=same,
            distinct_stragglers=len({c[0] for c in steps.values()}),
            fault_plan_ms=1e3 * b["timings"]["spans"]["setup.faults"][1],
            counts=b["timings"]["counts"],
            device=torch.cuda.get_device_name(dev))), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
