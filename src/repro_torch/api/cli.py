"""CLI front door of the port: run any (workload, protocol, engine) triple.

    python -m repro_torch.api.cli --list                 # the registries
    python -m repro_torch.api.cli smoke --engine proc:4  # on the card
    python -m repro_torch.api.cli smoke --device cpu     # plain torch
    python -m repro_torch.api.cli serve smoke --queries 64   # serve_main

Prints the TrainResult summary line (and the accuracy curve with -v).
`serve_main` trains the triple, then serves the workload's eval set
through api.serve's micro-batch path and reports throughput + agreement
with opened-model scoring.  The flags are the JAX package's, plus
--device: the card unless "cpu" is asked for, as in api.fit(device=).
"""

from __future__ import annotations

import argparse
import sys

from . import (PROTOCOLS, FaultPlan, engine_names, fit, objective_names,
               serve, workload_names)
from . import workloads as workloads_mod

DEVICES = ("cuda", "cpu")


def _device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=DEVICES, default=None,
                    help="run on the CUDA card (the default) or on the CPU "
                         "(the kernels' plain torch versions)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("workload", nargs="?", default=None,
                    help="registry name (see --list)")
    ap.add_argument("--workload", dest="workload_flag", default=None,
                    metavar="NAME",
                    help="alternative spelling of the positional workload")
    ap.add_argument("--protocol", default="copml",
                    choices=sorted(PROTOCOLS))
    ap.add_argument("--engine", default="jit",
                    help='"eager" | "jit" | "proc[:N]" (see --list for the '
                         'live registry)')
    ap.add_argument("--iters", type=int, default=None,
                    help="GD iterations (default: the workload's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--straggle-p", type=float, default=None, metavar="P",
                    help="inject a seeded FaultPlan.random churn schedule "
                         "(per-step straggle probability; repaired to the "
                         "protocol's recovery threshold)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for --straggle-p's schedule")
    ap.add_argument("--no-history", action="store_true",
                    help="skip the per-step model history / accuracy curve")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--list", action="store_true",
                    help="print the registries and exit")
    _device_flag(ap)
    args = ap.parse_args(argv)
    if args.workload_flag is not None:
        if args.workload is not None:
            ap.error("give the workload positionally OR via --workload, "
                     "not both")
        args.workload = args.workload_flag
    if args.workload is None:
        args.workload = "quickstart"

    if args.list:
        print("workloads: ", ", ".join(workload_names()))
        print("protocols: ", ", ".join(sorted(PROTOCOLS)))
        # the live kind registry, so engines registered after import appear
        # without a CLI edit
        print("engines:   ", ", ".join(engine_names()))
        print("objectives:", ", ".join(objective_names()))
        return

    plan = None
    if args.straggle_p is not None:
        proto = PROTOCOLS[args.protocol]
        if not proto.supports_faults:
            ap.error(f"--straggle-p: protocol {args.protocol!r} has no "
                     f"fault injection")
        wl = workloads_mod.resolve(args.workload)
        iters = wl.iters if args.iters is None else args.iters
        # the same threshold protocol-side validation enforces
        thr = proto.fault_threshold(wl)
        plan = FaultPlan.random(wl.n_clients, iters, seed=args.fault_seed,
                                straggle_p=args.straggle_p,
                                min_available=thr)
        print(plan.describe(thr))

    res = fit(args.workload, args.protocol, args.engine, key=args.seed,
              iters=args.iters, history=not args.no_history, faults=plan,
              device=args.device)
    print(res.summary())
    if args.verbose and res.accuracy is not None:
        for t, a in enumerate(res.accuracy):
            print(f"  iter {t:3d}  accuracy {a:.3f}")


def serve_main(argv=None) -> None:
    """Train a triple, then serve its eval set from the secret-shared
    model."""
    import numpy as np

    ap = argparse.ArgumentParser(
        description="train a (workload, protocol, engine) triple, then "
                    "serve its eval set from the secret-shared model")
    ap.add_argument("workload", nargs="?", default="smoke",
                    help="registry name (default: smoke)")
    ap.add_argument("--protocol", default="copml",
                    choices=sorted(PROTOCOLS))
    ap.add_argument("--train-engine", default="jit", metavar="ENGINE",
                    help="engine for the training fit (default: jit)")
    ap.add_argument("--engine", default="jit",
                    help='serving engine: "eager" | "jit"')
    ap.add_argument("--iters", type=int, default=None,
                    help="GD iterations (default: the workload's)")
    ap.add_argument("--batch-size", type=int, default=32,
                    help="micro-batch window size (default: 32)")
    ap.add_argument("--window-ms", type=float, default=5.0,
                    help="micro-batch window in ms (default: 5)")
    ap.add_argument("--queries", type=int, default=None, metavar="Q",
                    help="serve only the first Q eval rows")
    ap.add_argument("--seed", type=int, default=0)
    _device_flag(ap)
    args = ap.parse_args(argv)

    res = fit(args.workload, args.protocol, args.train_engine,
              key=args.seed, iters=args.iters, history=False,
              device=args.device)
    print(res.summary())
    srv = serve(args.workload, res, args.engine, key=args.seed,
                batch_size=args.batch_size, window_ms=args.window_ms,
                device=args.device)
    wl = workloads_mod.resolve(args.workload)
    x, _ = wl.eval_set()
    if args.queries is not None:
        x = x[: args.queries]
    preds, _ = srv.serve(x)
    w = res.weights if res.weights.ndim > 1 else res.weights[:, None]
    open_preds = srv._decide(np.asarray(x, np.float64) @ w)
    if preds.dtype.kind == "f":      # regression: scores, not classes
        agree = float(np.isclose(preds, open_preds, atol=0.5).mean())
    else:
        agree = float((preds == open_preds).mean())
    print(srv.summary())
    print(f"agreement with opened-model scoring: {agree:.3f} "
          f"over {len(preds)} queries")


def run(argv=None) -> None:
    """The module's entry point: `serve ...` runs serve_main on the rest
    of the arguments, anything else runs main."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["serve"]:
        serve_main(argv[1:])
    else:
        main(argv)


if __name__ == "__main__":
    run()
