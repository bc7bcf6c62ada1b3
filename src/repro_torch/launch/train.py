"""Training entry point: the paper's workload, through the api facade.

    PYTHONPATH=src python -m repro_torch.launch.train --arch copml-logreg \\
        --workload cifar10_case2 --protocol copml --engine jit --iters 5

prints the TrainResult's summary line, as api.fit(workload, protocol,
engine, iters=) gives it.  Runs on the CUDA card unless --device cpu is
given.  An LM arch is refused: LM training and its flags come with the LM
training slice (the LM archs serve through models/lm_serving.generate).
"""

from __future__ import annotations

import argparse

from ..api.cli import DEVICES
from ..configs import registry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="copml-logreg",
                    choices=list(registry.ARCH_IDS))
    # the (workload, protocol, engine) run triple
    ap.add_argument("--workload", default="quickstart")
    ap.add_argument("--protocol", default="copml")
    ap.add_argument("--engine", default="jit")
    ap.add_argument("--iters", type=int, default=None,
                    help="GD iterations (default: the workload's)")
    ap.add_argument("--device", choices=DEVICES, default=None,
                    help="run on the CUDA card (the default) or on the CPU")
    args = ap.parse_args(argv)
    if args.arch in registry.LM_ARCH_IDS:
        ap.error(f"--arch {args.arch}: LM training comes with the LM "
                 "training slice")

    from .. import api
    res = api.fit(args.workload, args.protocol, args.engine,
                  iters=args.iters, device=args.device)
    print(res.summary())


if __name__ == "__main__":
    main()
