"""Training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 100 --batch 8 --seq 256 --ckpt /tmp/ckpt

trains an LM arch with train/trainer.train: the reduced (smoke) config by
default, --full for the published one.  With --ckpt a rerun resumes from
the newest complete checkpoint and replays the step-keyed data stream,
so it ends where one straight run ends.  The port's trainer runs on one
device: --model-parallel takes 1 only (larger values are refused), and
the step runs under the one-device host mesh.

The paper's own workload is an arch too: `--arch copml-logreg` routes
through the api facade:

    PYTHONPATH=src python -m repro_torch.launch.train --arch copml-logreg \\
        --workload cifar10_case2 --protocol copml --engine jit --iters 5

prints the TrainResult's summary line.  Runs on the CUDA card unless
--device cpu is given.
"""

from __future__ import annotations

import argparse

from ..api.cli import DEVICES
from ..configs import registry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="copml-logreg",
                    choices=list(registry.ARCH_IDS))
    # copml-logreg only: the (workload, protocol, engine) run triple
    ap.add_argument("--workload", default="quickstart")
    ap.add_argument("--protocol", default="copml")
    ap.add_argument("--engine", default="jit")
    ap.add_argument("--iters", type=int, default=None,
                    help="copml-logreg GD iterations (default: workload's)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the model axis of the host mesh: 1 only, the "
                    "port's trainer runs on one device")
    ap.add_argument("--device", choices=DEVICES, default=None,
                    help="run on the CUDA card (the default) or on the CPU")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        ap.error(f"--model-parallel {args.model_parallel}: the port's "
                 f"trainer runs on one device, so only 1 is accepted")

    if args.arch == "copml-logreg":
        from .. import api
        res = api.fit(args.workload, args.protocol, args.engine,
                      iters=args.iters, device=args.device)
        print(res.summary())
        return

    from ..train import trainer
    from . import mesh as mesh_lib
    cfg = (registry.get_config(args.arch) if args.full
           else registry.smoke_config(args.arch))
    tcfg = trainer.TrainConfig(
        steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        microbatch=args.microbatch, loss_chunk=args.loss_chunk,
        ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every)
    params, history = trainer.train(
        cfg, tcfg, mesh=mesh_lib.make_host_mesh(1, n_devices=1),
        device=args.device)
    print(f"final loss: {history[-1]['loss']:.4f} "
          f"({cfg.name}, {args.steps} steps)")


if __name__ == "__main__":
    main()
