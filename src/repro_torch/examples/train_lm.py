"""End-to-end driver: train a small LM for a few hundred steps.

Model zoo config, AdamW, microbatching, the deterministic data pipeline,
asynchronous checkpoints and resume.  The default is a scaled smollm;
--hundred-m trains the ~100M-parameter configuration.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 20 \
        --device cpu
"""

import argparse
import os
import tempfile

from repro_torch.configs import registry
from repro_torch.train import trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--hundred-m", action="store_true",
                    help="~100M-param config")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt_lm"))
    ap.add_argument("--device", default=None,
                    help="'cpu' for plain torch (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.hundred_m:
        cfg = registry.get_config("smollm-360m").scaled(
            n_layers=12, d_model=768, n_heads=12, n_kv=4, d_ff=2048,
            vocab=32768)    # ~104M params
        batch, seq = 4, 256
    else:
        cfg = registry.smoke_config("smollm-360m").scaled(
            n_layers=4, d_model=128, n_heads=4, n_kv=2, d_ff=384)
        batch, seq = 8, 128
    print(f"training {cfg.name} variant: ~{cfg.param_count()/1e6:.0f}M params")

    tcfg = trainer.TrainConfig(
        steps=args.steps, global_batch=batch, seq_len=seq,
        microbatch=batch // 2, ckpt_dir=args.ckpt, ckpt_every=50,
        log_every=10)
    params, history = trainer.train(cfg, tcfg, device=args.device)
    print(f"loss: {history[0]['loss']:.3f} -> {history[-1]['loss']:.3f} "
          f"over {args.steps} steps (checkpoints in {args.ckpt})")
    return params, history


if __name__ == "__main__":
    main()
