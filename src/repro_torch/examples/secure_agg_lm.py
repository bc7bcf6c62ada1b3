"""Beyond the paper: LM training with COPML-coded secure gradient
aggregation.

Eight virtual data owners fine-tune a shared LM; each host's gradient is
quantized (App. A), Shamir-shared, summed in the share domain, and decoded
with the paper's secure truncation -- no host ever sees another's gradient
(information-theoretic, T=2 colluders), and any 3 of 8 hosts suffice to
reconstruct (straggler tolerance).  See core/secure_agg.py.

    PYTHONPATH=src python -m repro_torch.examples.secure_agg_lm
    PYTHONPATH=src python -m repro_torch.examples.secure_agg_lm --device cpu
"""

import argparse

from repro_torch.configs import registry
from repro_torch.core.secure_agg import SecureAggConfig
from repro_torch.train import trainer

STEPS = 20


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for plain torch (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = registry.smoke_config("smollm-360m")
    sa = SecureAggConfig(n_clients=8, t=2, lq=14, clip=4.0)
    print(f"secure aggregation: N={sa.n_clients} hosts, privacy T={sa.t}, "
          f"straggler budget {sa.n_clients - (sa.t + 1)}")
    tcfg = trainer.TrainConfig(steps=STEPS, global_batch=8, seq_len=64,
                               log_every=2, secure_agg=sa)
    params, hist = trainer.train_secure(cfg, tcfg, device=args.device)
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"(every gradient exchange information-theoretically private)")
    return params, hist


if __name__ == "__main__":
    main()
