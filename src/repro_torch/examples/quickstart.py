"""Quickstart: privacy-preserving collaborative logistic regression (COPML).

13 virtual clients jointly train a logistic regression model without any of
them ever seeing another client's data, the intermediate models, or the
gradients -- only the final model is revealed (paper Algorithm 1).

Everything goes through the repro_torch.api front door: a run is a
(workload, protocol, engine) triple and returns a TrainResult.

    PYTHONPATH=src python -m repro_torch.examples.quickstart   # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

import argparse

from repro_torch import api


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for plain torch (default: the CUDA card)")
    args = ap.parse_args(argv)

    wl = api.get_workload("quickstart")
    cfg = wl.cfg
    print(f"COPML: N={wl.n_clients} clients, K={cfg.k} (parallelization), "
          f"T={cfg.t} (privacy), recovery threshold R={cfg.recovery_threshold}")
    print(f"  -> tolerates {wl.n_clients - cfg.recovery_threshold} stragglers "
          f"per iteration, privacy against any {cfg.t} colluding clients")

    secure = api.fit(wl, "copml", "jit", key=0, device=args.device)
    for t in range(0, secure.iters, 10):
        print(f"  iter {t:3d}  accuracy {secure.accuracy[t]:.3f}")

    plain = api.fit(wl, "float", "eager", key=0, device=args.device)
    print(f"\nfinal accuracy: COPML {secure.final_accuracy:.3f} vs float "
          f"logreg {plain.final_accuracy:.3f}"
          f"  (paper Fig. 4: parity within ~1.3 points)")
    print(f"modeled per-client cost on the paper's 40 Mbps WAN: "
          f"COPML {secure.cost['total_s']:.0f}s total "
          f"({secure.cost['comm_s']:.0f}s communication)")
    return secure, plain


if __name__ == "__main__":
    main()
