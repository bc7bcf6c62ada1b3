"""Multi-class quickstart: 10-class one-vs-rest training on CODED data.

13 virtual clients jointly train a 10-class classifier without any of them
ever seeing another client's data, the intermediate models, or the
gradients.  The model is a single (d, 10) field matrix: the dataset is
quantized, secret-shared, and LCC-encoded ONCE, and every gradient round
computes all 10 one-vs-rest columns as one class-batched field GEMM
X~^T ghat(X~ W) -- C-fold fewer encode/share collectives than 10
independent binary runs.

    PYTHONPATH=src python -m repro_torch.examples.multiclass_quickstart
    PYTHONPATH=src python -m repro_torch.examples.multiclass_quickstart \
        --device cpu
"""

import argparse

from repro_torch import api


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for plain torch (default: the CUDA card)")
    args = ap.parse_args(argv)

    wl = api.get_workload("mnist10_like")
    n_classes = wl.objective.n_outputs
    print(f"COPML multi-class: N={wl.n_clients} clients, C={n_classes} "
          f"one-vs-rest classes on ONE dataset encoding "
          f"(K={wl.cfg.k}, T={wl.cfg.t}, R={wl.cfg.recovery_threshold})")
    print(f"  model: ({wl.d}, {n_classes}) field matrix; "
          f"prediction: argmax over the C column scores\n")

    secure = api.fit(wl, "copml", "jit", key=0, device=args.device)
    print(f"secure 10-class training: {secure.iters} iters in "
          f"{secure.wall_time_s:.1f}s, argmax accuracy "
          f"{secure.final_accuracy:.3f} on {wl.test_m} held-out rows")
    print("per-class accuracy:")
    for c, acc in enumerate(secure.per_class_accuracy):
        print(f"  class {c}: {acc:.3f}")

    plain = api.fit(wl, "float", "jit", key=0, device=args.device)
    print(f"\nplaintext one-vs-rest reference: {plain.final_accuracy:.3f} "
          f"(parity gap {plain.final_accuracy - secure.final_accuracy:+.3f})")
    print(f"modeled per-client cost on the paper's 40 Mbps WAN: "
          f"{secure.cost['total_s']:.0f}s total "
          f"({secure.cost['comm_s']:.0f}s communication), amortized over "
          f"all {n_classes} classes")
    return secure, plain


if __name__ == "__main__":
    main()
